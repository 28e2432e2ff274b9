"""Batches classified in a closed loop.

Set-up builds the program from the seed's weights and runs ``WARM`` calls
on the pool's batches.  The window calls the program on batch ``i`` of the
seed's pool, reads each image's class back to the host, and goes on until
``--seconds`` have passed and it has made every call whose logits are
kept for the check: ``images_per_s`` is every image classified over the
window.  Those calls are drawn from the seed (``SAMPLED`` of the first
``SAMPLE_FROM``); once the window has closed, the reference computes the same batches'
logits and the worst image's row is compared (``check.rows``).
"""
from __future__ import annotations

import time

from .. import check, gen

WARM = 2
SAMPLE_FROM, SAMPLED = 48, 4
TRACED_CALLS = 3


def run(ctx) -> dict:
    cell, fam, dev = ctx.cell, ctx.cell.family, ctx.device
    cfg, mix = cell.config, cell.mix
    pool = gen.pool(cfg, mix, ctx.seed, dev)
    ctx.mark("inputs")
    prog = fam.Infer(cfg, mix, fam.make_weights(cfg, ctx.seed, dev), dev,
                     ctx.impl)
    ctx.mark("program")
    for i in range(WARM):
        prog.infer(pool[i % len(pool)][0]).argmax(-1).cpu()
    sampled = set(gen.sample(ctx.seed, "answers", SAMPLE_FROM, SAMPLED))

    ctx.setup_done()
    kept, calls, t0 = {}, 0, time.perf_counter()
    while True:
        logits = prog.infer(pool[calls % len(pool)][0])
        logits.argmax(-1).cpu()
        if calls in sampled:
            kept[calls] = logits.clone()
        calls += 1
        window = time.perf_counter() - t0
        if window >= ctx.seconds and calls > max(sampled):
            break
    per_call = window / calls

    reading = None
    if ctx.trace:
        def segment():
            for i in range(TRACED_CALLS):
                prog.infer(pool[i % len(pool)][0]).argmax(-1).cpu()
        reading = ctx.traced(segment)
        reading.update(kind="infer", precision=fam.precision(cfg),
                       units=TRACED_CALLS,
                       model_flops_per_s=fam.model_flops(cfg, mix) / per_call)
    peak = ctx.peak_bytes()
    del prog
    ctx.free()

    w0 = fam.make_weights(cfg, ctx.seed, dev)
    worst = 0.0
    for i, got in sorted(kept.items()):
        want = fam.reference_logits(cfg, w0, pool[i % len(pool)][0],
                                    control=False)
        worst = max(worst, check.rows(got, want))
    return {"attempted": calls * mix["batch"], "failed": 0,
            "e2e": {"images_per_s": calls * mix["batch"] / window},
            "numbers": {"logit_row": worst}, "reading": reading,
            "memory_peak_bytes": peak}
