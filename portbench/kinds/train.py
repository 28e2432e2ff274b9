"""Training steps in a closed loop.

Set-up builds the program's training step (model and optimizer state)
from the seed's weights and drives it through its first ``CHECKED``
steps on the first distinct batches of the seed's pool, through the same
call the window makes; it keeps each step's loss, each leaf's norm of
the first gradient (read from the optimizer's state after one step) and,
on the host, the parameters after the last checked step.  The window then
runs steps on the same object, batch ``i`` of the pool at step ``i``, each
ending in a synchronise, until ``--seconds`` have passed: ``train_step_ms``
is the window over the steps.  Once the window has closed, the peak
memory is read, the program's state freed, and the reference follows the
checked steps from the same weights and batches (``check.training``).
"""
from __future__ import annotations

import time

from .. import check, gen

CHECKED = 3
TRACED_STEPS = 3


def run(ctx) -> dict:
    cell, fam, dev = ctx.cell, ctx.cell.family, ctx.device
    cfg, mix = cell.config, cell.mix
    if mix["distinct_batches"] < CHECKED:
        raise ValueError("the checked steps need distinct batches")
    pool = gen.pool(cfg, mix, ctx.seed, dev)
    ctx.mark("inputs")
    prog = fam.Train(cfg, mix, fam.make_weights(cfg, ctx.seed, dev), dev,
                     ctx.impl)
    ctx.mark("program")
    losses, grad_norms = [], None
    for i in range(CHECKED):
        losses.append(prog.step(pool[i]))
        ctx.sync()
        if i == 0:
            grad_norms = prog.first_grad_norms()
    after = {k: v.to("cpu", copy=True) for k, v in prog.params().items()}
    losses = [float(x) for x in losses]

    ctx.setup_done()
    steps, t0 = 0, time.perf_counter()
    while True:
        prog.step(pool[(CHECKED + steps) % len(pool)])
        ctx.sync()
        steps += 1
        window = time.perf_counter() - t0
        if window >= ctx.seconds:
            break
    step_s = window / steps

    reading = None
    if ctx.trace:
        def segment():
            for i in range(TRACED_STEPS):
                prog.step(pool[i % len(pool)])
        reading = ctx.traced(segment)
        reading.update(kind="train", precision=fam.precision(cfg),
                       units=TRACED_STEPS,
                       model_flops_per_s=fam.model_flops(cfg, mix) / step_s)
    peak = ctx.peak_bytes()
    del prog
    ctx.free()

    w0 = fam.make_weights(cfg, ctx.seed, dev)
    want = fam.reference_train(cfg, mix, w0, pool[:CHECKED], control=False)
    got = {"losses": losses, "grad_norms": grad_norms,
           "change_norms": {k: float((v.to(dev).double() - w0[k].double())
                                     .norm()) for k, v in after.items()}}
    return {"attempted": steps, "failed": 0,
            "e2e": {"train_step_ms": step_s * 1e3},
            "numbers": check.training(got, want), "reading": reading,
            "memory_peak_bytes": peak}
