"""Prompts served in an open loop above the server's capacity: each
request asks for the first token after its prompt.

The mix's schedule (``gen.arrivals``) releases the window's
``round(rate * seconds)`` single requests, rounded to whole prefills, the
same in every run.  The server (``plan``) takes each prompt length's
requests in arrival order in prefills of ``MAX_BATCH``, each closing when
its last request is due, and serves them in the order of closing as soon
as it is free.  Offered above what the server sustains, the queue grows
all through the window and every prefill starts full as soon as the last
ends, so what each holds and when it runs follow from the schedule alone,
and only the time it takes varies.  The served token is read back to the
host.  The window closes at the first prefill that ends at or after
``--seconds``; what is still queued then is not served.  Set-up runs one
prefill of each length.

The traced segment is the schedule's steady state: the prefills that
close in the ``TRACED_SECONDS`` after the first closes, on their schedule
shifted to start at that close, so that the first fill is left out.

The check: once the window has closed, the reference runs a sample of
the served requests drawn from the seed (``SAMPLED``, a longest prompt
among them) and reads how far each served token's logit lies below its
best (``check.token_gaps``); for ``KV_SAMPLED`` of them it compares the
keys and values the prefill wrote for every layer with its own
(``check.rows``, a layer's K or V of a request a row).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from .. import check, gen

MAX_BATCH = 16
SCHEDULE_SEED = 2026
SAMPLED, KV_SAMPLED = 192, 2
REF_BATCH = 8
TRACED_SECONDS = 0.5


def schedule(mix: dict, seconds: float) -> Tuple[List[float], List[int]]:
    """Each request's due time and prompt length: the mix's arrivals over
    ``seconds``, as many as fill whole prefills of every length."""
    return gen.arrivals(mix, seconds, SCHEDULE_SEED,
                        multiple=MAX_BATCH * len(mix["lengths"]))


def plan(due: List[float], lengths: List[int]
         ) -> List[Tuple[float, List[int]]]:
    """``(close time, requests)`` of each prefill, in serving order."""
    groups: Dict[int, List[int]] = {}
    for r in range(len(due)):
        groups.setdefault(lengths[r], []).append(r)
    out = [(due[rows[i:i + MAX_BATCH][-1]], rows[i:i + MAX_BATCH])
           for rows in groups.values()
           for i in range(0, len(rows), MAX_BATCH)]
    return sorted(out, key=lambda b: (b[0], b[1][0]))


def serve(prog, prompts, lengths, batches, seconds, keep_kv):
    """Serves ``batches`` (``plan``'s) on their schedule until the first
    prefill that ends at or after ``seconds`` (all of them where it is
    None); returns each served request's token, the window's end (s),
    the prefills served, the seconds spent in prefill calls, and the
    kept caches."""
    tokens, kv = {}, {}
    busy, served = 0.0, 0
    start = time.perf_counter()
    done = start
    for close, batch in batches:
        wait = close - (time.perf_counter() - start)
        if wait > 0:
            time.sleep(wait)
        length = lengths[batch[0]]
        t_b = time.perf_counter()
        rows = torch.tensor(batch, device=prompts.device)
        tok, cache = prog.prefill(prompts.index_select(0, rows)[:, :length])
        for j, r in enumerate(batch):
            if r in keep_kv:
                kv[r] = prog.kv(cache, j).clone()
        del cache
        out = tok.cpu().tolist()
        done = time.perf_counter()
        busy += done - t_b
        served += 1
        tokens.update(zip(batch, out))
        if seconds is not None and done - start >= seconds:
            break
    return tokens, done - start, served, busy, kv


def run(ctx) -> dict:
    cell, fam, dev = ctx.cell, ctx.cell.family, ctx.device
    cfg, mix = cell.config, cell.mix
    due, lengths = schedule(mix, ctx.seconds)
    n = len(due)
    batches = plan(due, lengths)
    prompts = gen.prompts(cfg, mix, ctx.seed, n, dev)
    ctx.mark("inputs")
    weights = fam.make_weights(cfg, ctx.seed, dev)
    prog = fam.Prefill(cfg, mix, weights, dev, ctx.impl)
    ctx.mark("program")
    for length in sorted(set(lengths)):
        prog.prefill(prompts[:MAX_BATCH, :length])[0].cpu()
    del weights
    # kept from the first prefill, and from the first of the longest
    # prompts, which the window always serves
    first = batches[0][1]
    longest = next(rows for _, rows in batches
                   if lengths[rows[0]] == max(lengths))
    keep_kv = {longest[gen.sample(ctx.seed, "kv", len(longest), 1)[0]]}
    keep_kv |= {first[i] for i in gen.sample(ctx.seed, "kv-any", len(first),
                                             KV_SAMPLED - 1)}

    ctx.setup_done()
    tokens, window, served, busy, kv = serve(
        prog, prompts, lengths, batches, ctx.seconds, keep_kv)
    done = sorted(tokens)
    flops = sum(fam.model_flops(cfg, mix, len(rows), lengths[rows[0]])
                for _, rows in batches[:served])

    reading = None
    if ctx.trace:
        c0 = batches[0][0]
        traced = [(close - c0, rows) for close, rows in batches
                  if close < c0 + TRACED_SECONDS]

        def segment():
            serve(prog, prompts, lengths, traced, None, set())
        reading = ctx.traced(segment)
        reading.update(kind="prefill", precision=fam.precision(cfg),
                       units=len(traced), model_flops_per_s=flops / busy)
    peak = ctx.peak_bytes()
    del prog
    ctx.free()

    sampled = sorted({done[i] for i in gen.sample(ctx.seed, "served",
                                                  len(done), SAMPLED)}
                     | set(kv))
    w32 = {k: v.float() for k, v in fam.make_weights(cfg, ctx.seed,
                                                     dev).items()}
    gaps, kv_worst = [], 0.0
    for length in sorted(set(lengths[r] for r in sampled)):
        rows = [r for r in sampled if lengths[r] == length]
        for i in range(0, len(rows), REF_BATCH):
            part = rows[i:i + REF_BATCH]
            want_kv = any(r in kv for r in part)
            logits, kvs = fam.reference_prefill(
                cfg, w32, prompts[part, :length], control=False,
                keep_kv=want_kv)
            served_tokens = torch.tensor([tokens[r] for r in part],
                                         device=dev)
            gaps += check.token_gaps(logits, served_tokens).tolist()
            for j, r in enumerate(part):
                if r in kv:
                    got = kv[r].flatten(0, 1).flatten(2)
                    want = kvs[:, :, j].flatten(0, 1).flatten(2)
                    kv_worst = max(kv_worst, check.rows(got, want))
    attempted = sum(len(rows) for _, rows in batches[:served])
    return {"attempted": attempted, "failed": attempted - len(tokens),
            "e2e": {"prefill_tokens_per_s":
                    sum(lengths[r] for r in done) / window},
            "numbers": {"token_gap": max(gaps), "kv_row": kv_worst},
            "reading": reading, "memory_peak_bytes": peak}
