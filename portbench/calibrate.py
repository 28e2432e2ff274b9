"""The readings a cell's check limits are set from, on the card, in one
process:

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault-seeds 4,5,6] [--seconds S] \\
        [--out FILE]

* the program: a run of the cell (``run.run_cell``, a ``--seconds``
  window) on each of ``--seeds``, its compared numbers;
* the control: on each of ``--control-seeds``, the plain reference
  computed one precision below the configuration's (fp8 for bfloat16,
  TF32 for float32) put in the program's place, compared with
  the plain reference by the cell's own numbers (for a served model: at
  each sampled prompt the token the control puts first);
* the faults (``faults.py``) the cell can have, each planted in the
  program on each of ``--fault-seeds``.

Each reading is printed as a JSON line (and appended to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path
               if p != str(Path(__file__).resolve().parent)]
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def control_numbers(cell, seed: int, device, seconds: float) -> dict:
    """The control's numbers on the inputs a run of ``seed`` makes."""
    import torch
    from portbench import check, gen
    from portbench.kinds import infer, prefill, train
    fam, cfg, mix = cell.family, cell.config, cell.mix
    kind = mix["kind"]
    if kind == "train":
        pool = gen.pool(cfg, mix, seed, device)[:train.CHECKED]
        w0 = fam.make_weights(cfg, seed, device)
        want = fam.reference_train(cfg, mix, w0, pool, control=False)
        got = fam.reference_train(cfg, mix, w0, pool, control=True)
        return check.training(got, want)
    if kind == "infer":
        pool = gen.pool(cfg, mix, seed, device)
        w0 = fam.make_weights(cfg, seed, device)
        worst = 0.0
        for i in gen.sample(seed, "answers", infer.SAMPLE_FROM,
                            infer.SAMPLED):
            images = pool[i % len(pool)][0]
            worst = max(worst, check.rows(
                fam.reference_logits(cfg, w0, images, control=True),
                fam.reference_logits(cfg, w0, images, control=False)))
        return {"logit_row": worst}
    due, lengths = prefill.schedule(mix, seconds)
    n = len(due)
    prompts = gen.prompts(cfg, mix, seed, n, device)
    w32 = {k: v.float() for k, v in fam.make_weights(cfg, seed,
                                                     device).items()}
    sampled = gen.sample(seed, "served", n, prefill.SAMPLED)
    gaps, kv_worst = [], 0.0
    for length in sorted(set(lengths[r] for r in sampled)):
        rows = [r for r in sampled if lengths[r] == length]
        for i in range(0, len(rows), prefill.REF_BATCH):
            part = rows[i:i + prefill.REF_BATCH]
            toks = prompts[part, :length]
            want, want_kv = fam.reference_prefill(cfg, w32, toks, False,
                                                  keep_kv=i == 0)
            got, got_kv = fam.reference_prefill(cfg, w32, toks, True,
                                                keep_kv=i == 0)
            gaps += check.token_gaps(want, got.argmax(-1)).tolist()
            if i == 0:
                kv_worst = max(kv_worst, check.rows(
                    got_kv[:, :, 0].flatten(0, 1).flatten(2),
                    want_kv[:, :, 0].flatten(0, 1).flatten(2)))
            del want_kv, got_kv
            torch.cuda.empty_cache()
    return {"token_gap": max(gaps), "kv_row": kv_worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import faults, spec
    from portbench.run import run_cell
    cell = spec.cell(args.workload)
    kind, family = cell.mix["kind"], cell.config["family"]

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda")
        emit({"workload": cell.name, "side": "program", "seed": seed,
              "numbers": {k: v["value"] for k, v in out["checks"].items()},
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "peak": out["memory_peak_bytes"],
              "s": time.perf_counter() - t})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for seed in seeds(args.control_seeds):
        t = time.perf_counter()
        emit({"workload": cell.name, "side": "control", "seed": seed,
              "numbers": control_numbers(cell, seed, "cuda", args.seconds),
              "s": time.perf_counter() - t})
        torch.cuda.empty_cache()
    for name in faults.faults_of(kind) if args.fault_seeds else ():
        for seed in seeds(args.fault_seeds):
            with faults.planted(name, family, kind):
                out = run_cell(cell, seed, args.seconds, False, "cuda")
            emit({"workload": cell.name, "side": f"fault:{name}",
                  "seed": seed, "correct": out["correct"],
                  "numbers": {k: v["value"] for k, v in
                              out["checks"].items()}})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
