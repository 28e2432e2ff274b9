#!/usr/bin/env python3
"""How far a ResNet-50 training step's gradients move when its arithmetic
changes a little, through the port's plain versions.

    PYTHONPATH=src python scripts/training_conditioning.py \
        [--batch 4] [--noise 1e-7] [--zero-gamma] [--after-step] \
        [--device cuda]

One step of ``networks.resnet50(batch)`` at 224 x 224, 1000 classes, with
seeded weights (``kernels.training.init_params``, seed 2026) and seeded
images and labels, is run with float32 GEMMs (``training.PLAIN``) as the
baseline, recording its ReLU and max-pool choices.  Against it, printed as
one JSON object, the relative Frobenius error of the loss and of every
parameter's gradient (max, median, 90th percentile, worst four) for:

* ``noise``: the same step with every GEMM output multiplied by
  ``1 + noise * N(0, 1)`` (``chip_smoke.noisy_plain``, the float32
  control of the chip check), a stand-in for another summation order;
* ``bf16``: the step with bfloat16 GEMMs, as the timed step runs;

each once on the baseline's ReLU and pooling choices (``pinned``) and
once making its own (``free``).  ``--zero-gamma`` starts from Goyal et
al.'s init (gamma 0 in the last BN of each block); ``--after-step`` first
takes one float32 SGDM step and measures at the weights it leaves.
``--device cpu`` runs every step through the plain versions on the CPU;
the default, ``cuda``, needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import noisy_plain  # noqa: E402
from repro_torch.core import networks  # noqa: E402
from repro_torch.kernels import training as T  # noqa: E402

SEED = 2026


def summary(loss, want_loss, errs):
    v = sorted(errs.values())
    return {"loss_rel": abs(loss - want_loss) / abs(want_loss),
            "max": v[-1], "median": v[len(v) // 2],
            "p90": v[int(0.9 * len(v))],
            "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--zero-gamma", action="store_true")
    ap.add_argument("--after-step", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("torch.cuda.is_available() is false; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    layers = networks.resnet50(batch=args.batch)
    arrs = T.init_params(layers, SEED, zero_gamma=args.zero_gamma)
    rng = np.random.default_rng(SEED + 1)
    images = torch.from_numpy(rng.standard_normal(
        (args.batch, 224, 224, 3), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, args.batch)).to(dev)

    def net(impl, dtype, weights):
        return T.Network(layers, T.params_from_numpy(weights, dev),
                         impl=impl, gemm_dtype=dtype)
    if args.after_step:
        first = net(T.PLAIN, torch.float32, arrs)
        T.train_step(first, T.make_optimizer(first), images, labels)
        arrs = {k: p.detach().cpu().numpy()
                for k, p in first.params().items()}
    decisions = {}
    base_loss, base = T.loss_and_grads(net(T.PLAIN, torch.float32, arrs),
                                       images, labels, decisions)
    base = {k: g.clone() for k, g in base.items()}
    out = {"batch": args.batch, "noise": args.noise,
           "zero_gamma": args.zero_gamma, "after_step": args.after_step,
           "device": str(dev), "loss": float(base_loss),
           "zero_grads": sum(float(g.norm()) == 0 for g in base.values()),
           "grads": len(base)}
    noisy = noisy_plain(
        args.noise, torch.Generator(device=dev).manual_seed(SEED))
    for name, impl, dtype in (("noise", noisy, torch.float32),
                              ("bf16", T.PLAIN, torch.bfloat16)):
        for pin in (True, False):
            loss, grads = T.loss_and_grads(net(impl, dtype, arrs), images,
                                           labels, decisions, pin)
            out[f"{name} {'pinned' if pin else 'free'}"] = summary(
                float(loss), float(base_loss), T.relative_errors(grads, base))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
