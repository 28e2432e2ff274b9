#!/usr/bin/env python3
"""How far the JAX package's own model moves when its weights move by a
float32 rounding's worth: the floor below which the port cannot be held
to it.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_noise_floor.py \
        [--noise 1e-7] [--draws 3] [ARCH ...]

For each configuration (``reduced``, float32, the weights and tokens of
``tests/test_torch_decode.py``: numpy, seed 0 and 1), the JAX ``Model``'s
forward logits and ``Model.loss`` gradients are taken at the weights and
at the weights times ``1 + noise * N(0, 1)`` (``--draws`` draws, seed 7).
Printed as one JSON object per configuration: for each draw the largest
absolute logit difference and the worst leaf's relative Frobenius
gradient difference, with that leaf's name.  The port's tests
(``test_torch_decode.py``, ``test_torch_train.py``) hold it to the JAX
model within limits at or above these readings for the badly
conditioned configurations.  Runs on the CPU, a few seconds a
configuration.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
# (it imports JAX and the JAX package: it lives with the tests, not with
# the port's scripts, which import neither)

from repro.configs import get_config, reduced  # noqa: E402
from repro.models.transformer import Model  # noqa: E402
from test_torch_decode import inputs, numpy_params  # noqa: E402


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def floor(arch: str, noise: float, draws: int) -> dict:
    cfg = reduced(get_config(arch)).replace(dtype=jnp.float32, remat=False)
    model = Model(cfg)
    p = numpy_params(cfg)
    data = {k: jnp.asarray(v) for k, v in inputs(cfg).items()}

    def logits(q):
        return np.asarray(model.forward(
            q, data["tokens"], frames=data.get("frames"),
            patches=data.get("patches"))[0], np.float64)
    grad = jax.jit(jax.grad(lambda q: model.loss(q, data)[0]))
    base = jax.tree_util.tree_map(jnp.asarray, p)
    want_logits, want_grads = logits(base), dict(leaves(grad(base)))
    rng = np.random.default_rng(7)
    out = []
    for _ in range(draws):
        moved = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a * (1 + noise * rng.standard_normal(
                a.shape).astype(np.float32))), p)
        errs = {name: float(np.linalg.norm(g - want_grads[name])
                            / max(np.linalg.norm(want_grads[name]), 1e-30))
                for name, g in leaves(grad(moved))}
        worst = max(errs, key=errs.get)
        out.append({"logits_max_abs": float(np.abs(
            logits(moved) - want_logits).max()),
            "grad_worst_rel": errs[worst], "grad_worst_leaf": worst})
    return {"arch": arch, "noise": noise, "draws": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*",
                    default=["recurrentgemma-9b",
                             "llama4-maverick-400b-a17b"])
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args(argv)
    for arch in args.archs:
        print(json.dumps(floor(arch, args.noise, args.draws)))


if __name__ == "__main__":
    main()
