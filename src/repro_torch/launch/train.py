"""Training driver: the train step and a runnable single-device loop with
checkpointing, watchdog, and pipeline state.

The port of the JAX package's ``launch/train.py``.  ``make_train_step``
builds the step: ``Model.loss``, ``torch.autograd.grad`` over the
parameter tree, then ``opt.update``.  ``train_loop`` runs it on the
port's kernels through their autograd functions (``Model(cfg,
impl=kernels.ops.differentiable())``: the GEMMs forward and backward,
fused add+RMSNorm and flash attention forward), on the card unless
``device`` says otherwise; without CUDA it raises rather than fall back.
The parameters are a tree of leaf tensors that require gradients, the
stacked ``blk<i>`` leaves with their ``(groups,)`` axis as ``Model``
declares them; the step is eager (the JAX package jits and donates it).

``make_state_shardings`` lays the state out on a ``DeviceMesh`` by the
sharding rules: trees of ``(mesh, placements)`` that
``torch.distributed.tensor.distribute_tensor`` takes
(``models.common.place``); ``batch_shardings`` the batch.  On state so
placed, with ``Model(cfg, impl=kernels.ops.partitioned(impl, mesh,
rules))``, ``make_train_step`` is the partitioned step: the reference's
``jax.jit(make_train_step(...), in_shardings=...)``.

Run (reduced, on a CUDA card; ``--device cpu`` runs the kernels' plain
versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 20 --batch 8 --seq 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, reduced
from ..data.pipeline import PipelineState, TokenPipeline
from ..distributed.fault import Watchdog
from ..kernels import ops
from ..models.common import (PartitionSpec, Rules, is_placed, placements,
                              tree_map)
from ..models.frontends import synth_frontend_inputs
from ..models.transformer import Model
from ..optim.optimizers import AdamW, cosine_schedule


def leaves(tree) -> list:
    """The leaves of a tree of nested dicts, in sorted key order."""
    out = []
    tree_map(out.append, tree)
    return out


def trainable(tree) -> Dict:
    """Every leaf of ``tree`` made a leaf tensor that requires grad."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def make_train_step(model: Model, opt, rules: Optional[Rules]):
    """The step ``(state, batch) -> (state, metrics)``.  On state placed
    by ``make_state_shardings`` (with ``Model(cfg, impl=kernels.ops.
    partitioned(...))`` and the batch by ``batch_shardings``) each
    gradient is laid out as its parameter before the update: the ranks'
    partial sums of a replicated leaf are all-reduced there."""
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        loss, metrics = model.loss(params, batch, rules)
        grads = iter(torch.autograd.grad(loss, leaves(params)))
        grads = tree_map(lambda p: _laid_out_as(next(grads), p), params)
        with torch.no_grad():
            new_params, new_opt, om = opt.update(grads, state["opt"],
                                                 params)
        out_metrics = {"loss": loss.detach(),
                       **{k: v.detach() for k, v in metrics.items()}, **om}
        return {"params": trainable(new_params), "opt": new_opt}, \
            out_metrics

    return train_step


def _laid_out_as(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    if not is_placed(param) or tuple(grad.placements) == tuple(
            param.placements):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def batch_shardings(mesh, rules: Rules, specs: Dict) -> Dict:
    """``(mesh, placements)`` of each batch input: the batch axis by the
    rules, the rest whole."""
    def spec_for(name, sds):
        if name == "tokens":
            return PartitionSpec(rules.get("batch"), None)
        return PartitionSpec(rules.get("batch"), None, None)
    return {k: (mesh, placements(spec_for(k, v), mesh))
            for k, v in specs.items()}


def make_state_shardings(model: Model, opt, rules: Optional[Rules], mesh
                         ) -> Dict:
    """``{"params", "opt"}``: for every leaf of the state, ``(mesh,
    placements)`` under ``rules`` (``distribute_tensor(leaf, *pair)``
    places it), where the JAX package gives a ``NamedSharding``."""
    pspecs = model.specs(rules)
    ospecs = opt.state_specs(pspecs)

    def to_pair(pspec: PartitionSpec):
        return mesh, placements(pspec, mesh)

    return {"params": tree_map(to_pair, pspecs),
            "opt": tree_map(to_pair, ospecs)}


# ---------------------------------------------------------------------------
# Single-device training loop (example scale)
# ---------------------------------------------------------------------------

def train_loop(arch: str, steps: int = 20, batch: int = 8, seq: int = 64,
               use_reduced: bool = True, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 10, resume: bool = True,
               lr: float = 3e-3, seed: int = 0,
               stop_after: Optional[int] = None,
               log=print, device="cuda") -> Dict[str, Any]:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: no CUDA card; pass device='cpu' "
                           "to run the kernels' plain versions")
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    cfg = cfg.replace(dtype=torch.float32, remat=False)
    model = Model(cfg, impl=ops.differentiable())
    opt = AdamW(schedule=cosine_schedule(lr, warmup=max(2, steps // 10),
                                         total=steps))

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    params = trainable(model.init(
        torch.Generator(device=device).manual_seed(seed)))
    state = {"params": params, "opt": opt.init(params)}
    pstate = PipelineState()
    start_step = 0
    if mgr is not None and resume and mgr.latest_step() is not None:
        s = mgr.latest_step()
        state, extra = mgr.restore(s, state)
        state["params"] = trainable(state["params"])
        pstate = PipelineState.from_dict(extra["pipeline"])
        start_step = int(extra["train_step"])
        log(f"resumed from checkpoint step {s}")

    step_fn = make_train_step(model, opt, rules=None)
    extras = synth_frontend_inputs(cfg, batch, device=device)

    losses = []
    stalled = {"flag": False}
    wd = Watchdog(timeout_s=300.0,
                  on_stall=lambda idle: stalled.update(flag=True)).start()
    try:
        it = pipe.iter_from(pstate)
        end = steps if stop_after is None else min(steps, stop_after)
        for step in range(start_step, end):
            pstate, np_batch = next(it)
            batch_dev = {"tokens": torch.from_numpy(np_batch["tokens"])
                         .to(device), **extras}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_dev)
            loss = float(metrics["loss"])
            losses.append(loss)
            wd.beat()
            log(f"step {step:4d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state,
                         {"pipeline": pstate.to_dict(),
                          "train_step": step + 1})
    finally:
        wd.stop()
    if mgr is not None:
        mgr.save(end, state, {"pipeline": pstate.to_dict(),
                              "train_step": end})
    return {"losses": losses, "state": state, "stalled": stalled["flag"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train_loop(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, use_reduced=args.reduced,
                     ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device)
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f})")


if __name__ == "__main__":
    main()
