"""AdamW, SGD with momentum, learning-rate schedules and global-norm
clipping: the port of the JAX package's ``repro/optim/optimizers.py``
(``cosine_schedule`` :22, ``constant_schedule``, ``global_norm``,
``clip_by_global_norm`` :49, ``AdamW`` :61 and ``SGDM`` :123), with the
same arithmetic in the same order.

A pytree of parameters becomes a tree of nested dicts of tensors, walked
in sorted key order as ``jax.tree_util`` walks a dict.  As in the JAX
package the update is functional: it returns new tensors and leaves its
inputs as they are (run it under ``torch.no_grad()`` when the parameters
require gradients).  The step count and the learning rate are 0-dim
tensors on the CPU (int32 and float32), which PyTorch applies as scalars
to tensors on any device.  ``state_specs`` gives the state's
``PartitionSpec``s from the parameters' (``models.common.param_specs``):
each moment laid out as its parameter, the step replicated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models.common import PartitionSpec

Tensors = Dict[str, Any]      # nested dicts of tensors

__all__ = ["cosine_schedule", "constant_schedule", "global_norm",
           "clip_by_global_norm", "AdamW", "SGDM"]


def _leaves(tree: Tensors) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree_util``'s order (sorted keys,
    depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _map(fn, tree: Tensors, *rest: Tensors):
    """``fn`` on the leaves of ``tree`` and the matching leaves of
    ``rest``, as a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to
    ``min_frac * base_lr`` at ``total``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Clipping
# ---------------------------------------------------------------------------

def global_norm(tree: Tensors) -> torch.Tensor:
    """The float32 norm of every tensor of ``tree`` taken together."""
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: Tensors,
                        max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """``tree`` scaled so that its global norm is at most ``max_norm``,
    each tensor in its own type, and the norm before scaling."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    """Adam with decoupled weight decay after global-norm clipping: the
    moments in ``mv_dtype`` (float32 by default; bfloat16 halves their
    memory), the bias corrections and the update in float32, each
    parameter back in its own type."""
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mv_dtype: torch.dtype = torch.float32

    def init(self, params: Tensors) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.mv_dtype, device=p.device)
        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads: Tensors, state: dict, params: Tensors):
        """``(new_params, new_state, {"lr", "grad_norm"})``."""
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        step = state["step"] + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p.float()
            return (m_new.to(self.mv_dtype), v_new.to(self.mv_dtype),
                    (p.float() - lr * delta).to(p.dtype))

        out = _map(upd, grads, state["m"], state["v"], params)
        new_m, new_v, new_p = (_map(lambda o, i=i: o[i], out)
                               for i in range(3))
        return new_p, {"m": new_m, "v": new_v, "step": step}, \
            {"lr": lr, "grad_norm": gnorm}

    def state_specs(self, pspecs: Dict) -> dict:
        """Optimizer-state PartitionSpecs mirroring the param specs."""
        return {"m": pspecs, "v": pspecs, "step": PartitionSpec()}


@dataclass(frozen=True)
class SGDM:
    """SGD with momentum: ``m = momentum * m + g`` in float32, then
    ``p = p - lr * m`` in float32 and back to p's type."""
    schedule: Callable
    momentum: float = 0.9
    clip_norm: float = 0.0

    def init(self, params: Tensors) -> dict:
        return {"mom": {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads: Tensors, state: dict, params: Tensors):
        """``(new_params, new_state, {"lr", "grad_norm"})``."""
        gnorm = global_norm(grads)
        if self.clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        step = state["step"] + 1
        lr = self.schedule(step)
        new_m, new_p = {}, {}
        for k in sorted(params):
            p = params[k]
            m = self.momentum * state["mom"][k] + grads[k].float()
            new_m[k] = m
            new_p[k] = (p.float() - lr * m).to(p.dtype)
        return new_p, {"mom": new_m, "step": step}, \
            {"lr": lr, "grad_norm": gnorm}

    def state_specs(self, pspecs: Dict) -> dict:
        return {"mom": pspecs, "step": PartitionSpec()}
