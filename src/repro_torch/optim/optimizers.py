"""SGD with momentum, learning-rate schedules and global-norm clipping:
the port of what a training step needs from the JAX package's
``repro/optim/optimizers.py`` (``cosine_schedule`` :22,
``constant_schedule``, ``global_norm``, ``clip_by_global_norm`` :49 and
``SGDM`` :123), with the same arithmetic in the same order.

A pytree of parameters becomes a dict of tensors, walked in sorted key
order as ``jax.tree_util`` walks a dict.  As in the JAX package the
update is functional: it returns new tensors and leaves its inputs as
they are.  The step count and the learning rate are 0-dim tensors on
the CPU (int32 and float32), which PyTorch applies as scalars to tensors
on any device.  ``AdamW`` and the sharding rules (``state_specs``) are
not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

__all__ = ["cosine_schedule", "constant_schedule", "global_norm",
           "clip_by_global_norm", "SGDM"]


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
    for key in sorted(tree):
        total = total + torch.sum(torch.square(tree[key].float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: Tensors,
                        max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """``tree`` scaled so that its global norm is at most ``max_norm``,
    each tensor in its own type, and the norm before scaling."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

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
