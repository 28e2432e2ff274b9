"""Gradient compression for a cross-pod all-reduce: int8 block quantization
with error feedback, the port of the JAX package's
``repro/optim/compression.py`` (``quantize`` :29, ``dequantize`` :44,
``compressed_psum`` :50, ``init_error`` :74).

Each tensor (plus the error carried from the last step) is cut into
blocks of ``BLOCK`` values, the last padded with zeros; a block keeps
int8 values and one float32 scale, its largest magnitude over 127.  The
arithmetic is the reference's, in its order, with IEEE division on the
CPU and the card alike; ``torch.round`` rounds half to even as
``jnp.round`` does, so the int8 values, the scales and the new errors
equal the JAX package's bit for bit, on either device.

``compressed_psum`` all-reduces a tree of nested dicts of tensors
(``models.common.tree_map``) over a ``torch.distributed`` group with
three ``all_reduce`` calls a leaf where the JAX package ``psum``s over a
mesh axis: the int8 values summed as int32, the scales, and a count of
the participants (the reference's ``psum`` of ones, kept in place of the
group's size).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.common import tree_map

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def quantize(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + err -> (int8 values (blocks, BLOCK), float32 scales per block,
    new error)."""
    comp = g.float() + err
    flat, _ = _pad_to_block(comp)
    blocks = flat.reshape(-1, BLOCK)
    # a divisor on the tensors' device: PyTorch's CUDA division by a
    # Python number multiplies by its rounded reciprocal instead
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) \
        / torch.full((), 127.0, device=blocks.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(flat.shape)[:comp.numel()] \
        .reshape(comp.shape)
    new_err = comp - deq
    return q, scale[:, 0], new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, size: int
               ) -> torch.Tensor:
    deq = (q.float() * scale[:, None]).reshape(-1)[:size]
    return deq.reshape(shape)


def compressed_psum(tree, err_tree, group=None) -> Tuple[Dict, Dict]:
    """All-reduce ``tree`` over ``group`` (the default group if None) in
    int8 with error feedback.

    Returns (reduced float32 tree, new error tree).  The int8 values (as
    int32 partial sums) and float32 scales are what cross the
    interconnect; the values are dequantized with the participants' mean
    scale, then multiplied by their count (sum semantics, like a plain
    all-reduce)."""
    import torch.distributed as dist

    def one(g: torch.Tensor, err: torch.Tensor):
        q, scale, new_err = quantize(g, err)
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, group=group)
        # scales differ per participant -> reduce the dequantized mean scale
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        n = torch.ones((), dtype=torch.float32, device=g.device)
        dist.all_reduce(n, group=group)
        avg_scale = scale_sum / n
        deq = (q_sum.float() / n * avg_scale[:, None]).reshape(-1)[
            :g.numel()].reshape(g.shape)
        return deq * n, new_err

    def walk(g, err):
        # sorted keys: every rank reduces the leaves in the same order
        if isinstance(g, dict):
            return {k: walk(g[k], err[k]) for k in sorted(g)}
        return one(g, err)

    outs = walk(tree, err_tree)
    return tree_map(lambda o: o[0], outs), tree_map(lambda o: o[1], outs)


def init_error(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
