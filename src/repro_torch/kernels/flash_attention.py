"""Forward attention with an online softmax, causal and sliding-window
masks and grouped-query heads: q (B*H, S, D), k and v (B*KV, S, D), out
(B*H, S, D) in q's type.

On CUDA tensors it launches the hand-written kernel
``csrc/flash_attention.cu`` (the port of the JAX package's Pallas
``flash_attention_pallas``; the source says how it is laid out and what
bounds it), for head_dim 16, 32, 64 or 128.  On CPU tensors it runs
``flash_attention_ref``, the plain version.  Both mask keys at or past S,
as the oracle does (the Pallas kernel, without ``causal``, lets its zero
padding into the softmax when S is not a multiple of its key block).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._dispatch import (DTYPE_CODE, call, device_kind, library,
                        positive_int, same_dtype)
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS"]

SOURCE = "flash_attention.cu"
_LAUNCH = "flash_attention_launch"
_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_void_p)
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations


def _check_shapes(q, k, v, n_heads: int, n_kv: int, window: int) -> None:
    positive_int("flash_attention", n_heads=n_heads, n_kv=n_kv)
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            k.shape[1:] != q.shape[1:]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match (B*H, S, D) and (B*KV, S, D)")
    if n_heads % n_kv or q.shape[0] % n_heads or \
            k.shape[0] != q.shape[0] // n_heads * n_kv:
        raise ValueError(f"flash_attention: {q.shape[0]} query and "
                         f"{k.shape[0]} key heads do not fit n_heads "
                         f"{n_heads}, n_kv {n_kv}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention: window must be an int >= 0, "
                         f"got {window!r}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_heads: int, n_kv: int, causal: bool = True,
                    window: int = 0, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Attention of ``q`` over ``k``, ``v``; ``window > 0`` keeps keys
    with ``k_pos > q_pos - window``.

    ``bq`` and ``bk`` were the Pallas kernel's VMEM tiles.  The CUDA
    kernel is compiled for one tile, 64 queries x 64 keys, and
    every positive ``bq`` and ``bk`` (the default 512 too) runs it; the
    result differs from another tile's only in the order of the float32
    sums."""
    kind = device_kind("flash_attention", {"q": q, "k": k, "v": v})
    dtype = same_dtype("flash_attention", {"q": q, "k": k, "v": v})
    positive_int("flash_attention", bq=bq, bk=bk)
    _check_shapes(q, k, v, n_heads, n_kv, window)
    if kind == "cpu":
        return flash_attention_ref(q, k, v, n_heads, n_kv, causal, window)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not compiled; "
                         f"the kernel has {HEAD_DIMS}")
    if bh > 65535 or s >= 2 ** 31:
        raise ValueError(f"flash_attention: {bh} heads or {s} positions "
                         f"exceed the grid")
    lib = library(SOURCE, _LAUNCH, _ARGTYPES)
    call(lib, _LAUNCH, q.device, DTYPE_CODE[dtype], q.data_ptr(),
         k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d, n_heads, n_kv,
         int(bool(causal)), window, 1.0 / math.sqrt(d))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
