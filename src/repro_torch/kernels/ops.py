"""Public wrappers of the port's kernels, with the JAX package's signatures
(``repro.kernels.ops``) less ``interpret``, and its layouts: ``(m, k) @
(k, n)``; q (B*H, S, D) and k/v (B*KV, S, D); rows x d; (N_eff, C) for
both batch-norm kernels, the forward and Algorithm 1's backward.

Each runs its hand-written CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors; any other device, mixed devices, a type
other than float32 or bfloat16, or a non-contiguous input raises.

The block arguments were the Pallas kernels' VMEM tiles.  On the card:

* ``matmul``: ``bm``/``bn``/``bk`` name one of the tiles ``matmul.cu`` is
  compiled for (``core.gpu_model.compiled_tiles``: ``MATMUL_TILES``, and
  in float32 ``F32_TILES``), else ``ValueError``; 0
  in any of them asks the port's tile model
  (``core.gpu_model.select_matmul_block``), as the JAX wrapper asks its
  TPU model.  The model also picks the K split, for an explicit tile
  too; the route follows from shape, type, pointers and tile
  (``core.gpu_model.matmul_route``).  A tile larger than the GEMM is
  masked at the edge, which gives what Pallas computes with the block
  clamped to the dimension.
* ``flash_attention``: each route is compiled for one tile, 64 queries x
  64 keys; every positive ``bq`` and ``bk``, the default 512 included,
  runs it.
* ``fused_add_rmsnorm``: one CUDA block a row; every positive
  ``block_rows`` gives the same bits.
* ``bn_forward``, ``bn_backward``: ``block_rows`` and ``block_c`` are
  validated (positive, ``block_c`` at most 1024) and set nothing: each
  call is one persistent launch laid out by
  ``core.gpu_model.bn_layout`` from the shape, type and alignment, so its
  bits do not depend on them.

A GEMM's result depends on the tile and the split only through the order
of float32 sums.

``differentiable(impl)`` gives ``matmul``, ``fused_add_rmsnorm`` and
``flash_attention`` over ``impl`` (this module by default) as autograd
functions (``MatmulFn``, ``FusedAddRMSNormFn``, ``FlashAttentionFn``):
on the card a kernel writes into a fresh tensor that autograd cannot see
into, so a model that is to be differentiated (the trainer's) calls its
kernels through these; serving calls them directly.

``partitioned(impl, mesh, rules)`` gives the same members for
``DTensor``s laid out on ``mesh``: each runs ``differentiable(impl)``'s
autograd function on the local shards (``models.common.on_shards``, that
is ``local_map`` with ``redistribute_inputs=True``), its placements from
``rules``.  The wrappers above take plain tensors only: a ``DTensor``
that reaches one raises (``kernels/_dispatch.py``).
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import torch

from ..core.gpu_model import MATMUL_TILES, compiled_tiles, select_matmul_block
from . import bn as _bn
from . import flash_attention as _fa
from . import fused_addnorm as _an
from . import matmul as _mm
from .bn import bn_backward, bn_forward
from .flash_attention import flash_attention
from .fused_addnorm import fused_add_rmsnorm

__all__ = ["matmul", "flash_attention", "fused_add_rmsnorm", "bn_forward",
           "bn_backward", "launch_counters", "differentiable",
           "Partitioned", "partitioned"]


def matmul(a: torch.Tensor, b: torch.Tensor, bm: int = 0, bn: int = 0,
           bk: int = 0) -> torch.Tensor:
    splits = 1
    if a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0]:
        m, k = a.shape
        n = b.shape[1]
        explicit = bool(bm and bn and bk)
        if 0 in (m, n, k):
            # degenerate GEMM: nothing is launched, so any compiled tile
            # serves (the JAX wrapper passes 1, 1, 1 for the same reason)
            if not explicit:
                bm, bn, bk = MATMUL_TILES[0]
        elif not explicit or (bm, bn, bk) in compiled_tiles(
                a.element_size()):
            size = a.element_size()      # C takes A's type
            blk = select_matmul_block(
                m, n, k, bytes_in=size, bytes_out=size,
                aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                tile=(bm, bn, bk) if explicit else None)
            bm, bn, bk, splits = blk.bm, blk.bn, blk.bk, blk.splits
    return _mm.matmul(a, b, bm, bn, bk, splits=splits)


def launch_counters() -> dict:
    """Each kernel's wrapper function, whose ``launches`` attribute counts
    its kernel launches, by kernel name (``matmul``'s counter is on the
    kernel module's wrapper, which this module's ``matmul`` calls)."""
    return {"matmul": _mm.matmul, "fused_add_rmsnorm": _an.fused_add_rmsnorm,
            "bn_forward": _bn.bn_forward, "bn_backward": _bn.bn_backward,
            "flash_attention": _fa.flash_attention}


def differentiable(impl=None) -> SimpleNamespace:
    """``impl``'s ``matmul``, ``fused_add_rmsnorm`` and
    ``flash_attention`` (this module's by default) through their autograd
    functions, with the signatures a model calls them by; ``base`` is
    ``impl`` (``models/remat.py`` runs its products on it)."""
    impl = sys.modules[__name__] if impl is None else impl

    def fused_add_rmsnorm(x, resid, scale):
        return _an.FusedAddRMSNormFn.apply(x, resid, scale, impl)

    def flash_attention(q, k, v, n_heads, n_kv, causal=True, window=0):
        return _fa.FlashAttentionFn.apply(q, k, v, n_heads, n_kv, causal,
                                          window, impl)
    return SimpleNamespace(
        matmul=lambda a, b: _mm.MatmulFn.apply(a, b, impl),
        fused_add_rmsnorm=fused_add_rmsnorm, flash_attention=flash_attention,
        base=impl)


class Partitioned(SimpleNamespace):
    """``partitioned``'s namespace: ``matmul``, ``fused_add_rmsnorm``,
    ``flash_attention`` and ``base`` as ``differentiable`` gives them,
    on ``DTensor``s in the model's shapes; ``mesh``, ``rules``."""


def partitioned(impl, mesh, rules) -> Partitioned:
    """``impl``'s kernels (this module's for None) on the local shards
    of ``DTensor``s laid out on ``mesh`` by ``rules`` (sized to the mesh
    by ``with_axis_sizes`` here).

    * ``matmul(a, b)``: ``a`` (..., k), ``b`` a (k, n) weight.  On a mesh
      dimension that shards ``a``'s rows by the rules' ``batch``, the
      weight is gathered (FSDP) and the output's rows stay sharded; on any
      other, the weight's own placement decides: split on n (column
      parallel) -> ``a`` whole, the output split on its last dimension;
      split on k (row parallel) -> ``a`` split on its last dimension, the
      output ``Partial``; whole -> all whole.
    * ``fused_add_rmsnorm(x, resid, scale)``: (B, S, d) on the rows of
      the residual stream's shard, ``("batch", "seq_resid",
      "act_embed")``; returns ``(h, s)``, the sum ``s`` on the stream's
      layout and ``h`` gathered once to ``("batch", "seq", "act_embed")``,
      what the next products read.
    * ``flash_attention(q, k, v, n_heads, n_kv, causal, window)``: q (B, S,
      H, D), k and v (B, S, KV, D) as the model lays them out, each rank
      on its query heads and the KV heads those read
      (``models.common.kv_heads_read``: where the KV heads do not divide
      the mesh axis they are whole on every rank)."""
    import torch.distributed.tensor as dt
    from ..models.common import (kv_heads_read, layout, on_shards,
                                 shard_offset, with_axis_sizes)
    base = sys.modules[__name__] if impl is None else impl
    local = differentiable(base)
    if "_axis_sizes" not in rules:
        rules = with_axis_sizes(rules, mesh)

    def matmul(a, b, product=None):
        product = product or (lambda x, w: _mm.MatmulFn.apply(x, w, base))
        last = a.ndim - 1
        rows = layout(rules, mesh, "batch", *[None] * last, shape=a.shape)
        per_dim = []                  # (a, b, output) on each mesh dimension
        for row, w in zip(rows, b.placements):
            if isinstance(row, dt.Shard):                   # FSDP
                per_dim.append((row, dt.Replicate(), row))
            elif isinstance(w, dt.Shard) and w.dim == 1:    # column parallel
                per_dim.append((dt.Replicate(), w, dt.Shard(last)))
            elif isinstance(w, dt.Shard):                   # row parallel
                per_dim.append((dt.Shard(last), w, dt.Partial()))
            else:
                per_dim.append((dt.Replicate(),) * 3)
        a_pl, b_pl, out_pl = zip(*per_dim)

        def fn(x, w):
            y = product(x.reshape(-1, x.shape[-1]).contiguous(),
                        w.contiguous())
            return (y.reshape(*x.shape[:-1], w.shape[-1]),)
        return on_shards(fn, mesh, [a_pl, b_pl], [out_pl], a, b)[0]

    def fused_add_rmsnorm(x, resid, scale):
        if x.ndim != 3:
            raise ValueError(f"partitioned fused_add_rmsnorm takes the (B, "
                             f"S, d) stream, got {tuple(x.shape)}")
        stream = layout(rules, mesh, "batch", "seq_resid", "act_embed",
                        shape=x.shape)
        whole = (dt.Replicate(),) * mesh.ndim

        def fn(x, r, g):
            h, s = local.fused_add_rmsnorm(x.reshape(-1, x.shape[-1]),
                                           r.reshape(-1, r.shape[-1]), g)
            return h.reshape(x.shape), s.reshape(x.shape)
        h, s = on_shards(fn, mesh, [stream, stream, whole], [stream, stream],
                         x, resid, scale)
        return h.redistribute(mesh, layout(rules, mesh, "batch", "seq",
                                           "act_embed", shape=h.shape)), s

    def flash_attention(q, k, v, n_heads, n_kv, causal=True, window=0):
        read = kv_heads_read(shard_offset(mesh, q.placements, 2, n_heads),
                             shard_offset(mesh, k.placements, 2, n_kv),
                             n_heads // n_kv)

        def heads_first(t):
            b, s, h, d = t.shape
            return t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

        def fn(q, k, v):
            if read is not None:
                k, v = k[:, :, read], v[:, :, read]
            b, s, h, d = q.shape
            out = local.flash_attention(
                heads_first(q), heads_first(k), heads_first(v), h,
                k.shape[2], causal=causal, window=window)
            return (out.reshape(b, h, s, d).permute(0, 2, 1, 3),)
        return on_shards(fn, mesh, None, [q.placements], q, k, v)[0]

    return Partitioned(matmul=matmul, fused_add_rmsnorm=fused_add_rmsnorm,
                       flash_attention=flash_attention, base=base,
                       mesh=mesh, rules=rules)
