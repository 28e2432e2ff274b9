"""Public wrappers of the port's kernels, with the JAX package's signatures
(``repro.kernels.ops``) less ``interpret``, and its layouts: ``(m, k) @
(k, n)``; q (B*H, S, D) and k/v (B*KV, S, D); rows x d; (N_eff, C).

Each runs its hand-written CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors; any other device, mixed devices, a type
other than float32 or bfloat16, or a non-contiguous input raises.

The block arguments were the Pallas kernels' VMEM tiles.  On the card:

* ``matmul``: ``bm``/``bn``/``bk`` name one of the tiles ``matmul.cu`` is
  compiled for (``core.gpu_model.MATMUL_TILES``), else ``ValueError``; 0
  in any of them asks the port's tile model
  (``core.gpu_model.select_matmul_block``), as the JAX wrapper asks its
  TPU model.  A tile larger than the GEMM is masked at the edge, which
  gives what Pallas computes with the block clamped to the dimension.
* ``flash_attention``: the kernel is compiled for one tile, 64 queries x
  64 keys; every positive ``bq`` and ``bk``, the default 512 included,
  runs it.
* ``fused_add_rmsnorm``: one CUDA block a row; every positive
  ``block_rows`` gives the same bits.
* ``bn_forward``: ``block_rows`` x ``block_c``, clamped to the tensor,
  is the tile of the statistics pass (``block_c`` at most 1024).

A result depends on the tile only through the order of float32 sums.
"""
from __future__ import annotations

import torch

from ..core.gpu_model import MATMUL_TILES, select_matmul_block
from . import bn as _bn
from . import flash_attention as _fa
from . import fused_addnorm as _an
from . import matmul as _mm
from .bn import bn_forward
from .flash_attention import flash_attention
from .fused_addnorm import fused_add_rmsnorm

__all__ = ["matmul", "flash_attention", "fused_add_rmsnorm", "bn_forward",
           "launch_counters"]


def matmul(a: torch.Tensor, b: torch.Tensor, bm: int = 0, bn: int = 0,
           bk: int = 0) -> torch.Tensor:
    if not (bm and bn and bk) and a.dim() == 2 and b.dim() == 2:
        m, k = a.shape
        n = b.shape[1]
        if 0 in (m, n, k):
            # degenerate GEMM: nothing is launched, so any compiled tile
            # serves (the JAX wrapper passes 1, 1, 1 for the same reason)
            bm, bn, bk = MATMUL_TILES[0]
        else:
            size = a.element_size()      # C takes A's type
            blk = select_matmul_block(m, n, k, bytes_in=size,
                                      bytes_out=size)
            bm, bn, bk = blk.bm, blk.bn, blk.bk
    return _mm.matmul(a, b, bm, bn, bk)


def launch_counters() -> dict:
    """Each kernel's wrapper function, whose ``launches`` attribute counts
    its kernel launches, by kernel name (``matmul``'s counter is on the
    kernel module's wrapper, which this module's ``matmul`` calls)."""
    return {"matmul": _mm.matmul, "fused_add_rmsnorm": _an.fused_add_rmsnorm,
            "bn_forward": _bn.bn_forward,
            "flash_attention": _fa.flash_attention}
