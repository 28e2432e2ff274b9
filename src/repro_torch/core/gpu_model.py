"""SimDIT's GEMM tile model instantiated for one NVIDIA H100 (SXM).

The counterpart of the GEMM half of the JAX package's TPU model
(``select_matmul_block`` and its cost, written there for the v5e's VMEM
and MXU): the paper's tile-based DRAM-access and stall model (Secs.
IV-B..D) applied to the loop nest of ``C[m,n] = A[m,k] @ B[k,n]``, here
used to pick the tile of the port's GEMM kernel
(``repro_torch/kernels/csrc/matmul.cu``).

What changes for the card:

* the on-chip buffer is a thread block's shared memory (232,448 bytes)
  instead of VMEM; the kernel holds one A tile and one B tile there
  (single-buffered) and its f32 accumulators in registers;
* the 132 streaming multiprocessors run tiles in parallel, so the
  output tiles are spread over the SMs in waves, each SM with its share of
  the 3.35 TB/s and of the peak rate (989 TFLOP/s for bf16 on the tensor
  cores, 67 TFLOP/s for f32 on the CUDA cores: the kernel's f32 path uses
  no TF32);
* the candidates are exactly the tiles ``matmul.cu`` is compiled for.

The roofline terms of a whole step wait for the port of the JAX
package's roofline module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# ---- H100 SXM constants (NVIDIA data sheet; dense rates at 700 W) --------
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, CUDA cores, no TF32
HBM_BW = 3.35e12                  # bytes/s
SM_COUNT = 132
SMEM_BYTES = 232_448              # shared memory one block can use

# The (bm, bn, bk) tiles matmul.cu instantiates, for f32 and bf16 alike:
# the tiles the JAX package's kernel tests name (64^3, and bm 32/64/128 x
# bn 64 x bk 32/128), and 128 x 128 x 32, which this model picks for the
# large GEMMs of the models the port drives.  ``chip_smoke.py`` times every
# one of them against the model's pick at those shapes;
# ``tests/test_torch_matmul.py`` holds this list equal to the source's.
MATMUL_TILES: Tuple[Tuple[int, int, int], ...] = (
    (32, 64, 32), (32, 64, 128), (64, 64, 32), (64, 64, 64), (64, 64, 128),
    (128, 64, 32), (128, 64, 128), (128, 128, 32))


@dataclass(frozen=True)
class MatmulBlock:
    bm: int
    bn: int
    bk: int
    est_s: float               # model-estimated time of the GEMM (Eq. 18)
    hbm_bytes: float           # model-estimated device-memory traffic


def smem_bytes(bm: int, bn: int, bk: int, bytes_in: int) -> int:
    """Shared memory of the A and B tiles of one block (Eq. 1's inner
    tiles; the kernel adds padding and an epilogue buffer)."""
    return (bm * bk + bk * bn) * bytes_in


def matmul_cost(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                bytes_in: int = 2, bytes_out: int = 2,
                smem: int = SMEM_BYTES) -> Optional[Tuple[float, float]]:
    """``(seconds, hbm_bytes)`` of ``C[m,n] = A[m,k] @ B[k,n]`` tiled
    ``(bm, bn, bk)``, or None if the tiles exceed shared memory.

      outer multipliers m_m = ceil(m/bm), m_n, m_k               (Eq. 1)
      B traffic: each B tile once per k step and output column    (Eq. 4)
      A traffic: each A tile for every (m, n, k) tile             (Eq. 7)
      C traffic: the psums stay in registers across the k sweep,
        so each output tile is written once                       (Eq. 9)
      per k step, one SM: max(compute, load) at its share of the
      card; the output tiles run in waves over the SMs            (Eq. 18)
    """
    if smem_bytes(bm, bn, bk, bytes_in) > smem:
        return None
    m_m, m_n, m_k = -(-m // bm), -(-n // bn), -(-k // bk)
    a_bytes = bm * bk * bytes_in * m_m * m_k * m_n
    b_bytes = bk * bn * bytes_in * m_k * m_n
    c_bytes = bm * bn * bytes_out * m_m * m_n
    hbm = a_bytes + b_bytes + c_bytes
    peak = PEAK_FLOPS_BF16 if bytes_in == 2 else PEAK_FLOPS_F32
    compute = 2.0 * bm * bn * bk / (peak / SM_COUNT)
    sm_bw = HBM_BW / SM_COUNT
    load = smem_bytes(bm, bn, bk, bytes_in) / sm_bw
    store = bm * bn * bytes_out / sm_bw
    waves = -(-(m_m * m_n) // SM_COUNT)
    return waves * (m_k * max(compute, load) + store), float(hbm)


def select_matmul_block(m: int, n: int, k: int, bytes_in: int = 2,
                        bytes_out: int = 2,
                        smem: int = SMEM_BYTES) -> MatmulBlock:
    """The compiled tile the model finds fastest for this GEMM (ties go to
    less traffic, then to the earlier tile of ``MATMUL_TILES``)."""
    if min(m, n, k) <= 0:
        raise ValueError(f"no tile for a degenerate GEMM ({m}, {n}, {k})")
    best: Optional[MatmulBlock] = None
    for bm, bn, bk in MATMUL_TILES:
        res = matmul_cost(m, n, k, bm, bn, bk, bytes_in, bytes_out, smem)
        if res is None:
            continue
        est, hbm = res
        if best is None or est < best.est_s or (
                est == best.est_s and hbm < best.hbm_bytes):
            best = MatmulBlock(bm, bn, bk, est, hbm)
    if best is None:
        raise ValueError(f"no compiled tile fits {smem} bytes of shared "
                         f"memory at {bytes_in} bytes an element")
    return best
