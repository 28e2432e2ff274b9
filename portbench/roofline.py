"""The yardstick: the chip's peaks, and the operations and bytes that each
of the port's kernel calls needs, computed from its shapes.

Peaks are NVIDIA's published figures for one H100 SXM at its full 700 W
(dense, no sparsity): 989 TFLOP/s in bfloat16 on the tensor cores, 67
TFLOP/s in float32 outside them (the port's float32 kernels run on the
CUDA cores), 3.35 TB/s of HBM.  A call's least time is the larger of its
operations over the peak of its type and its bytes over HBM's rate; each
input is read once and each output written once, whatever a kernel reads
again.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT = {"bfloat16": 2, "float32": 4}


def work(kernel: str, shapes: Tuple[Tuple[int, ...], ...], dtype: str,
         causal: bool = True) -> Tuple[float, float]:
    """``(operations, bytes)`` of one call of ``kernel`` on inputs of
    ``shapes`` and element type ``dtype`` (the inputs' type; batch
    norm's statistics and parameters are float32)."""
    e = ELEMENT[dtype]
    if kernel == "matmul":
        (m, k), (_, n) = shapes[:2]
        return 2.0 * m * k * n, float(e * (m * k + k * n + m * n))
    if kernel == "bn_forward":
        n, c = shapes[0]
        # sums and squares, then (x - mu) * psi * gamma + beta
        return 5.0 * n * c, float(2 * e * n * c + 4 * 4 * c)
    if kernel == "bn_backward":
        n, c = shapes[0]
        # dgamma, dbeta sums, then dx (Algorithm 1)
        return 8.0 * n * c, float(3 * e * n * c + 4 * 5 * c)
    if kernel == "flash_attention":
        (bh, s, d), (bkv, _, _) = shapes[:2]
        # QK^T and PV over the keys each query reads
        pairs = s * (s + 1) / 2 if causal else s * s
        return 4.0 * bh * pairs * d, float(e * (2 * bh * s * d
                                                + 2 * bkv * s * d))
    if kernel == "fused_add_rmsnorm":
        r, d = shapes[0]
        return 5.0 * r * d, float(4 * e * r * d + 4 * d)
    raise ValueError(f"no work model for {kernel!r}")


def least_seconds(flops: float, nbytes: float, dtype: str
                  ) -> Tuple[float, str]:
    """The call's least time and what sets it, ``operations`` or
    ``bytes``."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(calls: Iterable[Tuple[float, float, str, float]]
          ) -> Tuple[float, str]:
    """Σ least time / Σ measured time (%) over ``(flops, bytes, dtype,
    measured seconds)`` calls, and the bound that gives most of the least
    time; ``(nan, "")`` for no calls."""
    least = measured = 0.0
    by: Dict[str, float] = {"operations": 0.0, "bytes": 0.0}
    for flops, nbytes, dtype, seconds in calls:
        t, what = least_seconds(flops, nbytes, dtype)
        least += t
        by[what] += t
        measured += seconds
    if measured <= 0:
        return float("nan"), ""
    return 100.0 * least / measured, max(by, key=by.get)
