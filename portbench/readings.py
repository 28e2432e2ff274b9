"""The arithmetic of the per-layer metrics, from a traced run's reading
(``kinds/*.py``: ``Context.traced``'s reduction of the trace, the
recorded kernel calls, ``units`` (the steps, batches or prefills traced)
and ``model_flops_per_s`` from the untraced window).  Each metric's own
reader (``portbench/metrics/<name>.py``) picks one of these and the kind
it reads; a share with nothing under it is None, never 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

from . import roofline as RL


def mfu(r: dict) -> Optional[float]:
    """Model operations a second over the peak of the configuration's
    type (%)."""
    return 100.0 * r["model_flops_per_s"] / RL.PEAK_FLOPS[r["precision"]]


def _device_total(r: dict) -> float:
    return sum(r["group_s"].values())


def plain_pct(r: dict) -> Optional[float]:
    """Device time in kernels the port did not launch (%)."""
    total = _device_total(r)
    return 100.0 * r["group_s"].get("plain", 0.0) / total if total else None


def nonconv_pct(r: dict) -> Optional[float]:
    """Device time outside the GEMMs (every GEMM of a CNN is a
    convolution or the classifier), (%)."""
    total = _device_total(r)
    if not total or "matmul" not in r["group_s"]:
        return None
    return 100.0 * (1.0 - r["group_s"]["matmul"] / total)


def launches(r: dict) -> Optional[float]:
    """Device records (kernels, copies, sets) a step, batch or prefill."""
    return r["records"] / r["units"] if r["units"] else None


def idle_pct(r: dict) -> Optional[float]:
    if r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])


def roofline_pct(r: dict, kernels: Sequence[str]) -> Optional[float]:
    """Σ least time / Σ event-timed device time of ``kernels``' calls
    (%), or None where none was called."""
    calls = [(*RL.work(k, shapes, dtype, causal), dtype, seconds)
             for k, shapes, dtype, causal, seconds in r["calls"]
             if k in kernels]
    if not calls:
        return None
    return RL.share(calls)[0]
