"""matmul_roofline.prefill_over: the GEMM kernel's calls: least time by the roofline over their event-timed device time; read in the
above-capacity prefill cell's traced runs, moves prefill_tokens_per_s."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("matmul",)) if r["kind"] == "prefill" else None
