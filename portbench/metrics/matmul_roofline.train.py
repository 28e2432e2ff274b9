"""matmul_roofline.train: the GEMM kernel's calls: least time by the roofline over their event-timed device time; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("matmul",)) if r["kind"] == "train" else None
