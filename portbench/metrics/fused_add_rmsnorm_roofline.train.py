"""fused_add_rmsnorm_roofline.train: the fused add and RMSNorm kernel: least time by the roofline over event-timed device time; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("fused_add_rmsnorm",)) if r["kind"] == "train" else None
