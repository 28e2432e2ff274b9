"""bn_forward_roofline.train: batch norm's forward kernel: least time by the roofline over event-timed device time; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("bn_forward",)) if r["kind"] == "train" else None
