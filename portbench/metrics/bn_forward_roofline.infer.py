"""bn_forward_roofline.infer: batch norm's forward kernel: least time by the roofline over event-timed device time; read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("bn_forward",)) if r["kind"] == "infer" else None
