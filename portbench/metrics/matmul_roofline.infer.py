"""matmul_roofline.infer: the GEMM kernel's calls: least time by the roofline over their event-timed device time; read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("matmul",)) if r["kind"] == "infer" else None
