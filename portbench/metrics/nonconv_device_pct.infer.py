"""nonconv_device_pct.infer: the share of device time outside the convolution GEMMs, from the profiler: the paper's non-convolution share; read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import nonconv_pct


def read(r):
    return nonconv_pct(r) if r["kind"] == "infer" else None
