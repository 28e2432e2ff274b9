"""nonconv_device_pct.train: the share of device time outside the convolution GEMMs, from the profiler: the paper's non-convolution share; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import nonconv_pct


def read(r):
    return nonconv_pct(r) if r["kind"] == "train" else None
