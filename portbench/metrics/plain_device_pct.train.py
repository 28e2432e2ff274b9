"""plain_device_pct.train: the share of device time in kernels the port did not launch (im2col and its backward, casts, rotary embeddings, the attention backward, the optimizer), from the profiler; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import plain_pct


def read(r):
    return plain_pct(r) if r["kind"] == "train" else None
