"""plain_device_pct.infer: the share of device time in kernels the port did not launch (im2col and its backward, casts, rotary embeddings, the attention backward, the optimizer), from the profiler; read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import plain_pct


def read(r):
    return plain_pct(r) if r["kind"] == "infer" else None
