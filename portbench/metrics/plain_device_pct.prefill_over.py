"""plain_device_pct.prefill_over: the share of device time in kernels the port did not launch (im2col and its backward, casts, rotary embeddings, the attention backward, the optimizer), from the profiler; read in the
above-capacity prefill cell's traced runs, moves prefill_tokens_per_s."""
from portbench.readings import plain_pct


def read(r):
    return plain_pct(r) if r["kind"] == "prefill" else None
