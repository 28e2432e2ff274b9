"""mfu.prefill_over: model operations a second (the benchmark's own count over the shapes) over the chip's peak in the configuration's type (989 TFLOP/s bfloat16, 67 float32); read in the
above-capacity prefill cell's traced runs, moves prefill_tokens_per_s."""
from portbench.readings import mfu


def read(r):
    return mfu(r) if r["kind"] == "prefill" else None
