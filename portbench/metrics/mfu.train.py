"""mfu.train: model operations a second (the benchmark's own count over the shapes) over the chip's peak in the configuration's type (989 TFLOP/s bfloat16, 67 float32); read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import mfu


def read(r):
    return mfu(r) if r["kind"] == "train" else None
