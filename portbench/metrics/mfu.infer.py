"""mfu.infer: model operations a second (the benchmark's own count over the shapes) over the chip's peak in the configuration's type (989 TFLOP/s bfloat16, 67 float32); read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import mfu


def read(r):
    return mfu(r) if r["kind"] == "infer" else None
