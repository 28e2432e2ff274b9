"""launches_per_step.train: the device records (kernels, copies, sets) the profiler saw per traced step; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import launches


def read(r):
    return launches(r) if r["kind"] == "train" else None
