"""launches_per_step.infer: the device records (kernels, copies, sets) the profiler saw per traced batch; read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import launches


def read(r):
    return launches(r) if r["kind"] == "infer" else None
