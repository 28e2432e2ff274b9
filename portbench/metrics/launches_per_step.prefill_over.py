"""launches_per_step.prefill_over: the device records (kernels, copies, sets) the profiler saw per traced prefill; read in the
above-capacity prefill cell's traced runs, moves prefill_tokens_per_s."""
from portbench.readings import launches


def read(r):
    return launches(r) if r["kind"] == "prefill" else None
