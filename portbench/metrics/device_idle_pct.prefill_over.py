"""device_idle_pct.prefill_over: 1 - the union of device intervals over the traced window; read in the
above-capacity prefill cell's traced runs, moves prefill_tokens_per_s."""
from portbench.readings import idle_pct


def read(r):
    return idle_pct(r) if r["kind"] == "prefill" else None
