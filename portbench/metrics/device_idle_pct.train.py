"""device_idle_pct.train: 1 - the union of device intervals over the traced window; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import idle_pct


def read(r):
    return idle_pct(r) if r["kind"] == "train" else None
