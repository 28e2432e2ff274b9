"""device_idle_pct.infer: 1 - the union of device intervals over the traced window; read in the
infer cells' traced runs, moves images_per_s."""
from portbench.readings import idle_pct


def read(r):
    return idle_pct(r) if r["kind"] == "infer" else None
