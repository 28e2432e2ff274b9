"""flash_attention_roofline.train: the attention kernel (causal operations): least time by the roofline over event-timed device time; read in the
train cells' traced runs, moves train_step_ms."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("flash_attention",)) if r["kind"] == "train" else None
