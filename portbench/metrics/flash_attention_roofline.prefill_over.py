"""flash_attention_roofline.prefill_over: the attention kernel (causal operations): least time by the roofline over event-timed device time; read in the
above-capacity prefill cell's traced runs, moves prefill_tokens_per_s."""
from portbench.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("flash_attention",)) if r["kind"] == "prefill" else None
