"""Entry points of the port's model stack: ``serve`` (prefill and batched
greedy decode) and ``train`` (the train step and loop)."""
