"""Cells of ``BENCHMARK.json`` cut to CPU size for the tests: the same
families, kinds and code, tiny widths, float32 products (so that a sound
run reads near 0 and a fault stands out)."""
from __future__ import annotations

from portbench import spec

CONFIGS = {
    "resnet50": dict(layers=[1, 1, 1, 1], widths=[4, 8, 8, 8], stem_width=8,
                     image_size=32, num_classes=10,
                     precision={"gemm": "float32", "batch_norm": "float32",
                                "weights": "float32"}),
    "smollm-360m": dict(hidden_size=64, intermediate_size=96,
                        num_hidden_layers=4, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=211,
                        dtype="float32"),
}
CONFIGS["smollm-360m-f32"] = CONFIGS["smollm-360m"]
MIXES = {"train": dict(batch=4, seq=16), "infer": dict(batch=4),
         "prefill": dict(lengths=[8, 12, 16], rate_per_s=160)}


def cell(name: str, own_precision: bool = False):
    """``name`` at CPU size, in float32 or (``own_precision``) in the
    configuration's own types."""
    c = spec.cell(name)
    kept = {k: c.config[k] for k in ("dtype", "precision") if k in c.config}
    c.config.update(CONFIGS[c.config["name"]])
    if own_precision:
        c.config.update(kept)
    c.mix.update({k: v for k, v in MIXES[c.mix["kind"]].items()
                  if k in c.mix})
    return c
