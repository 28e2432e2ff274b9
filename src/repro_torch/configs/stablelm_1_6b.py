"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 — LayerNorm, partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
        vocab_size=100352,
        norm_type="layernorm", rope_fraction=0.25,
        tie_embeddings=False,
    )
