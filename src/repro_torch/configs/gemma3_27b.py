"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window schedule (window=1024),
qk-norm, head_dim=128, 128k-class context. [hf:google/gemma-3-1b-pt;
unverified]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
        vocab_size=262144, head_dim=128,
        qk_norm=True, act="gelu", rope_theta=1e6,
        window=1024,
        attn_pattern=("local", "local", "local", "local", "local", "global"),
        tie_embeddings=True,
    )
