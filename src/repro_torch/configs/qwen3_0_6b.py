"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA, head_dim=128 (Qwen3 uses an explicit 128-dim
head). [hf:Qwen/Qwen3-8B; hf]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
        vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6,
        tie_embeddings=True,
    )
