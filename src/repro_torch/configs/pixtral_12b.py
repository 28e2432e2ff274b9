"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend STUBBED (precomputed patch embeddings,
early fusion) + mistral-nemo-style decoder, head_dim=128.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=131072, head_dim=128, rope_theta=1e6,
        n_patches=64,
        tie_embeddings=False,
    )
