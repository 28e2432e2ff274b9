"""mamba2-130m [ssm] — 24L d_model=768, attention-free (d_ff=0),
vocab=50280, ssm_state=128 — SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
        vocab_size=50280,
        block_pattern=("mamba2",),
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
        tie_embeddings=True,
    )
