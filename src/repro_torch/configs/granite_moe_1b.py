"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
(per-expert), vocab=49155, MoE 32 experts top-8 every layer.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab_size=49155,
        n_experts=32, top_k=8,
        block_pattern=("attn+moe",),
        tie_embeddings=True,
    )
