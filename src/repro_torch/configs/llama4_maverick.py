"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (expert dim), vocab=202048, MoE 128 experts top-1 + shared
expert, alternating dense/MoE layers (Llama-4 interleave), head_dim=128,
early fusion (text backbone here; vision stub not in the assigned shape
set). [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048, head_dim=128, rope_theta=5e5,
        n_experts=128, top_k=1, shared_expert=True,
        block_pattern=("attn+moe", "attn"), moe_every=2,
        tie_embeddings=False,
    )
