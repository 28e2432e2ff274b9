"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 — RG-LRU + local attention in a (recurrent, recurrent,
attention) 2:1 pattern, window=2048, head_dim=256.
[arXiv:2402.19427; unverified]

38 = 12 full (rglru, rglru, attn) groups + 2 trailing recurrent layers
(handled by the grouped-scan remainder)."""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
        vocab_size=256000, head_dim=256,
        act="gelu",
        window=2048, attn_pattern=("local",),
        block_pattern=("rglru", "rglru", "attn"),
        rnn_width=4096, conv_width=4,
        tie_embeddings=True,
    )
