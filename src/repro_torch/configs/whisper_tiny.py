"""whisper-tiny [audio] — enc-dec, conv frontend stubbed.
4L enc + 4L dec, d_model=384, 6H (kv=6), d_ff=1536, vocab=51865.
[arXiv:2212.04356; unverified]

Whisper uses learned positions (no rope), LayerNorm, GELU; the real model
caps decoder positions at 448 — decode shapes beyond that are exercised
structurally (the launch layer resizes the learned-position table), noted
in DESIGN.md.
"""
from ..models.common import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
        vocab_size=51865,
        norm_type="layernorm", act="gelu",
        rope_fraction=0.0, learned_pos=448,
        encoder_layers=4, encoder_seq=1500,
        tie_embeddings=True,
    )
