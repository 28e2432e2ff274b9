"""Architecture config registry: ``get_config(arch_id)`` plus the reduced
(smoke-test) transform.  One module per assigned architecture.

The port's own copy of the JAX package's ``configs``: the same ten
configurations, each a ``repro_torch.models.common.ModelConfig``."""
from __future__ import annotations

from typing import Dict, List

from ..models.common import ModelConfig

ARCHS: List[str] = [
    "whisper-tiny",
    "qwen3-0.6b",
    "gemma3-27b",
    "stablelm-1.6b",
    "smollm-360m",
    "pixtral-12b",
    "mamba2-130m",
    "llama4-maverick-400b-a17b",
    "granite-moe-1b-a400m",
    "recurrentgemma-9b",
]

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "qwen3-0.6b": "qwen3_0_6b",
    "gemma3-27b": "gemma3_27b",
    "stablelm-1.6b": "stablelm_1_6b",
    "smollm-360m": "smollm_360m",
    "pixtral-12b": "pixtral_12b",
    "mamba2-130m": "mamba2_130m",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    import importlib
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.get_config()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test scale, preserving the family's
    structure (pattern length, GQA ratio, MoE top-k, qk-norm, etc.)."""
    plen = len(cfg.pattern)
    # >=2 full groups, plus a remainder layer when the pattern is grouped so
    # the unrolled-remainder path is exercised (recurrentgemma: 38 = 12*3+2)
    n_layers = 2 * plen + (1 if plen > 1 else 0)
    kv_ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    heads = 4
    kv = max(1, heads // kv_ratio)
    if cfg.n_kv_heads == cfg.n_heads:
        kv = heads
    return cfg.replace(
        n_layers=n_layers,
        d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=503,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_block=64,
        ssm_state=16 if cfg.ssm_state else 0, ssm_head_dim=16,
        rnn_width=64 if cfg.rnn_width else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=24 if cfg.encoder_seq else 0,
        learned_pos=96 if cfg.learned_pos else 0,
        n_patches=8 if cfg.n_patches else 0,
        window=8 if cfg.window else 0,
        attn_block=32, dense_attn_max_seq=64,
    )
