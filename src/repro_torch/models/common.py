"""Model-stack foundations of the port: the model configuration.

``ModelConfig`` is the port's own copy of the JAX package's
(``models/common.py``): the same fields and defaults, except that
``dtype`` defaults to ``torch.bfloat16``.  The cost-model lowering
(``models.frontends.lower_llm``) reads its shapes; the parameter
declarations and sharding rules beside it in the JAX package belong to
the model stack, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # norms / activations
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    qk_norm: bool = False
    # rotary
    rope_theta: float = 1e4
    rope_fraction: float = 1.0     # partial rotary (stablelm: 0.25)
    # attention pattern
    window: int = 0                # sliding-window size (0 = full attention)
    # per-layer pattern of window usage: 'local'/'global'; empty -> all global
    attn_pattern: Tuple[str, ...] = ()
    causal: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE on layers where (i % moe_every)==moe_offset
    moe_offset: int = 0
    shared_expert: bool = False
    moe_block: int = 1024          # token block size for dispatch
    moe_capacity: float = 1.25     # expert capacity factor (tokens dropped
                                   # beyond cap — standard capacity MoE)
    moe_dispatch: str = "onehot"   # onehot (GEMM dispatch) | scatter
    # mixer pattern: repeating tuple over layers; entries in
    # {'attn','mamba2','rglru'}
    block_pattern: Tuple[str, ...] = ("attn",)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # RG-LRU
    rnn_width: int = 0             # 0 -> d_model
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed encoder length (whisper: 1500)
    learned_pos: int = 0           # learned position table size (0 = rope)
    # vlm stub
    n_patches: int = 0
    # misc
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_block: int = 1024         # kv block for chunked attention
    dense_attn_max_seq: int = 4096  # use dense attention at/below this length
    ce_chunk: int = 0              # seq-chunked cross-entropy (0 = off):
                                   # only (B, chunk, V) logits materialize
    cache_dtype: Any = None        # KV-cache storage dtype (None = dtype);
                                   # torch.int8 enables quantized KV serving
    kv_quant_scale: float = 1 / 32.  # symmetric int8 KV quantization scale
    remat_policy: str = "full"     # full | save_dots (selective remat)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0
                and (i % self.moe_every) == self.moe_offset)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
