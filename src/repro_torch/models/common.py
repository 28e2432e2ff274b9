"""Model-stack foundations of the port: config, parameter declaration.

``ModelConfig`` is the port's own copy of the JAX package's
(``models/common.py``): the same fields and defaults, except that
``dtype`` defaults to ``torch.bfloat16``.  Parameters are declared once
as ``ParamDef`` trees (shape + logical axes + initializer), nested dicts
with the JAX package's keys; the same tree materializes to
  * initialized tensors           (``init_params``)
  * ``TensorSpec``s               (``abstract_params``)
  * a count of parameters         (``param_count``)

Sharding is not ported: ``rules`` stays in the signatures and must be
``None`` (``check_rules``); ``shard`` is then the identity.  The logical
axes of a ``ParamDef`` are kept for the day it is.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Sharding rules (not ported)
# ---------------------------------------------------------------------------

Rules = Dict[str, Any]   # logical axis -> mesh axis (str | tuple | None)


def check_rules(rules: Optional[Rules]) -> None:
    """Raise unless ``rules`` is ``None``: the port runs on one device."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules are not ported: pass rules=None (ROADMAP "
            "Queue 1 item 9, the JAX package's models/common.py:116-207)")


def shard(x: torch.Tensor, rules: Optional[Rules], *axes: Optional[str]):
    """The identity; ``rules`` must be ``None`` (``check_rules``)."""
    check_rules(rules)
    return x


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier for 'normal'

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef: shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and type, without its storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of nested dicts, keys in sorted
    order (the order in which ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def init_params(generator: torch.Generator, defs,
                dtype=torch.bfloat16) -> Dict:
    """Tensors for a ``ParamDef`` tree on ``generator``'s device: normal
    leaves drawn in float32 with std ``scale / sqrt(fan_in)``, ``fan_in =
    shape[-2]`` (``shape[-1]`` for a vector), then cast to ``dtype``.  A
    leaf stacked over layers (leading axis ``"layers"``) is drawn one
    layer at a time: drawn whole, gemma3-27b's (62, 5376, 21504) FFN
    weights would hold 4x their bfloat16 bytes in float32 at once, past
    an 80 GB card.  The draws differ from the JAX package's (another
    generator)."""
    device = generator.device

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(1, fan_in))
        out = torch.empty(d.shape, dtype=dtype, device=device)
        for part in (out.unbind(0) if d.axes[:1] == ("layers",)
                     else (out,)):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device,
                                   dtype=torch.float32).mul_(std))
        return out
    return tree_map(make, defs)


def abstract_params(defs, dtype=torch.bfloat16) -> Dict:
    return tree_map(lambda d: TensorSpec(tuple(d.shape), dtype), defs)


def param_count(defs) -> int:
    """Parameters a ``ParamDef`` tree declares."""
    leaves = []
    tree_map(leaves.append, defs)
    return sum(math.prod(d.shape) for d in leaves)
