"""Model-stack foundations of the port: config, parameter declaration,
sharding rules.

``ModelConfig`` is the port's own copy of the JAX package's
(``models/common.py``): the same fields and defaults, except that
``dtype`` defaults to ``torch.bfloat16``.  Parameters are declared once
as ``ParamDef`` trees (shape + logical axes + initializer), nested dicts
with the JAX package's keys; the same tree materializes to
  * initialized tensors           (``init_params``)
  * ``TensorSpec``s               (``abstract_params``)
  * a count of parameters         (``param_count``)
  * ``PartitionSpec``s             (``param_specs``)

Logical axis names are mapped to mesh axes through a ``Rules`` dict, the
JAX package's own (``PROD_RULES``: FSDP over ``data`` x tensor
parallelism over ``model``).  A ``PartitionSpec`` is the port's own: a
tuple with one entry a tensor dimension (a mesh axis name, a tuple of
them, or ``None``), resolved as the JAX package resolves it (a dimension
not divisible by its axes' product stays whole; a mesh axis shards one
dimension at most, the first).  ``placements`` turns one into the
``torch.distributed.tensor`` placements of a ``DeviceMesh``, and
``shard`` redistributes a ``DTensor`` to the spec of its logical axes
(a plain tensor, which is what runs on one card, passes unchanged).
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
# Sharding rules
# ---------------------------------------------------------------------------

Rules = Dict[str, Any]   # logical axis -> mesh axis (str | tuple | None)

# Production default: FSDP('data') x TP('model'); batch over data (+pod).
PROD_RULES: Rules = {
    # parameter axes
    "embed": "data",          # FSDP axis of 2D weights
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "vocab": "model",
    "experts": "data",
    "expert_ff": "model",
    "rnn": "model",
    "ssm_heads": "model",
    "conv": None,
    "layers": None,
    "pos": None,
    # activation axes
    "batch": "data",
    "seq": None,
    # the residual stream between layers, sequence-sharded over the
    # tensor axis (Megatron-style sequence parallelism)
    "seq_resid": "model",
    "act_embed": None,
    "act_heads": "model",
    "act_ff": "model",
    "cache_seq": None,
    "cache_heads": "model",
}


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names
    (the dimension split over their product, the first major), or
    ``None`` (whole); ``PartitionSpec()`` replicates every dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def multipod(rules: Rules) -> Rules:
    """Extend rules with a leading 'pod' pure-DP axis."""
    r = dict(rules)
    r["batch"] = ("pod", "data")
    return r


def with_axis_sizes(rules: Rules, mesh) -> Rules:
    """Attach the axis sizes of ``mesh`` (a ``DeviceMesh``) so that spec
    resolution can apply the divisibility fallback (a dim not divisible
    by its mesh axis product is left unsharded, e.g. 5 KV heads on a
    16-way tensor axis)."""
    r = dict(rules)
    r["_axis_sizes"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return r


def _axis_product(rules: Rules, axis) -> int:
    sizes = rules.get("_axis_sizes")
    if not sizes or axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes.get(a, 1) for a in axis)
    return sizes.get(axis, 1)


def _resolve(rules: Rules, axis, dim: Optional[int]):
    """Logical axis -> mesh axis, dropped if ``dim`` is not divisible."""
    phys = rules.get(axis) if axis else None
    if phys is None:
        return None
    if dim is not None and "_axis_sizes" in rules:
        if dim % _axis_product(rules, phys) != 0:
            return None
    return phys


def spec(rules: Optional[Rules], *axes: Optional[str],
         shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    if rules is None:
        return P()
    dims = shape if shape is not None else (None,) * len(axes)
    out, used = [], set()
    for a, d in zip(axes, dims):
        phys = _resolve(rules, a, d)
        # a mesh axis may appear at most once per spec: first dim wins
        flat = phys if isinstance(phys, tuple) else (phys,)
        if phys is not None and any(f in used for f in flat):
            phys = None
        if phys is not None:
            used.update(flat)
        out.append(phys)
    return P(*out)


def placements(pspec: PartitionSpec, mesh) -> list:
    """The ``torch.distributed.tensor`` placements of ``pspec`` on
    ``mesh``, one per mesh dimension in mesh order: ``Shard(d)`` where
    tensor dimension ``d`` names that mesh axis (alone or in a tuple),
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    dim_of = {}
    for d, entry in enumerate(pspec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"placements: {pspec} names mesh axis "
                                 f"{axis!r}, not one of {names}")
            dim_of[axis] = d
    return [Shard(dim_of[n]) if n in dim_of else Replicate() for n in names]


def shard(x: torch.Tensor, rules: Optional[Rules], *axes: Optional[str]):
    """``x`` laid out by its logical axes: a ``DTensor`` redistributed to
    ``spec(rules, *axes, shape=x.shape)`` on its mesh; ``x`` itself
    without rules or for a plain tensor."""
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(
        spec(rules, *axes, shape=tuple(x.shape)), mesh))


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
    an 80 GB card.  A float32 leaf is drawn in place (``normal_`` is
    what ``randn`` runs: the same bits), so that llama4's (128, 5120,
    8192) float32 expert stacks are not held twice.  The draws differ
    from the JAX package's (another generator)."""
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
            if dtype == torch.float32:
                part.normal_(generator=generator).mul_(std)
            else:
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


def param_specs(defs, rules: Optional[Rules]) -> Dict:
    """The ``PartitionSpec`` of every leaf of a ``ParamDef`` tree."""
    def to_spec(d: ParamDef) -> PartitionSpec:
        if rules is None:
            return P()
        return spec(rules, *d.axes, shape=d.shape)
    return tree_map(to_spec, defs)
