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

The partitioned route's helpers (``kernels.ops.partitioned``): ``layout``
(logical axes and a shape to ``local_map`` placements), ``on_shards``
(a function on the local shards, with the placements of its inputs'
gradients), ``shard_offset`` and ``kv_heads_read`` (what a rank holds and
what its query heads read), ``summed`` (``Partial`` placements made
whole), ``placed_zeros`` and ``place`` (``DTensor``s
made from local shards, or distributed from whole tensors).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels._dispatch import is_placed


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
    if rules is None or not is_placed(x):
        return x
    return x.redistribute(x.device_mesh,
                          layout(rules, x.device_mesh, *axes, shape=x.shape))


# ---------------------------------------------------------------------------
# The partitioned route: tensors placed on a DeviceMesh
# ---------------------------------------------------------------------------

def layout(rules: Rules, mesh, *axes: Optional[str],
           shape: Tuple[int, ...]) -> tuple:
    """The placements on ``mesh`` of a tensor of ``shape`` whose
    dimensions have the logical ``axes``: ``placements(spec(...))``, as
    ``local_map`` takes them."""
    return tuple(placements(spec(rules, *axes, shape=tuple(shape)), mesh))


def _grad_layout(pl, outs) -> Optional[tuple]:
    """The placements of an input's gradient: ``Partial`` on a mesh
    dimension where the input is replicated and an output is not (each
    rank's part of the output then reads the whole input, so the ranks'
    gradients add up), else the input's own."""
    from torch.distributed.tensor import Partial, Replicate
    if pl is None:
        return None
    return tuple(Partial() if isinstance(p, Replicate) and any(
        not isinstance(o[i], Replicate) for o in outs) else p
        for i, p in enumerate(pl))


def on_shards(fn, mesh, in_pl, out_pl, *args, feeds=None):
    """``fn(*args)`` on the local shards of ``args``, through
    ``torch.distributed.tensor.experimental.local_map``: each ``DTensor``
    argument redistributed to its entry of ``in_pl`` (``None``: as it is
    laid out), the tensors ``fn`` returns (a tuple) made ``DTensor``s
    with ``out_pl``'s placements.  The gradient of an input is laid out
    by ``_grad_layout`` over the outputs it feeds (``feeds``: for each
    argument, the indices of the outputs it reaches; all by default).
    Non-tensor arguments pass unchanged and take ``None``; so does a
    plain tensor, which every rank must then hold whole."""
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten
    flat, _ = tree_flatten(args)
    if in_pl is None:
        in_pl = [None] * len(flat)
    in_pl = [tuple(x.placements) if p is None and is_placed(x) else
             (None if p is None else tuple(p)) for x, p in zip(flat, in_pl,
                                                            strict=True)]
    outs = [tuple(o) for o in out_pl]
    feeds = feeds or [range(len(outs))] * len(flat)
    grads = tuple(_grad_layout(p, [outs[j] for j in f])
                  for p, f in zip(in_pl, feeds, strict=True))
    return local_map(fn, out_placements=tuple(outs),
                     in_placements=tuple(in_pl), in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def shard_offset(mesh, pl, dim: int, size: int) -> Tuple[int, int]:
    """``(first, count)``: the global indices along tensor dimension
    ``dim`` (of ``size``) of this rank's shard under placements ``pl``
    (even shards; mesh dimensions in mesh order, the first major)."""
    from torch.distributed.tensor import Shard
    first, count = 0, size
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            count //= mesh.size(i)
            first += mesh.get_local_rank(i) * count
    return first, count


def summed(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` with its ``Partial`` placements summed (made whole
    there), as a ``local_map`` region that is not linear in it must read
    it."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


def kv_heads_read(q_heads: Tuple[int, int], kv_heads: Tuple[int, int],
                  groups: int):
    """What a rank's query heads ``(first, count)`` read of its KV heads
    ``(first, count)`` (query head ``i`` reads KV head ``i // groups``):
    ``None`` where they read all of them, in order, else the local KV
    head indices, one for each group of query heads (a list, one per
    query head where a group straddles the shard)."""
    (q0, hq), (k0, hk) = q_heads, kv_heads
    if hq % groups == 0:
        want = list(range(q0 // groups, q0 // groups + hq // groups))
    elif groups % hq == 0:
        want = [q0 // groups]
    else:
        want = [(q0 + i) // groups for i in range(hq)]
    local = [j - k0 for j in want]
    if not all(0 <= j < hk for j in local):
        raise ValueError(f"kv_heads_read: query heads {q_heads} read KV "
                         f"heads {want}, outside this rank's {kv_heads}")
    return None if local == list(range(hk)) else local


def placed_zeros(shape: Tuple[int, ...], dtype, mesh, pl, device,
                 fill=None):
    """A ``DTensor`` of global ``shape`` laid out by ``pl`` on ``mesh``,
    made from its local shard alone (zeros, or ``fill(local_shape)``) on
    ``device``: a global tensor is never made."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    t = (torch.zeros(local, dtype=dtype, device=device) if fill is None
         else fill(tuple(local)))
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def place(tree, pairs):
    """Every leaf of ``tree`` distributed by the matching ``(mesh,
    placements)`` of ``pairs`` (``launch.train.make_state_shardings``):
    every rank passes the same whole tree and keeps its shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: place(tree[k], pairs[k]) for k in tree}
    mesh, pl = pairs
    return distribute_tensor(tree, mesh, pl, src_data_rank=None)


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
