"""Shared neural layers: norms, MLPs, rotary embeddings, embedding/head.

The port of the JAX package's ``models/layers.py``, function for function.
Every product of activations with a weight goes through ``impl.matmul``
(``kernels.ops`` by default, whose wrapper runs the GEMM kernel on the
card and its plain version on the CPU) on 2-D contiguous operands
(``linear``).  Norms, rotary embeddings, the embedding gather and the
activations are plain PyTorch.

On ``DTensor``s (the partitioned route, ``kernels.ops.partitioned``):
``linear`` hands the placed activation to the partitioned ``matmul``;
the lookup on a vocab-split table, the cross-entropy and the greedy
argmax over vocab-split logits run on the local shards with a reduction
of one or two values a row across the split (``_embed_placed``,
``VocabParallelCE``, ``greedy``), where sharding propagation would
gather the vocabulary; the gated MLP's activation and product run on
the ``DTensor``s as PyTorch propagates them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import (ModelConfig, ParamDef, Rules, is_placed, on_shards,
                     shard, shard_offset)


def linear(impl, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., k) @ w (k, n)`` through ``impl.matmul`` on the 2-D
    contiguous view of ``x``; a ``DTensor`` ``x`` goes whole to the
    partitioned ``impl.matmul`` (``kernels.ops.partitioned``), which
    flattens each local shard."""
    if is_placed(x):
        return impl.matmul(x, w)
    lead = x.shape[:-1]
    y = impl.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, d: int, lead: Tuple[int, ...] = ()) -> Dict:
    lead_axes = ("layers",) * len(lead)
    out = {"scale": ParamDef(lead + (d,), lead_axes + (None,), init="ones")}
    if cfg.norm_type == "layernorm":
        out["bias"] = ParamDef(lead + (d,), lead_axes + (None,), init="zeros")
    return out


def apply_norm(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm over the last (head_dim) axis (qk-norm)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict:
    la = ("layers",) * len(lead)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamDef(lead + (d, f), la + ("embed", "ff")),
        "wg": ParamDef(lead + (d, f), la + ("embed", "ff")),
        "wo": ParamDef(lead + (f, d), la + ("ff", "embed")),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def apply_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              rules: Optional[Rules], impl=ops) -> torch.Tensor:
    h = _act(cfg, linear(impl, x, p["wg"])) * linear(impl, x, p["wi"])
    h = shard(h, rules, "batch", "seq", "act_ff")
    return linear(impl, h, p["wo"])


# ---------------------------------------------------------------------------
# Rotary embeddings (partial-fraction support)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    # positions: (B, S) -> angles (B, S, 1, half), broadcast over heads
    ang = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> Dict:
    out = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                               ("embed", "vocab"))
    return out


def embed_tokens(p: Dict, tokens: torch.Tensor, rules: Optional[Rules],
                 dtype) -> torch.Tensor:
    # F.embedding, not indexing: its backward on the card sorts the
    # tokens and sums each one's rows in order (the same bits every run)
    table = p["embedding"]
    if is_placed(table):
        x = _embed_placed(table, tokens, dtype)
    else:
        x = F.embedding(tokens, table).to(dtype)
    return shard(x, rules, "batch", "seq", "act_embed")


def _embed_placed(table, tokens, dtype):
    """The lookup on a placed (vocab, d) table: gathered on its ``embed``
    split (FSDP), each rank looks up the tokens of its own vocab rows
    and zeros the rest, so the output is ``Partial`` where the vocab is
    split (where it is whole, the plain lookup)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tab_pl, tok_pl, out_pl = [], [], []
    for i, p in enumerate(table.placements):
        vocab = isinstance(p, Shard) and p.dim == 0
        tab_pl.append(p if vocab else Replicate())
        tok = Replicate() if vocab else tokens.placements[i]
        tok_pl.append(tok)
        out_pl.append(Partial() if vocab else tok)
    first, count = shard_offset(mesh, tab_pl, 0, table.shape[0])
    split = count < table.shape[0]

    def fn(tok, tab):
        if not split:
            return (F.embedding(tok, tab).to(dtype),)
        inside = (tok >= first) & (tok < first + count)
        x = F.embedding(torch.where(inside, tok - first, 0), tab)
        return (x.masked_fill(~inside[..., None], 0).to(dtype),)
    return on_shards(fn, mesh, [tok_pl, tab_pl], [out_pl], tokens,
                     table)[0]


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(t, op, group)
    return out.wait() if hasattr(out, "wait") else out


def _vocab_split(logits):
    """``(groups, first)``: the process groups of the mesh dimensions
    that split ``logits``' last (vocab) dimension (one of a single rank
    splits nothing), and the first vocab index of this rank's shard."""
    from torch.distributed.tensor import Shard
    mesh, last = logits.device_mesh, logits.ndim - 1
    split = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1]
    first, _ = shard_offset(mesh, logits.placements, last,
                            logits.shape[-1])
    return [mesh.get_group(i) for i in split], first


def _whole_vocab(logits) -> tuple:
    """``logits``' placements with its vocab split made whole: the
    layout of what is reduced over the vocabulary."""
    from torch.distributed.tensor import Replicate, Shard
    last = logits.ndim - 1
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                 else p for p in logits.placements)


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                         targets[..., None]).squeeze(-1)


class VocabParallelCE(torch.autograd.Function):
    """Cross-entropy of logits whose vocab is split over ``groups``, each
    rank holding columns ``first ..``: the log-sum-exp and the target's
    logit are reduced across the groups (``all_reduce`` of one value a
    row), never the logits; the backward is local (softmax less the
    one-hot)."""

    @staticmethod
    def forward(ctx, logits, targets, first, groups):
        n = logits.shape[-1]
        m = logits.detach().amax(-1, keepdim=True)
        for g in groups:
            m = _all_reduce(m, "max", g)
        p = torch.exp(logits - m)
        total = p.sum(-1, keepdim=True)
        inside = (targets >= first) & (targets < first + n)
        idx = torch.where(inside, targets - first, 0)
        picked = torch.gather(logits, -1, idx[..., None]).squeeze(-1)
        picked = torch.where(inside, picked, 0.0)
        for g in groups:
            total = _all_reduce(total, "sum", g)
            picked = _all_reduce(picked, "sum", g)
        p.div_(total)
        ctx.save_for_backward(p, idx, inside)
        return (m + torch.log(total)).squeeze(-1) - picked

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Each row's ``-log_softmax(logits)[target]`` (float32 logits).  On
    ``DTensor``s split on the vocab, ``VocabParallelCE`` on the local
    shards; where the vocab is whole, the plain formula on each rank's
    rows."""
    if not is_placed(logits):
        return _ce(logits, targets)
    groups, first = _vocab_split(logits)
    out = _whole_vocab(logits)

    def fn(lg, t):
        if groups:
            return (VocabParallelCE.apply(lg, t, first, groups),)
        return (_ce(lg, t),)
    return on_shards(fn, logits.device_mesh, [logits.placements, out],
                     [out], logits, targets)[0]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The int32 argmax of ``logits`` over its last (vocab) dimension,
    the first of equal maxima.  On ``DTensor``s split on the vocab, each
    rank's best value and index are gathered across the split (two
    values a row), never the logits."""
    if not is_placed(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    import torch.distributed._functional_collectives as funcol
    groups, first = _vocab_split(logits)
    out = _whole_vocab(logits)        # the vocab dimension reduced away

    def fn(lg):
        best, idx = lg.max(-1)
        idx = (idx + first).to(torch.int32)   # token ids, as gathered
        for g in groups:
            vals = funcol.all_gather_tensor(best[None], 0, g)
            idxs = funcol.all_gather_tensor(idx[None], 0, g)
            best = vals.amax(0)
            idx = torch.where(vals == best, idxs,
                              torch.iinfo(idxs.dtype).max).amin(0)
        return (idx,)
    return on_shards(fn, logits.device_mesh, None, [out], logits)[0]


def lm_logits(p: Dict, x: torch.Tensor, rules: Optional[Rules], impl=ops,
              head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float32 logits of ``x @ head``.  ``head``: the (d, vocab) weight
    as a contiguous tensor; by default ``p["head"]``, or for tied
    embeddings a contiguous copy of ``p["embedding"].T`` made here (a
    model makes it once: ``Model.head``)."""
    if head is None:
        head = p.get("head")
        if head is None:
            head = p["embedding"].t().contiguous()
    logits = linear(impl, x, head).float()
    return shard(logits, rules, "batch", "seq", "vocab")
