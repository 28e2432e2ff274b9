"""Shared neural layers: norms, MLPs, rotary embeddings, embedding/head.

The port of the JAX package's ``models/layers.py``, function for function.
Every product of activations with a weight goes through ``impl.matmul``
(``kernels.ops`` by default, whose wrapper runs the GEMM kernel on the
card and its plain version on the CPU) on 2-D contiguous operands
(``linear``).  Norms, rotary embeddings, the embedding gather and the
activations are plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig, ParamDef, Rules, shard


def linear(impl, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., k) @ w (k, n)`` through ``impl.matmul`` on the 2-D
    contiguous view of ``x``."""
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
    x = F.embedding(tokens, p["embedding"]).to(dtype)
    return shard(x, rules, "batch", "seq", "act_embed")


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
