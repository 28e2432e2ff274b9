"""Plain PyTorch versions of the JAX package's kernel oracles.

One function for each oracle of ``repro.kernels.ref``, with the same
arithmetic in the same order: they are what a kernel wrapper runs for a
tensor on the CPU, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card.  Each kernel module re-exports its own.

On the card, ``matmul_ref`` in float32 must run without TF32
(``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default), or
it keeps only about three decimal digits.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_heads: int, n_kv: int, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B*H, S, D); k, v: (B*KV, S, D)."""
    bh, s, d = q.shape
    group = n_heads // n_kv
    b = bh // n_heads
    qh = q.reshape(b, n_heads, s, d)
    # each KV head repeated for its group of query heads: an expanded view
    # whose backward sums the group with a plain reduction, the same bits
    # every run (an index-add, as repeat_interleave may take, need not be)
    kh = k.reshape(b, n_kv, 1, s, d).expand(b, n_kv, group, s, d).reshape(
        b, n_heads, s, d)
    vh = v.reshape(b, n_kv, 1, s, d).expand(b, n_kv, group, s, d).reshape(
        b, n_heads, s, d)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float()
    logits = logits / math.sqrt(d)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    logits = torch.where(ok, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vh)
    return out.reshape(bh, s, d)


def fused_add_rmsnorm_ref(x: torch.Tensor, resid: torch.Tensor,
                          scale: torch.Tensor, eps: float = 1e-6):
    s = x.float() + resid.float()
    var = (s * s).mean(-1, keepdim=True)
    y = s * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype), s.to(x.dtype)


def bn_forward_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5):
    """Two-pass variance, as the JAX oracle; the kernel computes
    ``E[x^2] - mu^2`` as the Pallas kernel does."""
    xf = x.float()
    mu = xf.mean(0)
    var = xf.var(0, correction=0)
    psi = torch.rsqrt(var + eps)
    y = (xf - mu) * psi * gamma.float() + beta.float()
    return y.to(x.dtype), mu, psi


def bn_backward_ref(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                    mu: torch.Tensor, psi: torch.Tensor):
    n = x.shape[0]
    xf = x.float()
    dyf = dy.float()
    xhat = (xf - mu) * psi                         # Eq. 25
    dgamma = (dyf * xhat).sum(0)                   # Eq. 26
    dbeta = dyf.sum(0)                             # Eq. 27
    dx = (gamma.float() * psi / n) * (
        n * dyf - dgamma * xhat - dbeta)           # Eq. 28
    return dx.to(x.dtype), dgamma, dbeta
