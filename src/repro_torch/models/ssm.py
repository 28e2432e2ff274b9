"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) mixer.

The port of the JAX package's ``models/ssm.py``.  Training and prefill
path: chunked SSD — within-chunk quadratic (attention-like) term plus an
inter-chunk linear recurrence over the (B, H, P, N) float32 state, a
Python loop over the chunks where the JAX package has ``lax.scan``.
Decode path: the single-step recurrence over the cached state.

The in and out projections (``u @ w_in``, ``y @ w_out``) go through
``impl.matmul`` (``layers.linear``); the chunk einsums, the depthwise
causal conv and the gated norm stay plain PyTorch, as the JAX package
leaves them to XLA.  The float32 upcasts, the pad to a multiple of the
chunk and the state's float32 type are the reference's.

A cache entry (``state``: ``{'ssm': (B, H, P, N), 'conv': (B, W-1, C)}``,
both float32) is updated in place and returned.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig, ParamDef, Rules, shard
from .layers import linear


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state


def ssm_defs(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict:
    la = ("layers",) * len(lead)
    d = cfg.d_model
    di, h, n = ssm_dims(cfg)
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": ParamDef(lead + (d, 2 * di + 2 * n + h),
                         la + ("embed", "rnn")),
        "conv_w": ParamDef(lead + (cfg.conv_width, di + 2 * n),
                           la + ("conv", "rnn"), init="normal", scale=1.0),
        "a_log": ParamDef(lead + (h,), la + ("ssm_heads",), init="zeros"),
        "dt_bias": ParamDef(lead + (h,), la + ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef(lead + (h,), la + ("ssm_heads",), init="ones"),
        "norm_scale": ParamDef(lead + (di,), la + ("rnn",), init="ones"),
        "w_out": ParamDef(lead + (di, d), la + ("rnn", "embed")),
    }


def _split(cfg: ModelConfig, proj: torch.Tensor):
    di, h, n = ssm_dims(cfg)
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    bb = proj[..., 2 * di:2 * di + n]
    cc = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, x, bb, cc, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width W. x: (B,S,C), w: (W,C).
    Returns (y, new_state) with state = last W-1 inputs (in x's type)."""
    wlen = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, wlen - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(wlen))
    new_state = xp[:, -(wlen - 1):, :] if wlen > 1 else None
    return F.silu(y), new_state


def _gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    xf = (x * F.silu(z)).float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


def ssd_chunked(xh, dt, a_log, bb, cc, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xh: (B,S,H,P); dt: (B,S,H) post-softplus; a_log: (H,) (A = -exp(a_log));
    bb, cc: (B,S,N) (single group, broadcast over heads).
    Returns y: (B,S,H,P) float32 and the final state (B,H,P,N) float32.
    """
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
    t = xh.shape[1]
    a = -torch.exp(a_log.float())                             # (H,)
    # per-step log decay: (B, T, H)
    la = dt.float() * a
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xh.device)
             if init_state is None else init_state.float())
    ys = []
    for c0 in range(0, t, chunk):
        xk, dtk = xh[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        lak = la[:, c0:c0 + chunk]
        bk = bb[:, c0:c0 + chunk].float()
        ck = cc[:, c0:c0 + chunk].float()
        cum = torch.cumsum(lak, dim=1)                        # (B,L,H)
        # intra-chunk "attention": M[i,j] = exp(cum_i - cum_j) * (i >= j),
        # the exponent masked before the exp: above the diagonal cum_i -
        # cum_j > 0 passes float32's exp range (88.7) within a chunk of
        # 256 steps of dt ~ 0.7 (mamba2-130m at the reference's init),
        # where exp's gradient, 0 * inf, would be NaN.  The same values
        # as the JAX package's jnp.where(causal, jnp.exp(diff), 0.0),
        # whose gradient is NaN there.
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B,L,L,H)
        m = torch.exp(torch.where(causal, diff, float("-inf")))
        g = torch.einsum("bln,bmn->blm", ck, bk)              # (B,L,L)
        w = m * g[..., None]                                  # (B,L,L,H)
        xdt = xk.float() * dtk[..., None].float()
        y_intra = torch.einsum("blmh,bmhp->blhp", w, xdt)
        # inter-chunk: contribution of the incoming state
        y_state = torch.einsum("bln,blh,bhpn->blhp", ck, torch.exp(cum),
                               state)
        # state update
        tail = cum[:, -1:, :] - cum                           # (B,L,H)
        sx = torch.einsum("bln,blh,blhp->bhpn", bk,
                          torch.exp(tail) * dtk.float(), xk.float())
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + sx
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state


def apply_ssm(cfg: ModelConfig, p: Dict, u: torch.Tensor,
              rules: Optional[Rules],
              state: Optional[Dict] = None,
              chunk: int = 256, impl=ops
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """u: (B,S,d). state (decode): {'ssm': (B,H,P,N), 'conv': (B,W-1,C)},
    updated in place and returned."""
    b, s, _ = u.shape
    di, h, n = ssm_dims(cfg)
    proj = linear(impl, u, p["w_in"])
    z, x, bb, cc, dt = _split(cfg, proj)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xbc = torch.cat([x, bb, cc], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], conv_state)
    x, bb, cc = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    xh = x.reshape(b, s, h, cfg.ssm_head_dim)
    xh = shard(xh, rules, "batch", "seq", "ssm_heads", None)

    init = None if state is None else state["ssm"]
    if s == 1 and state is not None:
        # single-step recurrence (decode)
        a = -torch.exp(p["a_log"].float())
        dt1 = dt[:, 0]                                        # (B,H)
        decay = torch.exp(dt1 * a)                            # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xh[:, 0].float(),
                           bb[:, 0].float())
        final = init * decay[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cc[:, 0].float(), final)[:, None]
    else:
        y, final = ssd_chunked(xh, dt, p["a_log"], bb, cc, chunk, init)
    y = y + xh.float() * p["d_skip"].float()[:, None]
    y = y.reshape(b, s, di).to(u.dtype)
    y = _gated_rmsnorm(p["norm_scale"], y, z)
    out = linear(impl, y, p["w_out"])
    if state is not None:
        state["ssm"].copy_(final)
        state["conv"].copy_(new_conv)
    return shard(out, rules, "batch", "seq", "act_embed"), state


def init_ssm_state(cfg: ModelConfig, n_layers: int, batch: int,
                   device="cuda") -> Dict:
    di, h, n = ssm_dims(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, h, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1,
                             di + 2 * n), dtype=torch.float32,
                            device=device),
    }
