"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) mixer.

The port of the JAX package's ``models/ssm.py``.  Training and prefill
path: chunked SSD — within-chunk quadratic (attention-like) term plus an
inter-chunk linear recurrence over the (B, H, P, N) float32 state: the
terms that do not read the state for a group of chunks at once, the
state's update in a Python loop over the chunks where the JAX package
has ``lax.scan``.
Decode path: the single-step recurrence over the cached state.

The in and out projections (``u @ w_in``, ``y @ w_out``) go through
``impl.matmul`` (``layers.linear``); the chunk einsums, the depthwise
causal conv and the gated norm stay plain PyTorch, as the JAX package
leaves them to XLA.  The float32 upcasts, the pad to a multiple of the
chunk and the state's float32 type are the reference's.

A cache entry (``state``: ``{'ssm': (B, H, P, N), 'conv': (B, W-1, C)}``,
both float32) is updated in place and returned.

The partitioned route (``u`` a ``DTensor``, ``impl`` a
``kernels.ops.partitioned`` namespace), the reference's mixer under
``jax.jit(in_shardings=...)``: ``w_in`` packs z, x, B, C and dt in one
weight, split on ``model`` into equal pieces that do not line up with
the five parts (where its columns divide the axis at all), so its
column-parallel product is made whole on ``model`` as it enters
``_mix_placed``, one ``on_shards`` call: there every rank cuts the five
parts, runs the depthwise conv over every channel (``conv_w`` gathered
whole, 4 x (di + 2n) values; B and C, which every head reads, come out
whole, and the new ``conv`` state, whole on ``model`` as the cache
lays it out, is cut from the whole conv input with no collective), and
runs the chunk loop or the decode recurrence on its own heads
(``ssm_heads`` on ``model``; where they do not divide the axis, as
mamba2-130m's 24 do not divide 16, every rank runs them all).  The
gated norm's mean spans all of ``d_inner``: its sum of squares is summed
over the ranks that split the heads (``_AllSum``, whose backward sums
the ranks' gradients too), then divided, which the unpartitioned route
computes the same way.  The normed output is split on its last
dimension as the heads are, which is what ``w_out``'s row-parallel
product reads; its output stays ``Partial`` on ``model`` and reaches
the stream through the next norm (a reduce-scatter).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten

from ..kernels import ops
from .common import (ModelConfig, ParamDef, Rules, is_placed, on_shards,
                     shard_offset)
from .layers import linear
from .moe import _wait


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
                   z: torch.Tensor, width: Optional[int] = None,
                   total=None) -> torch.Tensor:
    """RMSNorm of ``x * silu(z)`` over ``width`` channels (the last
    dimension's by default), its mean taken as a sum of squares over
    ``width``; ``total`` (the partitioned route's) sums the rows' sums of
    squares over the ranks that split the last dimension."""
    xf = (x * F.silu(z)).float()
    ss = (xf ** 2).sum(-1, keepdim=True)
    if total is not None:
        ss = total(ss)
    y = xf * torch.rsqrt(ss / (width or x.shape[-1]) + 1e-6)
    return (y * scale.float()).to(x.dtype)


class _AllSum(torch.autograd.Function):
    """The sum of ``t`` over ``group`` (all-reduce), which each rank then
    reads for its own part of an output: the backward sums the ranks'
    gradients the same way."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_reduce(g.contiguous(), "sum",
                                       ctx.group)), None


# The bytes of one of ``ssd_chunked``'s (B, G, L, L, H) float32 terms for
# a group of G chunks: the chunks are taken in groups that fit it, so the
# transient memory stays bounded at any sequence length and a group's
# terms are a few batched ops.  1 GiB (256 MiB before): mamba2-130m's
# ``train_4k`` rows on one rank (16 x 4,096, 24 heads) take 10 chunks a
# group (2 before), in fewer and larger ops.
SSD_GROUP_BYTES = 1 << 30


def ssd_chunked(xh, dt, a_log, bb, cc, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xh: (B,S,H,P); dt: (B,S,H) post-softplus; a_log: (H,) (A = -exp(a_log));
    bb, cc: (B,S,N) (single group, broadcast over heads).
    Returns y: (B,S,H,P) float32 and the final state (B,H,P,N) float32.

    Each chunk's terms are the reference's ``chunk_fn``'s.  The chunks are
    taken in groups of ``SSD_GROUP_BYTES``: the terms that do not read the
    incoming state are computed for a whole group at once (a chunk axis
    ``c``), so that the loop over the group's chunks carries only the
    state's update, two element-wise ops a chunk.
    """
    b, s, h, p = xh.shape
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
    nc = xh.shape[1] // chunk
    group = max(1, SSD_GROUP_BYTES // (4 * b * chunk * chunk * h)) * chunk
    a = -torch.exp(a_log.float())                             # (H,)
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[:, :, None]
    state = (torch.zeros((b, h, p, bb.shape[-1]), dtype=torch.float32,
                         device=xh.device)
             if init_state is None else init_state.float())
    ys = []
    for t0 in range(0, nc * chunk, group):
        y, state = _ssd_group(xh[:, t0:t0 + group], dt[:, t0:t0 + group], a,
                              bb[:, t0:t0 + group], cc[:, t0:t0 + group],
                              chunk, causal, state)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y[:, :s], state


def _ssd_group(xh, dt, a, bb, cc, chunk: int, causal, state):
    """``ssd_chunked`` over whole chunks ``xh`` (B, C x L, H, P), ``dt``,
    ``bb``, ``cc`` from the incoming ``state``; ``a`` (H,) is -exp(a_log)
    and ``causal`` (L, L, 1) the mask i >= j.  Returns y (B, C x L, H, P)
    and the outgoing state."""
    b, t, h, p = xh.shape
    n = bb.shape[-1]
    nc = t // chunk
    # per-step log decay, (B, C, L, H)
    la = (dt.float() * a).reshape(b, nc, chunk, h)
    xk = xh.float().reshape(b, nc, chunk, h, p)
    dtk = dt.float().reshape(b, nc, chunk, h)
    bk = bb.float().reshape(b, nc, chunk, n)
    ck = cc.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(la, dim=2)                             # (B,C,L,H)
    # intra-chunk "attention": M[i,j] = exp(cum_i - cum_j) * (i >= j), the
    # exponent masked before the exp: above the diagonal cum_i - cum_j > 0
    # passes float32's exp range (88.7) within a chunk of 256 steps of dt
    # ~ 0.7 (mamba2-130m at the reference's init), where exp's gradient,
    # 0 * inf, would be NaN.  The same values as the JAX package's
    # jnp.where(causal, jnp.exp(diff), 0.0), whose gradient is NaN there.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,C,L,L,H)
    m = torch.exp(torch.where(causal, diff, float("-inf")))
    g = torch.einsum("bcln,bcmn->bclm", ck, bk)               # (B,C,L,L)
    w = m * g[..., None]                                      # (B,C,L,L,H)
    xdt = xk * dtk[..., None]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xdt)
    # each chunk's own contribution to the state it hands on
    tail = cum[:, :, -1:, :] - cum                            # (B,C,L,H)
    sx = torch.einsum("bcln,bclh,bclhp->bchpn", bk,
                      torch.exp(tail) * dtk, xk)
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]      # (B,C,H,1,1)
    incoming = []
    for c in range(nc):
        incoming.append(state)
        state = state * decay[:, c] + sx[:, c]
    # inter-chunk: the contribution of each chunk's incoming state
    y_state = torch.einsum("bcln,bclh,bchpn->bclhp", ck, torch.exp(cum),
                           torch.stack(incoming, 1))
    return (y_intra + y_state).reshape(b, t, h, p), state


def apply_ssm(cfg: ModelConfig, p: Dict, u: torch.Tensor,
              rules: Optional[Rules],
              state: Optional[Dict] = None,
              chunk: int = 256, impl=ops
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """u: (B,S,d). state (decode): {'ssm': (B,H,P,N), 'conv': (B,W-1,C)},
    updated in place and returned.  On ``DTensor``s the output is
    ``Partial`` where ``w_out`` is split on its rows."""
    proj = linear(impl, u, p["w_in"])
    args = (proj, p["conv_w"], p["dt_bias"], p["a_log"], p["d_skip"],
            p["norm_scale"], state)
    if is_placed(u):
        y = _mix_placed(cfg, u, chunk, *args)
    else:
        y = _mix(cfg, chunk, 0, None, *args)
    return linear(impl, y, p["w_out"]), state


def _mix(cfg: ModelConfig, chunk: int, h0: int, total, proj, conv_w,
         dt_bias, a_log, d_skip, scale, state) -> torch.Tensor:
    """The mixer between its projections: ``proj`` (B, S, 2di + 2n + h)
    whole, the heads ``h0 .. h0 + len(a_log)`` of ``dt_bias``, ``a_log``,
    ``d_skip`` and ``scale`` (their ``d_inner`` channels) and of the cache
    entry's ``ssm`` state, the ``conv`` state whole; ``total`` sums the
    gated norm's sums of squares over the other heads' ranks (None: all
    heads are here).  Returns the gated norm's output for these heads
    (B, S, heads x P) in ``proj``'s type; the state is updated in
    place."""
    b, s, _ = proj.shape
    di, h, n = ssm_dims(cfg)
    hp, hl = cfg.ssm_head_dim, a_log.shape[0]
    z, x, bb, cc, dt = _split(cfg, proj)
    dt = F.softplus(dt[..., h0:h0 + hl].float() + dt_bias.float())
    xbc = torch.cat([x, bb, cc], dim=-1)
    # every channel: B and C, which every head reads, come out whole, and
    # so does the new conv state
    xbc, new_conv = _causal_conv(xbc, conv_w,
                                 None if state is None else state["conv"])
    x, bb, cc = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    xh = x.reshape(b, s, h, hp)[:, :, h0:h0 + hl]
    z = z[..., h0 * hp:(h0 + hl) * hp]
    init = None if state is None else state["ssm"]
    if s == 1 and state is not None:
        # single-step recurrence (decode)
        a = -torch.exp(a_log.float())
        dt1 = dt[:, 0]                                        # (B,H)
        decay = torch.exp(dt1 * a)                            # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xh[:, 0].float(),
                           bb[:, 0].float())
        final = init * decay[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cc[:, 0].float(), final)[:, None]
    else:
        y, final = ssd_chunked(xh, dt, a_log, bb, cc, chunk, init)
    y = y + xh.float() * d_skip.float()[:, None]
    y = y.reshape(b, s, hl * hp).to(proj.dtype)
    y = _gated_rmsnorm(scale, y, z, di, total)
    if state is not None:
        state["ssm"].copy_(final)
        state["conv"].copy_(new_conv)
    return y


def _mix_placed(cfg: ModelConfig, u: torch.Tensor, chunk: int, proj,
                *weights_and_state) -> torch.Tensor:
    """``_mix`` on the local shards (module docstring), ``u`` the input
    ``proj`` was made from (batch split on its first dimension, whole
    elsewhere), the heads where ``a_log`` lays them; returns the gated
    norm's output split on its last dimension as the heads are."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = u.device_mesh
    _, h, _ = ssm_dims(cfg)
    a_log = weights_and_state[2]
    if any(not isinstance(q, (Replicate, Shard)) or isinstance(q, Shard)
           and q.dim != 0 for q in u.placements):
        raise ValueError(f"apply_ssm takes the batch split on its first "
                         f"dimension and whole elsewhere, got "
                         f"{u.placements}")
    heads = [i for i, q in enumerate(a_log.placements)
             if isinstance(q, Shard)]
    if any(isinstance(u.placements[i], Shard) for i in heads):
        raise NotImplementedError(f"apply_ssm: heads and batch split on "
                                  f"one mesh dimension ({heads})")
    h0, _ = shard_offset(mesh, a_log.placements, 0, h)
    groups = [mesh.get_group(i) for i in heads if mesh.size(i) > 1]

    def total(ss):
        for g in groups:
            ss = _AllSum.apply(ss, g)
        return ss
    # proj whole but for the batch (an all-gather where w_in's columns are
    # split; its gradient the ranks' partial sums, reduce-scattered) and
    # conv_w whole; the heads' leaves as laid out, norm_scale's channels
    # with its heads
    rows = list(u.placements)
    whole = [Replicate()] * mesh.ndim
    scale_pl = [Shard(0) if i in heads else Replicate()
                for i in range(mesh.ndim)]
    in_pl = [rows, whole, None, None, None, scale_pl] + [None] * len(
        tree_flatten(weights_and_state[-1])[0])
    out_pl = [Shard(2) if i in heads else q for i, q in enumerate(rows)]
    return on_shards(
        lambda *a: (_mix(cfg, chunk, h0, total if groups else None, *a),),
        mesh, in_pl, [out_pl], proj, *weights_and_state)[0]


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
