"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

  r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
  a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of the JAX package's ``models/rglru.py``.  A prefill scans the
per-step affine maps (h -> a*h + b composes associatively) with a
log-depth doubling scan in plain PyTorch (``_rglru_scan``: ceil(log2 S)
rounds of whole-tensor ops, where the JAX package has
``lax.associative_scan``; a loop over time would launch a kernel a step);
decode is the single-step recurrence on the cached state.  The block
follows Griffin's recurrent block: linear in, short causal conv,
RG-LRU, gated output.

``w_x``, ``w_gate`` and ``w_out`` go through ``impl.matmul`` in the
model's type; ``r`` and ``i`` are float32 products, as in the reference
(``x.float() @ w.float()``), so on the card they take the GEMM kernel's
float32 route.  A cache entry (``state``: ``{'h': (B, R), 'conv': (B,
W-1, R)}``, float32) is updated in place and returned.

The partitioned route (``u`` a ``DTensor``, ``impl`` a
``kernels.ops.partitioned`` namespace), the reference's block under
``jax.jit(in_shardings=...)``: x and the gate come out of column-parallel
products split on ``rnn`` (``model``); the conv runs on the local
channels (``_conv_placed``), where the ``conv`` cache is whole on
``model``: each rank reads its channels of it and the new state is
gathered whole over the ranks of the channels (B x (W-1) x R float32 a
step, the only collective of the conv).  ``w_r`` and ``w_i`` are
split on their rows, so r's and i's float32 products come out
``Partial``; each is reduce-scattered onto ``rnn``, the layout every
later op reads (``lam``, x, the ``h`` cache on ``("batch", "rnn")``).
The gates, the doubling scan (or the decode step) and the gated output
run on the local channels in one ``on_shards`` call
(``_recur``); ``w_out`` is row-parallel, its output ``Partial``
on ``model``, reaching the stream through the next norm.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import (ModelConfig, ParamDef, Rules, is_placed, on_shards,
                     shard_offset, summed)
from .layers import linear
from .ssm import _causal_conv, _wait

C_FACTOR = 8.0


def rglru_defs(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict:
    la = ("layers",) * len(lead)
    d = cfg.d_model
    r = cfg.rnn_width or d
    return {
        "w_x": ParamDef(lead + (d, r), la + ("embed", "rnn")),
        "w_gate": ParamDef(lead + (d, r), la + ("embed", "rnn")),
        "conv_w": ParamDef(lead + (cfg.conv_width, r), la + ("conv", "rnn"),
                           init="normal", scale=1.0),
        "w_r": ParamDef(lead + (r, r), la + ("rnn", None)),
        "w_i": ParamDef(lead + (r, r), la + ("rnn", None)),
        "lam": ParamDef(lead + (r,), la + ("rnn",), init="ones"),
        "w_out": ParamDef(lead + (r, d), la + ("rnn", "embed")),
    }


def _rglru_scan(x: torch.Tensor, a: torch.Tensor,
                h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a: (B,S,R) f32. h_t = a_t h_{t-1} + x_t by a doubling scan:
    after the round of stride d, element t holds the composition of
    steps max(0, t - 2d + 1) .. t, so ceil(log2 S) rounds give every
    prefix.  Out of place, so that autograd sees every round."""
    if h0 is not None:
        # fold the initial state into the first step
        x = torch.cat([x[:, :1] + a[:, :1] * h0[:, None], x[:, 1:]], dim=1)
    aa, hh = a, x
    d, s = 1, x.shape[1]
    while d < s:
        # (a1, b1) at t - d, then (a2, b2) at t: (a1 a2, a2 b1 + b2)
        hh = torch.cat([hh[:, :d], aa[:, d:] * hh[:, :-d] + hh[:, d:]], 1)
        aa = torch.cat([aa[:, :d], aa[:, :-d] * aa[:, d:]], 1)
        d *= 2
    return hh, hh[:, -1]


def apply_rglru(cfg: ModelConfig, p: Dict, u: torch.Tensor,
                rules: Optional[Rules],
                state: Optional[Dict] = None, impl=ops
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """u: (B,S,d); state (decode): {'h': (B,R), 'conv': (B,W-1,R)},
    updated in place and returned.  On ``DTensor``s the output is
    ``Partial`` where ``w_out`` is split on its rows."""
    x = linear(impl, u, p["w_x"])
    gate = linear(impl, u, p["w_gate"])
    conv_state = None if state is None else state["conv"]
    h0 = None if state is None else state["h"]
    placed = is_placed(u)
    if placed:
        # with the batch whole (a cell of one sequence), the FSDP-split
        # input products come out Partial on data: the conv state and the
        # gates must see their sums
        x, gate = summed(x), summed(gate)
        x = _conv_placed(x, p["conv_w"], conv_state)
    else:
        x = _conv(x, p["conv_w"], conv_state, 0, ())
    xf = x.float()
    r, i = (linear(impl, xf, p[w].float()) for w in ("w_r", "w_i"))
    if placed:
        # row-parallel float32 products, reduce-scattered onto x's channels
        r, i = (t.redistribute(x.device_mesh, x.placements) for t in (r, i))
        y, = on_shards(lambda *a: (_recur(*a),), x.device_mesh, None,
                       [x.placements], xf, r, i, p["lam"], gate, h0)
    else:
        y = _recur(xf, r, i, p["lam"], gate, h0)
    return linear(impl, y, p["w_out"]), state


def _conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor],
          c0: int, groups) -> torch.Tensor:
    """``_causal_conv`` of x (B, S, R) with ``w`` on channels ``c0 ..
    c0 + R`` of ``state`` (None: a zero history), which is overwritten
    with the new state gathered whole over ``groups`` (the ranks that
    split the channels, the minor mesh dimension first)."""
    cl = x.shape[-1]
    y, new = _causal_conv(x, w, None if state is None
                          else state[..., c0:c0 + cl])
    if state is not None:
        import torch.distributed._functional_collectives as funcol
        for g in groups:
            new = _wait(funcol.all_gather_tensor(new.contiguous(), 2, g))
        state.copy_(new)
    return y


def _conv_placed(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]) -> torch.Tensor:
    """``_conv`` on the local channels of ``x`` (B, S, R), ``w`` laid out
    alike and ``state`` whole on the mesh dimensions that split them."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    c0, _ = shard_offset(mesh, x.placements, 2, x.shape[-1])
    groups = [mesh.get_group(i) for i, q in reversed(list(enumerate(
        x.placements))) if isinstance(q, Shard) and q.dim == 2
        and mesh.size(i) > 1]
    return on_shards(lambda x, w, state: (_conv(x, w, state, c0, groups),),
                     mesh, [x.placements, None, None], [x.placements],
                     x, w, state)[0]


def _recur(xf, r, i, lam, gate, h0) -> torch.Tensor:
    """The gates, the recurrence (the doubling scan, or one decode step
    over the state ``h0``, updated in place) and the gated output, in
    the gate's type."""
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    log_a = -C_FACTOR * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    inp = beta * (i * xf)
    if xf.shape[1] == 1 and h0 is not None:
        h_last = a[:, 0] * h0 + inp[:, 0]
        hh = h_last[:, None]
    else:
        hh, h_last = _rglru_scan(inp, a, h0)
    if h0 is not None:
        h0.copy_(h_last)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(gate, approximate="tanh")
    return hh.to(gate.dtype) * gate


def init_rglru_state(cfg: ModelConfig, n_layers: int, batch: int,
                     device="cuda") -> Dict:
    r = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((n_layers, batch, r), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, r),
                            dtype=torch.float32, device=device),
    }
