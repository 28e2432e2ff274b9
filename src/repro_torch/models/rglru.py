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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig, ParamDef, Rules, shard
from .layers import linear
from .ssm import _causal_conv

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
    updated in place and returned."""
    b, s, _ = u.shape
    x = linear(impl, u, p["w_x"])
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(linear(impl, u, p["w_gate"]), approximate="tanh")
    conv_state = None if state is None else state["conv"]
    x, new_conv = _causal_conv(x, p["conv_w"], conv_state)
    x = shard(x, rules, "batch", "seq", "rnn")

    xf = x.float()
    r = torch.sigmoid(linear(impl, xf, p["w_r"].float()))
    i = torch.sigmoid(linear(impl, xf, p["w_i"].float()))
    log_a = -C_FACTOR * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    inp = beta * (i * xf)

    h0 = None if state is None else state["h"]
    if s == 1 and state is not None:
        h_last = a[:, 0] * h0 + inp[:, 0]
        hh = h_last[:, None]
    else:
        hh, h_last = _rglru_scan(inp, a, h0)
    y = linear(impl, hh.to(u.dtype) * gate, p["w_out"])
    if state is not None:
        state["h"].copy_(h_last)
        state["conv"].copy_(new_conv)
    return shard(y, rules, "batch", "seq", "act_embed"), state


def init_rglru_state(cfg: ModelConfig, n_layers: int, batch: int,
                     device="cuda") -> Dict:
    r = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((n_layers, batch, r), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, r),
                            dtype=torch.float32, device=device),
    }
