"""Mixture-of-Experts layer: top-k router + capacity-bounded expert FFNs.

The port of the JAX package's ``models/moe.py``.  Dispatch uses a
*blocked* capacity formulation: tokens are processed in blocks of
``blk = min(cfg.moe_block, tokens)`` (the last padded with zero rows);
per block each expert takes at most ``C = _capacity(cfg)`` tokens, a
number computed from ``cfg.moe_block`` itself, not from ``blk``.  A
(token, choice)'s place in its expert's queue is a cumsum over the
block's ``(blk * k, E)`` one-hot choices in token-major order;
overflowed choices are dropped (standard capacity-based MoE), the kept
gates are the top-k probabilities renormalised over all k, and the
router keeps the Switch auxiliary load-balancing loss.

Products: the router, every expert's three products and the shared
expert go through ``impl.matmul`` (``layers.linear``), one launch each;
the experts' on ``remat.unkept(impl)`` (in a rematerialised group, the
products no remat policy keeps).
The blocks are independent and share their weights, so the router runs
once over every token and each expert once over the rows dispatched to
it from every block (``(nblk, E, C, d)`` -> ``E x (nblk * C, d)``) where
the JAX package maps a function over the blocks.  The one-hot dispatch
and combine einsums (``moe_dispatch="onehot"``, the default) and the
gather/scatter of ``"scatter"`` are not weight products and stay plain
PyTorch, as the JAX package leaves them to XLA.

``jax.lax.top_k`` breaks ties by the lower index; the port takes the k
first indices of a stable descending sort, which does the same on the
CPU and the card (padded rows are zeros, so all their probabilities tie
and their choices enter the aux loss).

``routing`` (a ``Routing``, None by default) records the choices of
each call or replays recorded ones: two routes of one model whose
probabilities differ by rounding can flip a choice at a near-tie, and
each flip moves a token's output by a whole expert; replayed choices
put both on the same piece.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import remat
from .common import ModelConfig, ParamDef, Rules, shard
from .layers import _act, linear


class Routing:
    """The top-k expert indices of each MoE call of a run, in call order.

    ``Routing()`` records: each call appends its ``(nblk, blk, k)``
    indices.  ``Routing(choices)`` (``recorded.pinned()``) replays: each
    call takes the next recorded indices in place of its own top-k, and
    its gates are the router's probabilities at those indices,
    renormalised; with a model's own choices that is the same
    function."""

    def __init__(self, choices: Optional[List[torch.Tensor]] = None):
        self.replay = choices is not None
        self.choices: List[torch.Tensor] = list(choices or [])
        self.calls = 0

    def pinned(self) -> "Routing":
        return Routing(self.choices)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        if self.replay:
            if self.calls >= len(self.choices):
                raise IndexError(f"Routing: call {self.calls} has no "
                                 f"recorded choices ({len(self.choices)})")
            idx = self.choices[self.calls].to(idx.device)
        else:
            self.choices.append(idx)
        self.calls += 1
        return idx


def moe_defs(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict:
    la = ("layers",) * len(lead)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = {
        "router": ParamDef(lead + (d, e), la + ("embed", None)),
        "wi": ParamDef(lead + (e, d, f), la + ("experts", None, "expert_ff")),
        "wg": ParamDef(lead + (e, d, f), la + ("experts", None, "expert_ff")),
        "wo": ParamDef(lead + (e, f, d), la + ("experts", "expert_ff", None)),
    }
    if cfg.shared_expert:
        out["shared_wi"] = ParamDef(lead + (d, f), la + ("embed", "ff"))
        out["shared_wg"] = ParamDef(lead + (d, f), la + ("embed", "ff"))
        out["shared_wo"] = ParamDef(lead + (f, d), la + ("ff", "embed"))
    return out


def _capacity(cfg: ModelConfig) -> int:
    c = int(cfg.top_k * cfg.moe_block / cfg.n_experts * cfg.moe_capacity)
    return max(4, -(-c // 4) * 4)


def _experts(cfg: ModelConfig, p: Dict, xe: torch.Tensor, impl
             ) -> torch.Tensor:
    """(nblk, E, C, d) dispatched rows -> (nblk, E, C, d) expert outputs:
    each expert's gated FFN once over its rows of every block."""
    nblk, e, cap, d = xe.shape
    rows = xe.transpose(0, 1).reshape(e, nblk * cap, d)
    outs = []
    for j in range(e):
        h = _act(cfg, linear(impl, rows[j], p["wg"][j])) \
            * linear(impl, rows[j], p["wi"][j])
        outs.append(linear(impl, h, p["wo"][j]))
    return torch.stack(outs).reshape(e, nblk, cap, d).transpose(0, 1)


def apply_moe(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              rules: Optional[Rules], impl=ops,
              routing: Optional[Routing] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    blk = min(cfg.moe_block, b * s)
    cap = _capacity(cfg)
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    pad = (-n) % blk
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    nblk = tokens.shape[0] // blk
    xt = tokens.reshape(nblk, blk, d)

    logits = linear(impl, tokens, p["router"]).float().reshape(nblk, blk, e)
    probs = torch.softmax(logits, dim=-1)
    with torch.no_grad():
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    if routing is not None:
        idx = routing(idx)
    # the experts' products are one batched einsum in the reference, which
    # no remat policy keeps
    experts = remat.unkept(impl)
    gate_vals = probs.gather(-1, idx)                         # (n, blk, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    # position of each (token, choice) within its expert queue
    onehot = F.one_hot(idx, e)                                # (n,blk,k,E)
    flat = onehot.reshape(nblk, blk * k, e)
    ranks = torch.cumsum(flat, dim=1) - flat                  # (n,blk*k,E)
    rank = (ranks * flat).sum(-1).reshape(nblk, blk, k)
    keep = rank < cap
    # Switch aux loss a block: E * sum_e (frac_tokens_e * mean_prob_e),
    # before the dispatch, so that the combine is the layer's last
    # product (a rematerialised group's recompute stops before it)
    frac = onehot.sum(2).float().mean(1)                      # (n, E)
    auxs = e * torch.sum(frac * probs.mean(1), dim=-1)        # (n,)
    if cfg.moe_dispatch == "scatter":
        # gather/scatter dispatch: each (expert, slot) of a block takes at
        # most one row; overflowed choices go to a last, discarded slot
        pos = idx * cap + rank                                # (n, blk, k)
        pos_safe = torch.where(keep, pos, e * cap)
        base = torch.arange(nblk, device=x.device)[:, None, None] \
            * (e * cap + 1)
        slots = (pos_safe + base).reshape(-1)
        xe_flat = torch.zeros((nblk * (e * cap + 1), d), dtype=x.dtype,
                              device=x.device)
        xe_flat = xe_flat.index_add(0, slots,
                                    xt.repeat_interleave(k, dim=1)
                                    .reshape(-1, d))
        xe = xe_flat.reshape(nblk, e * cap + 1, d)[:, :e * cap] \
            .reshape(nblk, e, cap, d)
        xe = shard(xe, rules, None, "experts", None, None)
        ye = _experts(cfg, p, xe, experts)                    # (n,E,C,d)
        ye_flat = torch.cat([ye.reshape(nblk, e * cap, d),
                             torch.zeros((nblk, 1, d), dtype=ye.dtype,
                                         device=x.device)], dim=1)
        taken = ye_flat.reshape(-1, d)[slots].reshape(nblk, blk, k, d)
        y = torch.sum(taken * (gate_vals[..., None] * keep[..., None])
                      .to(taken.dtype), dim=2)
    else:
        # one-hot GEMM dispatch (the reference's baseline)
        oh_e = onehot.to(x.dtype) * keep[..., None]           # (n,blk,k,E)
        oh_c = F.one_hot(torch.where(keep, rank, cap),
                         cap + 1).to(x.dtype)[..., :cap]      # (n,blk,k,C)
        disp = torch.einsum("nbke,nbkc->nbec", oh_e, oh_c)    # (n,blk,E,C)
        xe = torch.einsum("nbec,nbd->necd", disp, xt)         # (n,E,C,d)
        xe = shard(xe, rules, None, "experts", None, None)
        ye = _experts(cfg, p, xe, experts)
        combine = torch.einsum(
            "nbke,nbkc->nbec", oh_e * gate_vals[..., None].to(x.dtype), oh_c)
        y = torch.einsum("nbec,necd->nbd", combine, ye)
    y = y.reshape(-1, d)[:n].reshape(b, s, d)
    if cfg.shared_expert:
        h = _act(cfg, linear(impl, x, p["shared_wg"])) \
            * linear(impl, x, p["shared_wi"])
        y = y + linear(impl, h, p["shared_wo"])
    return y, auxs.mean()
