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

The partitioned route (``x`` a ``DTensor``, ``impl`` a
``kernels.ops.partitioned`` namespace), the reference's MoE under
``jax.jit(in_shardings=...)`` with the experts on ``data`` and
``expert_ff`` on ``model`` (``PROD_RULES``).  The input is the
residual stream's norm, batch on the batch axes and whole on the
others; the router is the partitioned FSDP product; then two
``on_shards`` calls run on the local shards:

* ``route``: softmax, the stable top-k and the gates on this rank's
  tokens; the recorded or replayed choices (``routing``) are this
  rank's own slice.  The block is global: ``blk = min(cfg.moe_block,
  B * S)`` over every rank's tokens, never the local count (a smaller
  block would restart the queues on each rank).  Where each rank holds
  whole blocks (``train_4k``, ``prefill_32k``: 64 blocks of 1,024 on
  each of 16 data ranks) the queues are local; where a block spans
  ranks (``decode_32k``: one block of 128 tokens, 8 a rank) every rank's
  top-k indices are gathered (int64, ``tokens x k``) and each rank ranks
  its block whole, keeping its own rows.  The aux loss is the mean over
  the global blocks: each rank's part of it is summed over the batch
  axes (an all-reduce whose backward is the identity, since every rank
  reads the same sum).
* ``mix``: the dispatch on local tokens, the exchange, every local
  expert's gated FFN on its ``expert_ff`` columns (``model``), the
  exchange back and the combine.  Whole blocks: one
  ``all_to_all_single`` over the experts' axis sends each expert's
  ``(nblk, C, d)`` rows to the rank that holds it, which runs its
  experts over every rank's blocks, and a second brings the outputs
  back (``_Exchange``: the backward of each is the reverse
  all-to-all).  Blocks over several ranks: each rank's dispatch is a
  partial ``(E, C, d)`` of its own tokens in its block's place among
  the blocks of the experts' ranks; a reduce-scatter onto the experts'
  axis sums them (each slot has one token, so the sum is exact), the
  owner of an expert combines its outputs for those ranks' tokens with
  their gathered gates (``tokens x k``), and a reduce-scatter over the
  tokens gives each rank its rows.  That moves ``E x C x d`` once and
  ``tokens x d`` once, where an all-gather of the outputs for the
  combine would move ``E x C x d`` twice; the activations are never
  gathered.  The ``wo`` products are row-parallel on ``model``: the
  layer's output stays ``Partial`` there and the next norm
  reduce-scatters it onto the stream's rows, which moves a token's row
  once where reducing the dispatched rows (``1.25 x k`` rows a token)
  would move it ``1.25 x k`` times.  ``x``'s and the gates' gradients
  are ``Partial`` over ``model``; each rank's expert weights get the
  gradient of their own shard.

Other layouts raise on the partitioned route: a padded last block, a
block that straddles ranks unevenly, blocks not aligned with the
experts' ranks, or experts split on an axis other than the batch's
last.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import remat
from .common import ModelConfig, ParamDef, Rules, is_placed, on_shards
from .layers import _act, apply_mlp, linear


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


def _route(cfg: ModelConfig, logits: torch.Tensor,
           routing: Optional[Routing]):
    """(nblk, blk, E) float32 logits -> ``(probs, gates, idx)``: the
    softmax, the top-k's gates renormalised over k, and the top-k
    expert indices (``routing``'s where it replays)."""
    probs = torch.softmax(logits, dim=-1)
    with torch.no_grad():
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :cfg.top_k]
    if routing is not None:
        idx = routing(idx)
    gates = probs.gather(-1, idx)                             # (n, blk, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _queue(cfg: ModelConfig, idx: torch.Tensor):
    """``(onehot, rank)``: the (nblk, blk, k, E) one-hot choices and each
    (token, choice)'s position in its expert's queue, (nblk, blk, k)."""
    e = cfg.n_experts
    nblk, blk, k = idx.shape
    onehot = F.one_hot(idx, e)                                # (n,blk,k,E)
    flat = onehot.reshape(nblk, blk * k, e)
    ranks = torch.cumsum(flat, dim=1) - flat                  # (n,blk*k,E)
    return onehot, (ranks * flat).sum(-1).reshape(nblk, blk, k)


def _aux(cfg: ModelConfig, onehot: torch.Tensor, mean_probs: torch.Tensor
         ) -> torch.Tensor:
    """Switch aux loss a block: E * sum_e (frac_tokens_e * mean_prob_e)."""
    frac = onehot.sum(2).float().mean(1)                      # (n, E)
    return cfg.n_experts * torch.sum(frac * mean_probs, dim=-1)


def _onehots(cfg: ModelConfig, idx, rank, keep, dtype):
    """The one-hot expert (n, blk, k, E) of the kept choices and slot
    (n, blk, k, C) of every choice."""
    cap = _capacity(cfg)
    oh_e = F.one_hot(idx, cfg.n_experts).to(dtype) * keep[..., None]
    oh_c = F.one_hot(torch.where(keep, rank, cap),
                     cap + 1).to(dtype)[..., :cap]
    return oh_e, oh_c


def _shared_onehots(cfg: ModelConfig, idx, rank, keep, dtype):
    """``_onehots`` for a dispatch and a combine of the same choices, or
    None where the scatter dispatch needs none."""
    if cfg.moe_dispatch == "scatter":
        return None
    return _onehots(cfg, idx, rank, keep, dtype)


def _dispatch(cfg: ModelConfig, xt: torch.Tensor, idx, rank, keep,
              oh=None) -> torch.Tensor:
    """(nblk, blk, d) tokens -> (nblk, E, C, d) rows: each kept choice's
    token in its (expert, slot), zeros elsewhere (``oh``: ``_onehots`` of
    these choices, where the combine shares them)."""
    nblk, _, d = xt.shape
    e, k, cap = cfg.n_experts, cfg.top_k, _capacity(cfg)
    if cfg.moe_dispatch == "scatter":
        # gather/scatter dispatch: each (expert, slot) of a block takes at
        # most one row; overflowed choices go to a last, discarded slot
        pos_safe = torch.where(keep, idx * cap + rank, e * cap)
        base = torch.arange(nblk, device=xt.device)[:, None, None] \
            * (e * cap + 1)
        slots = (pos_safe + base).reshape(-1)
        xe_flat = torch.zeros((nblk * (e * cap + 1), d), dtype=xt.dtype,
                              device=xt.device)
        xe_flat = xe_flat.index_add(0, slots,
                                    xt.repeat_interleave(k, dim=1)
                                    .reshape(-1, d))
        return xe_flat.reshape(nblk, e * cap + 1, d)[:, :e * cap] \
            .reshape(nblk, e, cap, d)
    # one-hot GEMM dispatch (the reference's baseline)
    oh_e, oh_c = oh or _onehots(cfg, idx, rank, keep, xt.dtype)
    disp = torch.einsum("nbke,nbkc->nbec", oh_e, oh_c)        # (n,blk,E,C)
    return torch.einsum("nbec,nbd->necd", disp, xt)           # (n,E,C,d)


def _combine(cfg: ModelConfig, ye: torch.Tensor, idx, rank, keep, gates,
             first: int = 0, oh=None) -> torch.Tensor:
    """(nblk, El, C, d) outputs of experts ``first .. first + El`` ->
    (nblk, blk, d): each token's kept choices of those experts weighted
    by their gates (the other choices add nothing); ``oh`` as in
    ``_dispatch``."""
    nblk, el, cap, d = ye.shape
    dtype = ye.dtype
    if cfg.moe_dispatch == "scatter":
        own = keep & (idx >= first) & (idx < first + el)
        pos_safe = torch.where(own, (idx - first) * cap + rank, el * cap)
        base = torch.arange(nblk, device=ye.device)[:, None, None] \
            * (el * cap + 1)
        ye_flat = torch.cat([ye.reshape(nblk, el * cap, d),
                             torch.zeros((nblk, 1, d), dtype=dtype,
                                         device=ye.device)], dim=1)
        taken = ye_flat.reshape(-1, d)[(pos_safe + base).reshape(-1)] \
            .reshape(*idx.shape, d)
        return torch.sum(taken * (gates[..., None] * own[..., None])
                         .to(dtype), dim=2)
    oh_e, oh_c = oh or _onehots(cfg, idx, rank, keep, dtype)
    combine = torch.einsum("nbke,nbkc->nbec",
                           oh_e[..., first:first + el]
                           * gates[..., None].to(dtype), oh_c)
    return torch.einsum("nbec,necd->nbd", combine, ye)


def _experts(cfg: ModelConfig, p: Dict, rows: torch.Tensor, product
             ) -> torch.Tensor:
    """(El, R, d) rows of each local expert -> (El, R, d) outputs: each
    expert's gated FFN once over its rows, ``product(a, w)`` a GEMM."""
    outs = []
    for j in range(rows.shape[0]):
        h = _act(cfg, product(rows[j], p["wg"][j])) \
            * product(rows[j], p["wi"][j])
        outs.append(product(h, p["wo"][j]))
    return torch.stack(outs)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if hasattr(t, "wait") else t


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of equal parts over ``group``: dimension 0
    split into one part a rank; the backward sends the gradient back by
    the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_to_all_single(t, None, None, group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_to_all_single(g.contiguous(), None, None,
                                              ctx.group)), None


class _Scatter(torch.autograd.Function):
    """The sum over ``group`` split on dimension 0 (reduce-scatter); the
    backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.reduce_scatter_tensor(t.contiguous(), "sum", 0,
                                                  group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_gather_tensor(g.contiguous(), 0,
                                              ctx.group)), None


class _Gather(torch.autograd.Function):
    """Every rank's ``t`` of ``group`` in rank order on dimension 0
    (all-gather); the backward reduce-scatters the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_gather_tensor(t.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.reduce_scatter_tensor(g.contiguous(), "sum", 0,
                                                  ctx.group)), None


class _Sum(torch.autograd.Function):
    """The sum of ``t`` over ``group`` (all-reduce), which every rank
    then reads alike: the backward is the identity."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _over(fn, t: torch.Tensor, groups) -> torch.Tensor:
    """``fn.apply`` over each process group of ``groups`` in turn (a
    group of one rank passes ``t`` unchanged)."""
    for g in groups:
        if g is not None and g.size() > 1:
            t = fn.apply(t, g)
    return t


def _to_experts(xe: torch.Tensor, group) -> torch.Tensor:
    """(nblk, E, C, d) rows of this rank's blocks -> (El, parts * nblk *
    C, d): each of this rank's ``El = E / parts`` experts' rows of every
    rank's blocks in block order, ``parts`` the ranks of ``group`` (the
    experts' axis; None: this rank holds every expert)."""
    nblk, e, cap, d = xe.shape
    parts = 1 if group is None else group.size()
    send = _over(_Exchange, xe.transpose(0, 1).contiguous(), [group])
    return send.reshape(parts, e // parts, nblk, cap, d).transpose(0, 1) \
        .reshape(e // parts, parts * nblk * cap, d)


def _from_experts(out: torch.Tensor, nblk: int, group) -> torch.Tensor:
    """``_to_experts``' inverse for the experts' outputs: (El, parts *
    nblk * C, d) -> (nblk, E, C, d) on the rank of the blocks."""
    el, rows, d = out.shape
    parts = 1 if group is None else group.size()
    cap = rows // (parts * nblk)
    back = _over(_Exchange, out.reshape(el, parts, nblk, cap, d)
                 .transpose(0, 1).contiguous(), [group])
    return back.reshape(parts * el, nblk, cap, d).transpose(0, 1)


def apply_moe(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              rules: Optional[Rules], impl=ops,
              routing: Optional[Routing] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    if is_placed(x):
        y, aux = _apply_placed(cfg, p, x, impl, routing)
    else:
        y, aux = _apply(cfg, p, x, impl, routing)
    if cfg.shared_expert:
        y = y + apply_mlp(cfg, {"wi": p["shared_wi"], "wg": p["shared_wg"],
                                "wo": p["shared_wo"]}, x, rules, impl)
    return y, aux


def _apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, impl, routing
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e = cfg.n_experts
    blk = min(cfg.moe_block, b * s)
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    pad = (-n) % blk
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    nblk = tokens.shape[0] // blk
    xt = tokens.reshape(nblk, blk, d)

    logits = linear(impl, tokens, p["router"]).float().reshape(nblk, blk, e)
    probs, gates, idx = _route(cfg, logits, routing)
    onehot, rank = _queue(cfg, idx)
    keep = rank < _capacity(cfg)
    # the aux loss before the dispatch, so that the combine is the layer's
    # last product (a rematerialised group's recompute stops before it)
    auxs = _aux(cfg, onehot, probs.mean(1))                   # (n,)
    # the experts' products are one batched einsum in the reference, which
    # no remat policy keeps
    experts = remat.unkept(impl)
    oh = _shared_onehots(cfg, idx, rank, keep, x.dtype)
    rows = _to_experts(_dispatch(cfg, xt, idx, rank, keep, oh), None)
    ye = _from_experts(_experts(cfg, p, rows, experts.matmul), nblk, None)
    y = _combine(cfg, ye, idx, rank, keep, gates, oh=oh)
    return y.reshape(-1, d)[:n].reshape(b, s, d), auxs.mean()


def _apply_placed(cfg: ModelConfig, p: Dict, x: torch.Tensor, impl,
                  routing) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partitioned route (module docstring): ``(y, aux)``, ``y`` laid
    out as ``x`` but ``Partial`` where ``wo`` is split on its rows, the
    aux loss whole on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..kernels.matmul import MatmulFn
    mesh = x.device_mesh
    b, s, d = x.shape
    e, k, cap = cfg.n_experts, cfg.top_k, _capacity(cfg)
    n = b * s
    blk = min(cfg.moe_block, n)
    batch = [i for i, pl in enumerate(x.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    if any(not isinstance(pl, Replicate) for i, pl in
           enumerate(x.placements) if i not in batch):
        raise ValueError(f"apply_moe takes the batch split on its first "
                         f"dimension and whole elsewhere, got "
                         f"{x.placements}")
    held = [i for i, pl in enumerate(p["wi"].placements)
            if isinstance(pl, Shard) and pl.dim == 0]
    rows_split = {i for i, pl in enumerate(p["wo"].placements)
                  if isinstance(pl, Shard) and pl.dim == 1}
    if held and held != batch[-1:]:
        raise NotImplementedError(
            f"apply_moe: experts split on mesh dimensions {held}, not the "
            f"last of the batch's {batch}")
    ranks = math.prod(mesh.size(i) for i in batch)
    n_loc = n // ranks
    parts = mesh.size(held[0]) if held else 1   # the experts' ranks
    span = blk // n_loc                         # ranks a block spans
    whole = n_loc % blk == 0
    if not whole and (blk % n_loc or n % blk or (parts % span if
                                                 span <= parts else
                                                 span % parts)):
        raise NotImplementedError(
            f"apply_moe: blocks of {blk} tokens over ranks of {n_loc} and "
            f"experts over {parts} ranks (neither whole blocks a rank nor "
            f"whole ranks a block, aligned with the experts' ranks)")
    nblk = n_loc // blk if whole else 1
    groups = [mesh.get_group(i) for i in batch]
    group = mesh.get_group(held[0]) if held else None
    first = 0                        # this rank's first token, globally
    for i in batch:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= n_loc

    def route(lg):
        probs, gates, idx = _route(cfg, lg.reshape(nblk, -1, e), routing)
        if whole:
            onehot, rank = _queue(cfg, idx)
            aux = _aux(cfg, onehot, probs.mean(1)).mean()
            if ranks > 1:
                aux = _over(_Sum, aux, groups) / ranks
        else:
            # every rank's choices in token order (the last batch axis
            # gathered first): each rank ranks its block whole
            every = idx.reshape(n_loc, k)
            for g in reversed(groups):
                every = _over(_Gather, every, [g])
            onehot, rank = _queue(cfg, every.reshape(-1, blk, k))
            rank = rank.reshape(n, k)[first:first + n_loc]
            # this rank's part of its block's aux, the blocks' mean summed
            # over the ranks
            frac = onehot[first // blk].sum(1).float().mean(0)
            aux = e * torch.sum(frac * probs[0].sum(0)) / blk
            aux = _over(_Sum, aux, groups) / (n // blk)
        return (gates.reshape(n_loc, k), idx.reshape(n_loc, k),
                rank.reshape(n_loc, k), aux)

    by_token = [Shard(0) if i in batch else Replicate()
                for i in range(mesh.ndim)]
    logits = linear(impl, x, p["router"]).float()
    gates, idx, rank, aux = on_shards(
        route, mesh, None, [by_token] * 3 + [[Replicate()] * mesh.ndim],
        logits)
    base = getattr(impl, "base", impl)

    def product(a, w):
        return MatmulFn.apply(a, w, base)

    def mix(xl, gates, idx, rank, wi, wg, wo):
        w = {"wi": wi, "wg": wg, "wo": wo}
        xt = xl.reshape(nblk, -1, d)
        gates, idx, rank = (t.reshape(nblk, -1, k) for t in (gates, idx,
                                                             rank))
        keep = rank < cap
        oh = _shared_onehots(cfg, idx, rank, keep, xl.dtype) if whole \
            else None
        xe = _dispatch(cfg, xt, idx, rank, keep, oh)
        if whole:
            rows = _to_experts(xe, group)
            ye = _from_experts(_experts(cfg, w, rows, product), nblk, group)
            y = _combine(cfg, ye, idx, rank, keep, gates, oh=oh)
            return (y.reshape(xl.shape),)
        # blocks over several ranks: each rank's partial rows of its block
        # (beside zeros for the other blocks of the experts' ranks) summed
        # onto the experts' owners, each owner's outputs combined for the
        # tokens of those ranks and summed back onto their ranks
        el = wi.shape[0]
        blocks = max(1, parts // span)
        mine = (0 if group is None else group.rank()) * n_loc // blk
        xe = F.pad(xe, (0, 0, 0, 0, 0, 0, mine % blocks,
                        blocks - 1 - mine % blocks))
        rows = _over(_Scatter, xe.transpose(0, 1).contiguous(), [group])
        out = _experts(cfg, w, rows.reshape(el, blocks * cap, d), product)
        ye = out.reshape(el, blocks, cap, d).transpose(0, 1)
        idx, rank, gates = (_over(_Gather, t.reshape(n_loc, k), [group])
                            .reshape(blocks, -1, k)
                            for t in (idx, rank, gates))
        y = _combine(cfg, ye, idx, rank, rank < cap, gates,
                     0 if group is None else group.rank() * el)
        y = _over(_Scatter, y.reshape(-1, d), [group])
        return (y.reshape(xl.shape),)

    out_pl = [Shard(0) if i in batch else
              Partial() if i in rows_split else Replicate()
              for i in range(mesh.ndim)]
    y, = on_shards(mix, mesh, None, [out_pl], x, gates, idx, rank, p["wi"],
                   p["wg"], p["wo"])
    return y, aux
