"""Attention: GQA/MQA/MHA with rotary, qk-norm, sliding windows, cross
attention, KV caching, and a memory-bounded chunked (online-softmax)
implementation for long sequences.

The port of the JAX package's ``models/attention.py``.  Projections go
through ``impl.matmul`` (``layers.linear``).  The self-attention of a
prefill whose keys are its own queries (no ``kv_x``, and no cache or an
empty one, at position 0) goes through ``impl.flash_attention`` with the
layer's window: on the card that launches the flash-attention kernel, on
the CPU it runs the kernel's plain version.  The JAX package attends
there over the whole cache buffer and masks the empty slots; those add
exact zeros, so attending over the fresh keys alone is the same function.
A decode step, a staged prefill (position > 0) and cross-attention stay
on the JAX package's own path: ``_dense_attention``, or
``_chunked_attention_dynwin`` past ``cfg.dense_attn_max_seq``, plain
tensor ops as there.

Caches are updated in place and returned (the JAX serve loop donates
its cache, so the old one is never read again): ``cache['k']``,
``cache['v']`` (and the int8 scales) at rows ``pos .. pos + s``, and
``cache['pos']`` advanced by ``s``.

On ``DTensor``s (the partitioned route) the projections run through the
partitioned ``impl.matmul`` and ``shard`` lays q, k, v out by the rules;
qk-norm, rotary embeddings, the cache's append and the dense or chunked
attention run on the local shards (``_attend_placed``: one
``local_map`` region, plain ops inside, each rank's query heads against
the KV heads they read -- where the KV heads do not divide the model
axis, as Qwen3's 8 do not divide 16, they are whole on every rank and
each picks its own); the flash path through the partitioned
``impl.flash_attention``.  So does cross-attention: against the
encoder's keys (no rotary, no cache) and against the cache's
precomputed ones (``attend_precomputed``).

A placed cache may be split on its sequence (``cache_seq``: a decode of
one sequence puts it on ``data``, the optimized decode layout on
``model``), on any mesh dimension, one of a single rank too
(``_attend_split``).  Each rank then holds rows ``first .. first +
count``: it appends the new rows that fall there (``_append_rows``,
int8 quantized on the local rows alike), judges validity and windows
on global positions, and takes the partial softmax of every query over
its rows (``_partials``: the chunked path's running max, denominator
and accumulator); the ranks merge the partials by log-sum-exp across
the sequence's mesh dimensions (``_merge``), where the JAX package lets
XLA partition one softmax over the split keys.  A prefill into such a
cache attends over its fresh rows on the flash path.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten

from ..kernels import ops
from .common import (ModelConfig, ParamDef, Rules, TensorSpec, is_placed,
                     kv_heads_read, on_shards, shard, shard_offset)
from .layers import _all_reduce, linear, rms_head_norm, rope

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, lead: Tuple[int, ...] = (),
              cross: bool = False) -> Dict:
    la = ("layers",) * len(lead)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        "wq": ParamDef(lead + (d, h, hd), la + ("embed", "heads", None)),
        "wk": ParamDef(lead + (d, kv, hd), la + ("embed", "kv_heads", None)),
        "wv": ParamDef(lead + (d, kv, hd), la + ("embed", "kv_heads", None)),
        "wo": ParamDef(lead + (h, hd, d), la + ("heads", None, "embed")),
    }
    if cfg.qk_norm and not cross:
        out["q_norm"] = ParamDef(lead + (hd,), la + (None,), init="ones")
        out["k_norm"] = ParamDef(lead + (hd,), la + (None,), init="ones")
    return out


def _in_window(dq: torch.Tensor, dk: torch.Tensor, window):
    """Where ``dk`` lies in the window ending at ``dq``: a python int
    (0: everywhere) is decided on the host, a tensor scalar on the
    device; ``True`` stands for everywhere."""
    if isinstance(window, int):
        return dk > dq - window if window > 0 else True
    return torch.where(window > 0, dk > dq - window, True)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window) -> torch.Tensor:
    """(q, k) additive bias: 0 where attending is allowed, NEG_INF else.

    ``window`` may be a python int or a tensor scalar; 0 disables
    windowing.  Negative ``k_pos`` marks invalid (unwritten cache)
    slots."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = (dk >= 0).expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        ok = ok & (dk <= dq)
    ok = ok & _in_window(dq, dk, window)
    return torch.where(ok, 0.0, NEG_INF)


def _dense_attention(q, k, v, bias) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,KV,D); bias: (S,T) additive."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    qg = q.reshape(b, s, kvh, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(d) + bias
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, d)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D), contiguous."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _flash(impl, q, k, v, causal: bool, window: int) -> torch.Tensor:
    """``impl.flash_attention`` on q (B,S,H,D) and k, v (B,S,KV,D);
    returns (B,S,H,D)."""
    b, s, h, d = q.shape
    out = impl.flash_attention(_heads_first(q), _heads_first(k),
                               _heads_first(v), h, k.shape[2],
                               causal=causal, window=window)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and float32 scales of ``x`` per (token, kv-head)."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              rules: Optional[Rules],
              kv_x: Optional[torch.Tensor] = None,
              q_offset=0,
              cache: Optional[Dict] = None,
              window=None,
              causal: Optional[bool] = None,
              impl=ops,
              fresh: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention with optional KV cache.

    * training / prefill: ``cache`` None or empty -> keys from ``x`` itself
      (or ``kv_x`` for cross attention).
    * decode: ``cache`` = {'k','v','pos'} buffer, ``pos`` a 0-dim tensor;
      new KV written at position ``pos`` (in place) and attention runs
      against the whole buffer.
    * ``window``: sliding-window size, a python int (0 = full) or, off
      the flash path, a tensor scalar.
    * ``fresh``: ``cache`` is the zero cache ``make_cache`` made, its
      position 0 known without reading it from the device (a prefill;
      a trace on the meta device cannot read it).
    """
    b, s, _ = x.shape
    causal = cfg.causal if causal is None else causal
    src = x if kv_x is None else kv_x
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(impl, x, _flat(p["wq"], d, h * hd)).reshape(b, s, h, hd)
    t_src = src.shape[1]
    k = linear(impl, src, _flat(p["wk"], d, kvh * hd)).reshape(
        b, t_src, kvh, hd)
    v = linear(impl, src, _flat(p["wv"], d, kvh * hd)).reshape(
        b, t_src, kvh, hd)
    q = shard(q, rules, "batch", "seq", "act_heads", None)
    k = shard(k, rules, "batch", "seq", "cache_heads", None)
    v = shard(v, rules, "batch", "seq", "cache_heads", None)

    w = cfg.window if window is None else window
    # a prefill whose keys are its own queries: the flash path (the cache,
    # if any, is empty; reading its position waits for the device)
    flash = kv_x is None and s > 1 and (
        cache is None or fresh or int(cache["pos"]) == 0)
    norms = ((p["q_norm"], p["k_norm"]) if cfg.qk_norm and "q_norm" in p
             else None)
    cross = kv_x is not None
    if is_placed(q):
        out = _attend_placed(cfg, norms, q, k, v, cache, cross, q_offset,
                             causal, w, flash, impl)
    else:
        q, k, v, q_pos, k_pos = _prepare(cfg, norms, q, k, v, cache, cross,
                                         q_offset, flash)
        out = _attend(cfg, q, k, v, q_pos, k_pos, causal, w, flash, impl)
    out = shard(out, rules, "batch", "seq", "act_heads", None)
    y = linear(impl, out.reshape(b, s, h * hd), _flat(p["wo"], h * hd, d))
    return shard(y, rules, "batch", "seq", "act_embed"), cache


def _flat(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A projection weight as its (rows, cols) matrix.  A ``DTensor``
    split on a dimension of size 1 over a mesh dimension of one rank (the
    one KV head of an MQA config on a (4, 1) mesh, which the rules split
    since 1 divides 1) is first made whole there, which moves nothing:
    PyTorch's view propagation refuses to merge a split dimension of
    size 1."""
    if is_placed(w):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate() if isinstance(q, Shard) and w.shape[q.dim] == 1
              and w.device_mesh.size(i) == 1 else q
              for i, q in enumerate(w.placements)]
        if pl != list(w.placements):
            w = w.redistribute(w.device_mesh, pl)
    return w.reshape(rows, cols)


def _prepare(cfg: ModelConfig, norms, q, k, v, cache: Optional[Dict],
             cross: bool, q_offset, flash: bool, rows=None):
    """qk-norm, rotary embeddings and the cache's append, on plain
    tensors; returns ``(q, k, v, q_pos, k_pos)``, ``k`` and ``v`` what
    the queries attend over (with a cache, its whole buffer; on the
    flash path its fresh rows).  ``cross``: ``k`` and ``v`` are another
    sequence's (the encoder's), not rotated, at positions 0 .. T.
    ``rows``: ``(first, count)``, the cache holds only those rows of the
    sequence (a shard of a cache split on it, ``_append_rows``)."""
    b, s = q.shape[:2]
    device = q.device
    if norms is not None:
        q = rms_head_norm(norms[0], q)
        k = rms_head_norm(norms[1], k)

    if cache is not None:
        q_offset = cache["pos"]
    q_pos = q_offset + torch.arange(s, device=device)
    if not cross:
        k_pos_new = q_pos
        q = rope(q, q_pos.expand(b, s), cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, k_pos_new.expand(b, s), cfg.rope_theta,
                 cfg.rope_fraction)
    else:
        k_pos_new = torch.arange(k.shape[1], device=device)

    if cache is not None and rows is not None:
        k, v, k_pos = _append_rows(cfg, cache, k, v, rows, flash)
    elif cache is not None:
        # append at pos (decode or staged prefill); int8 caches quantize on
        # write with per-(token, kv-head) dynamic scales stored alongside
        pos = cache["pos"]
        rows = pos + torch.arange(s, device=device)
        if cache["k"].dtype == torch.int8:
            k8, ks = _quantize(k)
            v8, vs = _quantize(v)
            cache["k"].index_copy_(1, rows, k8)
            cache["v"].index_copy_(1, rows, v8)
            cache["k_scale"].index_copy_(1, rows, ks)
            cache["v_scale"].index_copy_(1, rows, vs)
            k = (cache["k"].to(cfg.dtype)
                 * cache["k_scale"][..., None].to(cfg.dtype))
            v = (cache["v"].to(cfg.dtype)
                 * cache["v_scale"][..., None].to(cfg.dtype))
        else:
            cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
            k, v = cache["k"], cache["v"]
        t = k.shape[1]
        k_pos = torch.arange(t, device=device)
        valid = k_pos < (pos + s)
        k_pos = torch.where(valid, k_pos, -10 ** 9)
        cache["pos"].add_(s)
        if flash:
            # what the JAX package attends over, less the empty slots
            k, v = k[:, :s], v[:, :s]
    else:
        k_pos = k_pos_new
    return q, k, v, q_pos, k_pos


def _append_rows(cfg: ModelConfig, cache: Dict, k, v, rows, flash: bool):
    """The cache's append where it holds rows ``first .. first + count``
    of the sequence alone (``rows``): the new rows ``pos .. pos + s``
    that fall inside written at ``row - first`` (``_write_rows``), int8
    quantized per (token, KV head) as ``_prepare`` does; returns ``(k, v,
    k_pos)``: the local rows (dequantized from int8) at their global
    positions (invalid past ``pos + s``), or on the flash path the fresh
    rows as the cache holds them."""
    pos, s = cache["pos"], k.shape[1]
    first, count = rows
    dtype = cache["k"].dtype
    if dtype == torch.int8:
        (k8, ks), (v8, vs) = _quantize(k), _quantize(v)
        for name, new in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            _write_rows(cache[name], new, pos, first)
        if not flash:
            k8, ks = cache["k"], cache["k_scale"]
            v8, vs = cache["v"], cache["v_scale"]
        k = k8.to(cfg.dtype) * ks[..., None].to(cfg.dtype)
        v = v8.to(cfg.dtype) * vs[..., None].to(cfg.dtype)
    else:
        k, v = k.to(dtype), v.to(dtype)
        _write_rows(cache["k"], k, pos, first)
        _write_rows(cache["v"], v, pos, first)
        if not flash:
            k, v = cache["k"], cache["v"]
    k_pos = first + torch.arange(count, device=k.device)
    k_pos = torch.where(k_pos < pos + s, k_pos, -10 ** 9)
    cache["pos"].add_(s)
    return k, v, k_pos


def _write_rows(buf: torch.Tensor, new: torch.Tensor, pos,
                first: int) -> None:
    """Rows ``pos .. pos + s`` of the sequence, ``new`` (B, s, ...),
    written into ``buf`` (B, count, ...), which holds rows ``first ..
    first + count``: each row that falls inside at ``row - first``, the
    others nowhere.  ``pos`` stays on the device: a window of ``min(s,
    count)`` local rows, its start clamped into ``buf``, holds every row
    that falls inside; it is read, those rows replaced, and written back
    at its own (distinct) indices, so that a row outside the new ones is
    written its own value."""
    s, count = new.shape[1], buf.shape[1]
    n = min(s, count)
    start = torch.clamp(pos - first, 0, count - n)
    local = start + torch.arange(n, device=buf.device)
    src = local + (first - pos)
    inside = ((src >= 0) & (src < s)).view(1, n, *[1] * (buf.ndim - 2))
    fresh = new.index_select(1, src.clamp(0, s - 1)).to(buf.dtype)
    buf.index_copy_(1, local, torch.where(inside, fresh,
                                          buf.index_select(1, local)))


def _attend(cfg: ModelConfig, q, k, v, q_pos, k_pos, causal: bool, w,
            flash: bool, impl) -> torch.Tensor:
    """The attention of ``_prepare``'s outputs: flash, dense, or chunked
    past ``cfg.dense_attn_max_seq``."""
    s, t = q.shape[1], k.shape[1]
    if flash:
        return _flash(impl, q, k, v, causal, int(w))
    if s == 1 or (s <= cfg.dense_attn_max_seq
                  and t <= cfg.dense_attn_max_seq):
        bias = _mask_bias(q_pos, k_pos, causal, w)
        return _dense_attention(q, k, v, bias)
    return _chunked_attention_dynwin(q, k, v, q_pos, k_pos, causal, w,
                                     cfg.attn_block)


def _attend_placed(cfg: ModelConfig, norms, q, k, v, cache: Optional[Dict],
                   cross: bool, q_offset, causal: bool, w, flash: bool, impl
                   ) -> torch.Tensor:
    """``_prepare`` and ``_attend`` on the local shards of placed q, k, v
    (B, S, heads, D) and cache (its leaves updated in place, each rank
    its shard): the flash path through the partitioned
    ``impl.flash_attention``, the others with each rank's query heads
    against the KV heads they read (``_read``)."""
    mesh = q.device_mesh
    split = _seq_split(cache) if not cross else []
    if split:
        return _attend_split(cfg, norms, q, k, v, cache, q_offset, causal, w,
                             flash, impl, split)
    args = (q, k, v, norms, cache)
    if flash:
        def prepared(q, k, v, norms, cache):
            return _prepare(cfg, norms, q, k, v, cache, False, q_offset,
                            True)[:3]
        # q, k and v each reach their own output, each norm its own
        feeds = ([[0], [1], [2]] + ([[0], [1]] if norms else [[]])
                 + [[1, 2]] * len(tree_flatten(cache)[0]))
        q, k, v = on_shards(prepared, mesh, None, [q.placements,
                            k.placements, v.placements], *args,
                            feeds=feeds)
        return impl.flash_attention(q, k, v, cfg.n_heads, cfg.n_kv_heads,
                                    causal=causal, window=int(w))
    read = _read(cfg, mesh, q.placements, k.placements)

    def attended(q, k, v, norms, cache):
        q, k, v, q_pos, k_pos = _prepare(cfg, norms, q, k, v, cache, cross,
                                         q_offset, False)
        if read is not None:
            k, v = k[:, :, read], v[:, :, read]
        return (_attend(cfg, q, k, v, q_pos, k_pos, causal, w, False,
                        None),)
    return on_shards(attended, mesh, None, [q.placements], *args)[0]


def _seq_split(cache: Optional[Dict]) -> list:
    """The mesh dimensions whose placements split a placed cache's
    sequence (dimension 1 of a layer's (B, T, KV, D) keys), one-rank
    dimensions included; ``[]`` for a whole sequence or no cache."""
    if cache is None or not is_placed(cache["k"]):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(cache["k"].placements)
            if isinstance(p, Shard) and p.dim == 1]


def _attend_split(cfg: ModelConfig, norms, q, k, v, cache: Dict, q_offset,
                  causal: bool, w, flash: bool, impl, split: list
                  ) -> torch.Tensor:
    """``_attend_placed`` over a cache whose sequence is split on the mesh
    dimensions ``split``.  The fresh k and v are made whole there, laid
    out as the cache's rows otherwise, and each rank appends the new rows
    that fall in its shard (``_append_rows``).  A prefill's flash path
    attends over the fresh rows.  Otherwise the query heads are made
    whole there too, each rank takes the partial softmax of every query
    over its rows (``_partials``: the running max, denominator and
    accumulator, in float32) and the ranks merge them by log-sum-exp
    across ``split`` (``_merge``), each group of one rank too; the output
    is laid out as the queries were gathered (``attention`` then keeps
    each rank's heads, which moves nothing)."""
    from torch.distributed.tensor import Replicate
    mesh, ck = q.device_mesh, cache["k"]

    def whole(pl):
        return tuple(Replicate() if i in split else p
                     for i, p in enumerate(pl))
    kv_pl = whole(ck.placements)
    rows = shard_offset(mesh, ck.placements, 1, ck.shape[1])
    rest = [None] * (len(tree_flatten((norms, cache))[0]))
    args = (q, k, v, norms, cache)
    if flash:
        def prepared(q, k, v, norms, cache):
            return _prepare(cfg, norms, q, k, v, cache, False, q_offset,
                            True, rows)[:3]
        q, k, v = on_shards(prepared, mesh, [None, kv_pl, kv_pl] + rest,
                            [q.placements, kv_pl, kv_pl], *args)
        return impl.flash_attention(q, k, v, cfg.n_heads, cfg.n_kv_heads,
                                    causal=causal, window=int(w))
    q_pl = whole(q.placements)
    read = _read(cfg, mesh, q_pl, ck.placements)
    groups = [mesh.get_group(i) for i in split]
    t, dense = ck.shape[1], cfg.dense_attn_max_seq

    def max_all(x):
        for g in groups:
            x = _all_reduce(x, "max", g)
        return x

    def sum_all(x):
        for g in groups:
            x = _all_reduce(x, "sum", g)
        return x

    def attended(q, k, v, norms, cache):
        q, k, v, q_pos, k_pos = _prepare(cfg, norms, q, k, v, cache, False,
                                         q_offset, False, rows)
        if read is not None:
            k, v = k[:, :, read], v[:, :, read]
        s = q.shape[1]
        one_block = s == 1 or (s <= dense and t <= dense)
        parts = _partials(q, k, v, q_pos, k_pos, causal, w,
                          k.shape[1] if one_block else cfg.attn_block)
        return (_heads_last(_merge(*parts, max_all, sum_all), q),)
    return on_shards(attended, mesh, [q_pl, kv_pl, kv_pl] + rest, [q_pl],
                     *args)[0]


def _merge(m, l, acc, max_all, sum_all) -> torch.Tensor:
    """Softmax-weighted sums from partials ``(m, l, acc)`` over parts of
    the keys: ``max_all`` and ``sum_all`` reduce a tensor across the
    parts (all-reduces across ranks).  Each part's denominator and
    accumulator are rescaled to the global max and summed (the
    denominator beside the accumulator, one reduction), then divided.  A
    part whose keys are all masked (``m`` at ``NEG_INF``) adds exact
    zeros where another part holds a key; where none does, the whole
    softmax is as uniform as the unsplit one's."""
    top = max_all(m)
    corr = torch.exp(m - top)
    both = sum_all(torch.cat([acc * corr[..., None], (l * corr)[..., None]],
                             -1))
    return both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-30)


def _heads_last(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, KV, groups, S, D) weighted sums as q's (B, S, H, D), in q's
    type."""
    b, s, h, d = q.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _read(cfg: ModelConfig, mesh, q_pl, k_pl):
    """What this rank's query heads of q (B, S, H, D) placed by ``q_pl``
    read of its KV heads of k (B, T, KV, D) placed by ``k_pl``
    (``kv_heads_read``: where the KV heads do not divide the mesh axis,
    every rank holds them all)."""
    return kv_heads_read(shard_offset(mesh, q_pl, 2, cfg.n_heads),
                         shard_offset(mesh, k_pl, 2, cfg.n_kv_heads),
                         cfg.n_heads // cfg.n_kv_heads)


def _chunked_attention_dynwin(q, k, v, q_pos, k_pos, causal, window, block):
    """Chunked attention where ``window`` may be a tensor scalar."""
    m, l, acc = _partials(q, k, v, q_pos, k_pos, causal, window, block)
    return _heads_last(acc / torch.clamp_min(l[..., None], 1e-30), q)


def _partials(q, k, v, q_pos, k_pos, causal, window, block):
    """``(m, l, acc)``: the running max (B, KV, groups, S), denominator
    and accumulator (B, KV, groups, S, D) of each query's softmax over
    the keys, taken ``block`` keys at a time, in float32 (float64 for
    float64 inputs)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    groups = h // kvh
    nblk = -(-t // block)
    pad = nblk * block - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-10 ** 9)
    qg = q.reshape(b, s, kvh, groups, d)
    scale = 1.0 / math.sqrt(d)
    dq = q_pos[:, None]

    def bias_fn(pc):
        dk = pc[None, :]
        ok = torch.ones((s, pc.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= dk <= dq
        ok &= _in_window(dq, dk, window)
        ok &= dk >= 0
        return torch.where(ok, 0.0, NEG_INF)

    acc_t = torch.promote_types(q.dtype, torch.float32)
    m = torch.full((b, kvh, groups, s), NEG_INF, dtype=acc_t,
                   device=q.device)
    l = torch.zeros((b, kvh, groups, s), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, kvh, groups, s, d), dtype=acc_t, device=q.device)
    for i in range(nblk):
        sl = slice(i * block, (i + 1) * block)
        kc, vc, pc = k[:, sl], v[:, sl], k_pos[sl]
        logits = torch.einsum("bskgd,btkd->bkgst", qg, kc).to(acc_t)
        logits = logits * scale + bias_fn(pc)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q.dtype), vc).to(acc_t)
        m = m_new
    return m, l, acc


def attend_precomputed(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       rules: Optional[Rules], impl=ops) -> torch.Tensor:
    """Cross-attention against precomputed (encoder) K/V — no append, no
    mask (every encoder position is valid), no rope.  On ``DTensor``s
    (the cache's K/V laid out by ``launch.serve.cache_pspecs``) on the
    local shards, each rank's query heads against the KV heads they
    read."""
    b, s, _ = x.shape
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    q = linear(impl, x, _flat(p["wq"], d, h * hd)).reshape(b, s, h, hd)
    q = shard(q, rules, "batch", "seq", "act_heads", None)
    read = (_read(cfg, q.device_mesh, q.placements, k.placements)
            if is_placed(q) else None)

    def attended(q, k, v):
        if read is not None:
            k, v = k[:, :, read], v[:, :, read]
        bias = torch.zeros((q.shape[1], k.shape[1]), dtype=torch.float32,
                           device=q.device)
        return (_dense_attention(q, k, v, bias),)
    out = (on_shards(attended, q.device_mesh, None, [q.placements], q, k,
                     v) if is_placed(q) else attended(q, k, v))[0]
    out = shard(out, rules, "batch", "seq", "act_heads", None)
    y = linear(impl, out.reshape(b, s, h * hd), _flat(p["wo"], h * hd, d))
    return shard(y, rules, "batch", "seq", "act_embed")


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int,
                  max_len: int, rules: Optional[Rules] = None,
                  device="cuda") -> Dict:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def kv_cache_specs(cfg: ModelConfig, n_layers: int, batch: int,
                   max_len: int) -> Dict:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": TensorSpec(shape, cfg.dtype),
        "v": TensorSpec(shape, cfg.dtype),
        "pos": TensorSpec((), torch.int32),
    }
