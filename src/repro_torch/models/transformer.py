"""Unified model: assembles attention / Mamba2 / RG-LRU mixers with dense /
MoE FFNs into layer stacks -- the JAX package's ``models/transformer.py``
for all ten architectures: serving (``forward``, ``prefill``,
``decode_step``) and training (``loss``).

Layer stacking follows the JAX package: the layer list is ``cfg.pattern``
repeated; each *pattern position* ``gi`` is a homogeneous stack whose
parameters (``params['blk<gi>']``) carry a leading ``(groups,)`` axis, and
the remainder ``n_layers % len(pattern)`` layers (``rem<j>``) are
unrolled.  Where the JAX package scans the groups, this module loops over
the stacked slices in Python (``torch.unbind``, so that the backward
stacks each leaf's layer gradients once).

``cfg.remat`` (on by default, as in the JAX package; ``launch/train.py``
and ``launch/serve.py`` turn it off, as the JAX trainer and server do):
while autograd records and no cache is given, each group -- one period
of ``cfg.pattern``, the reference's ``group_step`` -- runs through
``torch.utils.checkpoint`` with ``cfg.remat_policy`` (``models/remat.py``:
``full``, ``save_dots``, ``save_mixer``; any other name is ``full``), its
carry ``(x, pending)`` and the summed aux loss; the remainder layers run
unwrapped, and each encoder layer is checkpointed with ``full``, as
there.  It changes memory and work, not values: a step's gradients are
bit-equal with and without it.  Serving (grad off, or a cache) is
never wrapped.

Caches mirror the parameter structure: ``cache['blk<i>']`` holds the
stacked per-layer state of pattern position i (KV buffer and position
``pos``, shape ``(groups,)``, for attention; the float32 SSD state and
conv tail for mamba2; the float32 recurrent state and conv tail for
RG-LRU), ``cache['rem<j>']`` the unrolled remainder's,
``cache['blk<i>']['_cross']`` the encoder KV of enc-dec models.  They
are updated in place.

Kernel routing (``impl``, ``kernels.ops`` by default; ``kernels.forward.
PLAIN`` gives the same model composed of the plain versions; a model
that is differentiated on the card takes ``kernels.ops.differentiable()``,
the same calls through autograd functions): every
product of activations with a weight goes through ``impl.matmul`` (the
mixers' projections, the MoE router and each expert's products among
them), the self-attention of a prefill through ``impl.flash_attention``
(``attention.attention``), and for ``norm_type == "rmsnorm"`` every
residual add followed by an RMSNorm through ``impl.fused_add_rmsnorm`` --
each block's norm2, the next block's norm1 and the final norm.  A block
therefore hands its last residual (``pending``) to the next norm instead
of adding it itself; the first norm1 adds a zero residual.  LayerNorm
configs add and normalize in plain PyTorch.  The SSD chunk einsums, the
RG-LRU scan, the convs and the MoE dispatch are plain PyTorch, as the
JAX package leaves them to XLA.

``forward``, ``prefill``, ``decode_step`` and ``loss`` take an optional
``routing`` (``moe.Routing``) that records or replays the MoE layers'
top-k choices, so that two kernel routes can be compared on the same
choices.

``loss`` is the JAX package's next-token cross-entropy over the same
stack plus 0.01 x the summed MoE aux loss, its LM head built inside the
caller's graph; ``ce_chunk > 0`` rematerializes one chunk of logits at a
time (``torch.utils.checkpoint`` where the JAX package uses
``jax.checkpoint``).

The partitioned route (``Model(cfg, impl=kernels.ops.partitioned(impl,
mesh, rules))``, parameters, batch and cache ``DTensor``s placed by the
rules, the counterpart of the reference's ``jax.jit(in_shardings=...)``)
runs the same code.  On the local shards (``local_map``): every kernel
(the partitioned namespace), the embedding lookup on the vocab-split
table, qk-norm, rotary embeddings, the cache's append and decode
attention (``attention._attend_placed``), the cross-entropy and the
greedy argmax over vocab-split logits (``layers.VocabParallelCE``,
``layers.greedy``), the MoE routing, dispatch, experts and combine with
the experts on ``data`` and an explicit all-to-all (``moe.py``), the SSD
mixer between its projections, each rank on its heads (``ssm.py``), the
RG-LRU block's conv and recurrence on its channels (``rglru.py``), the
cross-attention against the encoder's or the cache's K/V, and the rows
of a learned-position table (``_positions``: each rank cuts its shard's
rows, which are then gathered whole).  On the ``DTensor``s as PyTorch's
sharding propagation lays them out: the weights' reshapes and the tied
head's transpose, the heads' split and merge, ``unbind`` of the stacked
layers, the MLP's activation and product, the patch prefix's
concatenation and cut, the loss's chunk slices, its mean (replicated,
``_replicated``) and the optimizer; the chunked loss's pads and
concatenation run on the local shards (``_local``: PyTorch 2.11's
propagation of ``pad`` fails).  The encoder's K/V are written into the
cache's placed ``_cross`` buffers (``_write``), laid out as
``launch.serve.cache_pspecs`` lays them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from . import attention as ATT
from . import moe as MOE
from . import remat as REMAT
from . import rglru as RG
from . import ssm as SSM
from .common import (ModelConfig, ParamDef, Rules, TensorSpec,
                     abstract_params, init_params, is_placed, on_shards,
                     param_count, param_specs, shard)
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_defs,
                     embed_tokens, linear, lm_logits, mlp_defs, norm_defs)

def _mixer_kind(entry: str) -> str:
    return entry.split("+")[0]


def has_attention(cfg: ModelConfig) -> bool:
    """Whether any layer of ``cfg`` mixes by attention (and so keeps a KV
    cache and runs ``flash_attention``)."""
    return any(_mixer_kind(e) == "attn" for e in cfg.pattern)


def _is_moe(entry: str) -> bool:
    return entry.endswith("+moe")


_MIXERS = ("attn", "mamba2", "rglru")


def _check_entry(entry: str) -> None:
    """Raise ``ValueError`` for a pattern entry whose mixer the JAX
    package does not know either."""
    kind = _mixer_kind(entry)
    if kind not in _MIXERS:
        raise ValueError(kind)


def _block_defs(cfg: ModelConfig, entry: str, lead: Tuple[int, ...],
                cross: bool) -> Dict:
    _check_entry(entry)
    kind = _mixer_kind(entry)
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg, cfg.d_model, lead)}
    if kind == "attn":
        defs["attn"] = ATT.attn_defs(cfg, lead)
    elif kind == "mamba2":
        defs["ssm"] = SSM.ssm_defs(cfg, lead)
    else:
        defs["rglru"] = RG.rglru_defs(cfg, lead)
    if cross:
        defs["xnorm"] = norm_defs(cfg, cfg.d_model, lead)
        defs["xattn"] = ATT.attn_defs(cfg, lead, cross=True)
    if cfg.d_ff > 0:
        defs["norm2"] = norm_defs(cfg, cfg.d_model, lead)
        defs["mlp"] = (MOE.moe_defs(cfg, lead) if _is_moe(entry)
                       else mlp_defs(cfg, lead))
    return defs


def add_norm(cfg: ModelConfig, p: Dict, x: torch.Tensor,
             delta: Optional[torch.Tensor], impl=ops
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(norm(x + delta), x + delta)``; ``delta`` None adds nothing.

    RMSNorm goes through ``impl.fused_add_rmsnorm`` (a zero residual when
    ``delta`` is None).  In bfloat16 it normalizes the unrounded float32
    sum, where the JAX package rounds ``x + delta`` to bfloat16 first and
    normalizes that; the sum it returns is rounded once, as there.  In
    float32 the two are the same function.  LayerNorm adds and
    normalizes in plain PyTorch; on ``DTensor``s laid out as the
    partitioned ``fused_add_rmsnorm`` lays its stream: the sum on
    ``("batch", "seq_resid", "act_embed")`` (a row-parallel product's
    ``Partial`` residual reduce-scattered onto it), each rank normalizing
    its rows, the norm gathered to ``("batch", "seq", "act_embed")``
    once for its readers."""
    if cfg.norm_type != "rmsnorm":
        x = x if delta is None else x + delta
        if not is_placed(x):
            return apply_norm(cfg, p, x), x
        x = shard(x, impl.rules, "batch", "seq_resid", "act_embed")
        return shard(apply_norm(cfg, p, x), impl.rules, "batch", "seq",
                     "act_embed"), x
    delta = torch.zeros_like(x) if delta is None else delta
    if is_placed(x):
        # the partitioned namespace takes the (B, S, d) stream whole
        return impl.fused_add_rmsnorm(delta, x, p["scale"])
    rows = (-1, x.shape[-1])
    h, s = impl.fused_add_rmsnorm(delta.reshape(rows).contiguous(),
                                  x.reshape(rows).contiguous(), p["scale"])
    return h.reshape(x.shape), s.reshape(x.shape)


def _apply_block(cfg: ModelConfig, entry: str, p: Dict, x: torch.Tensor,
                 rules: Optional[Rules], *,
                 pending: Optional[torch.Tensor] = None,
                 window=None, cache: Optional[Dict] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 causal: Optional[bool] = None, impl=ops,
                 routing: Optional[MOE.Routing] = None,
                 fresh: bool = False,
                 tape: Optional[REMAT.Tape] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict],
                            Optional[torch.Tensor]]:
    """One block on the residual stream ``x + pending``.  Returns ``(x,
    pending, cache, aux)``: the stream is again ``x + pending``, the
    block's last residual not yet added (``add_norm`` of the next norm
    adds it); ``aux`` is the MoE aux loss, None for a dense FFN;
    ``fresh`` as in ``attention.attention``; ``tape``: the
    rematerialised group's (``models/remat.py``), told the mixer's
    output."""
    _check_entry(entry)
    kind = _mixer_kind(entry)
    aux = None
    # the cached cross-attention KV is read-only; the rest is the mixer's
    cross_kv = None if cache is None else cache.get("_cross")
    h, x = add_norm(cfg, p["norm1"], x, pending, impl)
    if kind == "attn":
        mix, cache = ATT.attention(cfg, p["attn"], h, rules, cache=cache,
                                   window=window, causal=causal, impl=impl,
                                   fresh=fresh)
    elif kind == "mamba2":
        mix, cache = SSM.apply_ssm(cfg, p["ssm"], h, rules, state=cache,
                                   impl=impl)
    else:
        mix, cache = RG.apply_rglru(cfg, p["rglru"], h, rules, state=cache,
                                    impl=impl)
    pending = mix
    if tape is not None:
        tape.mixer_out(mix)
    if "xattn" in p:
        hx, x = add_norm(cfg, p["xnorm"], x, pending, impl)
        if cross_kv is not None:
            pending = ATT.attend_precomputed(cfg, p["xattn"], hx,
                                             cross_kv["k"], cross_kv["v"],
                                             rules, impl=impl)
        else:
            pending, _ = ATT.attention(cfg, p["xattn"], hx, rules,
                                       kv_x=enc_out, causal=False,
                                       impl=impl)
    if cfg.d_ff > 0:
        h2, x = add_norm(cfg, p["norm2"], x, pending, impl)
        if _is_moe(entry):
            pending, aux = MOE.apply_moe(cfg, p["mlp"], h2, rules, impl,
                                         routing)
        else:
            pending = apply_mlp(cfg, p["mlp"], h2, rules, impl)
    return x, pending, cache, aux


def _serving(tokens: torch.Tensor):
    """The context a prefill or decode step runs in: inference mode, or
    on the partitioned route ``no_grad`` (a ``DTensor``'s views, the
    layers' slices among them, cannot be taken in inference mode)."""
    return torch.no_grad() if is_placed(tokens) else torch.inference_mode()


def _local(fn, *ts: torch.Tensor) -> torch.Tensor:
    """``fn(*ts)``; on ``DTensor``s, on their local shards, laid out as
    the first (``fn`` pads, cuts or joins only dimensions they do not
    split: PyTorch 2.11's sharding propagation of ``pad`` fails)."""
    if not is_placed(ts[0]):
        return fn(*ts)
    return on_shards(lambda *u: (fn(*u),), ts[0].device_mesh, None,
                     [ts[0].placements], *ts)[0]


def _positions(table: torch.Tensor, first, n: int) -> torch.Tensor:
    """Rows ``first .. first + n`` of a learned-position table (``first``
    an int or a 0-dim int tensor, the cache's ``pos_offset``).  On a
    placed table each rank cuts the rows of its shard (split on
    ``embed``), and the (n, d) rows are then gathered whole: every rank
    adds them to its rows of the stream."""
    def rows(tab, first):
        return (tab[first + torch.arange(n, device=tab.device)],)
    if not is_placed(table):
        return rows(table, first)[0]
    from torch.distributed.tensor import Replicate
    mesh = table.device_mesh
    out = on_shards(rows, mesh, None, [table.placements], table, first)[0]
    return out.redistribute(mesh, [Replicate()] * mesh.ndim)


def _write(buf: torch.Tensor, value: torch.Tensor) -> None:
    """``buf`` overwritten by ``value`` in place; on ``DTensor``s
    ``value`` is laid out as ``buf`` first and each rank writes its
    shard."""
    if is_placed(buf):
        value = value.redistribute(buf.device_mesh, buf.placements)
        buf, value = buf.to_local(), value.to_local()
    buf.copy_(value)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole on every rank where it is a ``DTensor`` (a loss that
    is a mean over rows split across ranks), else ``t``."""
    if not is_placed(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _index(tree, i: int):
    """Slice ``i`` of the leading axis of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> List:
    """The ``n`` slices of the leading axis of every leaf, as ``n`` trees
    of views; one ``unbind`` a leaf, whose backward stacks the slices'
    gradients in one pass (``n`` ``select``s would each write a
    gradient of the whole leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    impl: Any = field(default=ops, compare=False)
    # the context each rematerialised group's recompute runs in
    recompute_span: Any = field(default=REMAT.recompute_span,
                                compare=False, repr=False)
    # the tied head's contiguous (d, vocab) copy: (embedding, version, copy)
    _tied: Dict = field(default_factory=dict, init=False, compare=False,
                        repr=False)

    def __post_init__(self):
        for entry in self.pat:
            _check_entry(entry)

    # ---- structure ---------------------------------------------------------
    @property
    def pat(self) -> Tuple[str, ...]:
        return self.cfg.pattern

    @property
    def groups(self) -> int:
        return self.cfg.n_layers // len(self.pat)

    @property
    def remainder(self) -> int:
        return self.cfg.n_layers % len(self.pat)

    def _windows(self) -> List[int]:
        """Per-layer window sizes from cfg.attn_pattern (0 = full)."""
        cfg = self.cfg
        pat = cfg.attn_pattern or ("global",)
        return [cfg.window if pat[i % len(pat)] == "local" else 0
                for i in range(cfg.n_layers)]

    # ---- params ------------------------------------------------------------
    def param_defs(self) -> Dict:
        cfg = self.cfg
        cross = cfg.encoder_layers > 0
        defs: Dict[str, Any] = {"embed": embed_defs(cfg)}
        if cfg.learned_pos:
            defs["pos_emb"] = ParamDef((cfg.learned_pos, cfg.d_model),
                                       ("pos", "embed"))
        for gi, entry in enumerate(self.pat):
            if self.groups > 0:
                defs[f"blk{gi}"] = _block_defs(cfg, entry, (self.groups,),
                                               cross)
        for j in range(self.remainder):
            defs[f"rem{j}"] = _block_defs(cfg, self.pat[j], (), cross)
        defs["final_norm"] = norm_defs(cfg, cfg.d_model)
        if cross:
            defs["enc"] = {
                "blk": _block_defs(cfg, "attn", (cfg.encoder_layers,), False),
                "norm": norm_defs(cfg, cfg.d_model),
                "pos_emb": ParamDef((cfg.encoder_seq, cfg.d_model),
                                    ("pos", "embed")),
            }
        return defs

    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters on ``generator``'s device."""
        return init_params(generator, self.param_defs(), self.cfg.dtype)

    def abstract(self) -> Dict:
        return abstract_params(self.param_defs(), self.cfg.dtype)

    def n_params(self) -> int:
        return param_count(self.param_defs())

    def specs(self, rules: Optional[Rules]) -> Dict:
        return param_specs(self.param_defs(), rules)

    def head(self, params: Dict) -> torch.Tensor:
        """The LM head as a contiguous (d, vocab) tensor: ``head``, or the
        tied embedding's transpose, copied once for each embedding tensor
        (and again after an in-place update of it)."""
        emb = params["embed"]
        if "head" in emb:
            return emb["head"]
        table = emb["embedding"]
        version = None if table.is_inference() else table._version
        kept = self._tied.get("head")
        if kept is None or kept[0] is not table or kept[1] != version:
            kept = (table, version, table.t().contiguous())
            self._tied["head"] = kept
        return kept[2]

    # ---- encoder (enc-dec only) ---------------------------------------------
    def encode(self, params: Dict, frames: torch.Tensor,
               rules: Optional[Rules]) -> torch.Tensor:
        cfg = self.cfg
        x = frames.to(cfg.dtype)
        x = x + _positions(params["enc"]["pos_emb"], 0,
                           x.shape[1]).to(cfg.dtype)
        pending = None
        remat = REMAT.wanted(cfg, None)
        for p in _unbind(params["enc"]["blk"], cfg.encoder_layers):
            def layer(impl, tape, x, pending, p=p):
                x, pending, _, _ = _apply_block(cfg, "attn", p, x, rules,
                                                pending=pending,
                                                causal=False, impl=impl)
                if tape is not None:
                    tape.keep(pending)
                return x, pending
            if remat:
                # each layer, whatever the policy, as the reference does
                x, pending = REMAT.checkpointed(
                    layer, "full", self.impl, None, x, pending,
                    span=self.recompute_span)
            else:
                x, pending = layer(self.impl, None, x, pending)
        return add_norm(cfg, params["enc"]["norm"], x, pending,
                        self.impl)[0]

    # ---- main stacks ---------------------------------------------------------
    def _run_stack(self, params: Dict, x: torch.Tensor,
                   rules: Optional[Rules], cache: Optional[Dict],
                   enc_out: Optional[torch.Tensor],
                   routing: Optional[MOE.Routing] = None,
                   fresh: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[Dict], torch.Tensor]:
        """The layers on ``x``; returns ``(x, pending, cache, aux)`` (the
        stream is ``x + pending``; ``aux``: the MoE aux losses summed in
        layer order, a float32 0 without MoE).  Rematerialised
        (``REMAT.wanted``), each group runs through
        ``REMAT.checkpointed``."""
        cfg = self.cfg
        wins = self._windows()
        plen = len(self.pat)
        pending = None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        stacks = [_unbind(params[f"blk{gi}"], self.groups)
                  for gi in range(plen if self.groups else 0)]

        def run(layers, impl, routing, tape, x, pending, aux_total):
            for entry, p, i, csl in layers:
                x, pending, _, aux = _apply_block(
                    cfg, entry, p, x, rules, pending=pending,
                    window=wins[i], cache=csl, enc_out=enc_out, impl=impl,
                    routing=routing, fresh=fresh, tape=tape)
                if aux is not None:
                    aux_total = aux_total + aux
            return x, pending, aux_total

        groups = [[(entry, stacks[gi][g], g * plen + gi,
                    None if cache is None else _index(cache[f"blk{gi}"], g))
                   for gi, entry in enumerate(self.pat)]
                  for g in range(self.groups)]
        base = self.groups * plen
        rest = [(self.pat[j], params[f"rem{j}"], base + j,
                 None if cache is None else cache[f"rem{j}"])
                for j in range(self.remainder)]
        if not REMAT.wanted(cfg, cache):
            x, pending, aux_total = run(sum(groups, []) + rest, self.impl,
                                        routing, None, x, pending, aux_total)
            return x, pending, cache, aux_total
        for layers in groups:
            def group(impl, tape, *carry, layers=layers):
                out = run(layers, impl, tape, tape, *carry)
                tape.keep(out[1])
                return out
            x, pending, aux_total = REMAT.checkpointed(
                group, cfg.remat_policy, self.impl, routing, x, pending,
                aux_total, span=self.recompute_span)
        x, pending, aux_total = run(rest, self.impl, routing, None, x,
                                    pending, aux_total)
        return x, pending, cache, aux_total

    # ---- forward -------------------------------------------------------------
    def _final_hidden(self, params: Dict, tokens: torch.Tensor,
                      rules: Optional[Rules],
                      frames: Optional[torch.Tensor] = None,
                      patches: Optional[torch.Tensor] = None,
                      cache: Optional[Dict] = None,
                      routing: Optional[MOE.Routing] = None,
                      fresh: bool = False,
                      ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """The final norm's output (B, S, d), ``cache`` (updated in
        place) and the MoE aux loss summed over the layers."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, rules, cfg.dtype)
        if patches is not None:
            x = torch.cat([patches.to(cfg.dtype), x], dim=1)
        if cfg.learned_pos:
            off = cache["pos_offset"] if (cache is not None
                                          and "pos_offset" in cache) else 0
            x = x + _positions(params["pos_emb"], off,
                               x.shape[1]).to(cfg.dtype)

        enc_out = None
        if cfg.encoder_layers > 0 and frames is not None:
            enc_out = self.encode(params, frames, rules)

        x, pending, cache, aux = self._run_stack(params, x, rules, cache,
                                                 enc_out, routing, fresh)
        if cache is not None and "pos_offset" in cache:
            cache["pos_offset"].add_(x.shape[1])
        x, _ = add_norm(cfg, params["final_norm"], x, pending, self.impl)
        return x, cache, aux

    def forward(self, params: Dict, tokens: torch.Tensor,
                rules: Optional[Rules] = None,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None,
                routing: Optional[MOE.Routing] = None,
                fresh: bool = False,
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """Returns (logits_f32, cache, moe_aux_loss); ``cache`` is
        updated in place; ``routing`` records or replays the MoE
        choices (``moe.Routing``); ``fresh``: ``cache`` is a zero cache
        from ``make_cache`` (its positions 0 are then not read from the
        device)."""
        x, cache, aux = self._final_hidden(params, tokens, rules, frames,
                                           patches, cache, routing, fresh)
        logits = lm_logits(params["embed"], x, rules, self.impl,
                           head=self.head(params))
        return logits, cache, aux

    # ---- loss ------------------------------------------------------------------
    def loss(self, params: Dict, batch: Dict, rules: Optional[Rules] = None,
             routing: Optional[MOE.Routing] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy of ``batch["tokens"]`` (and
        ``frames`` / ``patches``) plus 0.01 x the aux loss; returns
        ``(loss, {"ce", "aux"})``, differentiable in ``params`` when the
        model's ``impl`` is (``kernels.ops.differentiable()`` on the
        card).  ``routing`` records or replays the MoE choices, as in
        ``forward``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        patches = batch.get("patches")
        x, _, aux = self._final_hidden(params, tokens, rules,
                                       frames=batch.get("frames"),
                                       patches=patches, routing=routing)
        if patches is not None:
            x = x[:, patches.shape[1]:]
        targets = tokens[:, 1:].long()
        x = x[:, :-1]
        # the head inside this graph (not ``Model.head``'s kept copy), so
        # that a tied embedding gets the head's gradient too
        emb = params["embed"]
        w = emb["head"] if "head" in emb else emb["embedding"].t().contiguous()

        def ce_of(xc, tc):
            return cross_entropy(linear(self.impl, xc, w).float(), tc)

        chunk = cfg.ce_chunk
        s = x.shape[1]
        if chunk and s > chunk:
            pad = (-s) % chunk
            xp = _local(lambda t: F.pad(t, (0, 0, 0, pad)), x)
            tp = _local(lambda t: F.pad(t, (0, pad)), targets)
            # the backward rematerializes one chunk of logits at a time:
            # only (B, chunk, V) of them is ever live
            ce = _local(lambda *parts: torch.cat(parts, 1)[:, :s], *[
                checkpoint(ce_of, xp[:, i:i + chunk], tp[:, i:i + chunk],
                           use_reentrant=False)
                for i in range(0, s + pad, chunk)])
        else:
            ce = ce_of(x, targets)
        ce = _replicated(ce.mean())
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ---- caches -----------------------------------------------------------------
    def _cache_entry(self, entry: str, lead: Tuple[int, ...], batch: int,
                     max_len: int, abstract: bool, device) -> Dict:
        cfg = self.cfg
        _check_entry(entry)
        kind = _mixer_kind(entry)
        mk = TensorSpec if abstract else (
            lambda s, d: torch.zeros(s, dtype=d, device=device))
        kv, hd = cfg.n_kv_heads, cfg.hd
        if kind == "attn":
            cdt = cfg.cache_dtype or cfg.dtype
            c = {"k": mk(lead + (batch, max_len, kv, hd), cdt),
                 "v": mk(lead + (batch, max_len, kv, hd), cdt),
                 "pos": mk(lead, torch.int32)}
            if cdt == torch.int8:
                c["k_scale"] = mk(lead + (batch, max_len, kv), torch.float32)
                c["v_scale"] = mk(lead + (batch, max_len, kv), torch.float32)
        elif kind == "mamba2":
            di, h, n = SSM.ssm_dims(cfg)
            c = {"ssm": mk(lead + (batch, h, cfg.ssm_head_dim, n),
                           torch.float32),
                 "conv": mk(lead + (batch, cfg.conv_width - 1, di + 2 * n),
                            torch.float32)}
        else:
            r = cfg.rnn_width or cfg.d_model
            c = {"h": mk(lead + (batch, r), torch.float32),
                 "conv": mk(lead + (batch, cfg.conv_width - 1, r),
                            torch.float32)}
        if cfg.encoder_layers > 0:
            c["_cross"] = {
                "k": mk(lead + (batch, cfg.encoder_seq, kv, hd), cfg.dtype),
                "v": mk(lead + (batch, cfg.encoder_seq, kv, hd), cfg.dtype)}
        return c

    def make_cache(self, batch: int, max_len: int, abstract: bool = False,
                   device="cuda") -> Dict:
        """A zero cache on ``device`` (``TensorSpec``s if ``abstract``)."""
        cache: Dict[str, Any] = {}
        for gi, entry in enumerate(self.pat):
            if self.groups > 0:
                cache[f"blk{gi}"] = self._cache_entry(
                    entry, (self.groups,), batch, max_len, abstract, device)
        for j in range(self.remainder):
            cache[f"rem{j}"] = self._cache_entry(
                self.pat[j], (), batch, max_len, abstract, device)
        if self.cfg.learned_pos:
            cache["pos_offset"] = TensorSpec((), torch.int32) if abstract \
                else torch.zeros((), dtype=torch.int32, device=device)
        return cache

    # ---- serving ---------------------------------------------------------------
    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int,
                rules: Optional[Rules] = None,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                routing: Optional[MOE.Routing] = None,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """The last position's logits and the filled cache; ``cache``: a
        zero cache of ``max_len`` rows to fill (a placed one,
        ``launch.serve.placed_cache``), made here by default."""
        with _serving(tokens):
            return self._prefill(params, tokens, max_len, rules, frames,
                                 patches, routing, cache)

    def _prefill(self, params, tokens, max_len, rules, frames, patches,
                 routing, cache):
        if cache is None:
            cache = self.make_cache(tokens.shape[0], max_len,
                                    device=tokens.device)
        if frames is not None and self.cfg.encoder_layers > 0:
            enc_out = self.encode(params, frames, rules)
            cache = self._fill_cross(params, cache, enc_out)
            logits, cache, _ = self.forward(params, tokens, rules,
                                            cache=cache, routing=routing,
                                            fresh=True)
        else:
            logits, cache, _ = self.forward(params, tokens, rules,
                                            patches=patches, cache=cache,
                                            routing=routing, fresh=True)
        # a copy, so that the (B, S, vocab) logits are freed
        return logits[:, -1].clone(memory_format=torch.contiguous_format), \
            cache

    def _fill_cross(self, params: Dict, cache: Dict,
                    enc_out: torch.Tensor) -> Dict:
        """Each decoder layer's cross-attention K/V of ``enc_out``,
        written into the cache's ``_cross`` buffers in place (placed
        ones in their own layout)."""
        cfg = self.cfg
        d, kvh, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
        b, t, _ = enc_out.shape

        def kv(p):
            k = linear(self.impl, enc_out, ATT._flat(p["wk"], d, kvh * hd))
            v = linear(self.impl, enc_out, ATT._flat(p["wv"], d, kvh * hd))
            return (k.reshape(b, t, kvh, hd).to(cfg.dtype),
                    v.reshape(b, t, kvh, hd).to(cfg.dtype))

        for gi in range(len(self.pat)):
            key = f"blk{gi}"
            if key in cache and "_cross" in cache[key]:
                pairs = [kv(_index(params[key]["xattn"], g))
                         for g in range(self.groups)]
                _write(cache[key]["_cross"]["k"],
                       torch.stack([k for k, _ in pairs]))
                _write(cache[key]["_cross"]["v"],
                       torch.stack([v for _, v in pairs]))
        for j in range(self.remainder):
            key = f"rem{j}"
            if key in cache and "_cross" in cache[key]:
                k, v = kv(params[key]["xattn"])
                _write(cache[key]["_cross"]["k"], k)
                _write(cache[key]["_cross"]["v"], v)
        return cache

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    rules: Optional[Rules] = None,
                    routing: Optional[MOE.Routing] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1) -> (logits (B, vocab), cache updated in place)."""
        with _serving(tokens):
            logits, cache, _ = self.forward(params, tokens, rules,
                                            cache=cache, routing=routing)
            return logits[:, -1].clone(
                memory_format=torch.contiguous_format), cache
