"""Model front-ends of the port: the cost-model lowering.

``lower_llm`` turns any registered ``ModelConfig`` — dense / MoE / SSM /
RG-LRU-hybrid / enc-dec — into a flat (GEMM + SIMD) layer graph the
SimDIT DSE engine prices like any CNN: attention/MLP/router/expert
projections become ``GemmLayer``s on the systolic array (k on the J
rows, n on the K columns, m streamed — no im2col), and softmax/norms/
rotary/activations/short-convs/scans route through the SIMD model
exactly like the paper's non-conv ops.  ``Workload(net="qwen3_0_6b")``
resolves through ``resolve_llm_config``, so every downstream feature
(objectives, refine, Pareto, phase attribution, store, backends) prices
LLM serving and training.

Stubs (the ``[audio]``/``[vlm]`` entries specify the transformer backbone
only): whisper-tiny consumes precomputed frame embeddings (batch,
encoder_seq, d_model) in place of its conv1d mel frontend; pixtral-12b
consumes precomputed patch embeddings (batch, n_patches, d_model)
prepended to the token stream (early fusion).
``frontend_input_specs`` gives their shapes, ``synth_frontend_inputs``
synthetic values for the model stack.

This is the port's own copy of the JAX package's ``models/frontends.py``,
the lowering the same layer for layer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import torch

from ..core import layers as L
from ..core.layers import GemmLayer, SimdLayer, gemm
from .common import ModelConfig, TensorSpec

LLM_SEQ_DEFAULT = 512

LlmLayer = Union[GemmLayer, SimdLayer]


def frontend_input_specs(cfg: ModelConfig, batch: int) -> Dict:
    """Extra abstract inputs the stubbed frontends inject."""
    out: Dict[str, TensorSpec] = {}
    if cfg.encoder_layers > 0:
        out["frames"] = TensorSpec((batch, cfg.encoder_seq, cfg.d_model),
                                   cfg.dtype)
    if cfg.n_patches > 0:
        out["patches"] = TensorSpec((batch, cfg.n_patches, cfg.d_model),
                                    cfg.dtype)
    return out


def synth_frontend_inputs(cfg: ModelConfig, batch: int,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> Dict:
    """Concrete synthetic embeddings (normal, std 0.02, in ``cfg.dtype``)
    on ``device``; ``generator`` defaults to seed 0 there.  The values
    differ from the JAX package's (another generator)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    out: Dict[str, torch.Tensor] = {}
    for name, spec in frontend_input_specs(cfg, batch).items():
        out[name] = torch.randn(spec.shape, generator=generator,
                                device=device, dtype=cfg.dtype) * 0.02
    return out


# ---------------------------------------------------------------------------
# Cost-model lowering: ModelConfig -> (GEMM + SIMD) layer graph
# ---------------------------------------------------------------------------

def llm_config_names() -> List[str]:
    """Every name ``resolve_llm_config`` accepts: the hyphenated arch ids
    plus their module-style (underscore) aliases."""
    from .. import configs
    return sorted(set(configs._MODULES) | set(configs._MODULES.values()))


def resolve_llm_config(name: str) -> Optional[ModelConfig]:
    """Resolve an arch id (``"gemma3-27b"``) or its module alias
    (``"gemma3_27b"``) to its ``ModelConfig``; ``None`` if unknown."""
    from .. import configs
    if name in configs._MODULES:
        return configs.get_config(name)
    inverse = {v: k for k, v in configs._MODULES.items()}
    if name in inverse:
        return configs.get_config(inverse[name])
    return None


def _norm(cfg: ModelConfig, name: str, tokens: int, d: int) -> SimdLayer:
    fn = L.layer_norm if cfg.norm_type == "layernorm" else L.rmsnorm
    return fn(name, tokens, d)


def _residual(name: str, tokens: int, d: int) -> SimdLayer:
    return L.tensor_add(name, tokens, 1, 1, d)


def _attention(cfg: ModelConfig, name: str, batch: int, s_q: int,
               s_kv: int, *, local: bool = False,
               cross: bool = False, rope: bool = True) -> List[LlmLayer]:
    """One attention sub-block: norm, q/k/v projections, (qk-norm,
    rotary), the two activation-activation GEMMs (scores, A·V) repeated
    per batch x query-head, softmax, out projection, residual.  GQA
    shares k/v across head groups (the k/v projections are
    ``n_kv_heads`` wide; the score/AV GEMM count stays batch x heads).
    ``local`` clips the attended length to the sliding window; ``cross``
    projects k/v from the (encoder) kv stream instead of the queries."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t_q = batch * s_q
    t_kv = batch * s_kv if cross else t_q
    s_att = min(cfg.window, s_kv) if local and cfg.window else s_kv
    out: List[LlmLayer] = [
        _norm(cfg, f"{name}.norm", t_q, D),
        gemm(f"{name}.q", t_q, H * hd, D),
        gemm(f"{name}.k", t_kv, Hkv * hd, D),
        gemm(f"{name}.v", t_kv, Hkv * hd, D),
    ]
    if cfg.qk_norm:
        out.append(L.rmsnorm(f"{name}.qnorm", t_q * H, hd))
        out.append(L.rmsnorm(f"{name}.knorm", t_kv * Hkv, hd))
    if rope and cfg.rope_fraction > 0:
        d_rot = max(1, int(hd * cfg.rope_fraction))
        out.append(L.rotary(f"{name}.rope_q", t_q * H, d_rot))
        out.append(L.rotary(f"{name}.rope_k", t_kv * Hkv, d_rot))
    out += [
        gemm(f"{name}.scores", s_q, s_att, hd, count=batch * H,
             param=False),
        L.softmax(f"{name}.softmax", batch * H * s_q, s_att),
        gemm(f"{name}.av", s_q, hd, s_att, count=batch * H, param=False),
        gemm(f"{name}.o", t_q, D, H * hd),
        _residual(f"{name}.res", t_q, D),
    ]
    return out


def _mlp(cfg: ModelConfig, name: str, tokens: int,
         gated: bool) -> List[LlmLayer]:
    D, F = cfg.d_model, cfg.d_ff
    out: List[LlmLayer] = [_norm(cfg, f"{name}.norm", tokens, D)]
    if gated:
        out += [gemm(f"{name}.gate", tokens, F, D),
                gemm(f"{name}.up", tokens, F, D),
                L.activation(f"{name}.act", tokens, F, cfg.act,
                             gated=True)]
    else:
        out += [gemm(f"{name}.fc1", tokens, F, D),
                L.activation(f"{name}.act", tokens, F, cfg.act)]
    out += [gemm(f"{name}.down", tokens, D, F),
            _residual(f"{name}.res", tokens, D)]
    return out


def _moe(cfg: ModelConfig, name: str, tokens: int) -> List[LlmLayer]:
    """Router + capacity-balanced expert GEMMs: each of the ``n_experts``
    identical expert MLPs processes ``ceil(tokens * top_k / n_experts)``
    tokens (the balanced-dispatch expectation the capacity factor
    enforces), expressed through ``GemmLayer.count``."""
    D, F, E, K = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    m_exp = max(1, math.ceil(tokens * K / E))
    out: List[LlmLayer] = [
        _norm(cfg, f"{name}.norm", tokens, D),
        gemm(f"{name}.router", tokens, E, D),
        L.softmax(f"{name}.route_sm", tokens, E),
        gemm(f"{name}.e_gate", m_exp, F, D, count=E),
        gemm(f"{name}.e_up", m_exp, F, D, count=E),
        L.activation(f"{name}.e_act", m_exp * E, F, cfg.act, gated=True),
        gemm(f"{name}.e_down", m_exp, D, F, count=E),
    ]
    if cfg.shared_expert:
        out += [gemm(f"{name}.s_gate", tokens, F, D),
                gemm(f"{name}.s_up", tokens, F, D),
                L.activation(f"{name}.s_act", tokens, F, cfg.act,
                             gated=True),
                gemm(f"{name}.s_down", tokens, D, F)]
    out.append(_residual(f"{name}.res", tokens, D))
    return out


def _mamba2(cfg: ModelConfig, name: str, batch: int,
            seq: int) -> List[LlmLayer]:
    """Mamba-2 mixer: in-projection (x, z, B, C, dt), short conv over the
    x/B/C channels, the SSD block expressed as its two per-head
    activation-activation GEMMs (state outer-product update and the
    output contraction against the carried state) plus the elementwise
    decay scan, gated merge, out-projection."""
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    nh = max(1, d_inner // cfg.ssm_head_dim)
    tokens = batch * seq
    d_conv = d_inner + 2 * cfg.ssm_state
    return [
        _norm(cfg, f"{name}.norm", tokens, D),
        gemm(f"{name}.in", tokens, 2 * d_inner + 2 * cfg.ssm_state + nh, D),
        L.conv1d(f"{name}.conv", tokens, d_conv, cfg.conv_width),
        gemm(f"{name}.ssd_state", seq, cfg.ssm_state, cfg.ssm_head_dim,
             count=batch * nh, param=False),
        L.elementwise_scan(f"{name}.scan", tokens,
                           nh * cfg.ssm_state, kind="ssm"),
        gemm(f"{name}.ssd_out", seq, cfg.ssm_head_dim, cfg.ssm_state,
             count=batch * nh, param=False),
        L.rmsnorm(f"{name}.gnorm", tokens, d_inner),
        L.activation(f"{name}.gate", tokens, d_inner, "silu", gated=True),
        gemm(f"{name}.out", tokens, D, d_inner),
        _residual(f"{name}.res", tokens, D),
    ]


def _rglru(cfg: ModelConfig, name: str, batch: int,
           seq: int) -> List[LlmLayer]:
    """RG-LRU recurrent mixer (recurrentgemma): two input branches, short
    conv, the input/recurrence gate projections (block-diagonal in the
    real model; priced dense as an upper bound), the elementwise gated
    recurrence, gated merge, out-projection."""
    D = cfg.d_model
    W = cfg.rnn_width or D
    tokens = batch * seq
    return [
        _norm(cfg, f"{name}.norm", tokens, D),
        gemm(f"{name}.in", tokens, 2 * W, D),
        L.conv1d(f"{name}.conv", tokens, W, cfg.conv_width),
        gemm(f"{name}.gates", tokens, 2 * W, W),
        L.elementwise_scan(f"{name}.scan", tokens, W, kind="rglru"),
        L.activation(f"{name}.gate", tokens, W, cfg.act, gated=True),
        gemm(f"{name}.out", tokens, D, W),
        _residual(f"{name}.res", tokens, D),
    ]


def lower_llm(cfg: ModelConfig, batch: int = 1,
              seq: Optional[int] = None) -> List[LlmLayer]:
    """Lower a model config to the flat (GEMM + SIMD) inference graph the
    DSE engine prices; ``expand_training_graph`` turns it into the
    training workload.  Embedding lookups are not modeled (pure DRAM
    gathers, no array work); the lm-head projection is.  VLM patch
    stubs extend the token stream (early fusion); enc-dec configs emit
    the encoder stack plus cross-attention in every decoder layer."""
    S = seq if seq is not None else LLM_SEQ_DEFAULT
    if S <= 0 or batch <= 0:
        raise ValueError(f"batch/seq must be positive, got {batch}/{S}")
    B = batch
    S = S + cfg.n_patches                   # early-fusion patch prefix
    D = cfg.d_model
    out: List[LlmLayer] = []
    gated = cfg.family not in ("audio", "encdec")
    for e in range(cfg.encoder_layers):
        enc = f"enc{e}"
        out += _attention(cfg, f"{enc}.attn", B, cfg.encoder_seq,
                          cfg.encoder_seq, rope=False)
        out += _mlp(cfg, f"{enc}.mlp", B * cfg.encoder_seq, gated)
    kinds = cfg.layer_kinds()
    pat = cfg.attn_pattern
    for i, kind in enumerate(kinds):
        blk = f"blk{i}"
        local = bool(pat) and pat[i % len(pat)] == "local"
        if kind.startswith("attn"):
            out += _attention(cfg, f"{blk}.attn", B, S, S, local=local,
                              rope=cfg.rope_fraction > 0)
            if cfg.encoder_layers:
                out += _attention(cfg, f"{blk}.xattn", B, S,
                                  cfg.encoder_seq, cross=True, rope=False)
        elif kind == "mamba2":
            out += _mamba2(cfg, blk, B, S)
        elif kind == "rglru":
            out += _rglru(cfg, blk, B, S)
        else:
            raise ValueError(f"unknown block kind {kind!r} in "
                             f"{cfg.name}: {kinds}")
        if "moe" in kind:
            out += _moe(cfg, f"{blk}.moe", B * S)
        elif cfg.d_ff:
            # every mixer is followed by an MLP when d_ff > 0 — this
            # covers hybrid patterns (recurrentgemma: MLP after rglru
            # and attn alike); pure-SSM configs set d_ff = 0
            out += _mlp(cfg, f"{blk}.mlp", B * S, gated)
    out.append(_norm(cfg, "final.norm", B * S, D))
    out.append(gemm("lm_head", B * S, cfg.vocab_size, D))
    return out
