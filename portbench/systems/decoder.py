"""The Llama-style decoder family: the port's side (``repro_torch.models.
transformer.Model`` through ``launch/train.py::make_train_step`` with
AdamW, and ``launch/serve.py::make_prefill_step``) and the plain
reference's, on the same weights and tokens.

``program_config`` gives the port its ``ModelConfig`` from the
configuration file; for SmolLM-360M it equals ``configs.get_config(
"smollm-360m")`` in the configuration's type and without remat.  Weights
are drawn in the configuration's type with its ``initializer_range``
(HF's normal init), the norms' scales 1, every normal leaf from one call
on the device.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from .. import gen
from ..reference import decoder as REF
from ..reference import lowp

# the port's RMSNorm (models/layers.py, kernels/csrc/fused_addnorm.cu)
PORT_RMS_EPS = 1e-6


def precision(cfg: dict) -> str:
    return cfg["dtype"]


def dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, precision(cfg))


def products(cfg: dict, control: bool):
    return lowp.products(lowp.control_of(precision(cfg)) if control
                         else "exact")


def program_config(cfg: dict):
    """The port's ``ModelConfig``; raises where the file asks for what
    the port does not run."""
    from repro_torch.models.common import ModelConfig
    if cfg["hidden_act"] != "silu" or not cfg["tie_word_embeddings"] or \
            cfg["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError("the port runs SiLU, a tied head and RMSNorm's "
                         f"eps {PORT_RMS_EPS}")
    n, d, h, kv, hd, ff, v = REF.dims(cfg)
    return ModelConfig(name=cfg["name"], family="dense", n_layers=n,
                       d_model=d, n_heads=h, n_kv_heads=kv, d_ff=ff,
                       vocab_size=v, head_dim=0 if hd == d // h else hd,
                       rope_theta=cfg["rope_theta"], tie_embeddings=True,
                       dtype=dtype(cfg), remat=False)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Leaf path -> tensor, in the configuration's type."""
    layout = REF.param_layout(cfg)
    normal = [(p, s) for p, s, kind in layout if kind == "normal"]
    flat = torch.randn(sum(math.prod(s) for _, s in normal),
                       generator=gen.generator(seed, "weights", device),
                       device=device, dtype=dtype(cfg))
    out, off = {}, 0
    for path, shape, kind in layout:
        if kind == "ones":
            out[path] = torch.ones(shape, dtype=dtype(cfg), device=device)
            continue
        n = math.prod(shape)
        out[path] = flat[off:off + n].view(shape) * cfg["initializer_range"]
        off += n
    return out


class Train:
    """``make_train_step`` on ``Model(cfg, impl=ops.differentiable(impl))``
    with the port's AdamW at the mix's settings (a constant rate)."""

    def __init__(self, cfg, mix, weights, device, impl):
        from repro_torch.kernels import ops
        from repro_torch.launch import train as TR
        from repro_torch.models.transformer import Model
        from repro_torch.optim import AdamW, constant_schedule
        o = mix["optimizer"]
        self.b1 = o["b1"]
        model = Model(program_config(cfg), impl=ops.differentiable(impl))
        opt = AdamW(schedule=constant_schedule(o["lr"]), b1=o["b1"],
                    b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
        params = TR.trainable(REF.nest(weights))
        self.state = {"params": params, "opt": opt.init(params)}
        self.fn = TR.make_train_step(model, opt, None)

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        self.state, metrics = self.fn(self.state, {"tokens": tokens})
        return metrics["loss"]

    def first_grad_norms(self) -> Dict[str, float]:
        """After one step from zero moments, m = (1 - b1) g, g the
        clipped gradient the update was made from."""
        return {k: float(m.double().norm()) / (1 - self.b1)
                for k, m in REF.flat(self.state["opt"]["m"]).items()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in
                REF.flat(self.state["params"]).items()}


class Prefill:
    """``make_prefill_step`` on ``Model(cfg, impl=impl)``: the last
    position's logits and a cache of exactly the prompt's rows; the
    served token is the port's ``greedy`` of those logits."""

    def __init__(self, cfg, mix, weights, device, impl):
        from repro_torch.launch.serve import make_prefill_step
        from repro_torch.models.layers import greedy
        from repro_torch.models.transformer import Model
        model = Model(program_config(cfg), impl=impl)
        self.params = REF.nest(weights)
        self.steps = {n: make_prefill_step(model, None, n)
                      for n in mix["lengths"]}
        self.greedy = greedy

    def prefill(self, tokens: torch.Tensor):
        """``(tokens (B,) int32, cache)``."""
        logits, cache = self.steps[tokens.shape[1]](self.params,
                                                    {"tokens": tokens})
        return self.greedy(logits), cache

    @staticmethod
    def kv(cache: dict, row: int) -> torch.Tensor:
        """Row ``row``'s keys and values: (2, layers, S, kv, hd)."""
        c = cache["blk0"]
        return torch.stack([c["k"][:, row], c["v"][:, row]])


def reference_train(cfg, mix, weights, batches: Sequence, control: bool
                    ) -> dict:
    return REF.adamw_steps(cfg, weights, batches, mix["optimizer"],
                           mm=products(cfg, control)[0])


def reference_prefill(cfg, weights32, tokens, control: bool,
                      keep_kv: bool = False):
    """The last logits (B, vocab) and, with ``keep_kv``, the keys and
    values (2, layers, B, S, kv, hd), from float32 weights."""
    logits, kvs = REF.last_logits(cfg, weights32, tokens,
                                  mm=products(cfg, control)[0],
                                  keep_kv=keep_kv)
    if not keep_kv:
        return logits, None
    return logits, torch.stack([torch.stack([k for k, _ in kvs]),
                                torch.stack([v for _, v in kvs])])


def layer_flops_per_token(cfg: dict) -> float:
    n, d, h, kv, hd, ff, _ = REF.dims(cfg)
    return 2.0 * n * (2 * d * h * hd + 2 * d * kv * hd + 3 * d * ff)


def attention_flops(cfg: dict, s: int) -> float:
    """QK^T and PV of one causal sequence of ``s`` tokens, every layer."""
    n, _, h, _, hd, _, _ = REF.dims(cfg)
    return 2.0 * n * h * hd * s * (s + 1)


def model_flops(cfg: dict, mix: dict, batch: int = 0, seq: int = 0) -> float:
    """A training step of the mix's batch (forward and backward: 3x the
    forward, the head over the S - 1 positions with a target), or one
    prefill of ``batch`` prompts of ``seq`` tokens (the head at the last
    position only)."""
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    if mix["kind"] == "train":
        b, s = mix["batch"], mix["seq"]
        return 3 * b * (s * layer_flops_per_token(cfg)
                        + attention_flops(cfg, s) + (s - 1) * head)
    return batch * (seq * layer_flops_per_token(cfg)
                    + attention_flops(cfg, seq) + head)
