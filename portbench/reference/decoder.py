"""A plain Llama-style decoder (SmolLM's ``LlamaForCausalLM``) in float32:
pre-norm RMSNorm blocks, grouped-query attention with rotary embeddings
(the halves rotated, as ``rotate_half`` does), a SiLU-gated MLP, a final
RMSNorm and the embedding tied as the head; its next-token loss and
AdamW's step.

Written from the configuration file alone.  The parameters are a tree
laid out as the benchmark hands them to both sides (``param_layout``):
``embed/embedding`` (vocab, d); in ``blk0`` each leaf stacked over the
layers: ``norm1/scale``, ``attn/wq`` (d, heads, hd), ``attn/wk`` and
``attn/wv`` (d, kv, hd), ``attn/wo`` (heads, hd, d), ``norm2/scale``,
``mlp/wg`` and ``mlp/wi`` (d, ff), ``mlp/wo`` (ff, d); ``final_norm/
scale``.  Every product goes through ``mm`` (``lowp.plain_matmul``, or
``lowp.products``' rounded ones for the control); attention's two products too.  In a
differentiated forward each layer is recomputed in the backward, so the
(B, H, S, S) weights of one layer at a time are live.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import lowp

Tree = Dict[str, object]


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int, int]:
    """``(layers, d, heads, kv, hd, ff, vocab)``."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], d, h, cfg["num_key_value_heads"],
            cfg.get("head_dim") or d // h, cfg["intermediate_size"],
            cfg["vocab_size"])


def param_layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every leaf as ``(path, shape, kind)``: kind ``normal`` (drawn with
    the configuration's ``initializer_range``) or ``ones``."""
    n, d, h, kv, hd, ff, v = dims(cfg)
    return [("embed/embedding", (v, d), "normal"),
            ("blk0/norm1/scale", (n, d), "ones"),
            ("blk0/attn/wq", (n, d, h, hd), "normal"),
            ("blk0/attn/wk", (n, d, kv, hd), "normal"),
            ("blk0/attn/wv", (n, d, kv, hd), "normal"),
            ("blk0/attn/wo", (n, h, hd, d), "normal"),
            ("blk0/norm2/scale", (n, d), "ones"),
            ("blk0/mlp/wg", (n, d, ff), "normal"),
            ("blk0/mlp/wi", (n, d, ff), "normal"),
            ("blk0/mlp/wo", (n, ff, d), "normal"),
            ("final_norm/scale", (d,), "ones")]


def flat(tree: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves of a tree by their ``a/b/c`` paths."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, path + "/"))
        else:
            out[path] = v
    return out


def nest(leaves: Dict[str, torch.Tensor]) -> Tree:
    out: Tree = {}
    for path, v in leaves.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) at positions 0 .. S-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) * 2 / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def layer(cfg: dict, lp: Dict[str, torch.Tensor], x: torch.Tensor, mm
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block on the float32 stream ``x`` (B, S, d); returns the new
    stream and the block's rotated keys and values (B, S, kv, hd)."""
    _, d, h, kv, hd, _, _ = dims(cfg)
    eps, b, s = cfg["rms_norm_eps"], x.shape[0], x.shape[1]
    a = rmsnorm(x, lp["norm1/scale"], eps).reshape(b * s, d)
    q = mm(a, lp["attn/wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = mm(a, lp["attn/wk"].reshape(d, kv * hd)).view(b, s, kv, hd)
    v = mm(a, lp["attn/wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = h // kv
    # query head j reads KV head j // g, as repeat_kv lays them out
    qh = q.permute(0, 2, 1, 3)                                # B H S hd
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    scores = mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = mm(w, vh).permute(0, 2, 1, 3).reshape(b * s, h * hd)
    x = x + mm(o, lp["attn/wo"].reshape(h * hd, d)).view(b, s, d)
    a = rmsnorm(x, lp["norm2/scale"], eps).reshape(b * s, d)
    f = F.silu(mm(a, lp["mlp/wg"])) * mm(a, lp["mlp/wi"])
    x = x + mm(f, lp["mlp/wo"]).view(b, s, d)
    return x, k, v


def hidden(cfg: dict, p: Dict[str, torch.Tensor], tokens: torch.Tensor, mm,
           remat: bool = False, keep_kv: bool = False):
    """The final norm's output (B, S, d) and, with ``keep_kv``, each
    layer's (k, v)."""
    x = p["embed/embedding"][tokens.long()]
    kvs = []
    for i in range(cfg["num_hidden_layers"]):
        lp = {k[len("blk0/"):]: v[i] for k, v in p.items()
              if k.startswith("blk0/")}
        if remat and torch.is_grad_enabled():
            x, k, v = checkpoint(layer, cfg, lp, x, mm, use_reentrant=False)
        else:
            x, k, v = layer(cfg, lp, x, mm)
        if keep_kv:
            kvs.append((k, v))
    return rmsnorm(x, p["final_norm/scale"], cfg["rms_norm_eps"]), kvs


def head(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["embed/embedding"].t()


def loss(cfg: dict, p: Dict[str, torch.Tensor], tokens: torch.Tensor,
         mm=lowp.plain_matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, S)."""
    x, _ = hidden(cfg, p, tokens, mm, remat=True)
    b, s, d = x.shape
    logits = mm(x[:, :-1].reshape(-1, d), head(p))
    return F.cross_entropy(logits, tokens[:, 1:].reshape(-1).long())


def adamw_steps(cfg: dict, params: Dict[str, torch.Tensor],
                batches: Sequence[torch.Tensor], opt: dict,
                mm=lowp.plain_matmul) -> dict:
    """AdamW (global-norm clipping first, decoupled weight decay, bias
    corrections; ``opt``: lr, b1, b2, eps, weight_decay, clip_norm) over
    ``batches`` from ``params`` (leaf path -> tensor, not changed), in
    float32.  Returns each step's loss, each leaf's first-gradient norm
    after clipping, and each leaf's change norm after the last step."""
    lowp.exact_products()
    p = {k: v.detach().float().clone().requires_grad_() for k, v in
         params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, lr = opt["b1"], opt["b2"], opt["lr"]
    losses, first = [], None
    for t, tokens in enumerate(batches, start=1):
        value = loss(cfg, p, tokens, mm)
        grads = torch.autograd.grad(value, list(p.values()))
        losses.append(float(value.detach()))
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        clip = min(1.0, opt["clip_norm"] / max(float(norm), 1e-9))
        if first is None:
            first = {k: float(g.double().norm()) * clip
                     for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                g = g * clip
                m[k].mul_(b1).add_((1 - b1) * g)
                v2[k].mul_(b2).add_((1 - b2) * g * g)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v2[k] / (1 - b2 ** t)
                w.sub_(lr * (mhat / (vhat.sqrt() + opt["eps"])
                             + opt["weight_decay"] * w))
    change = {k: float((w.detach().double() - params[k].double()).norm())
              for k, w in p.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


@torch.no_grad()
def last_logits(cfg: dict, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, mm=lowp.plain_matmul,
                keep_kv: bool = False):
    """The last position's logits (B, vocab) of each prompt, float32, and
    with ``keep_kv`` each layer's rotated keys and values."""
    lowp.exact_products()
    p = {k: v.float() for k, v in params.items()}
    x, kvs = hidden(cfg, p, tokens, mm, keep_kv=keep_kv)
    return mm(x[:, -1], head(p)), kvs
