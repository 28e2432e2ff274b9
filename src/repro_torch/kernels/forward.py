"""Model forwards driven through the port's kernel entry points
(``kernels.ops``), at the widths of two models the repository supports.

* A decoder-only transformer prefill (``decoder_forward``), laid out as
  the Qwen3 family: per layer, fused add + RMSNorm, one QKV projection,
  causal GQA flash attention, the output projection, fused add + RMSNorm,
  a SwiGLU MLP (gate, up, down); then a final fused add + RMSNorm and the
  tied LM head.  That is 5 GEMMs, 2 add+norms and 1 attention a layer,
  plus 1 GEMM and 1 add+norm.  Rotary embeddings and the q/k norms of
  Qwen3 are not applied: they run no kernel.  The whole model, on the
  same kernels, is ``models.transformer.Model``.
* ResNet-50's training forward as the kernels see it (``resnet50_calls``):
  each of its 53 BN layers is a ``bn_forward`` over (h*w*n, c), and each
  of its 54 convolutions (the FC layer included) a GEMM with M = n*oh*ow,
  K = kh*kw*ic, N = oc, the paper's Conv-as-GEMM (Sec. IV-B).

``impl`` is any object with the ``ops`` functions; ``PLAIN`` gives the
plain PyTorch versions on any device, against which the kernels are held.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

from ..configs import get_config
from ..core.layers import ConvLayer, SimdLayer
from ..core.networks import resnet50
from . import ops
from . import ref

PLAIN = SimpleNamespace(matmul=ref.matmul_ref,
                        fused_add_rmsnorm=ref.fused_add_rmsnorm_ref,
                        flash_attention=ref.flash_attention_ref,
                        bn_forward=ref.bn_forward_ref)


@dataclass(frozen=True)
class DecoderDims:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    n_layers: int


# Qwen3-0.6B (configs/qwen3_0_6b.py): 28 layers, d_model 1024, 16 heads,
# 8 KV heads, head_dim 128, d_ff 3072, vocabulary 151936, tied embeddings.
_QWEN3 = get_config("qwen3-0.6b")
QWEN3_0_6B = DecoderDims(d_model=_QWEN3.d_model, n_heads=_QWEN3.n_heads,
                         n_kv=_QWEN3.n_kv_heads, head_dim=_QWEN3.hd,
                         d_ff=_QWEN3.d_ff, vocab=_QWEN3.vocab_size,
                         n_layers=_QWEN3.n_layers)


def decoder_param_shapes(dims: DecoderDims,
                         n_layers: int) -> Dict[str, Tuple[tuple, float]]:
    """name -> (shape, standard deviation) of the decoder's parameters,
    for ``n_layers`` layers (``n_layers <= dims.n_layers`` cuts depth).
    Norm scales have mean 1 and the given deviation."""
    d, hd = dims.d_model, dims.head_dim
    qkv = (dims.n_heads + 2 * dims.n_kv) * hd
    out = {}
    for i in range(n_layers):
        out.update({
            f"l{i}.ln1": ((d,), 0.1),
            f"l{i}.wqkv": ((d, qkv), 1 / math.sqrt(d)),
            f"l{i}.wo": ((dims.n_heads * hd, d),
                         1 / math.sqrt(dims.n_heads * hd)),
            f"l{i}.ln2": ((d,), 0.1),
            f"l{i}.wg": ((d, dims.d_ff), 1 / math.sqrt(d)),
            f"l{i}.wu": ((d, dims.d_ff), 1 / math.sqrt(d)),
            f"l{i}.wd": ((dims.d_ff, d), 1 / math.sqrt(dims.d_ff)),
        })
    out["ln_f"] = ((d,), 0.1)
    # tied: the LM head is the embedding table, stored (d, vocab)
    out["embed"] = ((d, dims.vocab), 1 / math.sqrt(d))
    return out


def init_decoder_params(dims: DecoderDims, n_layers: int, seed: int,
                        device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random parameters from ``seed``, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for name, (shape, std) in decoder_param_shapes(dims, n_layers).items():
        t = torch.randn(shape, generator=gen, device=device) * std
        if name.split(".")[-1].startswith("ln"):
            t += 1.0
        params[name] = t.to(dtype)
    return params


def _heads(x: torch.Tensor, batch: int, heads: int, hd: int) -> torch.Tensor:
    """(batch*seq, heads*hd) -> (batch*heads, seq, hd), contiguous."""
    seq = x.shape[0] // batch
    return x.reshape(batch, seq, heads, hd).permute(0, 2, 1, 3) \
        .reshape(batch * heads, seq, hd).contiguous()


def decoder_forward(ids: torch.Tensor, params: Dict[str, torch.Tensor],
                    dims: DecoderDims, n_layers: int,
                    impl=ops) -> torch.Tensor:
    """Logits (batch*seq, vocab) of a causal prefill of token ids
    (batch, seq), through ``n_layers`` layers."""
    batch, seq = ids.shape
    h_, kv_, hd = dims.n_heads, dims.n_kv, dims.head_dim
    embed = params["embed"]
    x = embed.t()[ids.reshape(-1)]                      # (T, d)
    resid = torch.zeros_like(x)
    for i in range(n_layers):
        p = lambda name: params[f"l{i}.{name}"]         # noqa: E731
        y, resid = impl.fused_add_rmsnorm(x, resid, p("ln1"))
        qkv = impl.matmul(y, p("wqkv"))
        q = _heads(qkv[:, :h_ * hd], batch, h_, hd)
        k = _heads(qkv[:, h_ * hd:(h_ + kv_) * hd], batch, kv_, hd)
        v = _heads(qkv[:, (h_ + kv_) * hd:], batch, kv_, hd)
        a = impl.flash_attention(q, k, v, h_, kv_, causal=True)
        a = a.reshape(batch, h_, seq, hd).permute(0, 2, 1, 3) \
            .reshape(batch * seq, h_ * hd)
        x = impl.matmul(a, p("wo"))
        y, resid = impl.fused_add_rmsnorm(x, resid, p("ln2"))
        g = impl.matmul(y, p("wg"))
        u = impl.matmul(y, p("wu"))
        x = impl.matmul(torch.nn.functional.silu(g) * u, p("wd"))
    y, _ = impl.fused_add_rmsnorm(x, resid, params["ln_f"])
    return impl.matmul(y, embed)


def decoder_launches(dims: DecoderDims) -> Dict[str, int]:
    """Kernel launches of one full-depth forward, by kernel."""
    n = dims.n_layers
    return {"matmul": 5 * n + 1, "fused_add_rmsnorm": 2 * n + 1,
            "flash_attention": n}


def resnet50_calls(batch: int = 32) -> List[Tuple[str, str, tuple]]:
    """ResNet-50's kernel calls in execution order:
    ``("bn_forward", layer, (n_eff, c))`` for each BN layer and
    ``("matmul", layer, (m, k, n))`` for each convolution as a GEMM."""
    calls = []
    for layer in resnet50(batch=batch):
        if isinstance(layer, ConvLayer):
            calls.append(("matmul", layer.name,
                          (layer.n * layer.oh * layer.ow,
                           layer.kh * layer.kw * layer.ic, layer.oc)))
        elif isinstance(layer, SimdLayer) and layer.op == "bn":
            calls.append(("bn_forward", layer.name,
                          (layer.h * layer.w * layer.n, layer.c)))
    return calls


def resnet50_forward(calls, inputs: Dict[tuple, tuple], impl=ops) -> list:
    """Run each of ``calls`` (from ``resnet50_calls``) on the inputs kept
    for its shape: ``inputs[shape]`` is ``(x, gamma, beta)`` for a BN
    layer and ``(a, b)`` for a GEMM.  Returns the results in order."""
    return [getattr(impl, kind)(*inputs[shape]) for kind, _, shape in calls]
