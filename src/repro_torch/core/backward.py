"""Training-phase expansion — paper Sec. V.

``dx_conv`` / ``dw_conv`` implement the Table V tensor-transformation
formulas that turn the two Conv backward ops into *plain forward
convolutions* (dilate by S-1, pad by K-1, flip kernels, swap channel axes),
so they reuse the Sections IV-C/IV-D systolic models unchanged — including
kernel-dimension tiling, which is mandatory here because the dW-conv
"kernel" is S(OH-1)+1 wide (223x223 for early ResNet-50 layers).

``expand_training_graph`` turns an inference layer list into the full
forward + backward + parameter-update operation list of Table I.
"""
from __future__ import annotations

from typing import List, Union

from dataclasses import replace

from . import layers as L
from .layers import ConvLayer, GemmLayer, SimdLayer

Layer = Union[ConvLayer, GemmLayer, SimdLayer]

__all__ = ["dx_conv", "dw_conv", "dx_gemm", "dw_gemm",
           "expand_training_graph"]


def dx_conv(f: ConvLayer) -> ConvLayer:
    """Conv computing dL/dX^l (Table V, top half).

    ifmap  = dL/dX^{l+1} dilated by (S-1), padded by (K-1)   [N, IH^B, IW^B, OC^F]
    filter = W^l flipped, channel axes swapped               [Kh, Kw, OC^F, IC^F]
    ofmap  = dL/dX^l                                          [N, IH^F, IW^F, IC^F]
    """
    ih_b = f.s * (f.oh - 1) + 1 + 2 * (f.kh - 1)
    iw_b = f.s * (f.ow - 1) + 1 + 2 * (f.kw - 1)
    return ConvLayer(
        name=f"{f.name}.dX", n=f.n,
        ic=f.oc, ih=ih_b, iw=iw_b,
        oc=f.ic, oh=f.ih, ow=f.iw,
        kh=f.kh, kw=f.kw, s=1, has_bias=False,
        phase="bwd_dx", kind=f.kind)


def dw_conv(f: ConvLayer) -> ConvLayer:
    """Conv computing dL/dW^l (Table V, bottom half).

    ifmap  = X^l with (ic <-> n) swapped                      [IC^F, IH, IW, N^F]
    filter = dilated dL/dX^{l+1}                              [Kh^B, Kw^B, N^F, OC^F]
    ofmap  = dL/dW^l                                          [IC^F, Kh^F, Kw^F, OC^F]
    """
    kh_b = f.s * (f.oh - 1) + 1
    kw_b = f.s * (f.ow - 1) + 1
    return ConvLayer(
        name=f"{f.name}.dW", n=f.ic,
        ic=f.n, ih=f.ih, iw=f.iw,
        oc=f.oc, oh=f.kh, ow=f.kw,
        kh=kh_b, kw=kw_b, s=1, has_bias=False,
        phase="bwd_dw", kind=f.kind)


def dx_gemm(f: GemmLayer) -> GemmLayer:
    """GEMM computing dL/dX = dY . W^T: an [m x k] output reducing over
    n — the same M/N/K model with n and k swapped, so a dX GEMM whose
    swapped shape matches some forward GEMM shares its table column."""
    return replace(f, name=f"{f.name}.dX", n=f.k, k=f.n,
                   has_bias=False, phase="bwd_dx")


def dw_gemm(f: GemmLayer) -> GemmLayer:
    """GEMM computing dL/dW = X^T . dY: a [k x n] output reducing over
    the streamed dim m."""
    return replace(f, name=f"{f.name}.dW", m=f.k, k=f.m,
                   has_bias=False, phase="bwd_dw")


# Non-conv forward ops whose backward is modeled as a mirror-cost SIMD op
# (same iteration space and tensor traffic as the forward — first-order
# exact for elementwise/rotary ops and the standard softmax/norm backward
# recomputation schedules).  Parameterized norms additionally update
# their 1-D scale (and shift) vectors.
_MIRROR_OPS = ("softmax", "rotary", "rmsnorm", "layernorm", "conv1d")
_MIRROR_PREFIXES = ("act_", "gate_", "scan_")


def expand_training_graph(net: List[Layer]) -> List[Layer]:
    """Forward pass + backward pass + parameter updates (Table I).

    The backward pass walks the network in reverse.  Per layer:
      Conv/FC : dX conv (skipped for the input layer), dW conv, bias grad
                reduction (if biased), 4D weight update, 1D bias update.
      GEMM    : dX GEMM (dY.W^T) + dW GEMM (X^T.dY); weight/bias updates
                only for parameter GEMMs (``param=True``).
      Norms   : mirror-cost backward + 1D scale/shift updates; softmax/
                rotary/activations mirror without parameters.
      BN      : BN_back (Algorithm 1) + 1D scale/shift updates.
      ReLU    : relu_back.
      Pool    : pool_back (max routes through saved argmax; avg broadcasts).
      Add     : gradient junction = Tensor-add of the two incoming grads.
      GAP     : gap_back broadcast.
    """
    out: List[Layer] = list(net)
    # Positional, not identity-based: frozen layer dataclasses may be reused
    # (shape-identical blocks), so "the input layer" is the first conv *slot*.
    first_conv_pos = next((i for i, l in enumerate(net)
                           if isinstance(l, ConvLayer)), None)

    for pos in range(len(net) - 1, -1, -1):
        layer = net[pos]
        if isinstance(layer, ConvLayer):
            if pos != first_conv_pos:
                out.append(dx_conv(layer))
            out.append(dw_conv(layer))
            if layer.has_bias:
                out.append(L.bias_grad(f"{layer.name}.db", layer.oh, layer.ow,
                                       layer.n, layer.oc))
                out.append(L.param_update(f"{layer.name}.upd_b", layer.oc, 1))
            out.append(L.param_update(f"{layer.name}.upd_w",
                                      layer.weight_elems, 4))
        elif isinstance(layer, GemmLayer):
            # Both operand gradients are themselves GEMMs (dX = dY.W^T,
            # dW = X^T.dY); for activation-activation GEMMs (attention
            # scores, A.V — param=False) "dW" is just the other operand's
            # gradient and there is no parameter to update.
            out.append(dx_gemm(layer))
            out.append(dw_gemm(layer))
            if layer.param:
                if layer.has_bias:
                    out.append(L.bias_grad(f"{layer.name}.db", 1, 1,
                                           layer.m * layer.count, layer.n))
                    out.append(L.param_update(f"{layer.name}.upd_b",
                                              layer.n * layer.count, 1))
                out.append(L.param_update(
                    f"{layer.name}.upd_w",
                    layer.weight_elems * layer.count, 2))
        elif isinstance(layer, SimdLayer):
            if layer.op == "bn":
                out.append(L.bn_back(f"{layer.name}.back", layer.h, layer.w,
                                     layer.n, layer.c))
                out.append(L.param_update(f"{layer.name}.upd_g", layer.c, 1))
                out.append(L.param_update(f"{layer.name}.upd_b", layer.c, 1))
            elif layer.op == "relu":
                out.append(L.relu_back(f"{layer.name}.back", layer.h, layer.w,
                                       layer.n, layer.c))
            elif layer.op.startswith("pool_"):
                mode = layer.op.split("_")[1]
                r, s = (layer.pool_r or 2), (layer.pool_s or 2)
                out.append(L.pool_back(f"{layer.name}.back", layer.h, layer.w,
                                       layer.n, layer.c, r, s, mode))
            elif layer.op == "gap":
                out.append(L.gap_back(f"{layer.name}.back", layer.h, layer.w,
                                      layer.n, layer.c))
            elif layer.op == "tensor_add":
                out.append(L.tensor_add(f"{layer.name}.back", layer.h, layer.w,
                                        layer.n, layer.c, phase="bwd"))
            elif (layer.op in _MIRROR_OPS
                  or layer.op.startswith(_MIRROR_PREFIXES)):
                out.append(replace(layer, name=f"{layer.name}.back",
                                   phase="bwd"))
                if layer.op == "rmsnorm":
                    out.append(L.param_update(f"{layer.name}.upd_g",
                                              layer.c, 1))
                elif layer.op == "layernorm":
                    out.append(L.param_update(f"{layer.name}.upd_g",
                                              layer.c, 1))
                    out.append(L.param_update(f"{layer.name}.upd_b",
                                              layer.c, 1))
    return out
