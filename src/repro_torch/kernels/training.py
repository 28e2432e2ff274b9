"""A ResNet training step driven through the port's kernel entry points
(``kernels.ops``): the training counterpart of ``kernels/forward.py``.

``Network`` builds ``nn.Module``s from a layer list of ``core.networks``
(``ConvLayer`` and ``SimdLayer``) and executes the operation list that
``core.backward.expand_training_graph`` prices (the paper's Table I):

* A convolution (the FC layer included) is im2col plus ``MatmulFn``: its
  forward GEMM ``(n*oh*ow, kh*kw*ic) @ (kh*kw*ic, oc)``, and in the
  backward the dX GEMM (none for the first convolution, whose input is
  the images) and the dW GEMM.  Activations are NHWC, so the GEMM's
  output rows are already batch norm's (N_eff, C) layout (Sec. V-C) and
  no permute is needed.  The padding, which ``ConvLayer`` does not store,
  is derived from ``ih``, ``oh``, the kernel and the stride.
* A BN layer is ``BatchNormFn``: ``bn_forward``, and ``bn_backward``
  (Algorithm 1) in the backward.
* ReLU, the max pool (padding derived as for a convolution: 1 at the
  ResNet stem), the residual add, global average pooling, the FC bias
  and the cross-entropy loss are plain PyTorch under autograd, as are
  im2col (``Tensor.unfold``) and its backward: no TPU kernel computes
  them.
* The residual wiring is read from ``_bottleneck``'s layer names
  (``core/networks.py``): ``<block>.c1`` and ``<block>.down`` read the
  block's input, and ``<block>.add`` sums the last output of the main
  branch (``.c3.bn``) with that of ``.down`` or with the block's input.

Weights are float32 and are cast to ``gemm_dtype`` for the GEMMs; BN runs
in float32.  ``gemm_dtype=torch.bfloat16`` is the timed step,
``torch.float32`` the step held tightly to its plain version (on the card
every float32 GEMM is full float32, no TF32).  The update is the port's
``SGDM`` with ResNet-50's recipe (Goyal et al. 2017): momentum 0.9 and
learning rate 0.1 * 32 / 256 for a batch of 32, constant.

``impl`` is any object with ``matmul``, ``bn_forward`` and
``bn_backward``: ``kernels.ops`` by default, ``PLAIN`` for the plain
PyTorch versions on any device.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import interop
from ..core.backward import expand_training_graph
from ..core.layers import ConvLayer, SimdLayer
from ..optim import SGDM, constant_schedule
from . import ops
from . import ref
from .bn import BatchNormFn
from .matmul import MatmulFn

__all__ = ["PLAIN", "LR", "MOMENTUM", "Network", "init_params",
           "params_from_numpy", "make_optimizer", "loss_and_grads",
           "train_step", "training_launches", "conv_padding",
           "pool_padding", "im2col", "relative_errors", "ReLU", "MaxPool"]

PLAIN = SimpleNamespace(matmul=ref.matmul_ref,
                        bn_forward=ref.bn_forward_ref,
                        bn_backward=ref.bn_backward_ref)

# Goyal et al. 2017: lr 0.1 for a batch of 256, scaled linearly to 32
LR = 0.1 * 32 / 256
MOMENTUM = 0.9


def _pad(i: int, o: int, k: int, s: int) -> int:
    """The symmetric zero padding p >= 0 with (i + 2p - k) // s + 1 == o."""
    p = max(0, -(-((o - 1) * s + k - i) // 2))
    if (i + 2 * p - k) // s + 1 != o:
        raise ValueError(f"no symmetric padding takes {i} to {o} with "
                         f"kernel {k}, stride {s}")
    return p


def conv_padding(layer: ConvLayer) -> Tuple[int, int]:
    """``(pad_h, pad_w)`` of a convolution, from its input and output
    sizes, its kernel and its stride."""
    return (_pad(layer.ih, layer.oh, layer.kh, layer.s),
            _pad(layer.iw, layer.ow, layer.kw, layer.s))


def pool_padding(layer: SimdLayer, ih: int) -> int:
    """Padding of a pooling layer with output ``layer.h`` from input
    ``ih`` (its window and stride are ``pool_r`` and ``pool_s``)."""
    return _pad(ih, layer.h, layer.pool_r, layer.pool_s)


def im2col(x: torch.Tensor, kh: int, kw: int, s: int, ph: int,
           pw: int) -> torch.Tensor:
    """Patches of NHWC ``x`` as a contiguous (n*oh*ow, kh*kw*c) matrix,
    ordered (kh, kw, c) like an HWIO weight flattened to (kh*kw*c, oc)."""
    n, _, _, c = x.shape
    if kh == kw == 1 and ph == pw == 0:
        if s != 1:
            x = x[:, ::s, ::s, :]
        return x.reshape(-1, c).contiguous()
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    patches = xp.unfold(1, kh, s).unfold(2, kw, s)   # (n, oh, ow, c, kh, kw)
    return patches.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c) \
        .contiguous()


class Conv(nn.Module):
    """A ``ConvLayer`` (FC included) as im2col and ``MatmulFn``; weight
    HWIO (kh, kw, ic, oc), bias (oc,) where the layer has one."""

    def __init__(self, layer: ConvLayer, params: Dict[str, torch.Tensor],
                 impl, gemm_dtype: torch.dtype):
        super().__init__()
        self.layer, self.impl, self.gemm_dtype = layer, impl, gemm_dtype
        self.pad = conv_padding(layer)
        self.weight = nn.Parameter(params[f"{layer.name}.w"].clone())
        self.bias = nn.Parameter(params[f"{layer.name}.b"].clone()) \
            if layer.has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.layer
        a = im2col(x.to(self.gemm_dtype), L.kh, L.kw, L.s, *self.pad)
        w = self.weight.to(self.gemm_dtype).reshape(-1, L.oc)
        y = MatmulFn.apply(a, w, self.impl)
        y = y.float() if self.bias is None else y + self.bias
        return y.view(x.shape[0], L.oh, L.ow, L.oc)


class BatchNorm(nn.Module):
    """A BN layer over the (N_eff, C) rows of an NHWC activation."""

    def __init__(self, layer: SimdLayer, params: Dict[str, torch.Tensor],
                 impl):
        super().__init__()
        self.impl = impl
        self.gamma = nn.Parameter(params[f"{layer.name}.gamma"].clone())
        self.beta = nn.Parameter(params[f"{layer.name}.beta"].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = BatchNormFn.apply(x.reshape(-1, x.shape[-1]), self.gamma,
                              self.beta, self.impl)
        return y.view(x.shape)


class ReLU(nn.Module):
    """ReLU; see ``Network.forward`` for ``decisions`` and ``pin``."""

    def forward(self, x: torch.Tensor, key: str, decisions=None,
                pin: bool = False) -> torch.Tensor:
        if pin:
            return x * decisions[key]
        if decisions is not None:
            decisions[key] = x > 0
        return torch.relu(x)


class MaxPool(nn.Module):
    """Max pooling of NHWC activations; see ``Network.forward`` for
    ``decisions`` and ``pin``."""

    def __init__(self, r: int, s: int, pad: int):
        super().__init__()
        self.r, self.s, self.pad = r, s, pad

    def forward(self, x: torch.Tensor, key: str, decisions=None,
                pin: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if pin:
            idx = decisions[key]
            y = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        else:
            y, idx = F.max_pool2d(x, self.r, self.s, self.pad,
                                  return_indices=True)
            if decisions is not None:
                decisions[key] = idx
        return y.permute(0, 2, 3, 1).contiguous()


class GlobalAvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2), keepdim=True)


def _branch(name: str) -> Tuple[Optional[str], Optional[str]]:
    """``("s1.b0", "c3")`` for ``s1.b0.c3.bn``: a bottleneck's block and
    branch, or ``(None, None)`` outside the blocks."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[2] in ("c1", "c2", "c3", "down", "add",
                                        "out_relu"):
        return ".".join(parts[:2]), parts[2]
    return None, None


class Network(nn.Module):
    """The layers of ``layers`` as modules, in execution order, with the
    parameters ``params`` (name -> tensor, as ``params_from_numpy``
    gives them).  ``forward`` takes NHWC images and returns the logits
    (n, classes)."""

    def __init__(self, layers: List, params: Dict[str, torch.Tensor],
                 impl=ops, gemm_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.layers = list(layers)
        mods = []
        h = next(l.ih for l in layers if isinstance(l, ConvLayer))
        block_h = h
        for layer in layers:
            blk = _branch(layer.name)[0]
            if isinstance(layer, ConvLayer):
                if layer.name == f"{blk}.c1":
                    block_h = h
                ih = block_h if layer.name == f"{blk}.down" else h
                if layer.ih != ih:
                    raise ValueError(f"{layer.name}: input size "
                                     f"{layer.ih}, activation {ih}")
                mods.append(Conv(layer, params, impl, gemm_dtype))
                h = layer.oh
            elif layer.op == "bn":
                mods.append(BatchNorm(layer, params, impl))
            elif layer.op == "relu":
                mods.append(ReLU())
            elif layer.op == "pool_max":
                mods.append(MaxPool(layer.pool_r, layer.pool_s,
                                    pool_padding(layer, h)))
                h = layer.h
            elif layer.op == "gap":
                mods.append(GlobalAvgPool())
                h = 1
            elif layer.op == "tensor_add":
                mods.append(nn.Identity())       # the sum is wired below
            else:
                raise NotImplementedError(f"{layer.name}: op {layer.op}")
        self.mods = nn.ModuleList(mods)

    def params(self) -> Dict[str, nn.Parameter]:
        """Every parameter by the name ``init_params`` gives it."""
        out = {}
        for layer, mod in zip(self.layers, self.mods):
            if isinstance(mod, Conv):
                out[f"{layer.name}.w"] = mod.weight
                if mod.bias is not None:
                    out[f"{layer.name}.b"] = mod.bias
            elif isinstance(mod, BatchNorm):
                out[f"{layer.name}.gamma"] = mod.gamma
                out[f"{layer.name}.beta"] = mod.beta
        return out

    def forward(self, images: torch.Tensor, decisions=None,
                pin: bool = False) -> torch.Tensor:
        """Logits of ``images``.  The step is piecewise smooth: each ReLU
        keeps the elements above 0 and each max pool routes its gradient
        to the element it picked.  ``decisions`` (a dict) records those
        choices by layer name; with ``pin`` the forward takes them from
        ``decisions`` instead (ReLU multiplies by the recorded mask, the
        pool gathers the recorded elements), so that two implementations
        can be compared on the same piece: rounding differences flip a
        few choices at near-ties, and each flip changes a gradient by a
        whole element."""
        x = images
        block_in, main, down = {}, {}, {}
        for layer, mod in zip(self.layers, self.mods):
            blk, branch = _branch(layer.name)
            if layer.name == f"{blk}.c1":
                block_in[blk] = x
            if branch == "add":
                x = main[blk] + down.get(blk, block_in[blk])
            elif layer.name == f"{blk}.down":
                x = mod(block_in[blk])
            elif isinstance(mod, (ReLU, MaxPool)):
                x = mod(x, layer.name, decisions, pin)
            else:
                x = mod(x)
            if branch == "down":
                down[blk] = x
            elif branch in ("c1", "c2", "c3"):
                main[blk] = x
        return x.reshape(x.shape[0], -1)


def init_params(layers: List, seed: int,
                zero_gamma: bool = False) -> Dict[str, np.ndarray]:
    """Random float32 parameters from a numpy ``Generator`` seeded with
    ``seed``: conv weights HWIO (kh, kw, ic, oc) with He's deviation
    sqrt(2 / (kh*kw*ic)), biases 0; BN gamma 1 + 0.1 N(0, 1) and beta
    0.1 N(0, 1), so that neither is the same in every channel.

    ``zero_gamma``: Goyal et al. (2017)'s init besides, gamma 0 in the
    last BN of each residual block's main branch (``.c3.bn`` of a
    bottleneck), so that every block starts as its shortcut; the other
    parameters are the same as without it."""
    rng = np.random.default_rng(seed)
    last_bn = {}
    for layer in layers:
        blk, branch = _branch(layer.name)
        if isinstance(layer, SimdLayer) and layer.op == "bn" and \
                branch in ("c1", "c2", "c3"):
            last_bn[blk] = layer.name
    out = {}
    for layer in layers:
        if isinstance(layer, ConvLayer):
            if layer.phase != "fwd":
                continue
            shape = (layer.kh, layer.kw, layer.ic, layer.oc)
            std = np.float32(np.sqrt(2.0 / (layer.kh * layer.kw * layer.ic)))
            out[f"{layer.name}.w"] = \
                rng.standard_normal(shape, dtype=np.float32) * std
            if layer.has_bias:
                out[f"{layer.name}.b"] = np.zeros(layer.oc, np.float32)
        elif isinstance(layer, SimdLayer) and layer.op == "bn":
            gamma = np.float32(1) + np.float32(0.1) \
                * rng.standard_normal(layer.c, dtype=np.float32)
            if zero_gamma and layer.name in last_bn.values():
                gamma = np.zeros(layer.c, np.float32)
            out[f"{layer.name}.gamma"] = gamma
            out[f"{layer.name}.beta"] = np.float32(0.1) \
                * rng.standard_normal(layer.c, dtype=np.float32)
    return out


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """``init_params``' arrays as tensors on ``device`` (``"cuda"`` for the
    kernels; ``"cpu"`` runs the step through the plain versions), bit for
    bit; the port keeps the same layouts (HWIO weights), so nothing is
    permuted."""
    return {k: interop.from_numpy(v, device) for k, v in arrays.items()}


def make_optimizer(net: Network, lr: float = LR,
                   momentum: float = MOMENTUM) -> SimpleNamespace:
    """The step's optimizer: ``rule`` (``SGDM`` with a constant
    schedule) and its ``state`` over the network's parameters."""
    rule = SGDM(constant_schedule(lr), momentum=momentum)
    return SimpleNamespace(rule=rule, state=rule.init(
        {k: p.detach() for k, p in net.params().items()}))


def loss_and_grads(net: Network, images: torch.Tensor, labels: torch.Tensor,
                   decisions=None, pin: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean cross-entropy loss of ``images`` (n, h, w, 3) against
    ``labels`` (n,), and every parameter's gradient (left in ``.grad``
    too); ``decisions`` and ``pin`` as for ``Network.forward``."""
    params = net.params()
    for p in params.values():
        p.grad = None
    logits = net(images, decisions, pin)
    loss = F.cross_entropy(logits.float(), labels)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}


def train_step(net: Network, opt: SimpleNamespace, images: torch.Tensor,
               labels: torch.Tensor, decisions=None) -> torch.Tensor:
    """One step: forward, backward, and the SGDM update of the network's
    parameters (written back in place; the gradients stay in ``.grad``).
    Returns the loss before the update.  ``decisions``, a dict, records
    the step's ReLU and pooling choices (``Network.forward``)."""
    loss, grads = loss_and_grads(net, images, labels, decisions)
    params = net.params()
    new, opt.state, _ = opt.rule.update(
        grads, opt.state, {k: p.detach() for k, p in params.items()})
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(new[k])
    return loss


def relative_errors(got: Dict[str, torch.Tensor],
                    want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Relative Frobenius error of each tensor of ``got`` against
    ``want``: ``|got - want| / |want|``, or ``|got - want|`` where
    ``want`` is 0."""
    out = {}
    for k, w in want.items():
        d = float((got[k].float() - w.float()).norm())
        n = float(w.float().norm())
        out[k] = d / n if n > 0 else d
    return out


def training_launches(layers: List) -> Dict[str, int]:
    """Kernel launches of one training step of ``layers``, counted on the
    operation list ``expand_training_graph`` makes of it: a ``matmul``
    for each convolution of phase fwd, bwd_dx and bwd_dw, a
    ``bn_forward`` for each ``bn`` layer and a ``bn_backward`` for each
    ``bn_back`` layer."""
    ops_ = expand_training_graph(list(layers))
    return {"matmul": sum(isinstance(l, ConvLayer) for l in ops_),
            "bn_forward": sum(isinstance(l, SimdLayer) and l.op == "bn"
                              for l in ops_),
            "bn_backward": sum(isinstance(l, SimdLayer)
                               and l.op == "bn_back" for l in ops_)}
