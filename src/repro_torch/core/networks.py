"""CNN workload graphs used in the paper's evaluation (Sec. VII):
ResNet-50, ResNet-18, VGG16, AlexNet, with per-layer tensor shapes matching
the standard torchvision/ONNX-Zoo topologies at 224x224 (AlexNet 227 via the
classic 11x11/4 arithmetic is normalized to the torchvision 224 variant).

Graphs are flat layer lists in execution order; residual topology is
represented by the Tensor-add layers the accelerator actually executes
(the paper models execution cost per layer, not graph routing).
"""
from __future__ import annotations

from typing import List, Union

from . import layers as L
from .layers import ConvLayer, SimdLayer, fc

Layer = Union[ConvLayer, SimdLayer]


def _conv(name: str, n: int, ic: int, ih: int, oc: int, k: int, s: int,
          pad: int, has_bias: bool) -> ConvLayer:
    oh = (ih + 2 * pad - k) // s + 1
    return ConvLayer(name=name, n=n, ic=ic, ih=ih, iw=ih, oc=oc, oh=oh, ow=oh,
                     kh=k, kw=k, s=s, has_bias=has_bias)


def _bn_relu(net: List[Layer], name: str, n: int, c: int, h: int,
             with_bn: bool = True, with_relu: bool = True) -> None:
    if with_bn:
        net.append(L.batch_norm(f"{name}.bn", h, h, n, c))
    if with_relu:
        net.append(L.relu(f"{name}.relu", h, h, n, c))


# BN is a *training-phase* layer in the paper (Sec. V-A: "inference is a
# subset of training ... In addition, it also includes a BN layer"); for
# inference BN folds into the preceding conv, so ResNet builders accept
# ``bn=False`` to emit the folded inference graph.


# ---------------------------------------------------------------------------
# ResNets
# ---------------------------------------------------------------------------

def _resnet_stem(net: List[Layer], n: int, bn: bool = True) -> int:
    net.append(_conv("stem.conv", n, 3, 224, 64, 7, 2, 3, has_bias=not bn))
    _bn_relu(net, "stem", n, 64, 112, with_bn=bn)
    net.append(L.pool("stem.maxpool", 56, 56, n, 64, r=3, s=2))
    return 56


def _bottleneck(net: List[Layer], name: str, n: int, h: int, cin: int,
                cmid: int, stride: int, bn: bool = True) -> int:
    cout = cmid * 4
    h_out = h // stride
    net.append(_conv(f"{name}.c1", n, cin, h, cmid, 1, 1, 0, has_bias=not bn))
    _bn_relu(net, f"{name}.c1", n, cmid, h, with_bn=bn)
    net.append(_conv(f"{name}.c2", n, cmid, h, cmid, 3, stride, 1, has_bias=not bn))
    _bn_relu(net, f"{name}.c2", n, cmid, h_out, with_bn=bn)
    net.append(_conv(f"{name}.c3", n, cmid, h_out, cout, 1, 1, 0, has_bias=not bn))
    _bn_relu(net, f"{name}.c3", n, cout, h_out, with_bn=bn, with_relu=False)
    if stride != 1 or cin != cout:
        net.append(_conv(f"{name}.down", n, cin, h, cout, 1, stride, 0,
                         has_bias=not bn))
        _bn_relu(net, f"{name}.down", n, cout, h_out, with_bn=bn, with_relu=False)
    net.append(L.tensor_add(f"{name}.add", h_out, h_out, n, cout))
    net.append(L.relu(f"{name}.out_relu", h_out, h_out, n, cout))
    return h_out


def _basicblock(net: List[Layer], name: str, n: int, h: int, cin: int,
                cout: int, stride: int, bn: bool = True) -> int:
    h_out = h // stride
    net.append(_conv(f"{name}.c1", n, cin, h, cout, 3, stride, 1, has_bias=not bn))
    _bn_relu(net, f"{name}.c1", n, cout, h_out, with_bn=bn)
    net.append(_conv(f"{name}.c2", n, cout, h_out, cout, 3, 1, 1, has_bias=not bn))
    _bn_relu(net, f"{name}.c2", n, cout, h_out, with_bn=bn, with_relu=False)
    if stride != 1 or cin != cout:
        net.append(_conv(f"{name}.down", n, cin, h, cout, 1, stride, 0,
                         has_bias=not bn))
        _bn_relu(net, f"{name}.down", n, cout, h_out, with_bn=bn, with_relu=False)
    net.append(L.tensor_add(f"{name}.add", h_out, h_out, n, cout))
    net.append(L.relu(f"{name}.out_relu", h_out, h_out, n, cout))
    return h_out


def resnet50(batch: int = 1, bn: bool = True) -> List[Layer]:
    n = batch
    net: List[Layer] = []
    h = _resnet_stem(net, n, bn)
    cfg = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
    cin = 64
    for si, (blocks, cmid, stride0) in enumerate(cfg):
        for bi in range(blocks):
            stride = stride0 if bi == 0 else 1
            h = _bottleneck(net, f"s{si}.b{bi}", n, h, cin, cmid, stride, bn)
            cin = cmid * 4
    net.append(L.global_avg_pool("gap", h, h, n, cin))
    net.append(fc("fc", n, cin, 1000))
    return net


def resnet18(batch: int = 1, bn: bool = True) -> List[Layer]:
    n = batch
    net: List[Layer] = []
    h = _resnet_stem(net, n, bn)
    cfg = [(2, 64, 1), (2, 128, 2), (2, 256, 2), (2, 512, 2)]
    cin = 64
    for si, (blocks, cout, stride0) in enumerate(cfg):
        for bi in range(blocks):
            stride = stride0 if bi == 0 else 1
            h = _basicblock(net, f"s{si}.b{bi}", n, h, cin, cout, stride, bn)
            cin = cout
    net.append(L.global_avg_pool("gap", h, h, n, cin))
    net.append(fc("fc", n, cin, 1000))
    return net


# ---------------------------------------------------------------------------
# VGG16 / AlexNet (classic, no BN; biased convs)
# ---------------------------------------------------------------------------

def vgg16(batch: int = 1, bn: bool = True) -> List[Layer]:
    n = batch
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    net: List[Layer] = []
    h, cin = 224, 3
    i = 0
    for v in cfg:
        if v == "M":
            h //= 2
            net.append(L.pool(f"pool{i}", h, h, n, cin, r=2, s=2))
        else:
            net.append(_conv(f"conv{i}", n, cin, h, v, 3, 1, 1, has_bias=True))
            net.append(L.relu(f"conv{i}.relu", h, h, n, v))
            cin = v
        i += 1
    net.append(fc("fc0", n, cin * h * h, 4096))
    net.append(L.relu("fc0.relu", 1, 1, n, 4096))
    net.append(fc("fc1", n, 4096, 4096))
    net.append(L.relu("fc1.relu", 1, 1, n, 4096))
    net.append(fc("fc2", n, 4096, 1000))
    return net


def alexnet(batch: int = 1, bn: bool = True) -> List[Layer]:
    n = batch
    net: List[Layer] = []
    net.append(_conv("conv0", n, 3, 224, 64, 11, 4, 2, has_bias=True))   # 55
    net.append(L.relu("conv0.relu", 55, 55, n, 64))
    net.append(L.pool("pool0", 27, 27, n, 64, r=3, s=2))
    net.append(_conv("conv1", n, 64, 27, 192, 5, 1, 2, has_bias=True))   # 27
    net.append(L.relu("conv1.relu", 27, 27, n, 192))
    net.append(L.pool("pool1", 13, 13, n, 192, r=3, s=2))
    net.append(_conv("conv2", n, 192, 13, 384, 3, 1, 1, has_bias=True))
    net.append(L.relu("conv2.relu", 13, 13, n, 384))
    net.append(_conv("conv3", n, 384, 13, 256, 3, 1, 1, has_bias=True))
    net.append(L.relu("conv3.relu", 13, 13, n, 256))
    net.append(_conv("conv4", n, 256, 13, 256, 3, 1, 1, has_bias=True))
    net.append(L.relu("conv4.relu", 13, 13, n, 256))
    net.append(L.pool("pool2", 6, 6, n, 256, r=3, s=2))
    net.append(fc("fc0", n, 256 * 6 * 6, 4096))
    net.append(L.relu("fc0.relu", 1, 1, n, 4096))
    net.append(fc("fc1", n, 4096, 4096))
    net.append(L.relu("fc1.relu", 1, 1, n, 4096))
    net.append(fc("fc2", n, 4096, 1000))
    return net


NETWORKS = {
    "resnet50": resnet50,
    "resnet18": resnet18,
    "vgg16": vgg16,
    "alexnet": alexnet,
}
