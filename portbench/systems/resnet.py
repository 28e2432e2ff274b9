"""The ResNet family: the port's side (``repro_torch.kernels.training``'s
``Network``, its ``train_step`` and SGDM) and the plain reference's, on
the same weights and images.

``program_layers`` gives the port its layer list (``core.layers``
records, named as ``core.networks`` names them) from the configuration;
for ResNet-50 it equals ``core.networks.resnet50``'s.  Weights are float32
(He's normal for every convolution and the classifier, batch norm's gamma
1 + 0.1 N(0, 1), in each block's last batch norm times the configuration's
``init.last_bn_gamma_scale``, and beta 0.1 N(0, 1), the classifier's bias
0), drawn in one call on the device; the GEMMs run in the configuration's
type.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .. import gen
from ..reference import lowp
from ..reference import resnet as REF


def precision(cfg: dict) -> str:
    """The type the configuration's GEMMs run in."""
    return cfg["precision"]["gemm"]


def gemm_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, precision(cfg))


def products(cfg: dict, control: bool):
    return lowp.products(lowp.control_of(precision(cfg)) if control
                         else "exact")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    layout = REF.param_layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in layout]
    flat = torch.randn(sum(sizes), generator=gen.generator(
        seed, "weights", device), device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind), n in zip(layout, sizes):
        v = flat[off:off + n].view(shape)
        off += n
        if kind == "conv":
            out[name] = v * math.sqrt(2.0 / math.prod(shape[:3]))
        elif kind == "gamma":
            scale = cfg["init"]["last_bn_gamma_scale"] \
                if name.endswith(".c3.bn.gamma") else 1.0
            out[name] = (1 + 0.1 * v) * scale
        elif kind == "beta":
            out[name] = 0.1 * v
        else:
            out[name] = torch.zeros_like(v)
    return out


def program_layers(cfg: dict, n: int) -> List:
    """The port's layer list of the configured network at batch ``n``."""
    from repro_torch.core import layers as L

    def conv(name, ic, ih, oc, k, s, pad):
        oh = (ih + 2 * pad - k) // s + 1
        return L.ConvLayer(name=name, n=n, ic=ic, ih=ih, iw=ih, oc=oc,
                           oh=oh, ow=oh, kh=k, kw=k, s=s, has_bias=False)

    def bn(name, c, h, relu=True):
        net.append(L.batch_norm(f"{name}.bn", h, h, n, c))
        if relu:
            net.append(L.relu(f"{name}.relu", h, h, n, c))

    k, w0 = cfg["stem_kernel"], cfg["stem_width"]
    net = [conv("stem.conv", cfg["in_channels"], cfg["image_size"], w0, k, 2,
                k // 2)]
    h = net[-1].oh
    bn("stem", w0, h)
    h = (h + 2 - 3) // 2 + 1
    net.append(L.pool("stem.maxpool", h, h, n, w0, r=3, s=2))
    for name, cin, width, cout, stride, down in REF.blocks(cfg):
        ho = h // stride
        net.append(conv(f"{name}.c1", cin, h, width, 1, 1, 0))
        bn(f"{name}.c1", width, h)
        net.append(conv(f"{name}.c2", width, h, width, 3, stride, 1))
        bn(f"{name}.c2", width, ho)
        net.append(conv(f"{name}.c3", width, ho, cout, 1, 1, 0))
        bn(f"{name}.c3", cout, ho, relu=False)
        if down:
            net.append(conv(f"{name}.down", cin, h, cout, 1, stride, 0))
            bn(f"{name}.down", cout, ho, relu=False)
        net.append(L.tensor_add(f"{name}.add", ho, ho, n, cout))
        net.append(L.relu(f"{name}.out_relu", ho, ho, n, cout))
        h = ho
    net.append(L.global_avg_pool("gap", h, h, n, cout))
    net.append(L.fc("fc", n, cout, cfg["num_classes"]))
    return net


def _network(cfg, mix, weights, impl):
    from repro_torch.kernels import training as T
    return T.Network(program_layers(cfg, mix["batch"]), weights, impl=impl,
                     gemm_dtype=gemm_dtype(cfg))


class Train:
    """``train_step`` on the port's ``Network`` and its SGDM."""

    def __init__(self, cfg, mix, weights, device, impl):
        from repro_torch.kernels import training as T
        self.T = T
        self.net = _network(cfg, mix, weights, impl)
        o = mix["optimizer"]
        self.opt = T.make_optimizer(self.net, lr=o["lr"],
                                    momentum=o["momentum"])

    def step(self, batch) -> torch.Tensor:
        images, labels = batch
        return self.T.train_step(self.net, self.opt, images, labels)

    def first_grad_norms(self) -> Dict[str, float]:
        """After one step from zero momentum, the momentum is the
        gradient the optimizer was handed."""
        return {k: float(m.double().norm())
                for k, m in self.opt.state["mom"].items()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.net.params().items()}


class Infer:
    """``Network.forward`` without gradients (batch statistics)."""

    def __init__(self, cfg, mix, weights, device, impl):
        self.net = _network(cfg, mix, weights, impl)

    def infer(self, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(images)


def reference_train(cfg, mix, weights, batches: Sequence, control: bool
                    ) -> dict:
    o = mix["optimizer"]
    return REF.train_steps(cfg, weights, batches, o["lr"], o["momentum"],
                           conv=products(cfg, control)[1])


def reference_logits(cfg, weights, images, control: bool) -> torch.Tensor:
    return REF.logits(cfg, weights, images, conv=products(cfg, control)[1])


def conv_shapes(cfg: dict) -> List[Tuple[int, int, int, int, int]]:
    """``(oh, kh, ic, oc, needs_dx)`` of each convolution of one image,
    the classifier included."""
    k, w0 = cfg["stem_kernel"], cfg["stem_width"]
    h = (cfg["image_size"] + 2 * (k // 2) - k) // 2 + 1
    out = [(h, k, cfg["in_channels"], w0, False)]
    h = (h + 2 - 3) // 2 + 1
    for _, cin, width, cout, stride, down in REF.blocks(cfg):
        ho = h // stride
        out += [(h, 1, cin, width, True), (ho, 3, width, width, True),
                (ho, 1, width, cout, True)]
        if down:
            out.append((ho, 1, cin, cout, True))
        h = ho
    out.append((1, 1, cout, cfg["num_classes"], True))
    return out


def model_flops(cfg: dict, mix: dict) -> float:
    """The convolutions' and the classifier's operations for one batch:
    the forward, and in training each one's weight gradient and, but
    for the first (its input is the images), its input gradient."""
    fwd = dx = 0.0
    for oh, kh, ic, oc, needs_dx in conv_shapes(cfg):
        f = 2.0 * oh * oh * kh * kh * ic * oc
        fwd += f
        dx += f if needs_dx else 0.0
    per_image = fwd if mix["kind"] == "infer" else 2 * fwd + dx
    return per_image * mix["batch"]
