"""A plain ResNet (He et al. 2016, the bottleneck network with the stride
on the 3x3 convolution) and its SGD-with-momentum step, in float32.

Written from the configuration file alone: the stages, widths and
expansion build the network, and the parameters are named as the
benchmark hands them to both sides (``param_layout``): convolution
weights HWIO ``(kh, kw, ic, oc)``, each batch norm's ``gamma`` and
``beta``, the classifier's ``fc.w`` (1, 1, C, classes) and ``fc.b``.
Images are NHWC.  Batch norm normalises with the batch's statistics
(biased variance) and keeps no running ones.  Every product goes through
``conv`` (``lowp.plain_conv``, or ``lowp.products``' rounded one for the
control), so the
same code is the reference and the control.  Each bottleneck block is
recomputed in the backward (``torch.utils.checkpoint``), so that a step
at batch 256 holds only the blocks' inputs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import lowp

Layout = List[Tuple[str, Tuple[int, ...], str]]


def blocks(cfg: dict):
    """``(name, cin, width, cout, stride, has_down)`` of each bottleneck."""
    cin = cfg["stem_width"]
    out = []
    for si, (n, width) in enumerate(zip(cfg["layers"], cfg["widths"])):
        cout = width * cfg["expansion"]
        for bi in range(n):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out.append((f"s{si}.b{bi}", cin, width, cout, stride,
                        stride != 1 or cin != cout))
            cin = cout
    return out


def param_layout(cfg: dict) -> Layout:
    """Every parameter as ``(name, shape, kind)``, kind ``conv`` (He's
    normal), ``gamma``, ``beta`` or ``bias``, in execution order."""
    k, w0 = cfg["stem_kernel"], cfg["stem_width"]
    out: Layout = [("stem.conv.w", (k, k, cfg["in_channels"], w0), "conv")]

    def bn(name, c):
        out.extend([(f"{name}.gamma", (c,), "gamma"),
                    (f"{name}.beta", (c,), "beta")])
    bn("stem.bn", w0)
    for name, cin, width, cout, _, down in blocks(cfg):
        for conv, shape in (("c1", (1, 1, cin, width)),
                            ("c2", (3, 3, width, width)),
                            ("c3", (1, 1, width, cout))):
            out.append((f"{name}.{conv}.w", shape, "conv"))
            bn(f"{name}.{conv}.bn", shape[-1])
        if down:
            out.append((f"{name}.down.w", (1, 1, cin, cout), "conv"))
            bn(f"{name}.down.bn", cout)
    feat = blocks(cfg)[-1][3]
    out.append(("fc.w", (1, 1, feat, cfg["num_classes"]), "conv"))
    out.append(("fc.b", (cfg["num_classes"],), "bias"))
    return out


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def forward(cfg: dict, p: Dict[str, torch.Tensor], images: torch.Tensor,
            conv=lowp.plain_conv, remat: bool = False) -> torch.Tensor:
    """Logits (n, classes), float32, of NHWC ``images``."""
    eps = cfg["bn_eps"]

    def bn(x, name):
        return F.batch_norm(x, None, None, p[f"{name}.gamma"],
                            p[f"{name}.beta"], training=True, eps=eps)

    def cv(x, name, stride, pad):
        return conv(x, _oihw(p[f"{name}.w"]), stride, pad)

    k = cfg["stem_kernel"]
    x = images.float().permute(0, 3, 1, 2)
    x = torch.relu(bn(cv(x, "stem.conv", 2, k // 2), "stem.bn"))
    x = F.max_pool2d(x, 3, 2, 1)

    def block(x, name, stride, down):
        y = torch.relu(bn(cv(x, f"{name}.c1", 1, 0), f"{name}.c1.bn"))
        y = torch.relu(bn(cv(y, f"{name}.c2", stride, 1), f"{name}.c2.bn"))
        y = bn(cv(y, f"{name}.c3", 1, 0), f"{name}.c3.bn")
        sc = bn(cv(x, f"{name}.down", stride, 0), f"{name}.down.bn") \
            if down else x
        return torch.relu(y + sc)

    for name, _, _, _, stride, down in blocks(cfg):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, name, stride, down, use_reentrant=False)
        else:
            x = block(x, name, stride, down)
    x = x.mean(dim=(2, 3))
    logits = conv(x[:, :, None, None], _oihw(p["fc.w"]), 1, 0)
    return logits.flatten(1) + p["fc.b"]


def train_steps(cfg: dict, params: Dict[str, torch.Tensor],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                lr: float, momentum: float, conv=lowp.plain_conv) -> dict:
    """SGD with momentum (``m = momentum m + g``, ``p -= lr m``) over
    ``batches`` from float32 ``params`` (not changed).  Returns each
    step's loss, each leaf's first-gradient norm and each leaf's change
    norm after the last step."""
    lowp.exact_products()
    p = {k: v.detach().float().clone().requires_grad_() for k, v in
         params.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for images, labels in batches:
        loss = F.cross_entropy(forward(cfg, p, images, conv, remat=True),
                               labels.long())
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(g.double().norm()) for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                mom[k].mul_(momentum).add_(g)
                v.sub_(lr * mom[k])
    change = {k: float((v.detach().double() - params[k].double()).norm())
              for k, v in p.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


@torch.no_grad()
def logits(cfg: dict, params: Dict[str, torch.Tensor], images: torch.Tensor,
           conv=lowp.plain_conv) -> torch.Tensor:
    lowp.exact_products()
    p = {k: v.float() for k, v in params.items()}
    return forward(cfg, p, images, conv)
