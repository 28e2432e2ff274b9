"""The plain reference against the port's plain route (its kernels' CPU
versions) at CPU size in float32, and the port's models built from the
configuration files equal to the port's own."""
from __future__ import annotations

import pytest
import torch

from portbench import check, gen, spec
from portbench.reference import decoder as RD
from portbench.reference import lowp
from portbench.reference import resnet as RR
from portbench.systems import decoder as SD
from portbench.systems import resnet as SR
from portbench.tests import tiny


def test_resnet50_layers_are_the_ports():
    from repro_torch.core import networks
    cfg = spec.cell("resnet50.train").config
    assert SR.program_layers(cfg, 4) == networks.resnet50(batch=4)
    assert [(n, s) for n, s, _ in RR.param_layout(cfg)] == [
        (k, tuple(v.shape)) for k, v in SR.make_weights(cfg, 1, "cpu")
        .items()]


@pytest.mark.parametrize("cell", ["smollm-360m.train", "smollm-360m.prefill_over"])
def test_smollm_config_is_the_ports(cell):
    from repro_torch.configs import get_config
    cfg = spec.cell(cell).config
    want = get_config("smollm-360m").replace(
        name=cfg["name"], dtype=getattr(torch, cfg["dtype"]), remat=False)
    assert SD.program_config(cfg) == want


def test_resnet_reference_step_follows_the_port():
    from repro_torch.kernels import training as T
    c = tiny.cell("resnet50.train")
    w = SR.make_weights(c.config, 3, "cpu")
    pool = gen.pool(c.config, c.mix, 3, "cpu")
    net = T.Network(SR.program_layers(c.config, c.mix["batch"]), w,
                    gemm_dtype=torch.float32)
    opt = T.make_optimizer(net, lr=0.1, momentum=0.9)
    losses = [float(T.train_step(net, opt, *pool[i])) for i in range(2)]
    ref = RR.train_steps(c.config, w, pool[:2], 0.1, 0.9)
    # float32 sums in another order, grown through a step at lr 0.1
    assert losses == pytest.approx(ref["losses"], rel=1e-4)
    after = {k: p.detach() for k, p in net.params().items()}
    for k in w:
        got = float((after[k].double() - w[k].double()).norm())
        assert got == pytest.approx(ref["change_norms"][k], rel=1e-4,
                                    abs=1e-7)
    assert check.rows(net(pool[0][0]).detach(),
                      RR.logits(c.config, after, pool[0][0])) < 1e-5


def test_decoder_reference_step_follows_the_port():
    c = tiny.cell("smollm-360m.train")
    w = SD.make_weights(c.config, 4, "cpu")
    pool = gen.pool(c.config, c.mix, 4, "cpu")
    from repro_torch.kernels import ops
    prog = SD.Train(c.config, c.mix, w, "cpu", ops)
    losses = [float(prog.step(pool[0]))]
    grads = prog.first_grad_norms()
    losses.append(float(prog.step(pool[1])))
    ref = RD.adamw_steps(c.config, w, pool[:2], c.mix["optimizer"])
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k, v in ref["grad_norms"].items():
        assert grads[k] == pytest.approx(v, rel=1e-4)
    after = prog.params()
    for k in w:
        got = float((after[k].double() - w[k].double()).norm())
        assert got == pytest.approx(ref["change_norms"][k], rel=1e-3)


def test_decoder_reference_prefill_follows_the_port():
    from repro_torch.kernels import ops
    c = tiny.cell("smollm-360m.prefill_over")
    w = SD.make_weights(c.config, 5, "cpu")
    prog = SD.Prefill(c.config, c.mix, w, "cpu", ops)
    tokens = gen.prompts(c.config, c.mix, 5, 3, "cpu")[:, :12]
    logits, cache = prog.steps[12](prog.params, {"tokens": tokens})
    want, kvs = SD.reference_prefill(c.config, w, tokens, control=False,
                                     keep_kv=True)
    assert check.rows(logits, want) < 1e-5
    for row in range(3):
        got = prog.kv(cache, row).flatten(0, 1).flatten(2)
        assert check.rows(got, kvs[:, :, row].flatten(0, 1).flatten(2)) \
            < 1e-5
    assert check.token_gaps(want, prog.greedy(logits)).max() == 0


@pytest.mark.parametrize("precision,lo,hi", [("fp8", 1e-3, 0.2),
                                              ("tf32", 1e-5, 2e-3)])
def test_control_rounds_operands_and_gradients(precision, lo, hi):
    matmul, _ = lowp.products(precision)
    rnd = {"fp8": lowp.round_fp8, "tf32": lowp.round_tf32}[precision]
    g0 = torch.Generator().manual_seed(3)
    a = torch.randn(8, 16, generator=g0).requires_grad_()
    b = torch.randn(16, 4, generator=g0)
    y = matmul(a, b)
    assert torch.allclose(y, rnd(a) @ rnd(b))
    assert lo < check.rows(y.detach(), a.detach() @ b) < hi
    g = torch.randn(8, 4, generator=g0)
    y.backward(g)
    assert torch.allclose(a.grad, rnd(g) @ rnd(b).t())


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 - 2 ** -9])
    assert lowp.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0,
                                           -3.0 - 2 ** -9]
