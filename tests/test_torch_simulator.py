"""The port's copy of the per-layer simulator (``repro_torch.core.
simulator``) against the JAX package's: ``simulate`` gives the same
report field for field, integers exactly and floats bit for bit."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import INFER_PRESETS as J_INFER  # noqa: E402
from repro.core import TRAIN_PRESETS as J_TRAIN  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch.core import INFER_PRESETS as T_INFER  # noqa: E402
from repro_torch.core import TRAIN_PRESETS as T_TRAIN  # noqa: E402
from repro_torch.core import simulate, simulator as tsim  # noqa: E402


def _fields(report):
    return [(r.name, r.engine, r.phase, r.op, dataclasses.asdict(r.stats))
            for r in report.layers]


def _same(a, b):
    """Equal, with every float equal bit for bit (``==`` on floats that
    are not NaN) and of the same type."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("net,mode,presets", [
    ("resnet50", "inference", "train"), ("resnet50", "training", "train"),
    ("resnet50", "inference", "infer"), ("alexnet", "training", "train"),
    ("vgg16", "inference", "infer")])
def test_simulate_matches_the_jax_package(net, mode, presets):
    thw = (T_TRAIN if presets == "train" else T_INFER)[64]
    jhw = (J_TRAIN if presets == "train" else J_INFER)[64]
    got, want = simulate(thw, net, mode=mode), jsim.simulate(jhw, net,
                                                             mode=mode)
    _same(_fields(got), _fields(want))
    for attr in ("total_cycles", "compute_cycles_sa", "compute_cycles_simd",
                 "stall_cycles"):
        _same(getattr(got, attr), getattr(want, attr))
    for method in ("cycles", "dram_bits", "sram_bits"):
        for engine in (None, "sa", "simd"):
            _same(getattr(got, method)(engine), getattr(want, method)(engine))
    for method in ("sram_bits_by_buffer", "ops", "cycles_by_phase",
                   "phase_shares", "energy_inputs"):
        _same(getattr(got, method)(), getattr(want, method)())
    for metric in ("cycles", "dram", "sram"):
        _same(got.nonconv_fraction(metric), want.nonconv_fraction(metric))
    _same(got.energy(thw), want.energy(jhw))
    _same(got.nonconv_energy_fraction(thw), want.nonconv_energy_fraction(jhw))


def test_simulate_network_with_each_stall_model():
    """``simulate_network`` over a training graph with each stall
    model."""
    from repro.core import backward as jb, networks as jn
    from repro_torch.core import backward as tb, networks as tn
    for stall in ("simdit", "simplified", "no_stall"):
        want = jsim.simulate_network(
            J_TRAIN[16], jb.expand_training_graph(jn.resnet18(4)), stall)
        got = tsim.simulate_network(
            T_TRAIN[16], tb.expand_training_graph(tn.resnet18(4)), stall)
        _same(_fields(got), _fields(want))
        _same(got.cycles_by_phase(), want.cycles_by_phase())
