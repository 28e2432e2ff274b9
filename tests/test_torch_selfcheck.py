"""The port's DSE self-check (``Study(selfcheck=n)``) under the two
perturbations of ``tests/test_selfcheck.py``, on the CPU: a cached conv
table drifted by hand, and the ``selfcheck_perturb`` fault point shifting
the scalar reference inside the comparison.

Each must raise the port's ``IntegrityError``, and the error must be the
JAX package's under the same perturbation on the same input: the same
sampled point, the same reference cycles and the same batched cycles."""
import pytest

pytest.importorskip("torch")

from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core import faultinject as ref_faultinject  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.core.layers import ConvLayer as RefConvLayer  # noqa: E402
from repro.core.layers import fc as ref_fc  # noqa: E402
from repro.core.layers import pool as ref_pool  # noqa: E402
from repro.core.layers import relu as ref_relu  # noqa: E402
from repro.core.study import IntegrityError as RefIntegrityError  # noqa: E402
from repro.core.study import Study as RefStudy  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro_torch.core import INFER_PRESETS, faultinject  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.layers import ConvLayer, fc, pool, relu  # noqa: E402
from repro_torch.core.study import IntegrityError, Study, Workload  # noqa: E402

GRID = (32, 64, 128, 256)


def tiny_net(conv, relu, pool, fc):
    """``tests/test_selfcheck.py``'s network, from either package's layer
    constructors."""
    def _conv(name, **kw):
        base = dict(name=name, n=1, ic=16, ih=16, iw=16, oc=32, oh=16,
                    ow=16, kh=3, kw=3, s=1, has_bias=True)
        base.update(kw)
        return conv(**base)
    return (
        _conv("c1"),
        relu("r1", 16, 16, 1, 32),
        _conv("c2", ic=32, oc=32, has_bias=False),
        pool("p1", 8, 8, 1, 32, 2, 2),
        fc("fc", 1, 2048, 100),
    )


PORT = dict(study=lambda **kw: Study(INFER_PRESETS[16], sizes=GRID,
                                     bws=GRID, tol=0.5, device="cpu", **kw),
            workload=Workload(net=tiny_net(ConvLayer, relu, pool, fc)),
            dse=dse, faultinject=faultinject, error=IntegrityError)
REF = dict(study=lambda **kw: RefStudy(REF_INFER[16], sizes=GRID, bws=GRID,
                                       tol=0.5, backend="numpy", **kw),
           workload=RefWorkload(net=tiny_net(RefConvLayer, ref_relu,
                                             ref_pool, ref_fc)),
           dse=ref_dse, faultinject=ref_faultinject,
           error=RefIntegrityError)


@pytest.fixture(autouse=True)
def _clean():
    for side in (PORT, REF):
        side["dse"].clear_table_caches()
        side["faultinject"].reset()
    yield
    for side in (PORT, REF):
        side["dse"].clear_table_caches()
        side["faultinject"].reset()


def _error(side, perturb):
    """The ``IntegrityError`` of a self-checked search on ``side`` after
    ``perturb(side)``, as comparable fields."""
    perturb(side)
    with pytest.raises(side["error"]) as ei:
        side["study"](selfcheck=3).search(side["workload"], 256, 256)
    err = ei.value
    return (err.workload, err.point.sizes_kb, err.point.bws, err.expected,
            err.actual)


def _drift_tables(side):
    side["study"]().search(side["workload"], 256, 256)    # warm the cache
    for t in side["dse"]._CONV_TABLE_CACHE.values():      # every table
        t.o1[:] = t.o1 + 1000


def _arm_perturb(side):
    side["faultinject"].arm("selfcheck_perturb", times=1, arg=7)


def test_perturbed_table_raises_integrity_error():
    got = _error(PORT, _drift_tables)
    workload, sizes_kb, bws, expected, actual = got
    assert workload == PORT["workload"].label
    assert expected != actual
    assert len(sizes_kb) == 4 and len(bws) == 4
    assert got == _error(REF, _drift_tables)


def test_selfcheck_perturb_fault_trips_integrity_error():
    """``selfcheck_perturb`` shifts the reference cycles by ``arg`` inside
    the comparison itself: the self-check trips on a one-cycle-scale
    divergence with no cache poking."""
    got = _error(PORT, _arm_perturb)
    assert faultinject.fired("selfcheck_perturb") == 1
    assert got[3] - got[4] == 7
    assert got == _error(REF, _arm_perturb)
    assert ref_faultinject.fired("selfcheck_perturb") == 1


def test_clean_selfcheck_matches_the_reference():
    """Unperturbed, the self-checked search passes and prices the JAX
    package's best point."""
    got = PORT["study"](selfcheck=5).search(PORT["workload"], 256, 256)
    want = REF["study"](selfcheck=5).search(REF["workload"], 256, 256)
    assert (got.best.sizes_kb, got.best.bws, got.best.cycles) \
        == (want.best.sizes_kb, want.best.bws, want.best.cycles)
