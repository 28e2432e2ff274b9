"""The port's fault injection and the recovery paths it exercises, on the
CPU: the cases of ``tests/test_faultinject.py`` that arm the worker-pool
and table-store points, run against the port's ``core`` at the same
sizes and timeouts.

Every injected fault — worker exception, hard worker crash
(``BrokenProcessPool``), build hang past the per-attempt timeout, store
corruption or truncation at write time, a held advisory lock — must be
recovered without a crash or hang, and each recovered search must equal
the fault-free one of the port and of the JAX package on the same input:
bit-identical cycle grids and the same best point."""
import multiprocessing
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core.layers import ConvLayer as RefConvLayer  # noqa: E402
from repro.core.layers import fc as ref_fc  # noqa: E402
from repro.core.layers import pool as ref_pool  # noqa: E402
from repro.core.layers import relu as ref_relu  # noqa: E402
from repro.core.study import Study as RefStudy  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro_torch.core import INFER_PRESETS, faultinject  # noqa: E402
from repro_torch.core.dse import (clear_table_caches,  # noqa: E402
                                  table_cache_stats)
from repro_torch.core.layers import ConvLayer, fc, pool, relu  # noqa: E402
from repro_torch.core.store import (TableStore, clear_default_store,  # noqa: E402
                                    store_stats)
from repro_torch.core.study import Study, Workload  # noqa: E402

HW = INFER_PRESETS[16]
GRID = (32, 64, 128, 256)


def tiny_net(conv=ConvLayer, relu=relu, pool=pool, fc=fc):
    """``tests/test_faultinject.py``'s network, from either package's
    layer constructors."""
    def _conv(name, **kw):
        base = dict(name=name, n=1, ic=16, ih=16, iw=16, oc=32, oh=16,
                    ow=16, kh=3, kw=3, s=1, has_bias=True)
        base.update(kw)
        return conv(**base)
    return [
        _conv("c1"),
        relu("r1", 16, 16, 1, 32),
        _conv("c2", ic=32, oc=32, has_bias=False),
        pool("p1", 8, 8, 1, 32, 2, 2),
        fc("fc", 1, 2048, 100),
    ]


@pytest.fixture(autouse=True)
def _clean():
    faultinject.reset()
    clear_default_store()
    clear_table_caches()
    yield
    faultinject.reset()
    clear_default_store()
    clear_table_caches()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's fault-free search of the same network on the same
    lattice (its numpy engine)."""
    net = tiny_net(RefConvLayer, ref_relu, ref_pool, ref_fc)
    return RefStudy(REF_INFER[16], sizes=GRID, bws=GRID, tol=0.5,
                    backend="numpy", store=None).search(
        RefWorkload(net=tuple(net)), 256, 256)


def _sweep(**kw):
    return Study(HW, sizes=GRID, bws=GRID, tol=0.5, device="cpu",
                 **kw).search(Workload(net=tuple(tiny_net())), 256, 256)


def _same(res, want):
    """Bit-identical cycle grid and the same best and worst points."""
    assert res.grid.costs.dtype == want.grid.costs.dtype == np.int64
    assert np.array_equal(res.grid.costs, want.grid.costs)
    for got, ref in ((res.best, want.best), (res.worst, want.worst)):
        assert (got.sizes_kb, got.bws, got.cycles) \
            == (ref.sizes_kb, ref.bws, ref.cycles)


# ---- parallel-build recovery ----------------------------------------------

@pytest.mark.parametrize("point", ["conv_worker_exc", "conv_worker_crash"])
def test_worker_failure_recovers_bit_identical(point, reference):
    serial = _sweep(workers=0)
    n_tables = table_cache_stats()["conv_builds"]
    clear_table_caches()
    faultinject.arm(point, times=2)
    res = _sweep(workers=2)
    assert faultinject.fired(point) == 2
    assert (res.grid.costs == serial.grid.costs).all()
    assert res.best == serial.best
    _same(res, reference)
    # the cache ended consistent: every table built exactly once, across
    # the surviving parallel attempts plus the salvage/fallback path
    assert table_cache_stats()["conv_builds"] == n_tables


def test_worker_hang_trips_timeout_and_recovers(monkeypatch, reference):
    serial = _sweep(workers=0)
    clear_table_caches()
    monkeypatch.setenv("REPRO_DSE_BUILD_TIMEOUT", "2.0")
    faultinject.arm("conv_worker_hang", times=1, arg=60)
    t0 = time.monotonic()
    res = _sweep(workers=2)
    assert time.monotonic() - t0 < 30         # the 60 s hang was cut
    assert faultinject.fired("conv_worker_hang") == 1
    # the hung worker was killed with its pool, not left for the
    # interpreter's exit to wait out
    deadline = time.monotonic() + 5
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert multiprocessing.active_children() == []
    assert (res.grid.costs == serial.grid.costs).all()
    assert res.best == serial.best
    _same(res, reference)


def test_worker_failure_then_serial_fallback_exhausts_retries(reference):
    """With a fault armed on *every* parallel task, all retries burn out
    and the guaranteed serial fallback still completes the sweep."""
    serial = _sweep(workers=0)
    clear_table_caches()
    faultinject.arm("conv_worker_exc", times=-1)
    res = _sweep(workers=2)
    assert (res.grid.costs == serial.grid.costs).all()
    st = table_cache_stats()
    assert st["conv_parallel_builds"] == 0          # nothing survived
    assert st["conv_builds"] > 0                    # serial built them all
    _same(res, reference)


# ---- store-fault recovery --------------------------------------------------

@pytest.mark.parametrize("point", ["store_corrupt", "store_truncate"])
def test_store_damage_at_write_recovers(tmp_path, point, reference):
    baseline = _sweep()
    clear_table_caches()
    store = TableStore(tmp_path)
    faultinject.arm(point, times=1)
    cold = _sweep(store=store)                      # one entry damaged
    assert faultinject.fired(point) == 1
    assert (cold.grid.costs == baseline.grid.costs).all()
    clear_table_caches()
    warm = _sweep(store=store)                      # damage found on load
    st = table_cache_stats()
    assert st["store_corrupt"] == 1
    assert (warm.grid.costs == baseline.grid.costs).all()
    clear_table_caches()
    again = _sweep(store=store)                     # rebuilt entry persisted
    assert table_cache_stats()["store_corrupt"] == 0
    for res in (cold, warm, again):
        _same(res, reference)


def test_lock_hold_degrades_without_deadlock(tmp_path):
    """A writer sitting on the advisory lock delays other writers at
    most ``lock_timeout_s``; they proceed unlocked and stay correct."""
    slow = TableStore(tmp_path, lock_timeout_s=0.2)
    fast = TableStore(tmp_path, lock_timeout_s=0.2)
    faultinject.arm("store_lock_hold", times=1, arg=1.0)

    t = threading.Thread(
        target=lambda: slow.save("conv", ("slow",), b"x" * 64))
    t.start()
    time.sleep(0.3)                                 # let it take the lock
    t0 = time.monotonic()
    fast.save("conv", ("fast",), b"y" * 64)
    elapsed = time.monotonic() - t0
    t.join(timeout=5)
    assert not t.is_alive()
    assert faultinject.fired("store_lock_hold") == 1
    assert elapsed < 0.8                            # bounded, no deadlock
    assert store_stats()["store_lock_timeouts"] >= 1
    assert fast.load("conv", ("fast",), bytes) == b"y" * 64
    assert slow.load("conv", ("slow",), bytes) == b"x" * 64


def test_lock_hold_under_a_search_keeps_the_grid(tmp_path, reference):
    """The held lock inside a search's cache section: the search waits
    out the hold and still prices the same grid."""
    store = TableStore(tmp_path, lock_timeout_s=0.2)
    faultinject.arm("store_lock_hold", times=1, arg=0.3)
    res = _sweep(store=store)
    assert faultinject.fired("store_lock_hold") == 1
    _same(res, reference)
