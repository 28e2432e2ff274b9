"""Phase 23's helpers of ``chip_smoke.py``, on the CPU: the lock witness
(``LockWitness``) over a service burst priced on the CPU, an inversion it
must report, what ``uninstall`` restores; the process helpers
(``_start``/``_finish_all``) stopping what they start; and ``--phases 23``
without a card exiting non-zero with no result."""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import _smoke  # noqa: E402

from repro_torch.analysis import DEFAULT_MANIFEST  # noqa: E402
from repro_torch.core import INFER_PRESETS, Study, Workload  # noqa: E402
from repro_torch.core import dse, faultinject  # noqa: E402
from repro_torch.core.store import TableStore, store_context  # noqa: E402
from repro_torch.kernels import _ext, reduce  # noqa: E402
from repro_torch.serve import DSEClient, DSERequest, DSEService  # noqa: E402

SMOKE = _smoke()
ORDER = DEFAULT_MANIFEST.lock_order


def _id(suffix):
    return next(i for i in ORDER if i.endswith(suffix))


@pytest.fixture
def witness():
    w = SMOKE.LockWitness(ORDER).install()
    try:
        yield w
    finally:
        w.uninstall()


def test_witness_sees_a_cpu_burst_in_the_manifests_order(witness, tmp_path):
    """Requests from 2 client threads through one service over a CPU
    study with a table store, cold caches: the service, metrics, cache,
    store and fault-registry locks are taken, and every nesting is one
    the manifest's order allows."""
    dse.clear_table_caches()
    study = Study(INFER_PRESETS[16], sizes=(32, 64, 128, 256),
                  bws=(8, 16, 32, 64), device="cpu")
    reqs = [DSERequest(Workload(net), 512, 64, objective=obj, tag=net + obj)
            for net in ("resnet18", "alexnet") for obj in ("cycles", "edp")]
    with store_context(TableStore(tmp_path)):
        svc = DSEService(study, autostart=False, max_batch=len(reqs))
        client = DSEClient(svc)
        tickets = [None] * len(reqs)

        def submit(tid):
            for i in range(tid, len(reqs), 2):
                tickets[i] = client.submit(reqs[i])
        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        svc.start()
        results = [t.result(timeout=300) for t in tickets]
        svc.close(timeout=60)
    assert all(r.best.cycles > 0 for r in results)
    for suffix in (":DSEService.self._lock", ":ServiceMetrics.self._lock",
                   ":_CACHE_LOCK", ":TableStore._locked", ":_FAULT_LOCK"):
        assert witness.counts[_id(suffix)] >= 1, suffix
    assert witness.inversions() == []
    assert (_id(":_CACHE_LOCK"), _id(":TableStore._locked")) \
        in witness.edges
    assert (_id(":TableStore._locked"), _id(":_FAULT_LOCK")) \
        in witness.edges


def test_witness_reports_a_nesting_against_the_order(witness):
    with reduce._COUNT_LOCK:
        with reduce._WS_LOCK:
            pass
    with dse._CACHE_LOCK:            # reentrant: no nesting with itself
        with dse._CACHE_LOCK:
            faultinject.armed("conv_worker_exc")
    assert witness.inversions() == [
        f"{_id(':_COUNT_LOCK')} -> {_id(':_WS_LOCK')}"]
    assert witness.edges == {
        (_id(":_COUNT_LOCK"), _id(":_WS_LOCK")): 1,
        (_id(":_CACHE_LOCK"), _id(":_FAULT_LOCK")): 1}
    assert witness.counts[_id(":_CACHE_LOCK")] == 2


def test_uninstall_restores_every_lock():
    from repro_torch.core.store import TableStore as Store
    from repro_torch.distributed.fault import Watchdog
    from repro_torch.serve.metrics import ServiceMetrics
    before = (reduce._WS_LOCK, reduce._COUNT_LOCK, _ext._LOCK,
              dse._CACHE_LOCK, faultinject._FAULT_LOCK,
              Store.__dict__["_locked"], DSEService.__dict__["__init__"],
              ServiceMetrics.__dict__["__init__"],
              Watchdog.__dict__["__init__"])
    w = SMOKE.LockWitness(ORDER).install()
    assert isinstance(reduce._WS_LOCK, SMOKE._RecordingLock)
    assert isinstance(Watchdog(1.0, lambda idle: None)._lock,
                      SMOKE._RecordingLock)
    w.uninstall()
    after = (reduce._WS_LOCK, reduce._COUNT_LOCK, _ext._LOCK,
             dse._CACHE_LOCK, faultinject._FAULT_LOCK,
             Store.__dict__["_locked"], DSEService.__dict__["__init__"],
             ServiceMetrics.__dict__["__init__"],
             Watchdog.__dict__["__init__"])
    assert all(a is b for a, b in zip(before, after))


def test_finish_all_stops_a_process_at_its_timeout(tmp_path):
    started = {
        "sleeper": SMOKE._start([sys.executable, "-c",
                                 "import time; print('up', flush=True); "
                                 "time.sleep(60)"], tmp_path, "sleeper"),
        "quick": SMOKE._start([sys.executable, "-c", "print('done')"],
                              tmp_path, "quick")}
    t0 = time.monotonic()
    done = SMOKE._finish_all(started, 5.0)
    assert time.monotonic() - t0 < 20
    assert started["sleeper"][0].poll() is not None
    rc, out, _, secs = done["sleeper"]
    assert (rc, out, secs) == (None, "up\n", None)
    rc, out, _, secs = done["quick"]
    assert (rc, out) == (0, "done\n") and 0 < secs < 5.0


def test_phase_23_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SMOKE.main(["--phases", "23"]) == 1
    assert '"ok"' not in capsys.readouterr().out
