"""The port's DSE service (``repro_torch.serve``) on the CPU: the twin of
``tests/test_service.py`` and of
``tests/test_dse_threadsafety.py::test_concurrent_searches_bit_identical_to_serial``.

Every answer the port's ``DSEService`` hands back — through grouping,
dedup and degraded serial retry — is bit-identical to a direct
``Study.search`` of the same request on the port, and a burst with an
LLM request in it gets, request for request, the answers the JAX
package's service gives for the same burst.  The service behaviours are
pinned as the reference pins them: coalescing saves table builds,
identical in-flight requests share one pricing, admission control bounds
the queue, a poisoned request (a misspelt LLM name among them) fails
alone, and the ``service_batch_exc``/``service_request_hang`` fault
points (the port's own ``core.faultinject``) degrade a grouped dispatch
to per-request serial pricing.

A hung pricing thread is abandoned, not stopped: when it wakes, it
prices beside the degraded serial retry.  That case runs here on the
``torch`` backend, and the host-side state the CUDA path shares between
such threads — ``kernels.reduce``'s launch counters and its workspace
per (device, stream) — is driven from many threads at once.
"""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core import Study as RefStudy  # noqa: E402
from repro.core import Workload as RefWorkload  # noqa: E402
from repro.core import layers as RL  # noqa: E402
from repro.core.dse import clear_table_caches as ref_clear_caches  # noqa: E402
from repro.serve import DSERequest as RefRequest  # noqa: E402
from repro.serve import DSEService as RefService  # noqa: E402
from repro_torch.core import INFER_PRESETS, Study, Workload  # noqa: E402
from repro_torch.core import faultinject  # noqa: E402
from repro_torch.core import layers as L  # noqa: E402
from repro_torch.core.dse import (DSE_BACKENDS, clear_table_caches,  # noqa: E402
                                  table_cache_stats)
from repro_torch.core.store import TableStore, clear_default_store  # noqa: E402
from repro_torch.kernels import reduce  # noqa: E402
from repro_torch.serve import (AdmissionError, DSEClient, DSERequest,  # noqa: E402
                               DSEService, InvalidRequest, RequestTimeout,
                               ServiceError)

GRID = (32, 64, 128, 256)
LLM = ("qwen3_0_6b", 64)                  # (name, seq) of the LLM requests


def _conv(mod, name, **kw):
    base = dict(name=name, n=1, ic=16, ih=16, iw=16, oc=32, oh=16, ow=16,
                kh=3, kw=3, s=1, has_bias=True)
    base.update(kw)
    return mod.ConvLayer(**base)


def tiny_net(mod=L):
    return (_conv(mod, "c1"), mod.relu("r1", 16, 16, 1, 32),
            _conv(mod, "c2", ic=32, oc=32, has_bias=False),
            mod.pool("p1", 8, 8, 1, 32, 2, 2), mod.fc("fc", 1, 2048, 100))


def tiny_train_net(mod=L):
    return (_conv(mod, "c1", has_bias=False),
            mod.batch_norm("c1.bn", 16, 16, 1, 32),
            mod.relu("c1.relu", 16, 16, 1, 32),
            _conv(mod, "c2", ic=32, oc=32), mod.fc("fc", 1, 2048, 10))


@pytest.fixture(autouse=True)
def _clean():
    faultinject.reset()
    clear_default_store()
    clear_table_caches()
    yield
    faultinject.reset()
    clear_default_store()
    clear_table_caches()


def _study(**kw):
    kw.setdefault("store", None)
    kw.setdefault("device", "cpu")
    return Study(INFER_PRESETS[16], sizes=GRID, bws=GRID, tol=0.5, **kw)


def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def _same_result(a, b):
    """Bit-identity of two grid results, across the two packages too: the
    same optimum, frontier and Pareto set, and the same cost and score
    surfaces."""
    assert _pt(a.best) == _pt(b.best)
    assert _pt(a.worst) == _pt(b.worst)
    assert [_pt(p) for p in a.points] == [_pt(p) for p in b.points]
    assert [_pt(p) for p in a.pareto()] == [_pt(p) for p in b.pareto()]
    assert a.grid.costs.dtype == b.grid.costs.dtype == np.int64
    assert np.array_equal(a.grid.costs, b.grid.costs)
    if b.grid_scores is None:
        assert a.grid_scores is None
    else:
        assert np.array_equal(a.grid_scores, b.grid_scores)


def _burst(mod, workload, request):
    """The mixed burst of ``tests/test_service.py``'s acceptance test, one
    LLM request, inference and training, in either package."""
    train = workload(net=tiny_train_net(mod), training=True,
                     name="tiny-train")
    llm = workload(LLM[0], seq=LLM[1])
    return [request("resnet18", 512, 256, objective="cycles"),
            request("resnet18", 256, 256, objective="edp"),
            request("alexnet", 512, 256, objective="edp"),
            request(llm, 512, 256, objective="cycles"),
            request(train, 512, 256, objective="cycles"),
            request(train, 256, 256, objective="edp"),
            request(llm, 256, 256, objective="edp"),
            request("alexnet", 512, 256, objective="cycles")]


def _submit_from_threads(client, reqs, n_threads=4):
    tickets = [None] * len(reqs)
    barrier = threading.Barrier(n_threads)

    def submitter(tid):
        barrier.wait()
        for i in range(tid, len(reqs), n_threads):
            tickets[i] = client.submit(reqs[i])

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return tickets


@pytest.fixture(scope="module")
def reference_burst():
    """The JAX package's service answering the same burst."""
    ref_clear_caches()
    reqs = _burst(RL, RefWorkload, RefRequest)
    svc = RefService(RefStudy(REF_INFER[16], sizes=GRID, bws=GRID, tol=0.5,
                              store=None, backend="numpy"),
                     autostart=False, max_batch=len(reqs))
    tickets = [svc.submit(r) for r in reqs]
    svc.start()
    results = [t.result(timeout=600) for t in tickets]
    svc.close()
    ref_clear_caches()
    return results


# ---- acceptance: concurrent mixed burst ------------------------------------

@pytest.mark.parametrize("backend", DSE_BACKENDS)
def test_concurrent_burst_bit_identical_coalesced_clean_store(
        tmp_path, reference_burst, backend):
    """8 mixed queries (2 CNNs, an LLM and a training net; 2 budgets;
    cycles and EDP) submitted from 4 client threads, served coalesced off
    a shared store: every response bit-identical to a fresh direct
    ``Study.search`` and to the JAX package's service, coalescing ratio
    above 1, no quarantine debris in the store."""
    store_root = tmp_path / "store"
    reqs = _burst(L, Workload, DSERequest)
    svc = DSEService(_study(store=str(store_root), backend=backend),
                     autostart=False, max_batch=len(reqs))
    tickets = _submit_from_threads(DSEClient(svc), reqs)
    svc.start()                       # whole burst lands in one drain
    results = [t.result(timeout=600) for t in tickets]
    svc.close()

    st = svc.stats()
    assert st.submitted == len(reqs) and st.completed == len(reqs)
    assert st.failed == 0 and st.degraded_batches == 0
    assert st.searches < len(reqs)
    assert st.coalescing_ratio > 1.0
    assert st.batch_occupancy > 1.0

    ref = _study(store=str(store_root), backend=backend)
    for req, res, want in zip(reqs, results, reference_burst):
        _same_result(res, ref.search(req.workload, req.size_budget_kb,
                                     req.bw_budget, objective=req.objective))
        _same_result(res, want)

    store = TableStore(store_root)
    assert len(list(store.entries())) > 0
    assert not (store.quarantine_dir.exists()
                and list(store.quarantine_dir.iterdir()))
    assert not list(store_root.glob(".tmp-*"))


def test_coalescing_builds_fewer_tables_than_sequential_cold():
    wl = Workload(net=tiny_net(), name="tiny")
    reqs = [DSERequest(wl, 512, 256, objective="cycles"),
            DSERequest("alexnet", 512, 256, objective="cycles"),
            DSERequest(wl, 512, 256, objective="edp"),
            DSERequest(Workload(LLM[0], seq=LLM[1]), 512, 256)]

    def builds():
        s = table_cache_stats()
        return sum(int(s[f"{k}_builds"]) for k in ("conv", "simd", "gemm"))

    sequential = 0
    for r in reqs:
        clear_table_caches()
        _study().search(r.workload, r.size_budget_kb, r.bw_budget,
                        objective=r.objective)
        sequential += builds()

    clear_table_caches()
    with DSEService(_study(), autostart=False,
                    max_batch=len(reqs)) as svc:
        tickets = DSEClient(svc).submit_burst(reqs)
        svc.start()
        for t in tickets:
            t.result(timeout=600)
    coalesced = builds()
    assert coalesced < sequential, (coalesced, sequential)


# ---- dedup / admission ------------------------------------------------------

def test_identical_inflight_requests_share_one_result():
    wl = Workload(LLM[0], seq=LLM[1])
    svc = DSEService(_study(), autostart=False)
    a = svc.submit(wl, 512, 256)
    b = svc.submit(Workload(LLM[0], seq=LLM[1]), 512, 256)   # equal: dedup
    c = svc.submit(wl, 256, 256)                   # different budget: new
    svc.start()
    ra, rb, rc = (t.result(timeout=600) for t in (a, b, c))
    svc.close()
    assert ra is rb
    assert rc is not ra
    st = svc.stats()
    assert st.dedup_hits == 1
    assert st.submitted == 3 and st.completed == 2
    assert st.priced_requests == 2


def test_admission_control_bounds_pending_and_rejects_after_close():
    wl = Workload(net=tiny_net(), name="tiny")
    svc = DSEService(_study(), autostart=False, max_pending=2)
    svc.submit(wl, 512, 256)
    svc.submit(wl, 256, 256)
    with pytest.raises(AdmissionError) as exc:
        svc.submit(wl, 128, 256)
    assert exc.value.kind == "rejected"
    assert svc.stats().rejected == 1
    svc.close(drain=False)
    with pytest.raises(AdmissionError):
        svc.submit(wl, 512, 256)


# ---- graceful degradation ---------------------------------------------------

def test_poisoned_request_fails_alone():
    """An unknown CNN, a misspelt LLM name and an infeasible budget each
    fail alone with a structured error; healthy batchmates complete."""
    svc = DSEService(_study(), autostart=False)
    client = DSEClient(svc)
    bad_net = client.submit("no_such_net", 512, 256)
    bad_llm = client.submit("qwen3_0_6", 512, 256)
    bad_budget = client.submit(Workload(net=tiny_net()), 1, 256)
    good = client.submit("alexnet", 512, 256)
    good_llm = client.submit(Workload(LLM[0], seq=LLM[1]), 512, 256)
    svc.start()
    res, res_llm = good.result(timeout=600), good_llm.result(timeout=600)
    errors = [t.exception(timeout=600) for t in (bad_net, bad_llm)]
    e_budget = bad_budget.exception(timeout=600)
    svc.close()
    for err, name in zip(errors, ("no_such_net", "qwen3_0_6")):
        assert isinstance(err, InvalidRequest) and err.kind == "invalid"
        assert name in str(err) and "qwen3_0_6b" in str(err)
        assert isinstance(err.__cause__, ValueError)
    assert isinstance(e_budget, ServiceError)
    assert e_budget.kind == "error" and e_budget.__cause__ is not None
    _same_result(res, _study().search("alexnet", 512, 256))
    _same_result(res_llm, _study().search(Workload(LLM[0], seq=LLM[1]),
                                          512, 256))
    st = svc.stats()
    assert st.completed == 2 and st.failed == 3 and st.timeouts == 0


def test_batch_exception_degrades_to_serial_not_dropped():
    faultinject.arm("service_batch_exc", times=1)
    wl = Workload(net=tiny_net(), name="tiny")
    llm = Workload(LLM[0], seq=LLM[1])
    svc = DSEService(_study(), autostart=False)
    tickets = DSEClient(svc).submit_burst(
        [DSERequest(wl, 512, 256), DSERequest("alexnet", 512, 256),
         DSERequest(llm, 512, 256)])
    svc.start()
    results = [t.result(timeout=600) for t in tickets]
    svc.close()
    assert faultinject.fired("service_batch_exc") == 1
    st = svc.stats()
    assert st.degraded_batches == 1
    assert st.completed == 3 and st.failed == 0
    ref = _study()
    for res, w in zip(results, (wl, "alexnet", llm)):
        _same_result(res, ref.search(w, 512, 256))


def test_hang_watchdog_isolates_the_hung_request():
    faultinject.arm("service_request_hang", times=2, arg=30)
    wl = Workload(net=tiny_net(), name="tiny")
    svc = DSEService(_study(), autostart=False, batch_timeout_s=0.5)
    tickets = DSEClient(svc).submit_burst(
        [DSERequest(wl, 512, 256, tag="hangs"),
         DSERequest("alexnet", 512, 256, tag="survives")])
    svc.start()
    err = tickets[0].exception(timeout=600)
    res = tickets[1].result(timeout=600)
    svc.close()
    assert isinstance(err, RequestTimeout) and err.kind == "timeout"
    assert err.request.tag == "hangs"
    st = svc.stats()
    assert st.degraded_batches == 1
    assert st.timeouts == 1 and st.completed == 1
    _same_result(res, _study().search("alexnet", 512, 256))


def test_expired_in_queue_times_out_without_pricing():
    wl = Workload(net=tiny_net(), name="tiny")
    svc = DSEService(_study(), autostart=False)
    t = svc.submit(wl, 512, 256, timeout_s=0.01)
    time.sleep(0.05)                  # deadline passes while queued
    svc.start()
    err = t.exception(timeout=60)
    svc.close()
    assert isinstance(err, RequestTimeout)
    st = svc.stats()
    assert st.timeouts == 1 and st.searches == 0


# ---- a hung pricing thread beside the degraded serial retry ----------------

HANG_S = 4.5          # the grouped dispatch sleeps this long, then prices
WATCHDOG_S = 4.0      # and is abandoned after this long


def test_degraded_retry_beside_hung_pricing_thread():
    """``service_request_hang`` armed once, on the ``torch`` backend: the
    grouped dispatch sleeps past its watchdog and is abandoned, the group
    degrades to serial pricing, and the abandoned thread wakes and prices
    the whole group while the serial retry is still pricing.  Both
    threads' answers are bit-identical to a direct search, and every
    request completes once."""
    faultinject.arm("service_request_hang", times=1, arg=HANG_S)
    study = _study(backend="torch")
    group_started = threading.Event()
    calls, lock = [], threading.Lock()
    search_requests = study.search_requests

    def recorded(requests):
        if len(requests) == 1:
            # a serial retry: start once the abandoned thread is pricing
            assert group_started.wait(timeout=30)
        else:
            group_started.set()
        t0 = time.monotonic()
        out = search_requests(requests)
        with lock:
            calls.append((threading.current_thread(), len(requests), t0,
                          time.monotonic(), out))
        return out

    study.search_requests = recorded
    wl = Workload(net=tiny_net(), name="tiny")
    llm = Workload(LLM[0], seq=LLM[1])
    reqs = [DSERequest(wl, 512, 256), DSERequest(llm, 512, 256),
            DSERequest("alexnet", 512, 256)]
    svc = DSEService(study, autostart=False, batch_timeout_s=WATCHDOG_S)
    tickets = DSEClient(svc).submit_burst(reqs)
    svc.start()
    results = [t.result(timeout=600) for t in tickets]
    svc.close(timeout=60)
    deadline = time.monotonic() + 120
    while len(calls) < 1 + len(reqs) and time.monotonic() < deadline:
        time.sleep(0.05)

    st = svc.stats()
    assert faultinject.fired("service_request_hang") == 1
    assert st.degraded_batches == 1
    assert st.completed == len(reqs) and st.failed == st.timeouts == 0
    groups = [c for c in calls if c[1] == len(reqs)]
    serial = [c for c in calls if c[1] == 1]
    assert len(groups) == 1 and len(serial) == len(reqs)
    hung = groups[0]
    assert hung[0].name == "repro-dse-pricing"
    assert any(s[2] < hung[3] and hung[2] < s[3] for s in serial), \
        "the abandoned thread never priced beside the serial retry"
    ref = _study()
    for req, res, abandoned in zip(reqs, results, hung[4]):
        want = ref.search(req.workload, 512, 256)
        _same_result(res, want)
        _same_result(abandoned, want)


# ---- client surface ---------------------------------------------------------

def test_query_burst_returns_errors_in_place():
    wl = Workload(net=tiny_net(), name="tiny")
    with DSEService(_study(), coalesce_window_s=0.05) as svc:
        out = DSEClient(svc).query_burst(
            [DSERequest(wl, 512, 256),
             DSERequest("no_such_net", 512, 256)],
            return_errors=True)
    assert not isinstance(out[0], ServiceError)
    assert isinstance(out[1], InvalidRequest)
    _same_result(out[0], _study().search(wl, 512, 256))


def test_sync_query_matches_direct_search():
    with DSEService(_study()) as svc:
        res = DSEClient(svc).query("alexnet", 512, 256, objective="edp")
    _same_result(res, _study().search("alexnet", 512, 256,
                                      objective="edp"))


def test_service_prices_on_its_studys_device():
    svc = DSEService(_study(backend="torch-fused"), autostart=False)
    assert svc.study.device.type == "cpu"
    assert svc.study.backend == "torch-fused"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DSEService(Study(INFER_PRESETS[16]), autostart=False)


# ---- many threads through one Study ----------------------------------------

def _race(n_threads, fn):
    barrier = threading.Barrier(n_threads)
    out = [None] * n_threads
    errs = []

    def work(tid):
        try:
            barrier.wait()
            out[tid] = fn(tid)
        except BaseException as exc:                 # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("backend", ["torch", "torch-fused"])
def test_concurrent_searches_bit_identical_to_serial(backend):
    """Four threads running full grid searches through one Study (shared
    caches, no store), an LLM among them, each match the serial answer."""
    study = _study(backend=backend)
    wl = Workload(net=(_conv(L, "c1"), L.relu("r1", 16, 16, 1, 32),
                       _conv(L, "c2", ic=32, oc=32)), name="tiny")
    llm = Workload(LLM[0], seq=LLM[1])
    queries = [(wl, 512, 256), ("alexnet", 512, 256),
               (llm, 256, 256), ("alexnet", 256, 256)]
    results = _race(4, lambda tid: study.search(*queries[tid]))
    clear_table_caches()
    for q, res in zip(queries, results):
        _same_result(res, study.search(*q))


def test_launch_counters_lose_no_update_across_threads(monkeypatch):
    """``reduce._count`` from 16 threads at a tiny switch interval: every
    launch is counted, on its route."""
    monkeypatch.setattr(reduce.grid_minmax, "launches", 0)
    monkeypatch.setattr(reduce.grid_minmax, "routes",
                        dict.fromkeys(reduce.ROUTES, 0))
    n, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _race(n, lambda tid: [reduce._count(reduce.ROUTES[tid % 2])
                              for _ in range(per)])
    finally:
        sys.setswitchinterval(old)
    assert reduce.grid_minmax.launches == n * per
    assert reduce.grid_minmax.routes == {"shared": n * per // 2,
                                         "global": n * per // 2}


def test_workspace_made_once_per_stream_across_threads(monkeypatch):
    """``reduce._workspace`` called from 16 threads at once for two
    streams of one device: each stream gets one workspace, made once and
    shared by every thread, zeroed."""
    made = []
    zeros = torch.zeros

    def fake_zeros(*shape, dtype, device):
        assert device == torch.device("cuda", 0)
        time.sleep(0.01)          # widen the window a second maker would hit
        t = zeros(*shape, dtype=dtype)
        made.append(t)
        return t

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(reduce, "_WORKSPACES", {})
    monkeypatch.setattr(reduce.torch, "zeros", fake_zeros)
    monkeypatch.setattr(reduce.torch.cuda, "get_device_properties",
                        lambda index: Props)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _race(16, lambda tid: reduce._workspace(0, 7 + tid % 2)[:2])
    finally:
        sys.setswitchinterval(old)
    assert len(made) == 2
    words = reduce.BLOCKS_PER_SM * 132 * reduce.PARTIAL_BYTES // 8
    assert all(t.shape == (words + 1,) and not t.any() for t in made)
    for stream in (7, 8):
        ws = {g for tid, g in enumerate(got) if 7 + tid % 2 == stream}
        assert len(ws) == 1
        partials, ticket = ws.pop()
        assert ticket == partials + 8 * words
    assert set(reduce._WORKSPACES) == {(0, 7), (0, 8)}
