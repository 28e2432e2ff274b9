"""DSE-as-a-service: a concurrent sweep-serving loop over one ``Study``.

The durability layer (``core.store``) made warm sweeps pure lookups;
this module is the serving half of the ROADMAP item: many concurrent
DSE queries — different networks, budgets, objectives, inference and
training — submitted from any number of threads, answered from ONE
``Study`` so they coalesce on shared cost tables.  The framing is the
TPU paper's datacenter one (serve heavy query traffic from a shared
accelerator fleet model), applied to the simulator itself.

Architecture::

    client threads ── submit() ──>  bounded queue  ──>  dispatcher thread
         ^   admission control /        |                   |
         |   in-flight dedup            |            micro-batch drain
         |                              v                   v
      Ticket  <── future fan-out ── per-request   group by (budgets,
       .result()                      futures      objective, method)
                                                        |
                                              ONE search_many per group
                                              (union-of-shapes tables)

  * **Micro-batching + coalescing.**  The dispatcher drains the queue in
    micro-batches (up to ``max_batch``, waiting ``coalesce_window_s``
    for a burst to accumulate), groups compatible requests — same
    ``SweepRequest.group_key``, i.e. same budgets/objective/method on
    this service's one hardware base and lattice — and prices each group
    with ONE ``Study.search_requests`` call, so N concurrent queries for
    different networks share every table build their shape union allows.
    Results fan back out through per-request futures, each bit-identical
    to a direct synchronous ``Study.search`` (pinned in
    tests/test_service.py).
  * **Dedup/memoization.**  Identical in-flight queries (equal
    ``SweepRequest.dedup_key``) attach to the first submission's future
    and never hit the queue.
  * **Admission control.**  At most ``max_pending`` requests may be
    in flight; past that, ``submit`` raises ``AdmissionError`` instead
    of letting the queue grow without bound.  Per-request deadlines
    (``timeout_s``) fail a request with ``RequestTimeout`` whether it
    expires waiting in the queue or mid-pricing (watchdog).
  * **Graceful degradation.**  A poisoned request fails ALONE: unknown
    nets are caught at pre-validation, and any grouped dispatch that
    raises or hangs (see the ``service_batch_exc`` /
    ``service_request_hang`` fault points in ``core.faultinject``) is
    retried per request serially — the batch is never dropped, and each
    failure surfaces as a structured ``ServiceError`` on its own future.
  * **Metrics.**  ``stats()`` returns a ``ServiceStats`` snapshot: queue
    depth, batch occupancy, coalescing ratio, p50/p95 request latency,
    and a race-safe cut of ``table_cache_stats()`` (cache/store hit
    rates).

Thread-safety note: the dispatcher and its pricing watchdog threads
drive the process-lifetime table caches concurrently with any direct
``Study`` use on other threads; the caches serialize check-then-build
under a lock (``core.dse._CACHE_LOCK``), so concurrent identical
queries build each table exactly once.

The port's own copy of the JAX package's ``serve/service.py``.  Requests
are priced by the port's ``Study`` on that study's device
(``Study(device=...)``), so the CUDA work of a search runs on the
service's dispatcher or pricing threads.  A watchdog that gives up on a
hung pricing thread leaves it running, and the degraded serial retry
then prices beside it: both launch on the device's default stream (a
new thread starts on it), so their kernels run in order, and the
host-side state they share — ``kernels.reduce``'s per-(device, stream)
workspace and its launch counters — is taken under locks.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ..core import faultinject
from ..core.dse import DSEResult, table_cache_stats
from ..core.study import Study, SweepRequest
from .metrics import ServiceMetrics, ServiceStats

HANG_DEFAULT_S = 3600.0        # service_request_hang without an arg


class ServiceError(RuntimeError):
    """Structured per-request failure.

    ``kind`` is one of ``"rejected"`` (admission control), ``"timeout"``
    (deadline passed in queue or mid-pricing), ``"invalid"`` (the
    workload itself cannot be resolved), or ``"error"`` (pricing raised;
    the original exception rides on ``__cause__``).  ``request`` is the
    offending ``DSERequest`` so callers can retry or log it."""
    kind = "error"

    def __init__(self, message: str,
                 request: Optional["DSERequest"] = None):
        self.request = request
        self.message = message
        tag = f" [{request.tag}]" if request is not None and request.tag \
            else ""
        super().__init__(f"[{self.kind}]{tag} {message}")


class AdmissionError(ServiceError):
    """Submission refused: the service is saturated or closed."""
    kind = "rejected"


class RequestTimeout(ServiceError):
    """The request's deadline passed before a result was produced."""
    kind = "timeout"


class InvalidRequest(ServiceError):
    """The workload cannot be resolved (unknown net, bad seq, ...)."""
    kind = "invalid"


class RequestFailed(ServiceError):
    """Pricing this request raised; the cause is chained."""
    kind = "error"


@dataclass(frozen=True)
class DSERequest(SweepRequest):
    """A ``SweepRequest`` plus service-level envelope fields.

    ``timeout_s`` is this request's deadline (measured from ``submit``;
    ``None`` falls back to the service default); ``tag`` is an opaque
    client label echoed in errors and ``Ticket.request``.  Neither field
    participates in ``dedup_key``/``group_key`` — they describe the
    *delivery*, not the answer."""
    timeout_s: Optional[float] = None
    tag: Optional[str] = None


class Ticket:
    """Client handle for one submitted request.

    ``result(timeout=None)`` blocks for the ``DSEResult``; it raises the
    structured ``ServiceError`` subclass the service resolved the
    request with on failure.  Deduplicated submissions hold tickets
    backed by the same future, so they observe one shared result."""

    def __init__(self, request: DSERequest, future: "Future[DSEResult]",
                 submitted_at: float):
        self.request = request
        self._future = future
        self._submitted_at = submitted_at

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> DSEResult:
        return self._future.result(timeout)

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        return self._future.exception(timeout)

    @property
    def latency_s(self) -> Optional[float]:
        """Submission-to-now wall time while pending, frozen usage is up
        to the caller; ``None`` before submission bookkeeping."""
        return time.monotonic() - self._submitted_at


class _Entry:
    """Internal queue record: request + future + deadline."""
    __slots__ = ("request", "future", "submitted_at", "deadline", "key")

    def __init__(self, request: DSERequest, submitted_at: float,
                 deadline: Optional[float], key: Optional[tuple]):
        self.request = request
        self.future: "Future[DSEResult]" = Future()
        self.submitted_at = submitted_at
        self.deadline = deadline
        self.key = key

    def remaining(self, now: float) -> Optional[float]:
        return None if self.deadline is None else self.deadline - now


class _WatchdogTimeout(Exception):
    """Internal: a pricing call outlived its watchdog deadline."""


def _run_with_watchdog(fn, timeout_s: Optional[float]):
    """Run ``fn()`` on a watchdog thread; raise ``_WatchdogTimeout`` if
    it neither returns nor raises within ``timeout_s`` (``None`` = run
    inline, unguarded).  A timed-out call keeps running on its daemon
    thread — it may still warm the shared caches — but its result is
    discarded and it can never touch a request future (completion
    happens in the caller, after this returns)."""
    if timeout_s is None:
        return fn()
    box: Dict[str, object] = {}
    done = threading.Event()

    def run():
        try:
            box["ok"] = fn()
        except BaseException as exc:       # noqa: BLE001 — re-raised below
            box["err"] = exc
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name="repro-dse-pricing")
    t.start()
    if not done.wait(max(0.001, timeout_s)):
        raise _WatchdogTimeout(f"pricing exceeded {timeout_s:.3f}s")
    if "err" in box:
        raise box["err"]                   # type: ignore[misc]
    return box["ok"]


class DSEService:
    """Concurrent sweep-serving front door over one ``Study``.

    Parameters:

    ``study``             the one ``Study`` whose hardware base, lattice,
                          store, workers, self-check, and backend every
                          request runs against
    ``max_pending``       admission bound: in-flight requests past which
                          ``submit`` raises ``AdmissionError``
    ``max_batch``         micro-batch size cap per dispatcher drain
    ``coalesce_window_s`` how long a drain waits for a burst to
                          accumulate after its first request
    ``batch_timeout_s``   watchdog ceiling per pricing dispatch when no
                          request deadline is tighter (``None`` disables
                          the watchdog entirely)
    ``default_timeout_s`` per-request deadline for requests that don't
                          carry their own (``None`` = no deadline)
    ``autostart``         spawn the dispatcher immediately; pass False
                          to submit a burst first and ``start()`` after,
                          which guarantees maximal coalescing
                          (deterministic tests/benchmarks)

    Use as a context manager: ``with DSEService(study) as svc: ...``
    closes and drains on exit."""

    def __init__(self, study: Study, *,
                 max_pending: int = 128,
                 max_batch: int = 16,
                 coalesce_window_s: float = 0.02,
                 batch_timeout_s: Optional[float] = 300.0,
                 default_timeout_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 autostart: bool = True):
        self.study = study
        self.max_pending = int(max_pending)
        self.max_batch = max(1, int(max_batch))
        self.coalesce_window_s = float(coalesce_window_s)
        self.batch_timeout_s = batch_timeout_s
        self.default_timeout_s = default_timeout_s
        self.poll_s = float(poll_s)
        self.metrics = ServiceMetrics()
        self._queue: "queue.Queue[_Entry]" = queue.Queue()
        self._lock = threading.Lock()
        self._inflight: Dict[tuple, _Entry] = {}   # guarded-by: self._lock
        self._pending = 0                          # guarded-by: self._lock
        self._closed = False                       # guarded-by: self._lock
        self._abandon = False                      # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._lock
        if autostart:
            self.start()

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "DSEService":
        """Spawn the dispatcher thread (idempotent)."""
        with self._lock:
            if self._closed:
                raise AdmissionError("service is closed")
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="repro-dse-dispatcher")
                self._thread.start()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting requests; by default let the dispatcher drain
        what is already queued, then join it.  ``drain=False`` fails the
        backlog with ``AdmissionError`` instead of pricing it."""
        with self._lock:
            self._closed = True
            if not drain:
                self._abandon = True
            t = self._thread
        self._stop.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def __enter__(self) -> "DSEService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- submission --------------------------------------------------------

    def submit(self, request, size_budget_kb: Optional[int] = None,
               bw_budget: Optional[int] = None, *,
               objective: Union[str, object, None] = "cycles",
               method: str = "grid",
               timeout_s: Optional[float] = None,
               tag: Optional[str] = None) -> Ticket:
        """Enqueue one query and return its ``Ticket`` immediately.

        Accepts either a prebuilt ``DSERequest``/``SweepRequest`` or the
        inline form ``submit(workload, size_budget_kb, bw_budget,
        objective=..., method=..., timeout_s=...)``.  Raises
        ``AdmissionError`` when the service is closed or ``max_pending``
        requests are already in flight."""
        if isinstance(request, DSERequest):
            req = request
        elif isinstance(request, SweepRequest):
            req = DSERequest(request.workload, request.size_budget_kb,
                             request.bw_budget, objective=request.objective,
                             method=request.method, timeout_s=timeout_s,
                             tag=tag)
        else:
            if size_budget_kb is None or bw_budget is None:
                raise TypeError("submit(workload, size_budget_kb, "
                                "bw_budget, ...) or submit(DSERequest)")
            req = DSERequest(request, size_budget_kb, bw_budget,
                             objective=objective, method=method,
                             timeout_s=timeout_s, tag=tag)
        now = time.monotonic()
        try:
            key: Optional[tuple] = req.dedup_key
            hash(key)
        except TypeError:                  # unhashable custom piece: no dedup
            key = None
        with self._lock:
            if self._closed:
                self.metrics.count("rejected")
                raise AdmissionError("service is closed", req)
            if key is not None:
                primary = self._inflight.get(key)
                if primary is not None:
                    self.metrics.count("submitted")
                    self.metrics.count("dedup_hits")
                    return Ticket(req, primary.future, now)
            if self._pending >= self.max_pending:
                self.metrics.count("rejected")
                raise AdmissionError(
                    f"queue full ({self.max_pending} requests pending)",
                    req)
            timeout = req.timeout_s if req.timeout_s is not None \
                else self.default_timeout_s
            entry = _Entry(req, now,
                           None if timeout is None else now + timeout, key)
            if key is not None:
                self._inflight[key] = entry
            self._pending += 1
        self._queue.put(entry)
        self.metrics.count("submitted")
        return Ticket(req, entry.future, now)

    # ---- metrics -----------------------------------------------------------

    def stats(self) -> ServiceStats:
        """A consistent ``ServiceStats`` snapshot (see ``serve.metrics``);
        the table-cache cut comes from ``table_cache_stats()``, which
        copies its counters under the cache lock."""
        with self._lock:
            inflight = self._pending
        return self.metrics.snapshot(queue_depth=self._queue.qsize(),
                                     inflight=inflight,
                                     table_cache=table_cache_stats())

    # ---- dispatcher --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=self.poll_s)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            window_end = time.monotonic() + self.coalesce_window_s
            while len(batch) < self.max_batch:
                remaining = window_end - time.monotonic()
                try:
                    batch.append(self._queue.get(
                        timeout=max(0.0, remaining)))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Entry]) -> None:
        self.metrics.batch(len(batch))
        now = time.monotonic()
        live: List[_Entry] = []
        with self._lock:
            abandon = self._abandon
        for e in batch:
            if abandon:
                self._fail(e, AdmissionError("service closed before "
                                             "dispatch", e.request))
                continue
            rem = e.remaining(now)
            if rem is not None and rem <= 0:
                self._fail(e, RequestTimeout(
                    f"deadline passed after {now - e.submitted_at:.3f}s "
                    f"in queue", e.request))
                continue
            # Pre-validation: a workload that cannot even resolve to a
            # layer graph (unknown net, seq on a CNN, ...) fails alone
            # here instead of poisoning its group's shared search call.
            try:
                e.request.workload.layers()
            except Exception as exc:
                err = InvalidRequest(str(exc), e.request)
                err.__cause__ = exc
                self._fail(e, err)
                continue
            live.append(e)
        groups: Dict[tuple, List[_Entry]] = {}
        for e in live:
            groups.setdefault(e.request.group_key, []).append(e)
        for entries in groups.values():
            self._price_group(entries)

    # ---- pricing -----------------------------------------------------------

    def _effective_timeout(self, entries: List[_Entry],
                           now: float) -> Optional[float]:
        """Watchdog budget for one dispatch: the tightest remaining
        request deadline, capped by ``batch_timeout_s``."""
        limits = [r for e in entries
                  if (r := e.remaining(now)) is not None]
        if self.batch_timeout_s is not None:
            limits.append(self.batch_timeout_s)
        return min(limits) if limits else None

    def _price_group(self, entries: List[_Entry]) -> None:
        """Price one compatible group with a single shared search; on any
        failure — an exception out of the dispatch or a watchdog trip —
        degrade to per-request serial evaluation so one poisoned request
        cannot take its batchmates down."""
        requests = [e.request for e in entries]

        def work() -> List[DSEResult]:
            f = faultinject.fire("service_batch_exc")
            if f is not None:
                raise RuntimeError(
                    "faultinject: injected dispatcher batch exception")
            f = faultinject.fire("service_request_hang")
            if f is not None:
                time.sleep(f.arg if f.arg is not None else HANG_DEFAULT_S)
            return self.study.search_requests(requests)

        try:
            results = _run_with_watchdog(
                work, self._effective_timeout(entries, time.monotonic()))
        except Exception:
            self.metrics.count("degraded_batches")
            self._price_serial(entries)
            return
        self.metrics.search(len(entries))
        for e, res in zip(entries, results):
            self._complete(e, res)

    def _price_serial(self, entries: List[_Entry]) -> None:
        """Degraded mode: each request priced (and watchdogged) alone, so
        failures and timeouts stay request-local."""
        for e in entries:
            now = time.monotonic()
            rem = e.remaining(now)
            if rem is not None and rem <= 0:
                self._fail(e, RequestTimeout(
                    "deadline passed during degraded batch", e.request))
                continue

            def work_one(req=e.request) -> DSEResult:
                f = faultinject.fire("service_request_hang")
                if f is not None:
                    time.sleep(f.arg if f.arg is not None
                               else HANG_DEFAULT_S)
                return self.study.search_requests([req])[0]

            try:
                res = _run_with_watchdog(
                    work_one, self._effective_timeout([e], now))
            except _WatchdogTimeout as exc:
                self._fail(e, RequestTimeout(str(exc), e.request))
            except Exception as exc:
                err = RequestFailed(f"{type(exc).__name__}: {exc}",
                                    e.request)
                err.__cause__ = exc
                self._fail(e, err)
            else:
                self.metrics.search(1)
                self._complete(e, res)

    # ---- completion fan-out ------------------------------------------------

    def _retire(self, e: _Entry) -> None:
        with self._lock:
            if e.key is not None and self._inflight.get(e.key) is e:
                del self._inflight[e.key]
            self._pending -= 1

    def _complete(self, e: _Entry, result: DSEResult) -> None:
        self._retire(e)
        e.future.set_result(result)
        self.metrics.completed(time.monotonic() - e.submitted_at)

    def _fail(self, e: _Entry, error: ServiceError) -> None:
        self._retire(e)
        e.future.set_exception(error)
        self.metrics.failed(timeout=isinstance(error, RequestTimeout))
