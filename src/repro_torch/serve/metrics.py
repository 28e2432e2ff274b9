"""Service metrics: the observability surface of ``repro_torch.serve``.

Two pieces:

  * ``ServiceMetrics`` — the mutable, lock-guarded accumulator the
    ``DSEService`` dispatcher and client threads write into (counters,
    a bounded latency window, batch occupancy sums).
  * ``ServiceStats`` — an immutable snapshot of everything at one
    instant: request counters, batch/coalescing numbers, p50/p95 request
    latency, queue depth, and a consistent cut of the shared table-cache
    counters (``table_cache_stats()`` itself snapshots under the cache
    lock, so hits/misses/builds are never torn).

The headline number is ``coalescing_ratio``: requests priced per
``search_many`` dispatch.  A ratio of 1.0 means every query paid its own
search; above 1.0 means concurrent queries shared grouped dispatches
(and, through the union tables inside each dispatch plus the
process-lifetime caches across dispatches, shared table builds — the
thing that makes serving cheaper than N independent scripts).
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LATENCY_WINDOW = 4096          # completed-request latencies retained


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile of an unsorted sample (0 <= q <= 1);
    0.0 on an empty sample.  Deterministic and dependency-free — the
    service snapshot must never need numpy for a handful of floats."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(0, min(len(s) - 1, int(round(q * (len(s) - 1)))))
    return s[rank]


@dataclass(frozen=True)
class ServiceStats:
    """Immutable metrics snapshot; see ``DSEService.stats()``.

    Counter semantics:

    ``submitted``        accepted requests (dedup followers included)
    ``completed``        requests resolved with a result
    ``failed``           requests resolved with a structured error
                         (timeouts counted separately in ``timeouts``)
    ``rejected``         admission-control refusals (never enqueued)
    ``dedup_hits``       submissions answered by an in-flight duplicate
    ``batches``          dispatcher micro-batches drained
    ``degraded_batches`` grouped dispatches that fell back to
                         per-request serial evaluation
    ``searches``         pricing dispatches (grouped ``search_many``
                         calls + serial per-request evaluations)
    ``priced_requests``  requests answered through those dispatches
    """
    submitted: int
    completed: int
    failed: int
    timeouts: int
    rejected: int
    dedup_hits: int
    batches: int
    batch_requests: int
    degraded_batches: int
    searches: int
    priced_requests: int
    queue_depth: int
    inflight: int
    latency_p50_s: float
    latency_p95_s: float
    latency_samples: int
    table_cache: Dict[str, object] = field(repr=False)

    @property
    def batch_occupancy(self) -> float:
        """Mean requests per dispatched micro-batch."""
        return self.batch_requests / self.batches if self.batches else 0.0

    @property
    def coalescing_ratio(self) -> float:
        """Requests priced per pricing dispatch (dedup followers ride
        their primary's dispatch, so they count toward the numerator)."""
        return ((self.priced_requests + self.dedup_hits) / self.searches
                if self.searches else 0.0)

    def _hit_rate(self, hits_key: str, misses_key: str) -> float:
        h = int(self.table_cache.get(hits_key, 0))
        m = int(self.table_cache.get(misses_key, 0))
        return h / (h + m) if h + m else 0.0

    @property
    def table_hit_rate(self) -> float:
        """L1 hit rate over every table kind (conv + simd + gemm)."""
        h = sum(int(self.table_cache.get(f"{k}_hits", 0))
                for k in ("conv", "simd", "gemm"))
        m = sum(int(self.table_cache.get(f"{k}_misses", 0))
                for k in ("conv", "simd", "gemm"))
        return h / (h + m) if h + m else 0.0

    @property
    def store_hit_rate(self) -> float:
        """Persistent-store (L2) hit rate; 0.0 when the store is off."""
        return self._hit_rate("store_hits", "store_misses")

    def summary(self) -> str:
        """One human line for logs and the example/benchmark output."""
        return (f"submitted={self.submitted} completed={self.completed} "
                f"failed={self.failed} timeouts={self.timeouts} "
                f"rejected={self.rejected} dedup={self.dedup_hits} "
                f"batches={self.batches} "
                f"occupancy={self.batch_occupancy:.2f} "
                f"coalescing={self.coalescing_ratio:.2f}x "
                f"degraded={self.degraded_batches} "
                f"p50={self.latency_p50_s * 1e3:.1f}ms "
                f"p95={self.latency_p95_s * 1e3:.1f}ms "
                f"table_hit_rate={self.table_hit_rate:.2f} "
                f"store_hit_rate={self.store_hit_rate:.2f}")


class ServiceMetrics:
    """Lock-guarded accumulator behind ``DSEService.stats()``.

    Every mutator is a single short critical section, safe to call from
    the dispatcher thread, pricing watchdog threads, and any number of
    client threads at once."""

    def __init__(self, latency_window: int = LATENCY_WINDOW):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {             # guarded-by: self._lock
            k: 0 for k in ("submitted", "completed", "failed", "timeouts",
                           "rejected", "dedup_hits", "batches",
                           "batch_requests", "degraded_batches",
                           "searches", "priced_requests")}
        self._latencies: deque = deque(maxlen=latency_window)  # guarded-by: self._lock

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def batch(self, n_requests: int) -> None:
        with self._lock:
            self._counts["batches"] += 1
            self._counts["batch_requests"] += n_requests

    def search(self, n_priced: int) -> None:
        with self._lock:
            self._counts["searches"] += 1
            self._counts["priced_requests"] += n_priced

    def completed(self, latency_s: float) -> None:
        with self._lock:
            self._counts["completed"] += 1
            self._latencies.append(latency_s)

    def failed(self, timeout: bool) -> None:
        with self._lock:
            self._counts["failed"] += 1
            if timeout:
                self._counts["timeouts"] += 1

    def snapshot(self, queue_depth: int, inflight: int,
                 table_cache: Dict[str, object]) -> ServiceStats:
        with self._lock:
            counts = dict(self._counts)
            lats = list(self._latencies)
        return ServiceStats(
            queue_depth=queue_depth, inflight=inflight,
            latency_p50_s=percentile(lats, 0.50),
            latency_p95_s=percentile(lats, 0.95),
            latency_samples=len(lats),
            table_cache=table_cache, **counts)
