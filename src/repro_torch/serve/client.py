"""Client-side convenience wrapper around a ``DSEService``.

The service's native surface is ``submit() -> Ticket``; this wrapper
adds the three shapes callers actually write:

  * ``query(...)``        — synchronous single query (submit + wait)
  * ``submit(...)``       — passthrough, returns the ``Ticket``
  * ``query_burst(...)``  — submit a whole burst first, THEN gather, so
    the dispatcher sees the burst inside one coalesce window and can
    group it (submit-then-wait loops serialize and defeat coalescing)

``query_burst`` with ``return_errors=True`` maps failed requests to
their ``ServiceError`` instead of raising, which is what sweep drivers
want: one poisoned config shouldn't abort the gather of the other N-1.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from ..core.dse import DSEResult
from .service import DSERequest, DSEService, ServiceError, Ticket


class DSEClient:
    """Thin, thread-safe facade over one ``DSEService``.

    Many clients (one per thread, or one shared — both are fine) can
    point at the same service; all state lives in the service."""

    def __init__(self, service: DSEService):
        self.service = service

    def submit(self, workload, size_budget_kb: Optional[int] = None,
               bw_budget: Optional[int] = None, *,
               objective: Union[str, object, None] = "cycles",
               method: str = "grid",
               timeout_s: Optional[float] = None,
               tag: Optional[str] = None) -> Ticket:
        """Enqueue one query (inline fields or a prebuilt ``DSERequest``
        as the sole argument); returns immediately with its ``Ticket``."""
        return self.service.submit(
            workload, size_budget_kb, bw_budget, objective=objective,
            method=method, timeout_s=timeout_s, tag=tag)

    def query(self, workload, size_budget_kb: int, bw_budget: int, *,
              objective: Union[str, object, None] = "cycles",
              method: str = "grid",
              timeout_s: Optional[float] = None,
              tag: Optional[str] = None) -> DSEResult:
        """Synchronous query: submit and block for the ``DSEResult``
        (raises the request's ``ServiceError`` on failure)."""
        return self.submit(workload, size_budget_kb, bw_budget,
                           objective=objective, method=method,
                           timeout_s=timeout_s, tag=tag).result()

    def submit_burst(self, requests: Sequence[DSERequest]) -> List[Ticket]:
        """Submit every request before waiting on any — the coalescing-
        friendly pattern.  Admission failures surface immediately."""
        return [self.service.submit(r) for r in requests]

    def query_burst(self, requests: Sequence[DSERequest], *,
                    return_errors: bool = False
                    ) -> List[Union[DSEResult, ServiceError]]:
        """Submit a burst, then gather in submission order.

        With ``return_errors=False`` (default) the first failure raises
        its ``ServiceError``; with ``True`` each failed slot holds its
        error so the healthy majority still comes back."""
        tickets = self.submit_burst(requests)
        out: List[Union[DSEResult, ServiceError]] = []
        for t in tickets:
            if return_errors:
                err = t.exception()
                out.append(err if err is not None else t.result())
            else:
                out.append(t.result())
        return out
