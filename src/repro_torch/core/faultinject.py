"""Deterministic fault injection for the DSE durability layer.

The robustness contract of the persistent table store (``core.store``)
and the fault-tolerant parallel table builds (``core.dse``) is only
worth anything if every recovery path is actually exercised, so this
module provides *deterministic, countable* fault hooks in the spirit of
the step watchdog in ``repro.distributed.fault``: production code asks
``fire(point)`` at a named fault point and this module answers "inject
now" a configured number of times, then never again.

Faults are armed either in-process (tests)::

    faultinject.arm("conv_worker_crash", times=1)

or through the ``REPRO_FAULTS`` environment variable (CI / subprocess
harnesses), a comma-separated list of ``point[:times[:arg]]`` items::

    REPRO_FAULTS="conv_worker_crash:2,store_corrupt:1,conv_worker_hang:1:30"

Known fault points (the arg is point-specific):

=====================  =====================================================
``conv_worker_exc``    a parallel ConvTable build task raises in the worker
``conv_worker_crash``  a worker hard-exits mid-task (``os._exit``) — the
                       pool surfaces ``BrokenProcessPool``
``conv_worker_hang``   a worker sleeps ``arg`` seconds (default 3600),
                       tripping the per-attempt build timeout
``store_corrupt``      the table-store file just written gets a flipped
                       byte (checksum failure on next load)
``store_truncate``     the file just written is truncated to half
``store_lock_hold``    the store's advisory lock is held ``arg`` seconds
                       (default 1.0) while inside the critical section,
                       exercising lock-contention timeouts in other
                       writers
``selfcheck_perturb``  the study self-check's reference cycles are
                       perturbed by ``arg`` (default 1) — proves the
                       integrity comparison actually trips on drift
``service_batch_exc``  a ``repro.serve`` grouped dispatch raises before
                       pricing — the service must degrade to per-request
                       serial evaluation, not drop the batch
``service_request_hang``  a ``repro.serve`` pricing call sleeps ``arg``
                       seconds (default 3600), tripping the service
                       watchdog; in degraded serial mode only the hung
                       request times out
=====================  =====================================================

Counts are consumed in the process that *queries* the fault point.  The
parallel-build faults are deliberately consumed on the submission side
(in the parent) and shipped to the worker as task directives, so
``times=1`` means exactly one poisoned task — not one per forked worker.

Everything here is inert unless armed: ``fire`` on an unarmed point is a
dict lookup returning ``None``.
"""
from __future__ import annotations

import os
import threading
import warnings
from dataclasses import dataclass, replace
from typing import Dict, Optional

ENV_VAR = "REPRO_FAULTS"

# The canonical fault-point registry.  Injection sites (``fire``), tests
# (``arm`` / REPRO_FAULTS specs), and the docstring table above must all
# use these names; ``repro.analysis`` cross-checks the three sets, and
# ``arm`` warns on a name not listed here.
FAULT_POINTS: Dict[str, str] = {
    "conv_worker_exc": "parallel ConvTable build task raises in the worker",
    "conv_worker_crash": "worker hard-exits mid-task (BrokenProcessPool)",
    "conv_worker_hang": "worker sleeps arg seconds, tripping build timeout",
    "store_corrupt": "table-store file gets a flipped byte after write",
    "store_truncate": "table-store file truncated to half after write",
    "store_lock_hold": "store advisory lock held arg seconds in-section",
    "selfcheck_perturb": "self-check reference cycles perturbed by arg",
    "service_batch_exc": "serve grouped dispatch raises before pricing",
    "service_request_hang": "serve pricing call sleeps arg seconds",
}


@dataclass
class Fault:
    """One armed fault: remaining firing count plus an optional argument
    (seconds for hangs/lock holds)."""
    point: str
    times: int
    arg: Optional[float] = None


# Armed faults are mutated from every thread that prices (the serving
# dispatcher, build workers' parent, tests): all registry state below is
# guarded by one lock.  ``fire`` must be a single atomic
# check-decrement-count — two racing callers must consume two distinct
# firings, never the same one twice.
_FAULT_LOCK = threading.Lock()
_FAULTS: Dict[str, Fault] = {}       # guarded-by: _FAULT_LOCK
_FIRED: Dict[str, int] = {}          # guarded-by: _FAULT_LOCK


def arm(point: str, times: int = 1, arg: Optional[float] = None) -> None:
    """Arm ``point`` to fire on its next ``times`` queries.  Unknown
    points warn (a typo here silently disables a recovery test) but
    still arm."""
    if point not in FAULT_POINTS:
        warnings.warn(
            f"arming unknown fault point {point!r} — not in "
            f"FAULT_POINTS; is it a typo?", RuntimeWarning, stacklevel=2)
    with _FAULT_LOCK:
        _FAULTS[point] = Fault(point, int(times), arg)


def disarm(point: str) -> None:
    with _FAULT_LOCK:
        _FAULTS.pop(point, None)


def reset() -> None:
    """Disarm everything and zero the fired counters (test teardown)."""
    with _FAULT_LOCK:
        _FAULTS.clear()
        _FIRED.clear()


def armed(point: str) -> bool:
    with _FAULT_LOCK:
        f = _FAULTS.get(point)
        return f is not None and f.times != 0


def fired(point: str) -> int:
    """How many times ``point`` has actually fired in this process."""
    with _FAULT_LOCK:
        return _FIRED.get(point, 0)


def fire(point: str) -> Optional[Fault]:
    """Consume one firing of ``point``: returns a snapshot of the armed
    ``Fault`` (for its ``arg``) when the fault should be injected now,
    else ``None``.  ``times < 0`` arms a fault that fires on every
    query.  Atomic: concurrent callers each consume a distinct firing."""
    with _FAULT_LOCK:
        f = _FAULTS.get(point)
        if f is None or f.times == 0:
            return None
        if f.times > 0:
            f.times -= 1
        _FIRED[point] = _FIRED.get(point, 0) + 1
        return replace(f)


def load_env(env: Optional[str] = None) -> None:
    """Arm faults from a ``REPRO_FAULTS``-style spec string (default: the
    environment variable).  Malformed items are skipped with a
    ``RuntimeWarning`` naming the bad item — a typo'd fault spec must
    never silently disable a CI fault suite."""
    spec = os.environ.get(ENV_VAR, "") if env is None else env
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        try:
            point = parts[0]
            if not point:
                raise ValueError("empty fault point")
            times = int(parts[1]) if len(parts) > 1 else 1
            arg = float(parts[2]) if len(parts) > 2 else None
            if len(parts) > 3:
                raise ValueError("too many fields")
        except ValueError as exc:
            warnings.warn(
                f"ignoring malformed {ENV_VAR} item {item!r} ({exc}); "
                f"expected point[:times[:arg]]", RuntimeWarning,
                stacklevel=2)
            continue
        arm(point, times, arg)


load_env()
