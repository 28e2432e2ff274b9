"""Fault tolerance: step watchdog (hang/straggler detection) and the
restart contract.  The port's own copy of the JAX package's
``distributed/fault.py``.

At 1000+-node scale the failure modes are (a) hard node loss — the job
dies and the launcher restarts it; recovery = CheckpointManager.restore on
a possibly different mesh (elastic); (b) soft hangs / stragglers — a host
stalls inside a collective, everyone blocks.  The watchdog detects (b):
the train loop beats once per step; if no beat arrives within ``timeout``
the callback fires (default: checkpoint + abort, converting a silent hang
into a restartable hard failure).  Straggler *mitigation* beyond
detection (e.g. backup workers) is a scheduler-level concern documented in
DESIGN.md; detection + fast restart is what the framework owns.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Watchdog:
    """``_fired`` latches once per stall so a hung callback isn't invoked
    every poll tick, and ``beat()`` re-arms it — a second stall later in
    the same run fires again instead of being silently absorbed by the
    first.  The latch and the stop flag are read/written under a lock so
    ``stop()`` can never race ``_run`` into firing after shutdown."""

    def __init__(self, timeout_s: float,
                 on_stall: Callable[[float], None]):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._fired = False          # re-arm: detect the *next* stall too

    def _run(self) -> None:
        while not self._stop.wait(self.timeout_s / 10):
            with self._lock:
                idle = time.monotonic() - self._last
                fire = (idle > self.timeout_s and not self._fired
                        and not self._stop.is_set())
                if fire:
                    self._fired = True
            if fire:
                self.on_stall(idle)

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
