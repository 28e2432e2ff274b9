"""What a kind's run is handed: the cell, the run's arguments, the device,
the ``impl`` the program calls its kernels through, and the clock the
set-up time is taken on."""
from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from . import trace as TR
from .record import launch_counts


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``, in clock ticks since boot); 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


@dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    impl: object
    recorder: Optional[object] = None
    started: float = field(default_factory=lambda: time.perf_counter()
                           - process_age())
    setup_s: Optional[float] = None
    # seconds of each part of set-up, in order (``mark``)
    parts: Dict[str, float] = field(default_factory=dict)

    def mark(self, part: str, sync: bool = True) -> None:
        """Set-up's ``part`` ends now (it began where the last ended),
        once the device has finished its work (``sync``)."""
        if sync:
            self.sync()
        done = sum(self.parts.values())
        self.parts[part] = time.perf_counter() - self.started - done

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """The window starts: set-up is what the process did until now."""
        self.mark("warm-up")
        self.setup_s = sum(self.parts.values())

    def traced(self, fn: Callable[[], None]) -> dict:
        """``fn`` twice: once with the recording ``impl`` on, for each
        kernel call's ``(kernel, shapes, dtype, causal, seconds)`` by
        events (on the card), and once under the profiler, for the
        trace's reduction (``trace.reduce``) and the port's own launch
        counts over it (``port_launches``).  The profiler's host cost
        opens gaps between a call's events that they would count as the
        kernel's, so the two never run together."""
        self.recorder.on = True
        try:
            fn()
        finally:
            self.recorder.on = False
        calls = self.recorder.timed() if self.recorder.calls else []
        self.recorder.calls.clear()
        before = launch_counts()
        out = TR.reduce(*TR.profile(fn))
        out["calls"] = calls
        out["port_launches"] = {k: n - before[k]
                                for k, n in launch_counts().items()}
        return out

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
