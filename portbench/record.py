"""The ``impl`` a traced run hands the program: every kernel call goes on
to ``repro_torch.kernels.ops``; while ``on``, each is bracketed by two
CUDA events on the current stream and kept with its shapes and type, so
that its device time can be read once the stream has drained.  Outside
the traced segment it only forwards.  Untraced runs hand the program
``ops`` itself.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

KERNELS = ("matmul", "bn_forward", "bn_backward", "flash_attention",
           "fused_add_rmsnorm")


class RecordingOps:
    def __init__(self, ops):
        self.ops, self.on = ops, False
        self.calls: List[Tuple] = []
        for name in KERNELS:
            setattr(self, name, self._wrap(name, getattr(ops, name)))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if not self.on or not tensors[0].is_cuda:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            self.calls.append((name, tuple(tuple(t.shape) for t in tensors),
                               str(tensors[0].dtype).replace("torch.", ""),
                               bool(kwargs.get("causal", True)), start,
                               stop))
            return out
        return call

    def timed(self) -> List[Tuple[str, tuple, str, bool, float]]:
        """``(kernel, shapes, dtype, causal, seconds)`` of each recorded
        call (waits for the device)."""
        torch.cuda.synchronize()
        return [(k, s, d, c, a.elapsed_time(b) / 1e3)
                for k, s, d, c, a, b in self.calls]


def launch_counts() -> dict:
    """The port's own launch counters (``ops.launch_counters``): each
    kernel's launches, and the GEMM's by route as ``matmul.<route>``."""
    from repro_torch.kernels import ops
    counters = ops.launch_counters()
    out = {k: fn.launches for k, fn in counters.items()}
    out.update({f"matmul.{r}": n
                for r, n in counters["matmul"].routes.items()})
    return out
