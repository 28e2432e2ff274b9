"""Checkpointing: atomic, retention-managed, in the JAX package's format.

The port of the JAX package's ``checkpoint/manager.py``
(``CheckpointManager``, :47).  Fault-tolerance contract:
  * atomic: write to ``<dir>/tmp.<step>`` then ``os.replace`` -> a crash
    mid-save never corrupts the latest checkpoint;
  * resumable: ``latest_step`` + ``restore`` reconstruct params, optimizer
    state, and the data-pipeline state;
  * preemption-aware: ``CheckpointManager.save_on_signal`` installs a
    SIGTERM hook that flushes a checkpoint before exit.

The format is the JAX package's, so a checkpoint written by either
package restores in the other: ``step_<10 digits>/arrays.npz`` holds one
array per leaf under its path (keys joined by ``/``, written ``__``),
and ``manifest.json`` the step, each leaf's key, shape and logical dtype,
and ``extra``.  A bfloat16 leaf is stored as a ``uint16`` view of its
bits (``interop.to_stored``).  Arrays are saved whole: a ``DTensor``
leaf (state placed on a ``DeviceMesh``) is gathered (``full_tensor``,
which every rank calls) and rank 0 alone writes.  ``restore`` places
every leaf on one device (``device``) or on its template leaf's, or,
given ``shardings`` (a tree of ``(mesh, placements)`` such as
``launch.train.make_state_shardings`` returns), ``distribute_tensor``s
each leaf onto its mesh, which may differ from the saving run's (the
JAX package's elastic restart): each rank reads the arrays and keeps
its own shard, with no communication.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import signal
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import from_stored, to_stored
from ..models.common import is_placed


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of nested dicts in ``jax.tree_util``'s
    order (sorted keys, depth first), the path's keys joined by ``/``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _rank() -> int:
    """This process's rank in the default group (0 without one): rank 0
    alone writes a checkpoint."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _rebuild(template, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves, prefix + (str(k),))
                for k in sorted(template)}
    return leaves["/".join(prefix)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ---- write -------------------------------------------------------------
    def save(self, step: int, state: Dict, extra: Optional[Dict] = None
             ) -> pathlib.Path:
        flat = _flatten_with_paths(state)
        placed = any(is_placed(leaf) for _, leaf in flat)
        flat = [(key, leaf.full_tensor() if is_placed(leaf) else leaf)
                for key, leaf in flat]
        final = self.dir / f"step_{step:010d}"
        if _rank() == 0:
            self._write(step, flat, extra, final)
        if placed:                        # the others read it after this
            import torch.distributed as dist
            dist.barrier()
        return final

    def _write(self, step: int, flat, extra: Optional[Dict],
               final: pathlib.Path) -> None:
        tmp = self.dir / f"tmp.{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        arrays = {}
        for key, leaf in flat:
            arr, logical = to_stored(leaf)
            arrays[key] = arr
            manifest["leaves"].append(
                {"key": key, "shape": list(arr.shape), "dtype": logical})
        np.savez(tmp / "arrays.npz",
                 **{k.replace("/", "__"): v for k, v in arrays.items()})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():                # re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)            # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---- read --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, device=None, shardings=None
                ) -> Tuple[Dict, Dict]:
        """Restore into the structure of ``template`` (a tree of tensors
        or ``TensorSpec``s): each leaf in its template leaf's dtype, on
        ``device`` if given, else on the template leaf's device (the CPU
        for a ``TensorSpec``); with ``shardings`` (the template's tree of
        ``(mesh, placements)``) each leaf a ``DTensor`` on its mesh's
        device.  Returns ``(state, extra)``."""
        pairs = (dict(_flatten_with_paths(shardings))
                 if shardings is not None else None)
        path = self.dir / f"step_{step:010d}"
        with np.load(path / "arrays.npz") as data:
            manifest = json.loads((path / "manifest.json").read_text())
            logical = {l["key"]: l["dtype"] for l in manifest["leaves"]}
            stored = {k.replace("__", "/"): data[k] for k in data.files}
        restored = {}
        for key, leaf in _flatten_with_paths(template):
            arr = stored[key]
            t = from_stored(arr, logical.get(key, str(arr.dtype)))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint step {step}: {key} has shape "
                                 f"{tuple(t.shape)}, the template "
                                 f"{tuple(leaf.shape)}")
            if pairs is not None:
                mesh, pl = pairs[key]
                from torch.distributed.tensor import distribute_tensor
                restored[key] = distribute_tensor(
                    t.to(device=mesh.device_type, dtype=leaf.dtype), mesh,
                    pl, src_data_rank=None)
                continue
            where = device if device is not None else getattr(
                leaf, "device", "cpu")
            restored[key] = t.to(device=where, dtype=leaf.dtype)
        return _rebuild(template, restored), manifest["extra"]

    # ---- preemption hook -----------------------------------------------------
    def save_on_signal(self, get_state: Callable[[], Tuple[int, Dict, Dict]],
                       signals=(signal.SIGTERM,)) -> None:
        def handler(signum, frame):
            step, state, extra = get_state()
            self.save(step, state, extra)
            raise SystemExit(128 + signum)
        for s in signals:
            signal.signal(s, handler)
