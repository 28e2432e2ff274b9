"""Production mesh construction: the port of the JAX package's
``launch/mesh.py`` over ``torch.distributed``.

Both functions build a ``DeviceMesh`` (``init_device_mesh``) over the
process group that is already up, one rank a device: the caller starts
the group (``torch.distributed.init_process_group``; on one machine with
a ``FileStore`` or a ``tcp://localhost`` address).  A mesh whose size
differs from the group's raises, with the world size found: a smaller
mesh is never built in its place.  Importing this module touches no
device and no process group.

On one process, the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg`` gives a group of any
size, so the production meshes (256 and 512 ranks) build for a dry run.
"""
from __future__ import annotations

import math
from typing import Sequence

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTIPOD_SHAPE = (2, 16, 16)
MULTIPOD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    if multi_pod:
        return make_mesh(MULTIPOD_SHAPE, MULTIPOD_AXES, device_type)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A mesh of any ``shape`` with axis names ``axes`` (e.g. ``(4,)``,
    ``("stage",)`` for a pipeline) over the whole process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         f"in rank")
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh: no process group is up for a "
                           f"{shape} mesh (init_process_group first)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_mesh: a {shape} mesh needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"world size {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
