"""What every kernel wrapper of the port checks before it runs, and how it
binds and calls its library.

A wrapper runs its CUDA kernel for CUDA tensors and its plain PyTorch
version for CPU tensors; that is how a caller asks for the CPU.  Any other
device, tensors on two devices, a type other than float32 or bfloat16, a
non-contiguous tensor, or a ``DTensor`` (whose kernels run on its local
shards, ``kernels.ops.partitioned``) raises.  Nothing falls back: a
failed build or launch raises too.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

# element type codes of csrc/common.cuh::ReproDtype
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def is_placed(t) -> bool:
    """Whether ``t`` is a ``DTensor``: laid out on a ``DeviceMesh``."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def device_kind(fn: str, tensors: Dict[str, torch.Tensor]) -> str:
    """``"cuda"`` or ``"cpu"``: the one device of ``tensors`` (argument
    name -> tensor), each a contiguous float32 or bfloat16 tensor."""
    device = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {arg} must be a tensor, got {type(t)}")
        if is_placed(t):
            raise TypeError(f"{fn}: {arg} is a DTensor; a kernel runs on "
                            f"local shards (kernels.ops.partitioned)")
        if t.dtype not in DTYPE_CODE:
            raise TypeError(f"{fn}: {arg} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{fn}: {arg} is on {t.device}, the other "
                             f"inputs on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {arg} must be contiguous")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn} runs on cuda or cpu tensors, not "
                         f"{device.type}")
    return device.type


def same_dtype(fn: str, tensors: Dict[str, torch.Tensor]) -> torch.dtype:
    """The one element type of ``tensors``; two types raise."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1:
        raise TypeError(f"{fn}: {', '.join(tensors)} must have one type, "
                        f"got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def positive_int(fn: str, **values: int) -> None:
    for name, v in values.items():
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{fn}: {name} must be a positive int, got {v!r}")


@functools.lru_cache(maxsize=None)
def library(source: str, launch: str, argtypes: Sequence) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built on first use, with its
    ``<launch>`` entry point and error-string export bound."""
    from ._ext import load_library
    lib = load_library(source)
    fn = getattr(lib, launch)
    fn.restype = ctypes.c_int
    fn.argtypes = tuple(argtypes)
    err = getattr(lib, launch.replace("_launch", "_error_string"))
    err.restype = ctypes.c_char_p
    err.argtypes = (ctypes.c_int,)
    return lib


def call(lib: ctypes.CDLL, launch: str, device: torch.device, *args) -> None:
    """Run ``lib.<launch>(*args, stream)`` on ``device``'s current stream
    and raise if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, launch)(*args, stream)
    if err != 0:
        msg = getattr(lib, launch.replace("_launch", "_error_string"))(err)
        raise RuntimeError(f"{launch} failed: {msg.decode()} ({err})")
