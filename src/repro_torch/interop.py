"""Carry arrays between numpy and the port's tensors, bit for bit.

The tests make their inputs with numpy and hand the same arrays to the JAX
package and to the port.  ``np.asarray`` of a JAX bfloat16 array has the
``bfloat16`` dtype that ``ml_dtypes`` registers with numpy, which
``torch.from_numpy`` refuses.  Such arrays cross through a 16-bit integer
view of the same bits, so nothing is rounded on the way.  The dtype is
recognised by its name: this module imports neither jax nor ml_dtypes.

``params_from_numpy`` carries a whole tree the same way: the JAX
package's parameters or KV cache, taken to numpy leaf by leaf, become the
port's tree with the same keys and bits.

``to_stored`` and ``from_stored`` are the checkpoint format's view of a
tensor (the JAX package's ``checkpoint/manager.py``): numpy without
``ml_dtypes`` has no bfloat16, so a bfloat16 tensor is stored as a
``uint16`` array of the same bits beside its logical dtype's name.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """``arr`` as a contiguous tensor on ``device``, with the same bits
    (a numpy ``bfloat16`` array becomes a ``torch.bfloat16`` tensor)."""
    # (np.ascontiguousarray would make a 0-dim array 1-dim)
    arr = np.require(arr, requirements="C")
    if not arr.flags.writeable:      # e.g. np.asarray of a JAX array
        arr = arr.copy()
    if arr.dtype.name == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host, with the same bits.  A
    ``torch.bfloat16`` tensor becomes an array of numpy's registered
    ``bfloat16`` dtype, so ``ml_dtypes`` (which jax imports) must have
    registered it; otherwise numpy raises ``TypeError``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype(_BF16))
    return t.numpy()


def params_from_numpy(tree, device) -> dict:
    """A tree of nested dicts of numpy arrays (a parameter tree or a
    cache) as the same tree of tensors on ``device``, bit for bit."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return from_numpy(np.asarray(tree), device)


def to_stored(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """``t`` on the host as numpy stores it, and its logical dtype's name:
    a bfloat16 tensor as a ``uint16`` view of its bits and
    ``"bfloat16"``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def from_stored(arr: np.ndarray, logical: str) -> torch.Tensor:
    """The tensor ``to_stored`` gave ``arr`` and ``logical`` for (a
    ``uint16`` array whose logical dtype is bfloat16 becomes a bfloat16
    tensor of the same bits), on the CPU."""
    if logical == _BF16:
        bits = np.require(arr, requirements="C").view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return from_numpy(arr)
