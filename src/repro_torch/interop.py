"""Carry arrays between numpy and the port's tensors, bit for bit.

The tests make their inputs with numpy and hand the same arrays to the JAX
package and to the port.  ``np.asarray`` of a JAX bfloat16 array has the
``bfloat16`` dtype that ``ml_dtypes`` registers with numpy, which
``torch.from_numpy`` refuses.  Such arrays cross through a 16-bit integer
view of the same bits, so nothing is rounded on the way.  The dtype is
recognised by its name: this module imports neither jax nor ml_dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

_BF16 = "bfloat16"


def from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """``arr`` as a contiguous tensor on ``device``, with the same bits
    (a numpy ``bfloat16`` array becomes a ``torch.bfloat16`` tensor)."""
    arr = np.ascontiguousarray(arr)
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
