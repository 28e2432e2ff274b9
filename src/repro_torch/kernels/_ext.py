"""Build-on-first-use loader for the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``; the wrappers pass device pointers (``Tensor.data_ptr()``) and
PyTorch's current stream.  Sources carry no PyTorch headers, so a build
takes seconds.  Libraries go into ``build/`` beside this file (listed in
``.gitignore``) under a name that hashes the sources and the flags, so a
changed source rebuilds and an unchanged one loads from disk.

Nothing here runs at import: the compiler is looked up and run only when
a wrapper first launches its kernel on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# compiler output of each build in this process (ptxas register and
# shared-memory report), keyed by source name
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded-by: _LOCK
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are compiled on first use")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _build(source: str) -> Path:
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True)
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)                 # atomic: readers never see a part
    return out


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = _LIBS[source] = ctypes.CDLL(str(_build(source)))
        return lib
