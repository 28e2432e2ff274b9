"""Crash-safe persistent table store: the L2 under the in-memory caches.

The process-lifetime ``ConvTable``/``SimdTable`` caches in ``core.dse``
die with the process, so every CLI run and CI job repays the full table
build cost.  This module promotes them to a *content-addressed on-disk
store* shared across workers and sessions — the durability half of the
ROADMAP's "DSE-as-a-service" item:

  * **Content addressing.**  An entry's filename is
    ``<kind>-<sha256(port | schema | kind | stable_key_repr(key))>.tbl`` where
    ``key`` is the exact in-memory cache key (hardware invariants +
    size triple + layer-shape/phase tuple) serialized canonically by
    ``tiling.stable_key_repr``.  Bumping ``SCHEMA_VERSION`` re-addresses
    everything, so stale-format files are simply never looked up.
  * **Atomic writes.**  Entries are written to a tempfile in the store
    directory, flushed + fsynced, then ``os.replace``d into place —
    readers never observe a half-written file, and concurrent writers of
    the same key are last-writer-wins with either result valid.
  * **Checksummed loads, quarantine on corruption.**  Every file embeds a
    magic, the schema version, and a SHA-256 digest of its payload.  Any
    validation failure — truncation, bit flips, unpicklable payload, key
    mismatch — moves the file into ``<root>/quarantine/`` and reports a
    miss: corruption costs a rebuild, never a crash.
  * **Advisory locking.**  Mutating passes (writes, eviction) take an
    ``fcntl`` lock on ``<root>/.lock`` with a bounded wait; on timeout
    they proceed anyway (atomic renames keep the store consistent) and
    count a ``store_lock_timeouts``.
  * **Size-capped LRU eviction.**  After each write the store evicts
    least-recently-used entries (mtime, refreshed on load) until under
    ``cap_bytes`` (``REPRO_TABLE_STORE_CAP_MB``, default 2048).

The store is **disabled by default**: it activates only when the
``REPRO_TABLE_STORE`` environment variable names a directory or a
``Study(store=...)`` / ``store_context(...)`` installs one, so every
existing bit-identity pin runs untouched.  Counters
(``store_hits``/``store_misses``/``store_corrupt``/``store_evicted``/
``store_lock_timeouts``) surface through ``dse.table_cache_stats()``.

Fault points (``core.faultinject``): ``store_corrupt`` /
``store_truncate`` damage the file just written, ``store_lock_hold``
holds the advisory lock inside the critical section.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
import pickle
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

from . import faultinject
from .tiling import stable_key_repr

try:
    import fcntl
except ImportError:                      # non-POSIX: locking degrades to none
    fcntl = None  # type: ignore[assignment]

STORE_ENV = "REPRO_TABLE_STORE"
CAP_ENV = "REPRO_TABLE_STORE_CAP_MB"

SCHEMA_VERSION = 1
# Port tag in every content address: the JAX package's store pickles its
# own ``repro.core.dse`` table classes, so a directory shared by both
# packages must never hand one package's files to the other.
PORT_TAG = "repro_torch"
MAGIC = b"RPTB"
_HEADER_LEN = len(MAGIC) + 1 + 32        # magic + schema byte + sha256

DEFAULT_CAP_MB = 2048
DEFAULT_LOCK_TIMEOUT_S = 5.0

STORE_STATS: Dict[str, int] = {}


def _zero_stats() -> None:
    STORE_STATS.update(store_hits=0, store_misses=0, store_corrupt=0,
                       store_evicted=0, store_lock_timeouts=0,
                       store_writes=0)


_zero_stats()


def store_stats() -> Dict[str, int]:
    """Process-lifetime counters of every active store (a copy)."""
    return dict(STORE_STATS)


def reset_store_stats() -> None:
    _zero_stats()


def env_int(name: str, default: int) -> int:
    """``int(os.environ[name])`` with a loud fallback: a garbage value
    warns (``RuntimeWarning`` naming variable and value) and returns the
    default instead of being silently swallowed."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        warnings.warn(
            f"ignoring invalid {name}={raw!r} (expected an integer); "
            f"using default {default}", RuntimeWarning, stacklevel=2)
        return default


def env_float(name: str, default: float) -> float:
    """Float twin of ``env_int`` — same loud-fallback contract."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        warnings.warn(
            f"ignoring invalid {name}={raw!r} (expected a number); "
            f"using default {default}", RuntimeWarning, stacklevel=2)
        return default


class TableStore:
    """One on-disk table store rooted at a directory.

    ``load``/``save`` never raise on a damaged store: corruption
    quarantines, I/O errors warn and degrade to miss/no-op.  The store
    only trusts files it can fully validate, so any mix of concurrent
    writers and crashed processes leaves it serving correct entries."""

    def __init__(self, root: Union[str, Path],
                 cap_bytes: Optional[int] = None,
                 lock_timeout_s: float = DEFAULT_LOCK_TIMEOUT_S):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.quarantine_dir = self.root / "quarantine"
        if cap_bytes is None:
            cap_bytes = env_int(CAP_ENV, DEFAULT_CAP_MB) * 1024 * 1024
        self.cap_bytes = cap_bytes
        self.lock_timeout_s = lock_timeout_s
        self._seq = 0

    # ---- addressing --------------------------------------------------------

    def entry_path(self, kind: str, key: tuple) -> Path:
        """Content address of ``(kind, key)`` under the current schema."""
        digest = hashlib.sha256(
            f"{PORT_TAG}|v{SCHEMA_VERSION}|{kind}|{stable_key_repr(key)}"
            .encode()).hexdigest()
        return self.root / f"{kind}-{digest}.tbl"

    def contains(self, kind: str, key: tuple) -> bool:
        """Existence probe (no validation, no counters) — used to keep
        parallel builders from rebuilding entries the store already
        holds."""
        return self.entry_path(kind, key).is_file()

    # ---- load / save -------------------------------------------------------

    def load(self, kind: str, key: tuple, expect_type: type = object):
        """Validated fetch: the stored object, or ``None`` on miss.  Any
        corruption — bad magic/schema/digest, unpicklable payload, key or
        type mismatch — quarantines the file and returns ``None``."""
        path = self.entry_path(kind, key)
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            STORE_STATS["store_misses"] += 1
            return None
        except OSError as exc:
            warnings.warn(f"table store read failed for {path.name}: {exc}",
                          RuntimeWarning, stacklevel=2)
            STORE_STATS["store_misses"] += 1
            return None
        obj = self._validate(path, blob, kind, key, expect_type)
        if obj is None:
            self._quarantine(path)
            STORE_STATS["store_corrupt"] += 1
            return None
        STORE_STATS["store_hits"] += 1
        with contextlib.suppress(OSError):
            os.utime(path)               # refresh LRU recency
        return obj

    def _validate(self, path: Path, blob: bytes, kind: str, key: tuple,
                  expect_type: type):
        if len(blob) <= _HEADER_LEN or blob[:4] != MAGIC \
                or blob[4] != SCHEMA_VERSION:
            return None
        payload = blob[_HEADER_LEN:]
        if hashlib.sha256(payload).digest() != blob[5:_HEADER_LEN]:
            return None
        try:
            stored_kind, stored_key, obj = pickle.loads(payload)
        except Exception:
            return None
        if stored_kind != kind or stored_key != stable_key_repr(key) \
                or not isinstance(obj, expect_type):
            return None
        return obj

    def save(self, kind: str, key: tuple, obj) -> None:
        """Atomic, checksummed write of one entry, then an eviction pass.
        Best-effort: on I/O failure the store warns and the caller keeps
        its in-memory table."""
        payload = pickle.dumps((kind, stable_key_repr(key), obj),
                               protocol=pickle.HIGHEST_PROTOCOL)
        blob = (MAGIC + bytes([SCHEMA_VERSION])
                + hashlib.sha256(payload).digest() + payload)
        path = self.entry_path(kind, key)
        self._seq += 1
        tmp = self.root / f".tmp-{os.getpid()}-{self._seq}-{path.name}"
        try:
            with self._locked():
                with open(tmp, "wb") as fh:
                    fh.write(blob)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
                self._inject_damage(path)
                STORE_STATS["store_writes"] += 1
                self._evict_to_cap()
        except OSError as exc:
            warnings.warn(f"table store write failed for {path.name}: {exc}",
                          RuntimeWarning, stacklevel=2)
            with contextlib.suppress(OSError):
                tmp.unlink()

    def _inject_damage(self, path: Path) -> None:
        """Deterministic corruption hooks (tests/CI fault suite only)."""
        if faultinject.fire("store_corrupt"):
            with open(path, "r+b") as fh:
                fh.seek(_HEADER_LEN + 1)
                b = fh.read(1)
                fh.seek(_HEADER_LEN + 1)
                fh.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        if faultinject.fire("store_truncate"):
            size = path.stat().st_size
            with open(path, "r+b") as fh:
                fh.truncate(size // 2)

    # ---- corruption / eviction ---------------------------------------------

    def _quarantine(self, path: Path) -> None:
        try:
            self.quarantine_dir.mkdir(exist_ok=True)
            self._seq += 1
            dest = self.quarantine_dir \
                / f"{path.name}.{os.getpid()}-{self._seq}"
            os.replace(path, dest)
        except OSError:
            # Last resort: make sure the bad file at least stops being
            # served (another process may have quarantined it already).
            with contextlib.suppress(OSError):
                path.unlink()

    def entries(self) -> Iterator[Path]:
        """The validated-format entry files currently in the store."""
        for p in self.root.glob("*.tbl"):
            if p.is_file():
                yield p

    def total_bytes(self) -> int:
        total = 0
        for p in self.entries():
            with contextlib.suppress(OSError):
                total += p.stat().st_size
        return total

    def _evict_to_cap(self) -> None:
        """Drop least-recently-used entries until under ``cap_bytes``.
        LRU recency is file mtime, refreshed by ``load``; a concurrent
        deletion of the same victim is benign."""
        if self.cap_bytes is None or self.cap_bytes <= 0:
            return
        files = []
        for p in self.entries():
            with contextlib.suppress(OSError):
                st = p.stat()
                files.append((st.st_mtime, st.st_size, p))
        total = sum(size for _, size, _ in files)
        if total <= self.cap_bytes:
            return
        for _, size, p in sorted(files, key=lambda f: f[0]):
            if total <= self.cap_bytes:
                break
            with contextlib.suppress(OSError):
                p.unlink()
                total -= size
                STORE_STATS["store_evicted"] += 1

    # ---- advisory locking --------------------------------------------------

    @contextlib.contextmanager
    def _locked(self):
        """Advisory exclusive lock on the store, bounded wait.  On
        timeout — or on platforms without ``fcntl`` — the critical
        section proceeds unlocked: writes stay safe through atomic
        renames, so contention degrades to extra work, never to
        corruption or deadlock."""
        if fcntl is None:
            yield
            return
        fh: Optional[io.IOBase] = None
        locked = False
        try:
            try:
                fh = open(self.root / ".lock", "a+b")
            except OSError:
                yield
                return
            deadline = time.monotonic() + self.lock_timeout_s
            while True:
                try:
                    fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                    locked = True
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        STORE_STATS["store_lock_timeouts"] += 1
                        break
                    time.sleep(0.01)
            hold = faultinject.fire("store_lock_hold")
            if hold is not None:
                time.sleep(hold.arg if hold.arg is not None else 1.0)
            yield
        finally:
            if fh is not None:
                if locked:
                    with contextlib.suppress(OSError):
                        fcntl.flock(fh.fileno(), fcntl.LOCK_UN)
                fh.close()

    def __repr__(self) -> str:
        return (f"TableStore({str(self.root)!r}, "
                f"cap_bytes={self.cap_bytes})")


# ---------------------------------------------------------------------------
# Active-store resolution
#
# Precedence: an explicit override (``set_default_store`` / the
# ``store_context`` manager, used by ``Study(store=...)``) wins; otherwise
# the ``REPRO_TABLE_STORE`` environment variable names the store root;
# otherwise the store is off and every table path behaves exactly as
# before this module existed.
# ---------------------------------------------------------------------------

_UNSET = object()
_OVERRIDE = _UNSET                       # TableStore | None | _UNSET
_ENV_STORES: Dict[str, TableStore] = {}


def _coerce_store(spec: Union["TableStore", str, Path, None]
                  ) -> Optional[TableStore]:
    if spec is None or isinstance(spec, TableStore):
        return spec
    return TableStore(spec)


def set_default_store(spec: Union[TableStore, str, Path, None]) -> None:
    """Install a process-wide store override (``None`` disables the store
    even when ``REPRO_TABLE_STORE`` is set).  Prefer ``store_context``
    for scoped use."""
    global _OVERRIDE
    _OVERRIDE = _coerce_store(spec)


def clear_default_store() -> None:
    """Remove the override: resolution falls back to the environment."""
    global _OVERRIDE
    _OVERRIDE = _UNSET


@contextlib.contextmanager
def store_context(spec: Union[TableStore, str, Path, None]):
    """Scoped store override: inside the block every table fetch goes
    through ``spec`` (or none, for ``spec=None``); on exit the previous
    resolution is restored."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = _coerce_store(spec)
    try:
        yield _OVERRIDE
    finally:
        _OVERRIDE = prev


def active_store() -> Optional[TableStore]:
    """The store table fetches should use right now, or ``None``."""
    if _OVERRIDE is not _UNSET:
        return _OVERRIDE                 # type: ignore[return-value]
    path = os.environ.get(STORE_ENV)
    if not path or not path.strip():
        return None
    path = path.strip()
    store = _ENV_STORES.get(path, _UNSET)
    if store is _UNSET:
        try:
            store = TableStore(path)
        except OSError as exc:
            warnings.warn(
                f"ignoring invalid {STORE_ENV}={path!r} (cannot use as a "
                f"store directory: {exc}); persistent table store disabled",
                RuntimeWarning, stacklevel=2)
            store = None
        _ENV_STORES[path] = store        # cache the failure too: warn once
    return store                         # type: ignore[return-value]
