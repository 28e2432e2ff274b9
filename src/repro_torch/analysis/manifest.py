"""The module manifest: what each pass checks, over which files.

The annotations in the source (``# guarded-by:``, ``# holds-lock:``)
declare *what* is protected; this manifest declares the repo-wide facts
no single file can state — the global lock acquisition order, which
modules form the int64 cycle-count call graph, which modules carry int64
grids through torch and ``ctypes``, where the fault registry lives, and
which modules are pricing paths under the determinism contract.  Tests
construct custom ``Manifest`` instances over fixture snippets; the
port's own run uses ``DEFAULT_MANIFEST``, whose paths are the port's
(``repro_torch/...``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence, Tuple


@dataclass(frozen=True)
class Manifest:
    # ---- locks pass --------------------------------------------------------
    # Global acquisition order, outermost first.  Acquiring lock B while
    # holding lock A is legal iff A appears strictly before B here.
    # Lock ids: "<path-suffix>:<name>" for module globals,
    # "<path-suffix>:<Class>.self.<attr>" for instance locks,
    # "<path-suffix>:<Class>.<method>" for context-manager methods.
    lock_order: Tuple[str, ...] = ()
    # Caller-holds-lock helper suffix (``# holds-lock:`` names the lock).
    locked_suffix: str = "_locked"
    # Call-site resolution hints for the lock-order graph: the rendered
    # call expression (``self.metrics.count``, ``store.save``) -> the
    # qualified function id whose acquisitions the call implies.
    call_patterns: Mapping[str, str] = field(default_factory=dict)

    # ---- exactness pass ----------------------------------------------------
    # path-suffix -> ("*",) for the whole module, or a tuple of top-level
    # function/class names forming the int64 cycle-math roots there.  The
    # pass expands the roots through same-fileset calls (the call graph).
    exact_scope: Mapping[str, Tuple[str, ...]] = field(default_factory=dict)
    # Call names that introduce floats a cycle path must never see.
    exact_banned_calls: Tuple[str, ...] = (
        "mean", "average", "true_divide", "divide", "float_power")
    # ``/`` is legal only directly inside one of these (the exact
    # ceil-of-integer-division idiom: all operands integral, < 2**53).
    exact_div_wrappers: Tuple[str, ...] = ("ceil", "floor", "round")

    # ---- x64 pass ----------------------------------------------------------
    # Modules that carry int64 cycle grids through torch and ctypes.
    x64_modules: Tuple[str, ...] = ()
    # torch factories whose dtype, without ``dtype=``, comes from torch's
    # defaults (float32 for Python floats)
    x64_factories: Tuple[str, ...] = ("tensor", "as_tensor", "full", "zeros",
                                      "ones", "empty", "arange", "linspace")
    # dtypes and casts narrower than 64 bits (``torch.bool`` is not one)
    x64_narrow_dtypes: Tuple[str, ...] = (
        "torch.int32", "torch.int16", "torch.int8", "torch.uint8",
        "torch.float32", "torch.float16", "torch.bfloat16", "torch.half",
        "torch.float", "torch.int", "np.int32", "np.float32",
        "numpy.int32", "numpy.float32")
    x64_narrow_casts: Tuple[str, ...] = ("int", "short", "float", "half",
                                         "bfloat16")
    x64_narrow_ctypes: Tuple[str, ...] = ("c_int", "c_int32", "c_uint",
                                          "c_float")
    # calls that change torch's default dtype for every later factory
    x64_default_setters: Tuple[str, ...] = ("set_default_dtype",
                                            "set_default_tensor_type")

    # ---- faults pass -------------------------------------------------------
    fault_module: str = "repro/core/faultinject.py"
    fault_registry_name: str = "FAULT_POINTS"
    fault_call_names: Tuple[str, ...] = ("fire", "arm", "armed", "fired",
                                         "disarm")
    tests_dir_name: str = "tests"

    # ---- determinism pass --------------------------------------------------
    determinism_modules: Tuple[str, ...] = ()
    banned_clock_calls: Tuple[str, ...] = (
        "time.time", "time.time_ns", "datetime.now", "datetime.utcnow",
        "datetime.datetime.now", "datetime.datetime.utcnow", "date.today")
    # attribute calls on the *global* (unseeded) RNGs
    banned_rng_roots: Tuple[str, ...] = ("random", "np.random",
                                         "numpy.random")
    seeded_rng_ctors: Tuple[str, ...] = ("Random", "default_rng",
                                         "RandomState", "PRNGKey", "SeedSequence")
    # torch draws that use the global generator unless given ``generator=``
    torch_rng_calls: Tuple[str, ...] = ("rand", "randn", "randint",
                                        "randperm", "normal", "bernoulli",
                                        "multinomial", "rand_like",
                                        "randn_like", "randint_like")
    # order-insensitive consumers that sanction set iteration
    order_safe_calls: Tuple[str, ...] = ("sorted", "min", "max", "sum",
                                         "len", "any", "all", "frozenset",
                                         "set")


# ---------------------------------------------------------------------------
# The port's own manifest
# ---------------------------------------------------------------------------

DEFAULT_MANIFEST = Manifest(
    lock_order=(
        # serving tier first (outermost): the dispatcher/client threads
        # take service state locks, then fan into the shared caches
        "repro_torch/serve/service.py:DSEService.self._lock",
        "repro_torch/serve/metrics.py:ServiceMetrics.self._lock",
        # the process-lifetime table caches
        "repro_torch/core/dse.py:_CACHE_LOCK",
        # held strictly inside a cache critical section
        "repro_torch/core/store.py:TableStore._locked",
        "repro_torch/core/faultinject.py:_FAULT_LOCK",
        # Leaves: nothing in the code takes one of these under another
        # lock of this list, nor another lock while holding one.  A search
        # reduces its grid after the cache section, so the kernel's
        # workspace lock, its library loader (held across an nvcc build)
        # and its launch counter are taken under no lock, one after the
        # other; the watchdog's lock guards its own beat and latch.
        "repro_torch/kernels/reduce.py:_WS_LOCK",
        "repro_torch/kernels/_ext.py:_LOCK",
        "repro_torch/kernels/reduce.py:_COUNT_LOCK",
        "repro_torch/distributed/fault.py:Watchdog.self._lock",
    ),
    call_patterns={
        # service -> metrics accumulator (all mutators lock internally)
        "self.metrics.count":
            "repro_torch/serve/metrics.py:ServiceMetrics.count",
        "self.metrics.batch":
            "repro_torch/serve/metrics.py:ServiceMetrics.batch",
        "self.metrics.search":
            "repro_torch/serve/metrics.py:ServiceMetrics.search",
        "self.metrics.completed":
            "repro_torch/serve/metrics.py:ServiceMetrics.completed",
        "self.metrics.failed":
            "repro_torch/serve/metrics.py:ServiceMetrics.failed",
        "self.metrics.snapshot":
            "repro_torch/serve/metrics.py:ServiceMetrics.snapshot",
        # cache layer -> persistent store (fcntl critical sections)
        "store.save": "repro_torch/core/store.py:TableStore.save",
        "store.load": "repro_torch/core/store.py:TableStore.load",
        "store.contains": "repro_torch/core/store.py:TableStore.contains",
        # anything -> fault registry
        "faultinject.fire": "repro_torch/core/faultinject.py:fire",
        "faultinject.arm": "repro_torch/core/faultinject.py:arm",
        "faultinject.armed": "repro_torch/core/faultinject.py:armed",
        "faultinject.fired": "repro_torch/core/faultinject.py:fired",
        "faultinject.reset": "repro_torch/core/faultinject.py:reset",
    },
    exact_scope={
        # the paper's cycle/energy quantity derivations: whole modules
        "repro_torch/core/conv_model.py": ("*",),
        "repro_torch/core/simd_model.py": ("*",),
        "repro_torch/core/gemm_model.py": ("*",),
        "repro_torch/core/tiling.py": ("*",),
        # dse.py mixes cycle math with float scoring/reporting; only the
        # cost-table classes (and everything they call) are int64-exact
        "repro_torch/core/dse.py": ("ConvTable", "SimdTable", "GemmTable"),
    },
    fault_module="repro_torch/core/faultinject.py",
    x64_modules=(
        "repro_torch/core/gridtorch.py",
        "repro_torch/kernels/reduce.py",
        # the float64 energy report and objective scores on the device
        "repro_torch/core/energy.py",
        "repro_torch/core/objectives.py",
    ),
    determinism_modules=(
        "repro_torch/core/dse.py",
        "repro_torch/core/tiling.py",
        "repro_torch/core/conv_model.py",
        "repro_torch/core/simd_model.py",
        "repro_torch/core/gemm_model.py",
        "repro_torch/core/optimize.py",
        "repro_torch/core/study.py",
        "repro_torch/core/objectives.py",
        "repro_torch/core/energy.py",
        "repro_torch/core/backward.py",
        "repro_torch/core/gridtorch.py",
        "repro_torch/kernels/reduce.py",
    ),
)
