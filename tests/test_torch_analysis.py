"""``repro_torch.analysis`` — the port's static checks, checked.

The locks, exactness, faults and determinism passes are copies of the
JAX package's: on every fixture of ``tests/test_analysis.py``, written to
``tmp_path`` with the same ``Manifest`` values, both packages'
``run_passes`` must give the same findings.  The port's own cases: the
rewritten ``x64`` pass (X64001-X64003) and the torch generator cases of
``DT002``, each at exact lines; the manifest against the port's source
(every lock it creates is ranked, every path exists); and the self-run,
clean against the empty ``analysis-baseline-torch.json``.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro import analysis as jax_analysis
from repro_torch import analysis
from repro_torch.analysis import (DEFAULT_MANIFEST, Manifest,
                                  collect_sources, fingerprints, run_passes)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}


def _write(tmp_path: Path, rel: str, code: str) -> Path:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    return p


def _run(pkg, tmp_path: Path, manifest_kw: dict, rels, only=()):
    files = pkg.collect_sources([tmp_path / r for r in rels], root=tmp_path)
    return pkg.run_passes(files, pkg.Manifest(**manifest_kw), only=only)


# ---- the fixtures of tests/test_analysis.py --------------------------------

LOCK_GOOD = '''
    import threading

    _LOCK = threading.Lock()
    _CACHE = {}          # guarded-by: _LOCK


    def get(key):
        with _LOCK:
            return _CACHE.get(key)


    def _get_locked(key):
        return _CACHE.get(key)


    def put(key, val):
        with _LOCK:
            _put_impl(key, val)


    def _put_impl(key, val):  # holds-lock: _LOCK
        _CACHE[key] = val
'''

LOCK_BAD = '''
    import threading

    _LOCK = threading.Lock()
    _CACHE = {}          # guarded-by: _LOCK


    def get(key):
        return _CACHE.get(key)          # line 8: unguarded read


    def helper():
        _get_locked(1)                  # line 13: no lock held


    def _get_locked(key):
        return _CACHE.get(key)
'''

LOCK_TYPO = '''
    import threading
    _LOCK = threading.Lock()
    _CACHE = {}      # guarded-by: _LOKC

    def get(key):
        with _LOCK:
            return _CACHE.get(key)
'''

LOCK_MOD = '''
    import threading
    _LOCK = threading.Lock()

    def fine():
        with _LOCK:
            pass
'''

LOCK_OTHER_DIRECT = '''
    import threading
    from mod import _LOCK
    _OTHER = threading.Lock()

    def inverted():
        with _OTHER:
            with _LOCK:          # _OTHER is ordered after _LOCK
                pass
'''

LOCK_MOD_CALLEE = '''
    import threading
    _LOCK = threading.Lock()

    def takes_lock():
        with _LOCK:
            return 1
'''

LOCK_OTHER_CALLER = '''
    import threading
    import mod
    _OTHER = threading.Lock()

    def caller():
        with _OTHER:
            return mod.takes_lock()
'''

EXACT_GOOD = '''
    import numpy as np

    def folds(total, per):
        return int(np.ceil(total / per))    # sanctioned ceil-div

    def spans(total, per):
        return total // per + 2
'''

EXACT_BAD = '''
    import numpy as np

    def bad_div(total, per):
        return total / per                  # line 5

    def bad_mean(xs):
        return np.mean(xs)                  # line 8

    def bad_literal(x):
        return x * 0.5                      # line 11

    def bad_dtype(xs):
        return np.asarray(xs, dtype=np.float32)   # line 14
'''

EXACT_EXPAND = '''
    def entry(a, b):
        return helper(a, b)

    def helper(a, b):
        return a / b                        # line 6

    def unrelated(a, b):
        return a / b                        # not reachable from entry
'''

FAULT_MODULE = '''
    FAULT_POINTS = {
        "worker_exc": "worker raises",
        "store_corrupt": "store corrupted",
    }

    def fire(point):
        return None

    def arm(point, times=1):
        pass
'''

FAULT_WORKER_GOOD = '''
    import faultinject

    def work():
        if faultinject.fire("worker_exc"):
            raise RuntimeError
        if faultinject.fire("store_corrupt"):
            raise IOError
'''

FAULT_TESTS_GOOD = '''
    import faultinject

    def test_worker_exc():
        faultinject.arm("worker_exc")

    def test_env_spec():
        spec = "store_corrupt:1"
'''

FAULT_WORKER_BAD = '''
    import faultinject

    def work():
        if faultinject.fire("worker_ecx"):  # line 5: typo'd point
            raise RuntimeError
'''

FAULT_TESTS_BAD = '''
    import faultinject

    def test_worker_exc():
        faultinject.arm("worker_exc")
'''

FAULT_NO_REGISTRY = '''
    def fire(point):
        return None
'''

DET_GOOD = '''
    import random
    import time
    import numpy as np

    def price(cfgs, seed):
        rng = np.random.default_rng(seed)
        salt = random.Random(seed).random()
        t0 = time.monotonic()               # timeouts are not priced
        return sorted({c.key for c in cfgs}), rng, salt, t0
'''

DET_BAD = '''
    import random
    import time
    import numpy as np

    def bad_clock():
        return time.time()                  # line 7

    def bad_rng():
        return np.random.default_rng()      # line 10

    def bad_global_rng():
        return random.random()              # line 13

    def bad_set_iter(cfgs):
        keys = {c.key for c in cfgs}
        return [k for k in list(keys)]      # line 17

    def bad_hash(key):
        return hash(key)                    # line 20
'''

DET_SCOPES = '''
    def makes_a_set(cfgs):
        out = {c.key for c in cfgs}
        return sorted(out)

    def reuses_the_name(tup):
        out = list(tup)
        return tuple(out)                   # a list, not a set
'''

DET_ALLOW = '''
    def ok(key):
        return hash(key)  # analysis: allow[DT004]

    def still_bad(key):
        return hash(key)
'''

LOCKS = dict(lock_order=("mod.py:_LOCK", "other.py:_OTHER"))
EXACT = dict(exact_scope={"cycles.py": ("*",)})
FAULTS = dict(fault_module="faultinject.py")
DET = dict(determinism_modules=("pricing.py",))

# (id, manifest values, {path: source}, pass, findings expected)
FIXTURES = [
    ("locks-clean", LOCKS, {"mod.py": LOCK_GOOD}, "locks", False),
    ("locks-unguarded", LOCKS, {"mod.py": LOCK_BAD}, "locks", True),
    ("locks-typo", LOCKS, {"mod.py": LOCK_TYPO}, "locks", True),
    ("locks-direct-inversion", LOCKS,
     {"mod.py": LOCK_MOD, "other.py": LOCK_OTHER_DIRECT}, "locks", True),
    ("locks-call-inversion", LOCKS,
     {"mod.py": LOCK_MOD_CALLEE, "other.py": LOCK_OTHER_CALLER}, "locks",
     True),
    ("exact-clean", EXACT, {"cycles.py": EXACT_GOOD}, "exact", False),
    ("exact-seeded", EXACT, {"cycles.py": EXACT_BAD}, "exact", True),
    ("exact-expands", dict(exact_scope={"cycles.py": ("entry",)}),
     {"cycles.py": EXACT_EXPAND}, "exact", True),
    ("faults-clean", FAULTS,
     {"faultinject.py": FAULT_MODULE, "worker.py": FAULT_WORKER_GOOD,
      "tests/test_worker.py": FAULT_TESTS_GOOD}, "faults", False),
    ("faults-seeded", FAULTS,
     {"faultinject.py": FAULT_MODULE, "worker.py": FAULT_WORKER_BAD,
      "tests/test_worker.py": FAULT_TESTS_BAD}, "faults", True),
    ("faults-no-registry", FAULTS, {"faultinject.py": FAULT_NO_REGISTRY},
     "faults", True),
    ("determinism-clean", DET, {"pricing.py": DET_GOOD}, "determinism",
     False),
    ("determinism-seeded", DET, {"pricing.py": DET_BAD}, "determinism",
     True),
    ("determinism-scopes", DET, {"pricing.py": DET_SCOPES}, "determinism",
     False),
    ("determinism-allow", DET, {"pricing.py": DET_ALLOW}, "determinism",
     True),
]


@pytest.mark.parametrize("manifest_kw,sources,only,flagged",
                         [f[1:] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_passes_agree_with_the_jax_package(tmp_path, manifest_kw, sources,
                                           only, flagged):
    for rel, code in sources.items():
        _write(tmp_path, rel, code)
    rels = [r for r in sources if not r.startswith("tests/")]
    if any(r.startswith("tests/") for r in sources):
        rels.append("tests")
    got = _run(analysis, tmp_path, manifest_kw, rels, only=(only,))
    want = _run(jax_analysis, tmp_path, manifest_kw, rels, only=(only,))
    key = [(f.path, f.code, f.line, f.symbol) for f in got]
    assert key == [(f.path, f.code, f.line, f.symbol) for f in want]
    assert bool(got) == flagged
    # one waiver and one baseline read the same in both packages
    assert set(fingerprints(got)) == set(jax_analysis.fingerprints(want))


def test_unranked_port_locks_are_now_order_checked(tmp_path):
    """Two of the four locks the JAX manifest leaves unranked, nested
    against their rank in the grid kernel's module: the port's manifest
    sees the inversion, the JAX package's cannot."""
    _write(tmp_path, "repro_torch/kernels/reduce.py", '''
        import threading
        _WS_LOCK = threading.Lock()
        _COUNT_LOCK = threading.Lock()

        def inverted():
            with _COUNT_LOCK:
                with _WS_LOCK:           # line 8
                    pass
    ''')
    files = collect_sources([tmp_path / "repro_torch"], root=tmp_path)
    got = run_passes(files, DEFAULT_MANIFEST, only=("locks",))
    assert [(f.code, f.line) for f in got] == [("LOCK003", 8)]
    jax_files = jax_analysis.collect_sources([tmp_path / "repro_torch"],
                                             root=tmp_path)
    assert jax_analysis.run_passes(jax_files, jax_analysis.DEFAULT_MANIFEST,
                                   only=("locks",)) == []


# ---- the port's x64 pass ---------------------------------------------------

X64 = Manifest(x64_modules=("grid.py",))

X64_GOOD = '''
    import ctypes
    import numpy as np
    import torch

    class Plan(ctypes.Structure):
        _fields_ = [("n", ctypes.c_longlong),
                    ("route", ctypes.c_int)]  # analysis: allow[X64002] 0/1

    def ws(n, device):
        out = torch.zeros(n, dtype=torch.int64, device=device)
        keep = torch.ones(n, dtype=torch.bool, device=device)
        lim = torch.tensor(2.5, dtype=torch.float64)
        return out.to(torch.float64) <= lim, keep, np.int64(n)

    def bind(lib):
        lib.launch.argtypes = (ctypes.c_void_p, ctypes.c_longlong)
        lib.launch.restype = ctypes.c_int    # a return code, not declared
'''

X64_BAD = '''
    import ctypes
    import numpy as np
    import torch

    class Plan(ctypes.Structure):
        _fields_ = [("n", ctypes.c_longlong), ("blocks", ctypes.c_int)]

    def ws(n, cycles):
        a = torch.zeros(n)                          # line 10: X64001
        b = torch.tensor([1.5, 2.5])                # line 11: X64001
        c = cycles.to(torch.int32)                  # line 12: X64002
        d = cycles.float()                          # line 13: X64002
        e = np.asarray(cycles, dtype=np.float32)    # line 14: X64002
        return a, b, c, d, e

    def bind(lib):
        lib.launch.argtypes = (ctypes.c_void_p, ctypes.c_uint)   # line 18
'''


def test_x64_clean_fixture(tmp_path):
    _write(tmp_path, "grid.py", X64_GOOD)
    files = collect_sources([tmp_path / "grid.py"], root=tmp_path)
    assert run_passes(files, X64, only=("x64",)) == []


def test_x64_flags_defaults_narrowing_and_ctypes(tmp_path):
    _write(tmp_path, "grid.py", X64_BAD)
    files = collect_sources([tmp_path / "grid.py"], root=tmp_path)
    got = [(f.code, f.line, f.symbol)
           for f in run_passes(files, X64, only=("x64",))]
    assert got == [
        ("X64002", 7, "Plan:ctypes.c_int"),
        ("X64001", 10, "ws:torch.zeros"),
        ("X64001", 11, "ws:torch.tensor"),
        ("X64002", 12, "ws:torch.int32"),
        ("X64002", 13, "ws:.float()"),
        ("X64002", 14, "ws:np.float32"),
        ("X64002", 18, "bind:ctypes.c_uint"),
    ]


def test_x64_scopes_narrowing_to_its_modules(tmp_path):
    """Outside ``x64_modules`` narrowing is legal (the models compute in
    bf16); a default-dtype change is flagged in every scanned file."""
    _write(tmp_path, "model.py", '''
        import torch

        def cast(x):
            return x.to(torch.bfloat16).float()

        def setup():
            torch.set_default_dtype(torch.float64)          # line 8
            torch.set_default_tensor_type(torch.DoubleTensor)  # line 9
    ''')
    files = collect_sources([tmp_path / "model.py"], root=tmp_path)
    got = [(f.code, f.line) for f in run_passes(files, X64, only=("x64",))]
    assert got == [("X64003", 8), ("X64003", 9)]


# ---- the torch generator cases of DT002 ------------------------------------

DT_TORCH_GOOD = '''
    import torch

    def draw(n, seed):
        g = torch.Generator().manual_seed(seed)
        a = torch.rand(n, generator=g)
        b = torch.randint(0, 9, (n,), generator=g)
        c = torch.randperm(n, generator=g)
        d = torch.normal(0.0, 1.0, (n,), generator=g)
        e = torch.multinomial(a, 1, generator=g)
        f = torch.bernoulli(a, generator=g)
        return a, b, c, d, e, f, torch.randn(n, generator=g)
'''

DT_TORCH_BAD = '''
    import torch

    def draw(n, x):
        a = torch.rand(n)                   # line 5
        b = torch.randn(n)                  # line 6
        c = torch.randint(0, 9, (n,))       # line 7
        d = torch.randperm(n)               # line 8
        e = torch.normal(0.0, 1.0, (n,))    # line 9
        f = torch.bernoulli(a)              # line 10
        g = torch.multinomial(a, 1)         # line 11
        h = torch.rand_like(x)              # line 12
        i = torch.randn_like(x)             # line 13
        j = torch.randint_like(x, 9)        # line 14
        gen = torch.Generator()             # line 15
        gen.manual_seed(1)                  # seeded later: still flagged
        return a, b, c, d, e, f, g, h, i, j, gen
'''


def test_determinism_torch_rng_clean(tmp_path):
    _write(tmp_path, "pricing.py", DT_TORCH_GOOD)
    files = collect_sources([tmp_path / "pricing.py"], root=tmp_path)
    assert run_passes(files, Manifest(**DET), only=("determinism",)) == []


def test_determinism_flags_torch_global_generator(tmp_path):
    _write(tmp_path, "pricing.py", DT_TORCH_BAD)
    files = collect_sources([tmp_path / "pricing.py"], root=tmp_path)
    got = run_passes(files, Manifest(**DET), only=("determinism",))
    assert [(f.code, f.line) for f in got] \
        == [("DT002", line) for line in range(5, 16)]
    assert got[-1].symbol == "draw:torch.Generator"


# ---- the manifest against the port's source --------------------------------

def _created_locks():
    """Every ``threading.Lock()``/``RLock()`` the port assigns, as lock ids
    of the manifest (``repro_torch/<path>:<name>`` or
    ``repro_torch/<path>:<Class>.self.<attr>``)."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).as_posix()
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and ast.unparse(node.value.func)
                    in ("threading.Lock", "threading.RLock")):
                continue
            target = node.targets[0]
            cls = node
            while cls is not None and not isinstance(cls, ast.ClassDef):
                cls = getattr(cls, "parent", None)
            if isinstance(target, ast.Name):
                out.append(f"{rel}:{target.id}")
            else:
                out.append(f"{rel}:{cls.name}.{ast.unparse(target)}")
    return out


def test_every_lock_the_port_creates_is_ranked():
    created = _created_locks()
    assert len(created) == 8
    assert sorted(set(created) - set(DEFAULT_MANIFEST.lock_order)) == []
    # and every ranked lock exists: the eight above plus the store's
    # advisory file lock, a context-manager method
    ranked = set(DEFAULT_MANIFEST.lock_order) - set(created)
    assert ranked == {"repro_torch/core/store.py:TableStore._locked"}
    from repro_torch.core.store import TableStore
    assert callable(TableStore._locked)


def test_every_manifest_path_exists_in_the_port():
    m = DEFAULT_MANIFEST
    paths = [*m.exact_scope, *m.x64_modules, *m.determinism_modules,
             m.fault_module, *(e.partition(":")[0] for e in m.lock_order),
             *(v.partition(":")[0] for v in m.call_patterns.values())]
    for p in paths:
        assert p.startswith("repro_torch/"), p
        assert (PORT.parent / p).is_file(), p
    assert "repro_torch/core/gridtorch.py" in m.determinism_modules
    assert "repro_torch/kernels/reduce.py" in m.determinism_modules


def test_manifest_scopes_every_jax_scope_on_the_port():
    """The exactness and determinism scopes are the JAX package's, path
    for path (``gridax`` as ``gridtorch``), plus the grid kernel's module."""
    jm = jax_analysis.DEFAULT_MANIFEST

    def port_path(p):
        return "repro_torch/" + p.removeprefix("repro/").replace(
            "gridax", "gridtorch")
    assert dict(DEFAULT_MANIFEST.exact_scope) \
        == {port_path(k): v for k, v in jm.exact_scope.items()}
    assert DEFAULT_MANIFEST.determinism_modules \
        == tuple(port_path(p) for p in jm.determinism_modules) \
        + ("repro_torch/kernels/reduce.py",)
    assert DEFAULT_MANIFEST.lock_order[:5] \
        == tuple(port_path(p) for p in jm.lock_order)


# ---- the port's own run ----------------------------------------------------

def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=cwd, capture_output=True, text=True,
                          env=ENV, timeout=120)


def test_repo_port_is_clean_against_committed_baseline():
    """The port's source and its tests, clean against the empty
    ``analysis-baseline-torch.json``: a new violation, or a fault point
    of the port that no port test arms, fails here with the finding
    printed."""
    proc = _cli("--baseline", "analysis-baseline-torch.json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " 0 finding(s)" in proc.stdout


def test_repo_port_baseline_is_empty():
    data = json.loads((REPO / "analysis-baseline-torch.json").read_text())
    assert data == {"findings": {}, "version": 1}


def test_cli_counts_only_the_ports_tests_for_coverage(tmp_path):
    """A point armed only by a test of the JAX package is uncovered; the
    same arming in a ``test_torch_*.py`` covers it."""
    _write(tmp_path, "src/repro_torch/core/faultinject.py", FAULT_MODULE)
    _write(tmp_path, "src/repro_torch/core/worker.py", FAULT_WORKER_GOOD)
    _write(tmp_path, "tests/test_faultinject.py", FAULT_TESTS_GOOD)
    _write(tmp_path, "tests/test_torch_other.py", "def test_nothing(): pass\n")
    proc = _cli("--only", "faults", cwd=tmp_path)
    assert proc.returncode == 1
    assert "3 file(s)" in proc.stdout
    assert sorted(line.split("'")[1] for line in proc.stdout.splitlines()
                  if "FP003" in line) == ["store_corrupt", "worker_exc"]
    _write(tmp_path, "tests/test_torch_faultinject.py", FAULT_TESTS_GOOD)
    proc = _cli("--only", "faults", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout
    assert "4 file(s), 0 finding(s)" in proc.stdout


def test_cli_json_report(tmp_path):
    # the path suffix must match a DEFAULT_MANIFEST determinism module
    _write(tmp_path, "repro_torch/core/optimize.py", '''
        import torch

        def bad(key, n):
            return hash(key), torch.rand(n)
    ''')
    out = tmp_path / "findings.json"
    proc = _cli("--json", str(out), "--only", "determinism",
                str(tmp_path / "repro_torch/core/optimize.py"))
    assert proc.returncode == 1          # unbaselined findings
    report = json.loads(out.read_text())
    assert report["total"] == 2
    assert report["by_pass"] == {"determinism": 2}
    assert sorted(f["code"] for f in report["findings"]) \
        == ["DT002", "DT004"]
    assert all(len(f["fingerprint"]) == 16 for f in report["findings"])
