"""Multi-process tests of the port on the CPU: ``run_ranks`` starts one
process a rank over ``gloo``, joined through a ``FileStore`` under the
test's ``tmp_path`` (no TCP port, so parallel test workers never
collide), and kills every rank when its timeout expires, so a rank that
blocks fails its test instead of hanging the suite.  Held here: the
results of every rank come back, and a rank blocked in a collective its
peers never join fails within the timeout.

The compression, sharding and pipeline tests import ``run_ranks``.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RESULT = "RANK_RESULT "

PRELUDE = """
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["STORE"], WORLD), rank=RANK,
    world_size=WORLD)
"""
EPILOGUE = """
out = main(RANK, WORLD)
dist.barrier()
dist.destroy_process_group()
print(%r + json.dumps(out))
""" % RESULT


def env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)


def run_ranks(body: str, world: int, tmp_path, timeout: float = 90.0,
              **extra_env) -> list:
    """Run ``body`` (source that defines ``main(rank, world) -> dict`` of
    JSON values) in ``world`` processes joined over ``gloo``; returns
    each rank's dict, in rank order.  Fails the test if a rank exits
    non-zero or if the ranks are not all done within ``timeout`` seconds
    (every rank is then killed)."""
    script = PRELUDE + textwrap.dedent(body) + EPILOGUE
    store = tmp_path / f"store_{time.monotonic_ns()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env(RANK=str(r), WORLD=str(world), STORE=str(store),
                **extra_env)) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(0.1, deadline - time.monotonic())
            outs.append(p.communicate(timeout=left))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"ranks still running after {timeout} s: killed")
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err}"
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
        assert lines, f"rank {r} printed no result:\n{out}\n{err}"
        results.append(json.loads(lines[-1][len(RESULT):]))
    return results


def test_every_rank_reports(tmp_path):
    got = run_ranks("""
        def main(rank, world):
            t = torch.tensor([float(rank + 1)])
            dist.all_reduce(t)
            return {"rank": rank, "world": world, "sum": float(t)}
    """, 3, tmp_path)
    assert got == [{"rank": r, "world": 3, "sum": 6.0} for r in range(3)]


def test_a_blocked_rank_fails_within_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="killed"):
        run_ranks("""
            def main(rank, world):
                if rank == 0:           # a collective rank 1 never joins
                    dist.all_reduce(torch.ones(1))
                else:
                    dist.recv(torch.empty(1), 0)
                return {}
        """, 2, tmp_path, timeout=8.0)
    assert time.monotonic() - t0 < 20.0
