#!/usr/bin/env python3
"""Quick check of the GEMM and attention kernels on one CUDA card.

    python3 scripts/kernel_probe.py

From the repository root.  Builds ``matmul.cu`` and ``flash_attention.cu``
only, prints their ptxas reports and the tensor-core instructions in their
SASS, holds every GEMM route, tile and split count and every attention
route and head_dim against the plain versions (the tolerances of
``tests/test_kernels.py``), then times a few main-path shapes beside the
PyTorch call that computes the same (calls queued behind a device sleep).
It exits non-zero if a case fails.  About a minute; ``chip_smoke.py`` is
the full run.
"""
from __future__ import annotations

import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import gpu_model as g  # noqa: E402
from repro_torch.kernels import _ext, ops, ref  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
ATTN_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}


def build() -> None:
    tool = Path(_ext.nvcc_path()).parent / "cuobjdump"
    for source in ("matmul.cu", "flash_attention.cu"):
        t0 = time.perf_counter()
        path = _ext._build(source)
        print(f"built {source} in {time.perf_counter() - t0:.1f} s")
        for ln in _ext.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ", ln.strip())
        sass = subprocess.run([str(tool), "--dump-sass", str(path)],
                              check=True, capture_output=True,
                              text=True).stdout
        print(f"  SASS: HGMMA {sass.count(' HGMMA.')}, "
              f"HMMA {sass.count(' HMMA.')}")


class Holds:
    def __init__(self):
        self.failed = 0

    def __call__(self, label, fn, want, tol):
        try:
            got = fn()
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got.float()).all()) and float(
                (d - tol - tol * want.float().abs()).max()) <= 0
            print(f"{'ok  ' if ok else 'FAIL'} {label}: max abs err "
                  f"{float(d.max())}")
        except Exception:       # report every case, then fail at the end
            ok = False
            print(f"EXC  {label}\n{traceback.format_exc()}")
        self.failed += not ok


def hold_gemms(hold: Holds, dev) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        for m, n, k in ((64, 64, 64), (200, 96, 136), (147, 64, 4096),
                        (1568, 512, 4608), (4096, 4096, 1024), (33, 17, 65),
                        (1, 128, 7), (300, 200, 96)):
            a = torch.randn(m, k, device=dev).to(dtype)
            b = (torch.randn(k, n, device=dev) * k ** -0.5).to(dtype)
            want = ref.matmul_ref(a, b)
            for tile in g.WGMMA_TILES + ((64, 64, 64), (32, 64, 128)):
                for splits in (1, 3):
                    if splits > -(-k // tile[2]):
                        continue
                    route = g.matmul_route(n, k, a.element_size(), tile,
                                           a.data_ptr(), b.data_ptr())
                    hold(f"matmul {dtype} {(m, n, k)} {tile} x{splits} "
                         f"{route}", lambda: mm.matmul(a, b, *tile,
                                                       splits=splits),
                         want, TOL[dtype])
            blk = g.select_matmul_block(m, n, k, a.element_size(),
                                        a.element_size())
            hold(f"ops.matmul {dtype} {(m, n, k)} {blk}",
                 lambda: ops.matmul(a, b), want, TOL[dtype])


def hold_attention(hold: Holds, dev) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        for d in (16, 32, 64, 128):
            for s, causal, window in ((2048, True, 0), (300, False, 16),
                                      (96, True, 16), (40, False, 0)):
                if dtype == torch.float32 and s == 2048 and d != 128:
                    continue
                h, kv, b = 4, 2, 2
                q = torch.randn(b * h, s, d, device=dev).to(dtype)
                k = torch.randn(b * kv, s, d, device=dev).to(dtype)
                v = torch.randn(b * kv, s, d, device=dev).to(dtype)
                hold(f"flash_attention {dtype} D{d} S{s} causal={causal} "
                     f"w{window}", lambda: ops.flash_attention(
                         q, k, v, h, kv, causal=causal, window=window),
                     ref.flash_attention_ref(q, k, v, h, kv, causal, window),
                     ATTN_TOL[dtype])


def queued_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 4e5))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def times(dev) -> None:
    import torch.nn.functional as F
    q = torch.randn(32, 2048, 128, device=dev, dtype=torch.bfloat16)
    k = torch.randn(16, 2048, 128, device=dev, dtype=torch.bfloat16)
    v = torch.randn(16, 2048, 128, device=dev, dtype=torch.bfloat16)
    qb, kb, vb = (t.view(2, -1, 2048, 128) for t in (q, k, v))
    sdpa = queued_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True, enable_gqa=True))
    print(f"flash_attention Qwen3 causal (32, 2048, 128) bf16: "
          f"{queued_ms(lambda: ops.flash_attention(q, k, v, 16, 8))} ms, "
          f"scaled_dot_product_attention {sdpa} ms")
    for m, n, k_ in ((4096, 4096, 1024), (4096, 151936, 1024),
                     (147, 64, 401408), (1568, 512, 4608),
                     (4096, 1024, 3072)):
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and n > 100_000:
                continue
            a = torch.randn(m, k_, device=dev).to(dtype)
            b = torch.randn(k_, n, device=dev).to(dtype)
            blk = g.select_matmul_block(m, n, k_, a.element_size(),
                                        a.element_size())
            print(f"matmul {dtype} {(m, n, k_)} {blk.route} "
                  f"{(blk.bm, blk.bn, blk.bk)} x{blk.splits}: "
                  f"{queued_ms(lambda: ops.matmul(a, b), 5)} ms, "
                  f"torch.matmul {queued_ms(lambda: torch.matmul(a, b), 5)}"
                  f" ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    build()
    torch.manual_seed(0)
    hold = Holds()
    hold_gemms(hold, "cuda")
    hold_attention(hold, "cuda")
    if hold.failed == 0:
        times("cuda")
    print(f"failed cases: {hold.failed}")
    return 1 if hold.failed else 0


if __name__ == "__main__":
    sys.exit(main())
