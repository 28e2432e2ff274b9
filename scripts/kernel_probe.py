#!/usr/bin/env python3
"""Quick check of the port's CUDA kernels on one CUDA card.

    python3 scripts/kernel_probe.py [--only gemm|attention|bn|grid_minmax]
                                    [--src DIR] [--bits FILE]

From the repository root.  Builds the sources it probes only, prints
their ptxas reports (and the tensor-core instructions in the GEMM's and
attention's SASS), holds every GEMM route, tile and split count, every
attention route and head_dim, and both batch-norm kernels at ResNet-50's
12 BN shapes (batch 32, float32; two in bfloat16) and ragged shapes,
against the plain versions with the tolerances of
``tests/test_kernels.py``, then times main-path shapes beside the PyTorch
call that computes the same (calls queued behind a device sleep) and the
bound.  For batch norm it also holds two calls bit-identical and reads
how far the kernel's and the float32 plain version's outputs lie from
the same formula in float64 at mean shifts 10, 100 and 1000.  For
``grid_minmax`` it holds the kernel exactly against ``grid_minmax_ref``
on ``chip_smoke.py``'s cases (ties, extremes, both routes, the main
path's sorted projections, 46,341 x 46,341 candidates) and twice on each,
then times both main-path shapes, built from the searches' real
projections (2345 x 2345 and 311 x 311): device ms with the calls queued
behind a device sleep, ms a call by events with the host, the plain
version and the bound.  ``--src`` imports the port from another tree (an
unpacked parent commit, say), whose batch-norm wrappers are only called
through ``ops``; run it and the tree's own probe in one call to compare
the two on one card.  A build of the kernel with ``-DGRID_MINMAX_TRACE``
then gives each block's phase times in one call at both shapes.

The float32 GEMM (``--only gemm``) is also held bit for bit: at one
split on SmolLM-360M's training-step shapes (8 x 1024 tokens; fwd, dX,
dW), recurrentgemma-9b's RG-LRU product (8192, 4096) @ (4096, 4096),
ragged shapes and views offset by 4 bytes, every tile giving the same
bits; at a fixed tile and split count on split-K cases.  ``--bits FILE``
writes a digest of each output there, or, if the file exists, fails on
any output whose digest differs: run it on an unpacked parent with
``--src`` first and on this tree next, in one call, to hold the two
kernels' bits equal.  Then it times the float32 kernel at those shapes
(each of its tiles, and the model's pick) beside ``torch.matmul`` (TF32
off), summed over the step's GEMMs by phase.  ``--only attention`` also
times the float32 attention at SmolLM's shape beside SDPA in float32.
It exits non-zero if a case fails.  About a minute a part;
``chip_smoke.py`` is the full run.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(sys.argv[sys.argv.index("--src") + 1]).resolve() \
    if "--src" in sys.argv[:-1] else ROOT / "src"
sys.path.insert(0, str(SRC))

from repro_torch.core import gpu_model as g  # noqa: E402
from repro_torch.kernels import _ext, ops, ref  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
ATTN_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}


def build(sources) -> None:
    tool = Path(_ext.nvcc_path()).parent / "cuobjdump"
    for source in sources:
        t0 = time.perf_counter()
        path = _ext._build(source)
        print(f"built {source} in {time.perf_counter() - t0:.1f} s")
        for name, line in ptxas_lines(_ext.BUILD_LOGS.get(source, "")):
            print(f"   {name}: {line}")
        sass = subprocess.run([str(tool), "--dump-sass", str(path)],
                              check=True, capture_output=True,
                              text=True).stdout
        print(f"  SASS: HGMMA {sass.count(' HGMMA.')}, "
              f"HMMA {sass.count(' HMMA.')}")


def ptxas_lines(log: str):
    """``(kernel, line)`` for each register and spill line of a build's
    ptxas report; a template's integer arguments are shown, as in
    ``mm_f32<128,128,32>``."""
    import re
    name = ""
    for ln in log.splitlines():
        if "Function properties for " in ln or "entry function '" in ln:
            raw = ln.split("for ")[-1] if "Function properties" in ln \
                else ln.split("entry function '")[1].split("'")[0]
            name = raw.strip()
            if "ILi" in name:       # <length><name>I Li<int>E ... E
                pre, args = name.split("ILi", 1)
                for size in range(1, len(pre)):
                    if pre[:-size].endswith(str(size)) and \
                            not pre[-size].isdigit():
                        name = pre[-size:] + "<" + ",".join(
                            re.findall(r"(\d+)E", "Li" + args.split("EE")[0]
                                       + "E")) + ">"
                        break
        elif "registers" in ln or "spill" in ln:
            yield name, ln.strip()


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

    def many(self, label, fn, wants, names, tols):
        """Each output of ``fn()`` against ``wants`` within its
        ``tols[name]`` (atol, rtol)."""
        try:
            gots = fn()
            torch.cuda.synchronize()
            errs, ok = {}, True
            for name, got, want in zip(names, gots, wants):
                atol, rtol = tols[name]
                d = (got.float() - want.float()).abs()
                errs[name] = float(d.max())
                ok &= bool(torch.isfinite(got.float()).all()) and float(
                    (d - atol - rtol * want.float().abs()).max()) <= 0
            print(f"{'ok  ' if ok else 'FAIL'} {label}: max abs err {errs}")
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


# ---- the float32 GEMM, bit for bit and timed ------------------------------

def smollm_gemms():
    """``(phase, (m, k, n), count)`` of SmolLM-360M's training step at 8 x
    1024 tokens: fwd (m, k) @ (k, n), dX (m, n) @ (n, k), dW (k, m) @
    (m, n) of each forward GEMM (``chip_smoke.llm_gemm_shapes``), one
    entry a distinct shape and phase."""
    from repro_torch.configs import get_config
    cs = _smoke()
    counts = {}
    for m, k, n, count in cs.llm_gemm_shapes(get_config("smollm-360m"),
                                             cs.LLM_BATCH, cs.LLM_SEQ):
        for key in (("fwd", (m, k, n)), ("dX", (m, n, k)),
                    ("dW", (k, m, n))):
            counts[key] = counts.get(key, 0) + count
    return [(ph, mkn, count) for (ph, mkn), count in counts.items()]


RG_LRU_GEMM = (8192, 4096, 4096)      # recurrentgemma-9b's w_r / w_i, (m, k, n)


def _f32_operands(m, k, n, seed, dev, offset=False):
    """Seeded float32 A (m, k) and B (k, n) / sqrt(k) on the card; with
    ``offset``, views that start one float past their storage."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    extra = 1 if offset else 0
    a = torch.randn(m * k + extra, generator=gen, device=dev)[extra:]
    b = torch.randn(k * n + extra, generator=gen, device=dev)[extra:] \
        * k ** -0.5
    return a.view(m, k), b.view(k, n)


def f32_bit_cases():
    """``(key, (m, k, n), offset, [(tile, splits), ...])``: every run
    listed under one key must give the same bits, in this tree and in the
    tree ``--bits`` recorded.  One split: any compiled tile; split-K: one
    tile and split count a key."""
    wide = ((128, 128, 32), (128, 64, 64), (32, 64, 128)) + tuple(
        t for t in getattr(g, "F32_TILES", ()) if t not in g.MATMUL_TILES)
    cases = [(f"smollm {ph} {mkn} x1", mkn, False, [(t, 1) for t in wide])
             for ph, mkn, _ in smollm_gemms()]
    cases.append((f"rg-lru {RG_LRU_GEMM} x1", RG_LRU_GEMM, False,
                  [(t, 1) for t in wide]))
    for mkn in ((33, 65, 17), (1, 7, 128), (200, 130, 90), (147, 4099, 64),
                (300, 96, 200), (129, 200, 72)):
        cases.append((f"ragged {mkn} x1", mkn, False,
                      [(t, 1) for t in g.MATMUL_TILES]))
    for mkn in ((256, 1024, 512), (129, 200, 72)):
        cases.append((f"offset views {mkn} x1", mkn, True,
                      [(t, 1) for t in g.MATMUL_TILES]))
    for mkn, tile, splits in (((200, 1000, 96), (128, 64, 64), 7),
                              ((147, 4099, 64), (128, 128, 64), 13),
                              ((33, 650, 17), (32, 64, 32), 5),
                              ((300, 2050, 256), (128, 256, 64), 3),
                              ((64, 777, 40), (64, 64, 128), 6),
                              ((960, 8192, 2560), (128, 128, 32), 4),
                              ((2560, 8192, 960), (128, 64, 32), 3)):
        cases.append((f"split-K {mkn} {tile} x{splits}", mkn, False,
                      [(tile, splits)]))
    return cases


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int32).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def hold_f32_bits(hold: Holds, dev, bits_path) -> None:
    """Each case within 2e-4 of ``matmul_ref``, two calls and every tile
    of its key the same bits, and the same bits as ``bits_path`` (written
    there if it does not exist)."""
    recorded = None
    if bits_path is not None and Path(bits_path).exists():
        recorded = json.loads(Path(bits_path).read_text())
    digests = {}
    for i, (key, (m, k, n), offset, runs) in enumerate(f32_bit_cases()):
        a, b = _f32_operands(m, k, n, 2026 + i, dev, offset)
        want = ref.matmul_ref(a, b)
        seen = set()
        for tile, splits in runs:
            hold(f"f32 {key} {tile} x{splits}",
                 lambda: mm.matmul(a, b, *tile, splits=splits), want,
                 TOL[torch.float32])
            got = mm.matmul(a, b, *tile, splits=splits)
            again = mm.matmul(a, b, *tile, splits=splits)
            torch.cuda.synchronize()
            seen.add(_digest(got))
            if not torch.equal(got, again):
                print(f"FAIL f32 {key} {tile} x{splits}: two calls differ")
                hold.failed += 1
        digests[key] = sorted(seen)
        ok = len(seen) == 1 and (recorded is None or key not in recorded
                                 or recorded[key] == digests[key])
        print(f"{'ok  ' if ok else 'FAIL'} f32 bits {key}: {digests[key]}"
              + ("" if recorded is None else
                 f" (recorded {recorded.get(key)})"))
        hold.failed += not ok
        del a, b, want
    if bits_path is not None and recorded is None:
        Path(bits_path).parent.mkdir(parents=True, exist_ok=True)
        Path(bits_path).write_text(json.dumps(digests, indent=1))
        print(f"f32 digests written to {bits_path}")


def f32_times(dev) -> None:
    """Queued device ms of the float32 kernel at SmolLM's step shapes and
    recurrentgemma's RG-LRU product: the model's pick, every compiled
    tile (with the model's split for it) and ``torch.matmul``; then the
    sums over the step's GEMMs by phase."""
    tiles = getattr(g, "F32_TILES", g.MATMUL_TILES)
    sums = {}
    rows = [(ph, mkn, count) for ph, mkn, count in smollm_gemms()]
    rows.append(("rg-lru", RG_LRU_GEMM, 1))
    for ph, (m, k, n), count in rows:
        a, b = _f32_operands(m, k, n, 7, dev)
        iters = 3 if n * k > 10 ** 7 else 10
        blk = g.select_matmul_block(m, n, k, 4, 4)
        pick = queued_ms(lambda: ops.matmul(a, b), iters)
        lib = queued_ms(lambda: torch.matmul(a, b), iters)
        per = {}
        for t in tiles:
            sp = g.select_matmul_block(m, n, k, 4, 4, tile=t).splits
            per[t] = (sp, queued_ms(lambda: mm.matmul(a, b, *t, splits=sp),
                                    iters))
        best = min(per, key=lambda t: per[t][1])
        flop = 2.0 * m * n * k
        print(f"f32 {ph} {(m, k, n)} x{count}: model "
              f"{(blk.bm, blk.bn, blk.bk)} x{blk.splits} {pick:.4f} ms "
              f"({flop / pick / 1e9:.1f} TFLOP/s), fastest {best} "
              f"x{per[best][0]} {per[best][1]:.4f} ms, torch.matmul "
              f"{lib:.4f} ms ({flop / lib / 1e9:.1f} TFLOP/s), bound "
              f"{flop / 67e12 * 1e3:.4f} ms; tiles: " + ", ".join(
                  f"{t} x{sp} {v:.4f}" for t, (sp, v) in per.items()))
        for key, v in (("kernel", pick), ("torch.matmul", lib),
                       ("fastest tile", per[best][1]),
                       ("bound", flop / 67e12 * 1e3)):
            sums.setdefault(ph, {}).setdefault(key, 0.0)
            sums[ph][key] += count * v
        del a, b
    for ph, row in sums.items():
        print(f"f32 {ph} summed over the step's GEMMs: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in row.items()))


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


def attention_times(dev) -> None:
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
    # float32 at SmolLM-360M's training shape: 8 x 15 heads, 5 KV, S 1024,
    # head_dim 64, causal; bound at the CUDA cores' 67 TFLOP/s
    b, h, kv, s, d = 8, 15, 5, 1024, 64
    q = torch.randn(b * h, s, d, device=dev)
    k = torch.randn(b * kv, s, d, device=dev)
    v = torch.randn(b * kv, s, d, device=dev)
    qb, kb, vb = q.view(b, h, s, d), k.view(b, kv, s, d), v.view(b, kv, s, d)
    flop = 4.0 * d * b * h * s * (s + 1) / 2
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    kern = queued_ms(lambda: ops.flash_attention(q, k, v, h, kv))
    plain = queued_ms(lambda: ref.flash_attention_ref(q, k, v, h, kv), 5)
    sdpa = queued_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True, enable_gqa=True))
    print(f"flash_attention SmolLM causal (120, 1024, 64) float32: {kern} ms "
          f"({flop / kern / 1e9:.1f} TFLOP/s), plain {plain} ms, "
          f"scaled_dot_product_attention {sdpa} ms, bound "
          f"{max(flop / 67e12, nbytes / HBM_BYTES_PER_S) * 1e3} ms")


def gemm_times(dev) -> None:
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


# ---- batch norm ----------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
# (atol, rtol): tests/test_kernels.py's float32 tolerances (numpy's default
# rtol 1e-7 for the forward), 3e-2 in bfloat16
BN_TOL = {torch.float32: {"y": (1e-4, 1e-7), "mu": (1e-5, 1e-7),
                          "psi": (1e-4, 1e-7), "dx": (1e-4, 1e-4),
                          "dgamma": (1e-3, 1e-3), "dbeta": (1e-3, 1e-3)},
          torch.bfloat16: dict.fromkeys(
              ("y", "dx", "dgamma", "dbeta"), (3e-2, 3e-2)) | {
              "mu": (1e-5, 1e-7), "psi": (1e-4, 1e-7)}}


def resnet_bn_shapes():
    """ResNet-50's BN shapes at batch 32, each with its layer count."""
    from repro_torch.kernels.forward import resnet50_calls
    counts = {}
    for kind, _, shape in resnet50_calls(32):
        if kind == "bn_forward":
            counts[shape] = counts.get(shape, 0) + 1
    return counts


def _bn_inputs(n, c, dtype, dev, gen, shift=0.0):
    x = (torch.randn(n, c, device=dev, generator=gen) + shift).to(dtype)
    g = torch.randn(c, device=dev, generator=gen) + 1.0
    b = torch.randn(c, device=dev, generator=gen)
    dy = torch.randn(n, c, device=dev, generator=gen).to(dtype)
    return x, g, b, dy


def hold_bn(hold: Holds, dev) -> None:
    """Both kernels against the plain versions, and bit-identical over
    two calls."""
    gen = torch.Generator(device=dev).manual_seed(15)
    shapes = [(s, torch.float32) for s in resnet_bn_shapes()] + [
        ((401408, 64), torch.bfloat16), ((6272, 1024), torch.bfloat16)] + [
        (s, d) for d in (torch.float32, torch.bfloat16)
        for s in ((300, 70), (256, 128), (64, 33), (1001, 67), (4099, 1030),
                  (128, 16))]
    for (n, c), dtype in shapes:
        x, g, b, dy = _bn_inputs(n, c, dtype, dev, gen)
        want = ref.bn_forward_ref(x, g, b)
        _, mu, psi = want
        back = ref.bn_backward_ref(x, dy, g, mu, psi)
        tol = BN_TOL[dtype]
        hold.many(f"bn_forward {dtype} {(n, c)}",
                  lambda: ops.bn_forward(x, g, b), want, ("y", "mu", "psi"),
                  tol)
        hold.many(f"bn_backward {dtype} {(n, c)}",
                  lambda: ops.bn_backward(x, dy, g, mu, psi), back,
                  ("dx", "dgamma", "dbeta"), tol)
        first, again = ([t.clone() for t in ops.bn_forward(x, g, b)]
                        + [t.clone() for t in ops.bn_backward(
                            x, dy, g, mu, psi)] for _ in range(2))
        same = all(torch.equal(a, b_) for a, b_ in zip(first, again))
        print(f"{'ok  ' if same else 'FAIL'} bn {dtype} {(n, c)}: "
              f"bit-identical over two calls")
        hold.failed += not same
    from repro_torch.kernels import bn
    if hasattr(bn.bn_forward, "routes"):
        print(f"routes: bn_forward {bn.bn_forward.routes}, bn_backward "
              f"{bn.bn_backward.routes}")


def bn_forward_f64(x, g, b, eps=1e-5):
    """``bn_forward_ref``'s formula (two-pass variance) in float64."""
    xd = x.double()
    mu = xd.mean(0)
    psi = torch.rsqrt(xd.var(0, correction=0) + eps)
    return (xd - mu) * psi * g.double() + b.double(), mu, psi


def bn_shift(dev) -> None:
    """At mean shifts 10, 100, 1000 (4096 x 64, 5 seeds): the largest
    distance of the kernel's and of the float32 plain version's mu, psi
    and y from the plain version's formula in float64."""
    for shift in (10.0, 100.0, 1000.0):
        err = {}
        for seed in range(5):
            gen = torch.Generator(device=dev).manual_seed(seed)
            x, g, b, _ = _bn_inputs(4096, 64, torch.float32, dev, gen, shift)
            exact = bn_forward_f64(x, g, b)
            for label, got in (("kernel", ops.bn_forward(x, g, b)),
                               ("plain f32", ref.bn_forward_ref(x, g, b))):
                for what, a, w in zip(("y", "mu", "psi"), got, exact):
                    key = f"{label} {what}"
                    err[key] = max(err.get(key, 0.0),
                                   float((a.double() - w).abs().max()))
        print(f"bn_forward shift {shift}, max abs err against the float64 "
              f"formula over 5 seeds: {err}")


def bn_times(dev) -> None:
    """Queued device ms at the 12 shapes beside F.batch_norm /
    native_batch_norm_backward and the bound; and the sums over the 53
    layers."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(16)
    total = {}
    for (n, c), count in resnet_bn_shapes().items():
        x, g, b, dy = _bn_inputs(n, c, torch.float32, dev, gen)
        _, mu, psi = ref.bn_forward_ref(x, g, b)
        nb = x.numel() * x.element_size()
        vec = 4 * c
        row = {
            "fwd": queued_ms(lambda: ops.bn_forward(x, g, b)),
            "fwd F.batch_norm": queued_ms(lambda: F.batch_norm(
                x, None, None, g, b, training=True)),
            "fwd bound": (2 * nb + 4 * vec) / HBM_BYTES_PER_S * 1e3,
            "bwd": queued_ms(lambda: ops.bn_backward(x, dy, g, mu, psi)),
            "bwd native": queued_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dy, x, g, None, None, mu, psi, True, 1e-5,
                    [True, True, True])),
            "bwd bound": (3 * nb + 5 * vec) / HBM_BYTES_PER_S * 1e3}
        print(f"bn {(n, c)} f32 x{count}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()) + " ms")
        for k, v in row.items():
            total[k] = total.get(k, 0.0) + count * v
        del x, dy
    print("bn, all 53 layers (sum of shape ms x layers): " + ", ".join(
        f"{k} {v:.4f}" for k, v in total.items()) + " ms")


# ---- grid_minmax -----------------------------------------------------------

def _smoke():
    """``chip_smoke.py`` of this tree (its cases and bound); it imports the
    port only inside its functions, so from ``SRC``."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    return chip_smoke


def hold_grid_minmax(hold: Holds, dev) -> None:
    """Exactly ``grid_minmax_ref``, twice the same bits, on every case."""
    from repro_torch.kernels.reduce import grid_minmax, grid_minmax_ref
    cs = _smoke()
    cases = dict(cs.kernel_cases())
    cases.update((f"main_path/{k}", v)
                 for k, v in cs.main_path_shapes().items())
    big, want = cs.index_past_2_31_case()
    cases["index_past_2_31"] = big
    for name, arrs in cases.items():
        args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
        try:
            got, again = grid_minmax(*args), grid_minmax(*args)
            ref_ = grid_minmax_ref(*args)
            torch.cuda.synchronize()
            ok = torch.equal(got, ref_) and torch.equal(got, again)
            if name == "index_past_2_31":
                ok &= got.tolist() == want
            print(f"{'ok  ' if ok else 'FAIL'} grid_minmax {name} "
                  f"{tuple(args[2].shape) + tuple(args[0].shape[1:])}: "
                  f"{got.tolist()} (plain {ref_.tolist()})")
            del ref_
        except Exception:       # report every case, then fail at the end
            ok = False
            print(f"EXC  grid_minmax {name}\n{traceback.format_exc()}")
        hold.failed += not ok
        del args
        torch.cuda.empty_cache()
    print(f"routes: {getattr(grid_minmax, 'routes', 'none (one route)')}")


def grid_minmax_times(dev) -> None:
    from repro_torch.kernels.reduce import grid_minmax, grid_minmax_ref
    cs = _smoke()
    rate = cs.int32_ops_per_s()
    for label, arrs in cs.main_path_shapes().items():
        args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
        bound, by, _ = cs.kernel_bound_ms(args, rate)
        dev_ms = [queued_ms(lambda: grid_minmax(*args), 200)
                  for _ in range(3)]
        print(f"grid_minmax {label} {tuple(args[2].shape)} x "
              f"{tuple(args[0].shape)} + {tuple(args[1].shape)}: device "
              f"{dev_ms} ms (queued, 3 runs of 200), "
              f"{cs.cuda_ms(lambda: grid_minmax(*args), 200, 20)} ms a call "
              f"by events, plain "
              f"{cs.cuda_ms(lambda: grid_minmax_ref(*args), 50, 5)} ms, "
              f"bound {bound} ms ({by}; INT32 rate {rate:.4g}/s)")


def grid_minmax_trace(dev) -> None:
    """Where one call's time goes at each main-path shape: the kernel built
    with ``-DGRID_MINMAX_TRACE`` records the global timer and the SM clock
    of every block at its phase ends (``csrc/grid_minmax.cu``), read
    after the last of five calls."""
    import ctypes

    import numpy as np
    from repro_torch.kernels import reduce
    src = _ext.CSRC / reduce.SOURCE
    if "GRID_MINMAX_TRACE" not in src.read_text():
        print("grid_minmax: this tree's kernel has no trace points")
        return
    path = _ext.BUILD_DIR / "grid_minmax-trace.so"
    _ext.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-DGRID_MINMAX_TRACE",
                    "-o", str(path), str(src)], check=True,
                   capture_output=True)
    traced = reduce._bind(ctypes.CDLL(str(path)))
    library = reduce._library
    reduce._library = lambda: traced
    try:
        for label, arrs in _smoke().main_path_shapes().items():
            args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
            for _ in range(5):
                reduce.grid_minmax(*args)
            torch.cuda.synchronize()
            buf = np.zeros((2048, 16), np.int64)
            traced.grid_minmax_trace_read(ctypes.c_void_p(buf.ctypes.data))
            plan = reduce.launch_plan(args[2].shape[0], args[0].shape[1],
                                      args[1].shape[0], torch.cuda
                                      .get_device_properties(dev)
                                      .multi_processor_count)
            ns = buf[:plan.blocks, :7] - buf[:plan.blocks, 0].min()
            cycles = np.diff(buf[:plan.blocks, 8:13], axis=1)
            print(f"grid_minmax {label} trace ({plan.blocks} blocks): "
                  f"first item's phases, SM cycles median/max: "
                  + ", ".join(f"{name} {np.median(cycles[:, i])}/"
                              f"{cycles[:, i].max()}" for i, name in
                              enumerate(("staged", "numbered",
                                         "first half landed", "walked")))
                  + f"; global timer from the first block's start, ns: "
                  f"blocks started by {ns[:, 0].max()}, partials merged "
                  f"median {np.median(ns[:, 5])} max {ns[:, 5].max()}, "
                  f"answer written {ns[:, 6].max()}")
    finally:
        reduce._library = library


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("gemm", "attention", "bn",
                                       "grid_minmax"))
    ap.add_argument("--src", help="import the port from this src/ tree")
    ap.add_argument("--bits", help="float32 GEMM digests: written here, "
                    "or held against this file if it exists")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          SRC)
    parts = ("gemm", "attention", "bn", "grid_minmax") \
        if args.only is None else (args.only,)
    build([s for p, s in (("gemm", "matmul.cu"),
                          ("attention", "flash_attention.cu"),
                          ("bn", "bn_forward.cu"), ("bn", "bn_backward.cu"),
                          ("grid_minmax", "grid_minmax.cu"))
           if p in parts])
    torch.manual_seed(0)
    hold = Holds()
    for part, fn in (("gemm", hold_gemms), ("attention", hold_attention),
                     ("bn", hold_bn), ("grid_minmax", hold_grid_minmax)):
        if part in parts:
            fn(hold, "cuda")
    if "gemm" in parts:
        hold_f32_bits(hold, "cuda", args.bits)
    if hold.failed == 0:
        for part, fn in (("attention", attention_times),
                         ("gemm", gemm_times), ("gemm", f32_times),
                         ("bn", bn_shift),
                         ("bn", bn_times),
                         ("grid_minmax", grid_minmax_times),
                         ("grid_minmax", grid_minmax_trace)):
            if part in parts:
                fn("cuda")
    print(f"failed cases: {hold.failed}")
    return 1 if hold.failed else 0


if __name__ == "__main__":
    sys.exit(main())
