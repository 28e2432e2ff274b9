"""The port's GEMM entry point against the JAX package's Pallas GEMM.

``repro_torch.kernels.ops.matmul`` on CPU tensors (which runs the plain
version, ``matmul_ref``) is held to ``repro.kernels.ops.matmul`` in Pallas
interpret mode, on the same numpy inputs, with the shapes, dtypes, blocks
and tolerances of ``tests/test_kernels.py``.  The CUDA kernel
(``csrc/matmul.cu``) is held to ``matmul_ref`` on the card by
``chip_smoke.py``.  ``MatmulFn``'s gradients are held to ``jax.grad``
of the JAX oracle ``repro.kernels.ref.matmul_ref``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import gpu_model  # noqa: E402
from repro_torch.core.gpu_model import MATMUL_TILES  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"


def _tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == jnp.bfloat16 \
        else dict(atol=2e-4, rtol=2e-4)


def _operands(seed, m, n, k, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32).astype(dtype),
            rng.standard_normal((k, n), dtype=np.float32).astype(dtype))


def _both(a, b, **blocks):
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), **blocks)
    got = tops.matmul(from_numpy(a), from_numpy(b), **blocks)
    return to_numpy(got), np.asarray(want)


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (200, 90, 130),
                                   (128, 256, 512), (33, 17, 65), (1, 128, 7)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_sweep_matches_pallas(m, n, k, dtype):
    a, b = _operands(m * 1000 + n, m, n, k, dtype)
    got, want = _both(a, b, bm=64, bn=64, bk=64)
    assert got.dtype == want.dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **_tol(dtype))


@pytest.mark.parametrize("m,n,k", [(0, 8, 8), (8, 0, 8), (8, 8, 0),
                                   (0, 0, 0), (1, 1, 0)])
@pytest.mark.parametrize("explicit_blocks", [False, True])
def test_matmul_zero_dim(m, n, k, explicit_blocks):
    """An empty reduction axis contracts to zeros, an empty m or n gives
    the empty matrix, with or without blocks, as in the JAX package."""
    a = np.zeros((m, k), np.float32)
    b = np.zeros((k, n), np.float32)
    blocks = dict(bm=64, bn=64, bk=64) if explicit_blocks else {}
    got, want = _both(a, b, **blocks)
    assert got.shape == want.shape == (m, n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_matmul_zero_k_contracts_to_zeros():
    out = tops.matmul(torch.zeros((5, 0)), torch.zeros((0, 7)))
    np.testing.assert_array_equal(to_numpy(out), np.zeros((5, 7)))


@settings(max_examples=15, deadline=None)
@given(m=st.integers(1, 300), n=st.integers(1, 200), k=st.integers(1, 300),
       bm=st.sampled_from([32, 64, 128]), bk=st.sampled_from([32, 128]))
def test_matmul_property(m, n, k, bm, bk):
    a, b = _operands(m + 7 * n + 13 * k, m, n, k)
    got, want = _both(a, b, bm=bm, bn=64, bk=bk)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("m,n,k", [(300, 200, 96), (64, 1000, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_default_blocks_match_pallas(m, n, k, dtype):
    """Blocks 0 ask each package's tile model (the port's for the H100,
    the JAX package's for the TPU); the product is the same."""
    a, b = _operands(m + n + k, m, n, k, dtype)
    got, want = _both(a, b)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **_tol(dtype))


@pytest.mark.parametrize("tile", [(96, 64, 64), (64, 64, 16), (256, 256, 256),
                                  (16, 16, 16)])
def test_uncompiled_tile_raises(tile):
    a, b = _operands(0, 8, 8, 8)
    with pytest.raises(ValueError, match="not compiled"):
        tops.matmul(from_numpy(a), from_numpy(b), *tile)


def test_compiled_tiles_match_the_source():
    """``MATMUL_TILES`` lists exactly the instantiations of matmul.cu."""
    src = (CSRC / "matmul.cu").read_text()
    body = src[src.index("#define MATMUL_TILES(X)"):]
    body = body[:body.index("\n\n")]
    tiles = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    assert tiles == list(MATMUL_TILES)


@pytest.mark.parametrize("bad", [
    dict(a=(4, 3), b=(4, 5)),            # inner dimensions differ
    dict(a=(4,), b=(4, 5)),              # not a matrix
])
def test_shape_errors_raise(bad):
    with pytest.raises(ValueError, match="do not multiply"):
        tmm.matmul(torch.zeros(bad["a"]), torch.zeros(bad["b"]), 64, 64, 64)


def test_mixed_types_raise():
    with pytest.raises(TypeError, match="one type"):
        tops.matmul(torch.zeros((4, 4)), torch.zeros((4, 4),
                                                     dtype=torch.bfloat16))


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (200, 90, 130), (33, 17, 65)])
def test_matmulfn_matches_jax_grad(m, n, k):
    """``MatmulFn``'s forward and both operand gradients (two more GEMMs
    through ``ops.matmul``: dC @ B^T and A^T @ dC) against ``jax.grad``
    of ``matmul_ref``, float32, with the float32 tolerance."""
    a, b = _operands(m + n + k, m, n, k)
    dc = np.random.default_rng(7).standard_normal((m, n), dtype=np.float32)

    def loss(a, b):
        return jnp.sum(jref.matmul_ref(a, b) * dc)
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    c = tmm.MatmulFn.apply(at, bt)
    np.testing.assert_allclose(c.detach().numpy(),
                               np.asarray(jref.matmul_ref(a, b)),
                               **_tol(jnp.float32))
    (c * torch.from_numpy(dc)).sum().backward()
    for t, w in zip((at, bt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **_tol(jnp.float32))


def test_matmulfn_makes_only_the_needed_gradients():
    """The backward calls ``impl.matmul`` once for each operand that
    needs a gradient, on contiguous operands."""
    shapes = []

    class Recording:
        def matmul(self, a, b):
            assert a.is_contiguous() and b.is_contiguous()
            shapes.append((tuple(a.shape), tuple(b.shape)))
            return tops.matmul(a, b)
    a = torch.randn(5, 3)
    b = torch.randn(3, 4, requires_grad=True)
    tmm.MatmulFn.apply(a, b, Recording()).sum().backward()
    assert shapes == [((5, 3), (3, 4)), ((3, 5), (5, 4))]
    shapes.clear()
    a.requires_grad_()
    tmm.MatmulFn.apply(a, b, Recording()).t().sum().backward()
    assert shapes == [((5, 3), (3, 4)), ((5, 4), (4, 3)), ((3, 5), (5, 4))]


def test_wgmma_tiles_match_the_source():
    """``WGMMA_TILES`` lists exactly the `wgmma` instantiations of
    matmul.cu, and each is also compiled on the `mma` route."""
    src = (CSRC / "matmul.cu").read_text()
    body = src[src.index("#define WGMMA_TILES(X)"):]
    body = body[:body.index("\n\n")]
    tiles = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    assert tiles == list(gpu_model.WGMMA_TILES)
    assert set(tiles) <= set(MATMUL_TILES)


# ---------------------------------------------------------------------------
# routes and split-K (the rules the CUDA kernel follows, in Python)
# ---------------------------------------------------------------------------

def _resnet50_gemms():
    """(phase, (m, k, n)) of every GEMM of one ResNet-50 training step at
    batch 32: fwd (m, k) @ (k, n), dX (m, n) @ (n, k) but for the stem,
    dW (k, m) @ (m, n)."""
    from repro_torch.core.layers import ConvLayer
    from repro_torch.core.networks import resnet50
    convs = [c for c in resnet50(batch=32) if isinstance(c, ConvLayer)]
    out = []
    for i, c in enumerate(convs):
        m, k, n = c.n * c.oh * c.ow, c.kh * c.kw * c.ic, c.oc
        out.append(("fwd", (m, k, n)))
        if i:
            out.append(("dX", (m, n, k)))
        out.append(("dW", (k, m, n)))
    return out


QWEN3_GEMMS = [(4096, 1024, 4096), (4096, 2048, 1024), (4096, 1024, 3072),
               (4096, 3072, 1024), (4096, 1024, 151936)]     # (m, k, n)


def test_route_rule():
    """The stem's K = 147 (its forward, and the dX product's N = 147), the
    ragged edge cases, a misaligned pointer, float32 and a bm-32 tile go
    to the `mma` route; every Qwen3 GEMM and every other ResNet-50 GEMM
    of the training step goes to `wgmma` under the model's pick."""
    route = gpu_model.matmul_route
    wg = (128, 128, 64)
    assert route(64, 147, 2, wg) == "mma"           # stem forward
    assert route(147, 64, 2, wg) == "mma"           # stem dX: N = 147
    for m, n, k in ((200, 90, 130), (33, 17, 65), (1, 128, 7)):
        assert route(n, k, 2, wg) == "mma"
    assert route(64, 64, 2, wg, a_ptr=2) == "mma"   # an offset view
    assert route(64, 64, 2, wg, b_ptr=8) == "mma"
    assert route(64, 64, 4, wg) == "mma"            # float32
    assert route(64, 64, 2, (32, 64, 128)) == "mma"
    assert route(64, 64, 2, wg, a_ptr=4096, b_ptr=16) == "wgmma"
    gemms = [("qwen3", s) for s in QWEN3_GEMMS] + _resnet50_gemms()
    assert len(gemms) == 5 + 161
    for phase, (m, k, n) in gemms:
        blk = gpu_model.select_matmul_block(m, n, k)
        want = "mma" if k == 147 else "wgmma"
        assert blk.route == want, (phase, (m, k, n), blk)
        assert route(n, k, 2, (blk.bm, blk.bn, blk.bk)) == want
        # unaligned operands never reach `wgmma`
        assert gpu_model.select_matmul_block(
            m, n, k, aligned=False).route == "mma"


@pytest.mark.parametrize("k,bk,splits", [
    (64, 64, 1), (130, 64, 3), (401408, 64, 66), (4608, 64, 5),
    (65, 32, 3), (7, 128, 1), (1000, 64, 16), (1000, 64, 15),
    (147, 32, 5)])
def test_split_bounds_cover_k_exactly(k, bk, splits):
    """The mirror of the kernel's split bounds: consecutive, non-empty,
    together exactly [0, k), every inner bound a multiple of bk."""
    bounds = gpu_model.split_bounds(k, bk, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2 and hi % bk == 0
    assert all(lo < hi for lo, hi in bounds)
    covered = np.zeros(k, np.int64)
    for lo, hi in bounds:
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)


def _split_sum(a, b, bk, splits):
    """The split-K GEMM as the kernels compute it: a float32 partial per
    split over its K range, then the partials added in split order and
    cast to A's type."""
    af, bf = a.float(), b.float()
    parts = [af[:, lo:hi] @ bf[lo:hi] for lo, hi in
             gpu_model.split_bounds(a.shape[1], bk, splits)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.to(a.dtype)


@pytest.mark.parametrize("m,n,k,bk,splits", [
    (64, 64, 1000, 64, 7), (33, 17, 650, 32, 5), (147, 64, 4099, 64, 13),
    (200, 90, 130, 64, 3)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_split_sum_matches_the_oracle(m, n, k, bk, splits, dtype):
    """K not a multiple of splits * bk: the fixed-order sum of the
    partials is within the dtype's tolerance of the JAX oracle and of
    ``matmul_ref``."""
    a, b = _operands(m + n + k, m, n, k, dtype)
    got = to_numpy(_split_sum(from_numpy(a), from_numpy(b), bk, splits))
    for want in (np.asarray(jref.matmul_ref(jnp.asarray(a), jnp.asarray(b))),
                 to_numpy(tmm.matmul_ref(from_numpy(a), from_numpy(b)))):
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), **_tol(dtype))


# dW GEMMs of PERF.md's training step, (m, k, n) = (kh kw ic, n oh ow, oc)
DW_SHAPES = [(147, 401408, 64), (64, 100352, 256), (576, 100352, 64),
             (1152, 25088, 128), (2304, 6272, 256), (4608, 1568, 512)]


@pytest.mark.parametrize("bytes_in", [2, 4])
def test_select_splits_long_k_and_not_the_projections(bytes_in):
    """The model splits K for the step's long-K dW GEMMs (all but the
    last, whose output tiles already fill more than half the SMs) and
    leaves Qwen3's projections whole; its tiles are compiled and fit."""
    for m, k, n in DW_SHAPES[:-1]:
        blk = gpu_model.select_matmul_block(m, n, k, bytes_in, bytes_in)
        assert blk.splits > 1, (m, k, n, blk)
        blocks = -(-m // blk.bm) * -(-n // blk.bn) * blk.splits
        assert blocks > gpu_model.SM_COUNT * 0.9, (m, k, n, blk)
    for m, k, n in QWEN3_GEMMS:
        assert gpu_model.select_matmul_block(m, n, k, bytes_in,
                                             bytes_in).splits == 1
    for m, k, n in DW_SHAPES + QWEN3_GEMMS:
        blk = gpu_model.select_matmul_block(m, n, k, bytes_in, bytes_in)
        assert (blk.bm, blk.bn, blk.bk) in gpu_model.compiled_tiles(bytes_in)
        assert gpu_model.kernel_smem(blk.route, blk.bm, blk.bn, blk.bk,
                                     bytes_in) <= gpu_model.SMEM_BYTES
        assert 1 <= blk.splits <= -(-k // blk.bk)


def test_partials_cost_traffic():
    """``matmul_cost`` counts the partials: each split adds a float32
    write and read of the output."""
    one = gpu_model.matmul_cost(4096, 4096, 1024, 128, 256, 64, splits=1)
    four = gpu_model.matmul_cost(4096, 4096, 1024, 128, 256, 64, splits=4)
    assert four[1] - one[1] == 2 * 4 * 4096 * 4096 * 4
    assert gpu_model.matmul_cost(64, 64, 64, 128, 64, 64, splits=2) is None


@pytest.mark.parametrize("splits", [0, 3, -1, True, 2.0])
def test_bad_splits_raise(splits):
    a, b = _operands(0, 8, 8, 100)
    with pytest.raises(ValueError, match="splits"):
        tmm.matmul(from_numpy(a), from_numpy(b), 64, 64, 64, splits=splits)


def test_split_runs_the_plain_version_on_the_cpu():
    a, b = _operands(1, 40, 24, 300)
    counts = dict(tmm.matmul.routes)
    got = tmm.matmul(from_numpy(a), from_numpy(b), 64, 64, 64, splits=5)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(tmm.matmul_ref(
        from_numpy(a), from_numpy(b))))
    assert tmm.matmul.routes == counts


# ---------------------------------------------------------------------------
# the float32 kernel: its tiles, ring, residency and route rule
# ---------------------------------------------------------------------------

def _source():
    return (CSRC / "matmul.cu").read_text()


def _define(name):
    src = _source()
    body = src[src.index(f"#define {name}(X)"):]
    return body[:body.index("\n\n")]


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def test_f32_tiles_match_the_source():
    """``F32_TILES`` lists exactly the f32 kernel's instantiations:
    every `mma` tile (so an explicit tile runs in either type) and its
    own ones, each of bm a multiple of 32, bn of 64, bk of 32 (the
    kernel's static_assert)."""
    body = _define("F32_TILES")
    assert "MATMUL_TILES(X)" in body
    own = [tuple(int(v) for v in t) for t in
           re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    assert list(gpu_model.F32_TILES) == list(MATMUL_TILES) + own
    assert own and not set(own) & set(MATMUL_TILES)
    for bm, bn, bk in gpu_model.F32_TILES:
        assert bm % 32 == 0 and bn % 64 == 0 and bk % 32 == 0
    assert gpu_model.compiled_tiles(4) == gpu_model.F32_TILES
    assert gpu_model.compiled_tiles(2) == MATMUL_TILES


def test_f32_ring_matches_the_source():
    """The model's stage depth, shared memory and register bound of the
    f32 kernel follow ``F32Tile``: its constants read from the source,
    its formulas written out here; every tile fits a block's shared
    memory, and a two-block tile's ring fits half of it."""
    src = _source()
    for text in ("static constexpr int STAGE = BM * BK + BK * BN;",
                 "static constexpr int AT = KC * BM;",
                 "MIN_BLOCKS = TM * TN <= 64 ? 2 : 1;",
                 "MIN_BLOCKS == 2 ? F32_SMEM_BUDGET : 2 * F32_SMEM_BUDGET;",
                 "FIT = (BUDGET - 4 * AT - 128) / (4 * STAGE);",
                 "SMEM = sizeof(float) * (STAGES * STAGE + AT) + 128;",
                 "kTma ? F32Tile<BM, BN, BK>::MIN_BLOCKS : 1"):
        assert text in src, text
    max_stages, budget = _constant("F32_MAX_STAGES"), \
        _constant("F32_SMEM_BUDGET")
    kc = _constant("KC")
    assert (max_stages, budget, kc) == (gpu_model.F32_MAX_STAGES,
                                        gpu_model.F32_SMEM_BUDGET,
                                        gpu_model.F32_KC)
    assert gpu_model.F32_TWO_BLOCK_OUTPUTS == 64
    for bm, bn, bk in gpu_model.F32_TILES:
        tm, tn = bm // 16, bn // 16
        two = tm * tn <= 64
        stage, at = bm * bk + bk * bn, kc * bm
        fit = ((budget if two else 2 * budget) - 4 * at - 128) // (4 * stage)
        stages = max(2, min(max_stages, fit))
        smem = 4 * (stages * stage + at) + 128
        assert gpu_model.f32_two_blocks(bm, bn) == two
        assert gpu_model.f32_stages(bm, bn, bk) == stages
        assert gpu_model.kernel_smem("mma", bm, bn, bk, 4) == smem
        assert smem <= gpu_model.SMEM_BYTES, (bm, bn, bk)
        if two and fit >= 2:
            assert smem <= budget
        for tma in (True, False):
            regs = gpu_model.f32_regs(bm, bn, tma)
            assert regs <= (128 if two and tma else 255)
            assert gpu_model.resident_blocks("mma", bm, bn, bk, 4, tma) == \
                min(gpu_model.SMEM_PER_SM // smem,
                    gpu_model.THREADS_PER_SM // 256,
                    gpu_model.REGS_PER_SM // (256 * regs))


@pytest.mark.parametrize("tile,share", [
    ((128, 128, 32), 64 / 68), ((128, 64, 64), 32 / 48),
    ((128, 256, 32), 128 / 134), ((32, 64, 32), 8 / 24),
    ((64, 64, 64), 16 / 32)])
def test_f32_fma_share(tile, share):
    """A k step's FMAs against the longer of its issue (FMAs and shared
    loads) and its shared-memory cycles, four warps to an SM."""
    assert gpu_model.f32_fma_share(tile[0], tile[1]) == pytest.approx(share)


def _smollm_gemms():
    """(m, k, n) of SmolLM-360M's training step at 8 x 1024 tokens: fwd,
    dX and dW of each forward GEMM."""
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m")
    rows, d, f = 8 * 1024, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    fwd = [(rows, d, q), (rows, d, kv), (rows, q, d), (rows, d, f),
           (rows, f, d), (8 * 1023, d, cfg.vocab_size)]
    return sorted({g for m, k, n in fwd
                   for g in ((m, k, n), (m, n, k), (k, m, n))})


def test_f32_route_rule():
    """TMA fills the f32 ring when both operands' rows are multiples of 4
    floats and both bases 16-byte aligned, else cp.async (16 bytes for
    the operand that allows it, a float for the other); float32 always
    takes the `mma` route.  Every GEMM of SmolLM's step and of
    recurrentgemma's RG-LRU goes to TMA; of ResNet-50's f32 step only
    the stem's forward (K = 147) goes to cp.async."""
    vec, tma = gpu_model.f32_vector_copies, gpu_model.f32_tma_ok
    assert vec(64, 64) == (True, True) and tma(64, 64, 4096, 16)
    assert vec(64, 147) == (False, True) and not tma(64, 147)
    assert vec(17, 64) == (True, False) and not tma(17, 64)
    assert vec(17, 65) == (False, False)
    assert vec(128, 7) == (False, True)               # (1, 7) @ (7, 128)
    assert vec(64, 64, a_ptr=4) == (False, True)      # offset views
    assert vec(64, 64, b_ptr=8) == (True, False)
    assert not tma(64, 64, a_ptr=4) and not tma(64, 64, b_ptr=8)
    for tile in gpu_model.F32_TILES:
        assert gpu_model.matmul_route(64, 64, 4, tile) == "mma"
    for m, k, n in _smollm_gemms() + [(8192, 4096, 4096)]:
        assert tma(n, k), (m, k, n)
    resnet = [tma(n, k) for _, (m, k, n) in _resnet50_gemms()]
    assert len(resnet) == 161 and resnet.count(False) == 1


def test_select_f32_picks_a_compiled_tile_that_fits():
    """At SmolLM's and recurrentgemma's shapes the model picks a compiled
    f32 tile whose kernel fits shared memory and is resident, the least
    modelled time over every f32 tile and split, and its estimate is the
    Eq. 18 step written out with the ring's depth: (stages - 1) x the
    resident blocks (a load overlapped by the stages in flight)."""
    for m, k, n in _smollm_gemms() + [(8192, 4096, 4096)]:
        blk = gpu_model.select_matmul_block(m, n, k, 4, 4)
        tile = (blk.bm, blk.bn, blk.bk)
        assert blk.route == "mma" and tile in gpu_model.F32_TILES
        assert gpu_model.kernel_smem("mma", *tile, 4) <= \
            gpu_model.SMEM_BYTES
        assert gpu_model.resident_blocks("mma", *tile, 4) >= 1
        costs = [gpu_model.matmul_cost(m, n, k, *t, 4, 4, splits=s)
                 for t in gpu_model.F32_TILES
                 for s in range(1, min(-(-k // t[2]),
                                       gpu_model.MAX_SPLITS) + 1)]
        assert blk.est_s == min(c[0] for c in costs if c is not None)
    m, n, k, (bm, bn, bk) = 8192, 960, 2560, (128, 128, 32)
    stages = gpu_model.f32_stages(bm, bn, bk)
    res = gpu_model.resident_blocks("mma", bm, bn, bk, 4)
    assert (stages, res) == (3, 2)
    per_sm = -(-(-(-m // bm) * -(-n // bn)) // gpu_model.SM_COUNT)
    sm_bw = gpu_model.HBM_BW / gpu_model.SM_COUNT
    compute = 2.0 * bm * bn * bk / (gpu_model.PEAK_FLOPS_F32
                                    / gpu_model.SM_COUNT) \
        / gpu_model.f32_fma_share(bm, bn)
    load = (bm * bk + bk * bn) * 4 / sm_bw
    step = max(compute, load,
               (compute + load) / ((stages - 1) * min(res, per_sm)))
    want = per_sm * (-(-k // bk) * step + bm * bn * 4 / sm_bw)
    est, _ = gpu_model.matmul_cost(m, n, k, bm, bn, bk, 4, 4, splits=1)
    assert est == pytest.approx(want, rel=1e-12)


def test_f32_only_tile():
    """The f32 kernel's own tile runs in float32 (on the CPU, the plain
    version) and is refused in bf16, whose kernels lack it."""
    own = [t for t in gpu_model.F32_TILES if t not in MATMUL_TILES]
    a, b = _operands(3, 40, 24, 300)
    for tile in own:
        got = tops.matmul(from_numpy(a), from_numpy(b), *tile)
        np.testing.assert_array_equal(to_numpy(got), to_numpy(
            tmm.matmul_ref(from_numpy(a), from_numpy(b))))
        with pytest.raises(ValueError, match="not compiled"):
            tops.matmul(torch.zeros((8, 8), dtype=torch.bfloat16),
                        torch.zeros((8, 8), dtype=torch.bfloat16), *tile)


def test_f32_loads_count_only_launches():
    """On the CPU nothing launches, so the f32 ring counters stay."""
    a, b = _operands(4, 40, 24, 300)
    before = dict(tmm.matmul.f32_loads)
    tmm.matmul(from_numpy(a), from_numpy(b), 128, 128, 32)
    assert tmm.matmul.f32_loads == before == {
        "tma": before["tma"], "cp.async": before["cp.async"]}
