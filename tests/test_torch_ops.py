"""The port's kernel entry point ``repro_torch.kernels.ops`` as a whole.

* The slice end to end: a decoder laid out as Qwen3 (fused add+RMSNorm,
  QKV GEMM, causal GQA flash attention, output GEMM, SwiGLU GEMMs, tied
  LM head) and ResNet-50's BN layers and convolutions as GEMMs, cut to
  small widths, through the port's ``ops`` on the CPU and through the JAX
  package's ``repro.kernels.ops`` (Pallas interpret mode) on the same
  numpy inputs.
* The dispatch rules: CPU tensors run the plain versions and launch
  nothing; another device, mixed devices, another type or a
  non-contiguous tensor raises.
* ``interop``'s bit-exact bfloat16 bridge, and the H100 tile model
  ``gpu_model.select_matmul_block``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import gpu_model  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SMALL = F.DecoderDims(d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
                      vocab=256, n_layers=2)


def _decoder_params(dims, n_layers, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, std) in F.decoder_param_shapes(dims, n_layers).items():
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
        out[name] = a + np.float32(1.0) if "ln" in name else a
    return out


def _jax_heads(x, batch, heads, hd):
    seq = x.shape[0] // batch
    return x.reshape(batch, seq, heads, hd).transpose(0, 2, 1, 3) \
        .reshape(batch * heads, seq, hd)


def _jax_decoder(ids, p, dims, n_layers):
    """The port's ``decoder_forward``, op for op, through the JAX
    package's kernel entry points."""
    batch, seq = ids.shape
    h, kv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    embed = jnp.asarray(p["embed"])
    x = embed.T[jnp.asarray(ids).reshape(-1)]
    resid = jnp.zeros_like(x)
    for i in range(n_layers):
        w = {k.split(".", 1)[1]: jnp.asarray(v) for k, v in p.items()
             if k.startswith(f"l{i}.")}
        y, resid = jops.fused_add_rmsnorm(x, resid, w["ln1"])
        qkv = jops.matmul(y, w["wqkv"])
        q = _jax_heads(qkv[:, :h * hd], batch, h, hd)
        k = _jax_heads(qkv[:, h * hd:(h + kv) * hd], batch, kv, hd)
        v = _jax_heads(qkv[:, (h + kv) * hd:], batch, kv, hd)
        a = jops.flash_attention(q, k, v, h, kv, causal=True)
        a = a.reshape(batch, h, seq, hd).transpose(0, 2, 1, 3) \
            .reshape(batch * seq, h * hd)
        x = jops.matmul(a, w["wo"])
        y, resid = jops.fused_add_rmsnorm(x, resid, w["ln2"])
        g = jops.matmul(y, w["wg"])
        u = jops.matmul(y, w["wu"])
        x = jops.matmul(jax.nn.silu(g) * u, w["wd"])
    y, _ = jops.fused_add_rmsnorm(x, resid, jnp.asarray(p["ln_f"]))
    return jops.matmul(y, embed)


def test_decoder_slice_matches_jax():
    """Two layers at Qwen3's layout cut to d_model 64, float32, 2 x 32
    tokens: the logits agree within the float32 kernel tolerance."""
    p = _decoder_params(SMALL, 2, 0)
    ids = np.random.default_rng(1).integers(0, SMALL.vocab, (2, 32))
    want = np.asarray(_jax_decoder(ids, p, SMALL, 2))
    got = F.decoder_forward(from_numpy(ids), {k: from_numpy(v)
                                              for k, v in p.items()},
                            SMALL, 2)
    assert got.shape == (64, SMALL.vocab)
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4, rtol=2e-4)


def test_decoder_launch_counts_of_the_configs():
    assert F.decoder_launches(F.QWEN3_0_6B) == {
        "matmul": 5 * 28 + 1, "fused_add_rmsnorm": 2 * 28 + 1,
        "flash_attention": 28}
    names = [name for name, _ in F.decoder_param_shapes(F.QWEN3_0_6B, 28)
             .items()]
    assert len(names) == 7 * 28 + 2
    shapes = F.decoder_param_shapes(F.QWEN3_0_6B, 1)
    assert shapes["l0.wqkv"][0] == (1024, 4096)
    assert shapes["embed"][0] == (1024, 151936)


class _CountingOps:
    """An ``impl`` that counts the calls of each entry point and runs the
    port's ``ops``."""

    def __init__(self):
        self.calls = {}
        for name in ("matmul", "fused_add_rmsnorm", "flash_attention",
                     "bn_forward"):
            setattr(self, name, self._counted(name, getattr(tops, name)))

    def _counted(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4])
def test_decoder_forward_makes_the_counted_calls(n_layers):
    """A full-depth forward calls each kernel ``decoder_launches`` times,
    the count ``chip_smoke.py`` holds the launch counters to."""
    dims = F.DecoderDims(d_model=32, n_heads=2, n_kv=1, head_dim=16,
                         d_ff=64, vocab=64, n_layers=n_layers)
    impl = _CountingOps()
    params = F.init_decoder_params(dims, n_layers, 0, "cpu", torch.float32)
    ids = torch.randint(0, dims.vocab, (2, 8),
                        generator=torch.Generator().manual_seed(0))
    out = F.decoder_forward(ids, params, dims, n_layers, impl=impl)
    assert out.shape == (16, dims.vocab)
    assert impl.calls == F.decoder_launches(dims)


def test_resnet50_calls():
    """53 BN layers over 12 distinct (h*w*n, c) and 54 convolutions as
    GEMMs (the FC layer included) at batch 32; 355.6M BN elements."""
    calls = F.resnet50_calls(32)
    bns = [s for kind, _, s in calls if kind == "bn_forward"]
    gemms = [s for kind, _, s in calls if kind == "matmul"]
    assert len(bns) == 53 and len(gemms) == 54
    assert len(set(bns)) == 12
    assert max(bns) == (401408, 64) and (1568, 2048) in bns
    assert sum(n * c for n, c in bns) == 355_647_488
    assert calls[0] == ("matmul", "stem.conv", (401408, 147, 64))
    assert calls[-1] == ("matmul", "fc", (32, 2048, 1000))


def _cut(shape, cap):
    return tuple(min(v, cap) for v in shape)


def test_resnet_slice_matches_jax():
    """ResNet-50's distinct BN and GEMM shapes at batch 1, each dimension
    cut to 128 (BN rows to 256): BN in float32 with the BN tolerances,
    GEMMs in bf16 with the bf16 tolerance."""
    calls = F.resnet50_calls(1)
    rng = np.random.default_rng(2)
    seen = set()
    for kind, name, shape in calls:
        cut = (min(shape[0], 256), min(shape[1], 128)) \
            if kind == "bn_forward" else _cut(shape, 128)
        if (kind, cut) in seen:
            continue
        seen.add((kind, cut))
        if kind == "bn_forward":
            x = rng.standard_normal(cut, dtype=np.float32)
            g = rng.standard_normal(cut[1:], dtype=np.float32)
            b = rng.standard_normal(cut[1:], dtype=np.float32)
            want = jops.bn_forward(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b))
            got = F.resnet50_forward(
                [(kind, name, cut)],
                {cut: tuple(from_numpy(a) for a in (x, g, b))})[0]
            for a, w, tol in zip(got, want, (1e-4, 1e-5, 1e-4)):
                np.testing.assert_allclose(to_numpy(a), np.asarray(w),
                                           atol=tol)
        else:
            m, k, n = cut
            a = rng.standard_normal((m, k), dtype=np.float32) \
                .astype(jnp.bfloat16)
            w_ = rng.standard_normal((k, n), dtype=np.float32) \
                .astype(jnp.bfloat16)
            want = jops.matmul(jnp.asarray(a), jnp.asarray(w_))
            got = F.resnet50_forward([(kind, name, cut)],
                                     {cut: (from_numpy(a), from_numpy(w_))})[0]
            np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                                       np.asarray(want, np.float32),
                                       atol=3e-2, rtol=3e-2)
    assert len(seen) >= 8


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _calls(t):
    """One call of each entry point on tensors made by ``t(shape)``."""
    return {
        "matmul": lambda: tops.matmul(t((8, 8)), t((8, 8))),
        "fused_add_rmsnorm": lambda: tops.fused_add_rmsnorm(
            t((4, 8)), t((4, 8)), t((8,))),
        "bn_forward": lambda: tops.bn_forward(t((8, 4)), t((4,)), t((4,))),
        "flash_attention": lambda: tops.flash_attention(
            t((4, 8, 16)), t((2, 8, 16)), t((2, 8, 16)), 2, 1),
    }


@pytest.mark.parametrize("name", sorted(tops.launch_counters()))
def test_cpu_runs_the_plain_version_and_launches_nothing(name):
    counters = tops.launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    out = _calls(lambda s: torch.randn(s))[name]()
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == "cpu" and bool(torch.isfinite(t).all())
    assert {k: c.launches for k, c in counters.items()} == before
    assert all(c.launches == 0 for c in counters.values())


@pytest.mark.parametrize("name", sorted(tops.launch_counters()))
def test_other_device_raises(name):
    with pytest.raises(ValueError, match="cuda or cpu"):
        _calls(lambda s: torch.zeros(s, device="meta"))[name]()


@pytest.mark.parametrize("name", sorted(tops.launch_counters()))
def test_mixed_devices_raise(name):
    made = []

    def t(s):
        made.append(s)
        return torch.zeros(s, device="meta" if len(made) == 2 else "cpu")
    with pytest.raises(ValueError, match="is on"):
        _calls(t)[name]()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.int32])
@pytest.mark.parametrize("name", sorted(tops.launch_counters()))
def test_other_types_raise(name, dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _calls(lambda s: torch.zeros(s, dtype=dtype))[name]()


@pytest.mark.parametrize("name", sorted(tops.launch_counters()))
def test_non_contiguous_raises(name):
    def t(s):
        return torch.zeros(tuple(reversed(s))).permute(
            *reversed(range(len(s)))) if len(s) > 1 else torch.zeros(s)
    with pytest.raises(ValueError, match="contiguous"):
        _calls(t)[name]()


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------

def test_bf16_round_trip_is_bit_exact():
    """Every 16-bit pattern (NaNs, infinities, subnormals and both zeros
    included) crosses numpy -> torch -> numpy unchanged, and the tensor
    holds the values JAX holds."""
    bits = np.arange(2 ** 16, dtype=np.uint16).reshape(256, 256)
    arr = bits.view(jnp.bfloat16)
    t = from_numpy(arr)
    assert t.dtype == torch.bfloat16 and t.shape == (256, 256)
    back = to_numpy(t)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back.view(np.uint16), bits)
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(jnp.asarray(arr), np.float32))


def test_other_types_round_trip():
    for arr in (np.arange(6, dtype=np.float32).reshape(2, 3),
                np.arange(6, dtype=np.int64)[::2]):
        back = to_numpy(from_numpy(arr))
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)


# ---------------------------------------------------------------------------
# the H100 tile model
# ---------------------------------------------------------------------------

SHAPES = [(4096, 4096, 1024), (4096, 151936, 1024), (401408, 64, 147),
          (1568, 512, 4608), (32, 1000, 2048), (1, 128, 7), (33, 17, 65),
          (100352, 256, 64)]


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("bytes_in", [2, 4])
def test_select_matmul_block_is_compiled_and_fits(m, n, k, bytes_in):
    blk = gpu_model.select_matmul_block(m, n, k, bytes_in=bytes_in,
                                        bytes_out=bytes_in)
    assert (blk.bm, blk.bn, blk.bk) in gpu_model.MATMUL_TILES
    assert gpu_model.smem_bytes(blk.bm, blk.bn, blk.bk, bytes_in) \
        <= gpu_model.SMEM_BYTES
    costs = [gpu_model.matmul_cost(m, n, k, *t, bytes_in=bytes_in,
                                   bytes_out=bytes_in)
             for t in gpu_model.MATMUL_TILES]
    assert blk.est_s == min(c[0] for c in costs if c is not None)


def test_select_matmul_block_respects_a_smaller_budget():
    smem = 24 * 1024
    blk = gpu_model.select_matmul_block(4096, 4096, 1024, bytes_in=4,
                                        smem=smem)
    assert gpu_model.smem_bytes(blk.bm, blk.bn, blk.bk, 4) <= smem
    with pytest.raises(ValueError, match="fits"):
        gpu_model.select_matmul_block(64, 64, 64, smem=1024)
    with pytest.raises(ValueError, match="degenerate"):
        gpu_model.select_matmul_block(0, 64, 64)


def test_ops_matmul_uses_the_model_tile(monkeypatch):
    from repro_torch.kernels import matmul as tmm
    seen = []
    real = tmm.matmul
    monkeypatch.setattr(tmm, "matmul", lambda a, b, bm, bn, bk: (
        seen.append((bm, bn, bk)), real(a, b, bm, bn, bk))[1])
    tops.matmul(torch.zeros((300, 96)), torch.zeros((96, 200)))
    blk = gpu_model.select_matmul_block(300, 200, 96, bytes_in=4,
                                        bytes_out=4)
    assert seen == [(blk.bm, blk.bn, blk.bk)]
