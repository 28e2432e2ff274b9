"""The port's flash attention against the JAX package's Pallas kernel.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors (which runs
the plain version, ``flash_attention_ref``) is held to
``repro.kernels.ops.flash_attention`` in Pallas interpret mode, on the
same numpy inputs, with the shapes, blocks and tolerances of
``tests/test_kernels.py``.  Where the Pallas kernel departs from its own
oracle (non-causal attention over a length that is not a multiple of its
key block) the port is held to the oracle, ``repro.kernels.ref``.  The
CUDA kernel is held to ``flash_attention_ref`` on the card by
``chip_smoke.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"


def _tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == jnp.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, heads, kv, s, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32).astype(dtype)
                 for shape in ((b * heads, s, d), (b * kv, s, d),
                               (b * kv, s, d)))


def _port(q, k, v, *args, **kwargs):
    return to_numpy(tops.flash_attention(
        from_numpy(q), from_numpy(k), from_numpy(v), *args, **kwargs))


@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
@pytest.mark.parametrize("s", [64, 96])
def test_flash_attention_sweep(heads, kv, causal, window, s):
    q, k, v = _qkv(heads * 100 + kv * 10 + s, 2, heads, kv, s, 16)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), heads, kv, causal=causal,
                                window=window, bq=32, bk=32)
    got = _port(q, k, v, heads, kv, causal=causal, window=window, bq=32,
                bk=32)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_dtypes(dtype):
    h, kv = 4, 2
    q, k, v = _qkv(7, 1, h, kv, 64, 32, dtype)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), h, kv, bq=32, bk=32)
    got = _port(q, k, v, h, kv, bq=32, bk=32)
    assert got.dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got.astype(np.float32),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("window", [0, 16])
def test_ragged_non_causal_follows_the_oracle(window):
    """S = 40 with 32-key blocks, not causal.  The Pallas kernel pads K
    and V with zeros to its key block and, without the causal mask, lets
    the padded keys into the softmax (a fault of the reference: the
    padded keys add exp(0 - m) to each denominator).  Its oracle, and the
    port, mask every key at or past S."""
    h, kv = 4, 2
    q, k, v = _qkv(40, 2, h, kv, 40, 16)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), h, kv, causal=False,
                                    window=window)
    got = _port(q, k, v, h, kv, causal=False, window=window, bq=32, bk=32)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 16])
def test_ragged_causal_matches_pallas(window):
    """With the causal mask the padded keys are masked in the Pallas
    kernel too, so the port equals it at a ragged length."""
    h, kv = 4, 2
    q, k, v = _qkv(41, 2, h, kv, 40, 16)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), h, kv, causal=True,
                                window=window, bq=32, bk=32)
    got = _port(q, k, v, h, kv, causal=True, window=window, bq=32, bk=32)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_each_head_dim_matches_the_oracle(d, causal, window):
    """The plain version at every compiled head_dim (256: RecurrentGemma's
    MQA local attention, 16 query heads over 1 KV head) against the JAX
    oracle, float32."""
    h, kv = (16, 1) if d == 256 else (4, 2)
    q, k, v = _qkv(d + window, 1, h, kv, 80, d)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), h, kv, causal=causal,
                                    window=window)
    got = _port(q, k, v, h, kv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_compiled_head_dims_match_the_source():
    """``HEAD_DIMS`` lists exactly the head dims flash_attention.cu
    dispatches (each on both routes); the wrapper raises for any other
    on the card, 96 among them."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src[src.index("#define FLASH_DISPATCH_D(LAUNCH)"):]
    body = body[:body.index("\n\n")]
    dims = tuple(int(d) for d in
                 re.findall(r"case (\d+): return LAUNCH<\1>", body))
    assert dims == HEAD_DIMS == (16, 32, 64, 128, 256)
    assert 96 not in HEAD_DIMS
    wrapper = (CSRC.parent / "flash_attention.py").read_text()
    assert "if d not in HEAD_DIMS:" in wrapper and "is not compiled" in \
        wrapper


@pytest.mark.parametrize("bq,bk", [(512, 512), (32, 32), (1, 7)])
def test_blocks_do_not_change_the_result(bq, bk):
    q, k, v = _qkv(3, 1, 4, 2, 48, 16)
    base = _port(q, k, v, 4, 2)
    np.testing.assert_array_equal(_port(q, k, v, 4, 2, bq=bq, bk=bk), base)


@pytest.mark.parametrize("args,match", [
    (dict(heads=4, kv=3), "do not fit"),          # heads not a multiple
    (dict(heads=3, kv=1), "do not fit"),          # B*H not a multiple of H
    (dict(heads=4, kv=2, bq=0), "positive int"),
    (dict(heads=4, kv=2, window=-1), "window"),
])
def test_bad_arguments_raise(args, match):
    q, k, v = (torch.zeros((8, 16, 16)), torch.zeros((4, 16, 16)),
               torch.zeros((4, 16, 16)))
    args = dict(args)
    heads, kv = args.pop("heads"), args.pop("kv")
    with pytest.raises(ValueError, match=match):
        tops.flash_attention(q, k, v, heads, kv, **args)


def _tiled(q, k, v, heads, kv, causal, window, bkv=64):
    """The bf16 kernel's arithmetic in plain PyTorch: 64-key tiles from
    the first that can be unmasked, an online softmax in float32 (masked
    logits -1e30, masked p zeroed), the denominator from the unrounded p,
    p rounded to bf16 before P.V, acc / max(l, 1e-30)."""
    bh, s, d = q.shape
    group = heads // kv
    kvh = [(i // heads) * kv + (i % heads) // group for i in range(bh)]
    kf, vf = k[kvh].float(), v[kvh].float()
    qf = q.float()
    qpos = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, d))
    for k0 in range(0, s, bkv):
        kpos = torch.arange(k0, min(k0 + bkv, s))[None, :]
        ok = torch.ones((s, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        logits = (qf @ kf[:, k0:k0 + bkv].transpose(1, 2)) * (1 / d ** 0.5)
        logits = torch.where(ok, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(logits - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).float() @ vf[:, k0:k0 + bkv]
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("causal,window,s", [(True, 0, 160), (False, 16, 100),
                                             (False, 0, 70)])
def test_tiled_bf16_arithmetic_matches_the_oracle(d, causal, window, s):
    """The tensor-core kernel's order of operations (64-key tiles, p
    rounded to bf16 per tile), emulated on the CPU, against the JAX
    oracle, bf16 inputs, the bf16 tolerance."""
    h, kv = 4, 2
    q, k, v = _qkv(d + s, 1, h, kv, s, d, jnp.bfloat16)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), h, kv, causal=causal,
                                    window=window)
    got = to_numpy(_tiled(from_numpy(q), from_numpy(k), from_numpy(v), h, kv,
                          causal, window))
    np.testing.assert_allclose(got.astype(np.float32),
                               np.asarray(want, np.float32),
                               **_tol(jnp.bfloat16))
