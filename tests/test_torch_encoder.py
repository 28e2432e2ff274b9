"""whisper's encoder on the port's flash path, against the JAX package's
``Model.encode`` on the same numpy weights (carried by
``interop.params_from_numpy``), reduced and in float32, at frame counts
that leave the kernel's last 64-key tile ragged.

The port runs an encoder's self-attention through
``impl.flash_attention(..., causal=False)`` (one call a layer; on the
card the kernel masks the keys past S in its last tile); the JAX
package attends with its plain jnp path (dense, or chunked past
``dense_attn_max_seq`` with padded, masked key blocks).  On the CPU the
port's call runs the kernel's plain version.  The weights are the
seeded reference-init draws with every attention's projections
rescaled to a standard deviation of 1/sqrt(d_model)
(``chip_smoke.conditioned``, as the card serves whisper): at the
reference's init whisper's logits move by 3.3e-4 under 1e-7 weight
noise (``tests/test_torch_decode.py``), above the limit.  The limit is
that file's 2e-4, on the encoder's output and on the decoder's logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_decode import configs, numpy_params  # noqa: E402
from test_torch_serve import Counting, _smoke  # noqa: E402

from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

B = 2


class Flashes(Counting):
    """Counts each call, and keeps flash attention's ``causal`` and S."""

    def __init__(self):
        super().__init__()
        self.flash = []

    def __getattr__(self, name):
        call = super().__getattr__(name)
        if name != "flash_attention":
            return call

        def flash(q, k, v, h, kv, causal=True, window=0):
            self.flash.append((causal, q.shape[1]))
            return call(q, k, v, h, kv, causal=causal, window=window)
        return flash


# frames: the reduced config's 24 (one short tile), 70 (a full 64-key
# tile and 6), 100 (ragged, and past dense_attn_max_seq: the JAX model
# chunks it into padded 32-key blocks)
@pytest.mark.parametrize("frames", [24, 70, 100])
def test_encoder_through_the_flash_path_matches_jax(frames):
    jcfg, tcfg = configs("whisper-tiny", encoder_seq=frames)
    p = _smoke().conditioned(numpy_params(jcfg))
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, frames, tcfg.d_model)) * 0.02
         ).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab_size, (B, 12), dtype=np.int32)
    jm = JModel(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want = np.asarray(jm.encode(jp, jnp.asarray(x), None))
    impl = Flashes()
    tm = Model(tcfg, impl=impl)
    tp = params_from_numpy(p, "cpu")
    got = tm.encode(tp, torch.from_numpy(x), None)
    assert impl.flash == [(False, frames)] * tcfg.encoder_layers
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    # the decoder over that encoder output: the forward's logits
    jlog, _, _ = jm.forward(jp, jnp.asarray(tokens), frames=jnp.asarray(x))
    tlog, _, _ = tm.forward(tp, torch.from_numpy(tokens),
                            frames=torch.from_numpy(x))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=2e-4)
