"""``chip_smoke.py``'s launch reckonings, held against what the port's
``Model`` calls, for all ten configurations at ``reduced`` size in
float32 on the CPU (the frontend inputs given, as the serving and
training entry points give them):

* ``serve_launches(cfg, prefill)`` equals the calls a counting ``impl``
  sees in a prefill and in a decode step (LayerNorm configs fuse no
  norm; whisper's prefill runs its encoder, non-causal flash attention
  included, and the k and v products of its cross-attention);
* ``train_launches(cfg)`` equals the calls an opaque ``impl`` sees
  through ``ops.differentiable`` in a step of ``Model.loss`` and its
  gradients: three times each forward GEMM, the norms and flash
  attentions of a prefill forward only;
* the full-size counts that phases 16-21 hold on the card (llama4 at
  one period of its pattern, 2 layers; granite's training step under
  each remat policy);
* ``--phases`` selects whole groups of phases.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import Counting, _smoke  # noqa: E402
from test_torch_train import Opaque  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.frontends import synth_frontend_inputs  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

SMOKE = _smoke()


def _reduced(arch):
    cfg = reduced(get_config(arch)).replace(dtype=torch.float32,
                                            remat=False)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(1))
    extras = synth_frontend_inputs(cfg, 2, torch.Generator().manual_seed(2),
                                   device="cpu")
    return cfg, params, tokens, extras


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launches_equal_the_calls_of_every_config(arch):
    cfg, params, tokens, extras = _reduced(arch)
    counting = Counting()
    model = Model(cfg, impl=counting)
    _, cache = model.prefill(params, tokens[:, :8],
                             max_len=16 + cfg.n_patches, **extras)
    assert counting.n == SMOKE.serve_launches(cfg, True)
    for i in (8, 9):
        counting.n = dict.fromkeys(counting.n, 0)
        _, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
        assert counting.n == SMOKE.serve_launches(cfg, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launches_equal_the_calls_of_every_config(arch):
    cfg, params, tokens, extras = _reduced(arch)
    opaque = Opaque()
    model = Model(cfg, impl=ops.differentiable(opaque))
    params = train.trainable(params)
    loss, _ = model.loss(params, {"tokens": tokens, **extras})
    torch.autograd.grad(loss, train.leaves(params))
    assert opaque.n == SMOKE.train_launches(cfg)


# (matmul, fused_add_rmsnorm, flash_attention) a prefill and a decode step
# at full size: what phases 16, 18 and 20 hold on the card
FULL = {"qwen3-0.6b": ((197, 57, 28), (197, 57, 0)),
        "granite-moe-1b-a400m": ((2425, 49, 24), (2425, 49, 0)),
        "mamba2-130m": ((49, 25, 0), (49, 25, 0)),
        "recurrentgemma-9b": ((293, 77, 12), (293, 77, 0)),
        "gemma3-27b": ((435, 125, 62), (435, 125, 0)),
        "pixtral-12b": ((281, 81, 40), (281, 81, 0)),
        "stablelm-1.6b": ((169, 0, 24), (169, 0, 0)),
        "whisper-tiny": ((73, 0, 8), (37, 0, 0))}


@pytest.mark.parametrize("arch", sorted(FULL))
def test_full_size_launches(arch):
    names = ("matmul", "fused_add_rmsnorm", "flash_attention")
    cfg = get_config(arch)
    for prefill, want in zip((True, False), FULL[arch]):
        assert SMOKE.serve_launches(cfg, prefill) == dict(zip(names, want))
    prefill = dict(zip(names, FULL[arch][0]))
    assert SMOKE.train_launches(cfg.replace(remat=False)) == {
        **prefill, "matmul": 3 * prefill["matmul"]}


def test_full_size_launches_of_llama4s_period():
    """Phase 21: llama4-maverick at one ("attn+moe", "attn") period, full
    width: 1 + 3 x 128 + 3 MoE GEMMs, 4 + 4 attention, 3 dense, the head;
    the MoE layer alone (``hold_moe_f32``) launches its 388."""
    cfg = get_config("llama4-maverick-400b-a17b").replace(n_layers=2)
    assert SMOKE.serve_launches(cfg, True) == {
        "matmul": 400, "fused_add_rmsnorm": 5, "flash_attention": 2}
    assert SMOKE.serve_launches(cfg, False) == {
        "matmul": 400, "fused_add_rmsnorm": 5, "flash_attention": 0}
    assert SMOKE.LLAMA4.layers == 2 and SMOKE.LLAMA4.gen == 8
    assert SMOKE.LLAMA4.f32_layers is None and not SMOKE.LLAMA4.loop


def test_full_size_training_launches_of_the_trained_models():
    """Phases 17 and 19: SmolLM-360M (3(7n+1) / 2n+1 / n) and mamba2
    through ``train_loop`` (remat off), recurrentgemma at one period
    (remat off), and granite under each remat policy (``full`` in its
    run: every layer's 101 forward GEMMs, 2 add+norms and its attention
    again; ``save_dots`` its 96 expert GEMMs; ``save_mixer`` all but the
    output projection) beside its 7,275 / 49 / 24 without."""
    want = {"smollm-360m": (675, 65, 32),
            "mamba2-130m": (147, 25, 0)}
    for arch, (mm, norms, attn) in want.items():
        assert SMOKE.train_launches(get_config(arch).replace(
            remat=False)) == {"matmul": mm, "fused_add_rmsnorm": norms,
                              "flash_attention": attn}
    rg = get_config("recurrentgemma-9b").replace(n_layers=3, remat=False)
    assert SMOKE.train_launches(rg) == {"matmul": 3 * 24,
                                        "fused_add_rmsnorm": 7,
                                        "flash_attention": 1}
    granite = get_config("granite-moe-1b-a400m")
    for policy, mm in (("off", 7275), ("full", 9699), ("save_dots", 9579),
                       ("save_mixer", 9675)):
        cfg = granite.replace(remat=policy != "off", remat_policy=policy)
        assert SMOKE.train_launches(cfg) == {
            "matmul": mm, "fused_add_rmsnorm": 49 + 48 * (policy != "off"),
            "flash_attention": 24 + 24 * (policy != "off")}


@pytest.mark.parametrize("text, want", [
    ("all", {3, 10, 13, 16, 17, 18, 19, 20, 21, 22, 23, 24}),
    ("19", {19}), ("19,20", {19, 20}), ("5", {3}), ("11-14,18", {10, 13, 18}),
    ("3-20", {3, 10, 13, 16, 17, 18, 19, 20}), ("21", {21}),
    ("20-21", {20, 21}), ("22", {22}), ("21-22", {21, 22}), ("23", {23}),
    ("22-23", {22, 23}), ("24", {24}), ("23-24", {23, 24})])
def test_phase_selector_takes_whole_groups(text, want):
    assert SMOKE.parse_phases(text) == want


@pytest.mark.parametrize("text", ["", "2", "25", "x", "9-3"])
def test_phase_selector_rejects_unknown_phases(text):
    with pytest.raises(ValueError):
        SMOKE.parse_phases(text)
