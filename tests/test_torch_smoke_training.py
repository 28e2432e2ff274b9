"""Phase 19 of ``chip_smoke.py`` (``training_mixers_slice``) for granite
under remat, rehearsed on the CPU at reduced size (where ``kernels.ops``
runs the plain versions): its run, held step and control, its step
under each policy and both routes' timing.  In a file of its own so
that parallel workers take it apart from the other helpers
(``tests/test_torch_smoke_helpers.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import _smoke  # noqa: E402
from test_torch_smoke_helpers import _Event  # noqa: E402

from repro_torch.configs import reduced  # noqa: E402

SMOKE = _smoke()


def test_phase_19_remat_model_rehearsed_on_the_cpu(monkeypatch):
    """``training_mixers_slice`` for granite under remat at reduced size
    on the CPU: the CUDA calls, the profiler and the launch reckoning
    stubbed (a plain version touches no counter), the meta reckoning run
    in this process.  Its run, held step and control, its step under
    each policy (gradients bit-equal, one recompute a group) and both
    routes' timing run through."""
    import repro_torch.configs as configs
    import repro_torch.launch.train as train
    full = configs.get_config
    for module in (configs, train):   # train_loop's own reference too
        monkeypatch.setattr(module, "get_config",
                            lambda arch: reduced(full(arch)))
    monkeypatch.setattr(SMOKE, "CARD", "cpu")
    monkeypatch.setattr(SMOKE, "MIXER_TRAIN",
                        (("granite-moe-1b-a400m", None, 2, 32, "full"),))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "_sleep"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    none = dict.fromkeys(("matmul", "fused_add_rmsnorm", "flash_attention"),
                         0)
    monkeypatch.setattr(SMOKE, "train_launches", lambda cfg: dict(none))
    monkeypatch.setattr(SMOKE, "counted", lambda what, fn, want, route: (
        fn(), dict(want), {"wgmma": 0, "mma": want.get("matmul", 0)}))
    monkeypatch.setattr(SMOKE, "profile_phases", lambda fn: (fn(), {
        "device_ms": 1.0, "phases": None, "records": [0],
        "recompute_device_ms": 0.0})[1])
    made = {}

    def reckon(arch, policy, batch, seq, path):
        made["cfg"] = reduced(full(arch)).replace(
            dtype=torch.float32, remat=True, remat_policy=policy)
        return batch, seq
    monkeypatch.setattr(SMOKE, "start_train_reckoning", reckon)
    monkeypatch.setattr(SMOKE, "train_reckoning", lambda proc, path: (
        SMOKE.dry_reckoning(made["cfg"], "train", *proc)))
    report = {}
    got = SMOKE.training_mixers_slice(torch.device("cpu"), "cpu", report)
    out = report["training_mixers"]["granite-moe-1b-a400m"]
    assert set(out["policies"]) == set(SMOKE.REMAT_POLICIES)
    cfg = reduced(full("granite-moe-1b-a400m"))
    for policy, rec in out["policies"].items():
        assert rec["recomputes"] == cfg.n_layers
        assert rec.get("grads_bit_equal", True)
    assert out["reckoning"]["total_gb"] > out["reckoning"]["state_gb"] > 0
    assert len(out["losses"]) == out["steps"] == 2
    off = out["remat_off"]
    assert len(off["losses"]) == SMOKE.REMAT_OFF_STEPS
    assert off["steps"]["grads_bit_equal"]
    assert set(off["steps"]) == {"off", "full", "grads_bit_equal"}
    assert out["step_vs_plain"]["grad"] <= SMOKE.LLM_STEP_REL["grad"]
    assert set(got["held"]) == {"matmul", "fused_add_rmsnorm",
                                "flash_attention"}
