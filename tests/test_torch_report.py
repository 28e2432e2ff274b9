"""The port's report (``repro_torch.launch.report``, its own copy of the
JAX package's ``launch/report.py``) against the JAX package's, on the
same synthetic dry-run records (both ``ART_DIR`` pointed at one
temporary directory): ``render`` for both meshes and
``render_improvement`` give the same text; a record whose ``temp_bytes``
and collective term are ``None`` (as the port's dry run writes them)
renders ``-`` where the reference's would raise; ``ART_DIR`` is the
port's own directory, not the reference's.  Exact text equality."""
import json

import pytest

pytest.importorskip("torch")

from repro.launch import report as JREP  # noqa: E402

from repro_torch.launch import report as REP  # noqa: E402


def record(arch, shape, mesh, step, bound="memory", temp=2.5e9,
           opt=False):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "memory": {"argument_bytes": 1, "output_bytes": 1,
                       "temp_bytes": temp, "alias_bytes": 0},
            "roofline": {"t_compute_s": step / 3, "t_memory_s": step,
                         "t_collective_s": 0.004, "bound": bound,
                         "step_time_s": step, "roofline_fraction": 1 / 3,
                         "model_flops_ratio": 0.531 if not opt else 0.6}}


RECORDS = {
    "qwen3-0.6b.train_4k.16x16.json": record("qwen3-0.6b", "train_4k",
                                             "16x16", 0.139),
    "qwen3-0.6b.decode_32k.16x16.json": record(
        "qwen3-0.6b", "decode_32k", "16x16", 3.2e-5, temp=0.0),
    "qwen3-0.6b.long_500k.16x16.json": {
        "arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
        "status": "skipped", "reason": "pure full attention"},
    "gemma3-27b.train_4k.16x16.json": {
        "arch": "gemma3-27b", "shape": "train_4k", "mesh": "16x16",
        "status": "error", "error": "boom"},
    "gemma3-27b.prefill_32k.2x16x16.json": record(
        "gemma3-27b", "prefill_32k", "2x16x16", 12345.0, bound="compute"),
    "qwen3-0.6b.train_4k.16x16.opt.json": record(
        "qwen3-0.6b", "train_4k", "16x16", 0.05, opt=True),
    "qwen3-0.6b.decode_32k.16x16.opt.json": record(
        "qwen3-0.6b", "decode_32k", "16x16", 0.0, temp=0.0, opt=True),
}


@pytest.fixture
def art(tmp_path, monkeypatch):
    for name, rec in RECORDS.items():
        (tmp_path / name).write_text(json.dumps(rec))
    monkeypatch.setattr(REP, "ART_DIR", tmp_path)
    monkeypatch.setattr(JREP, "ART_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_render_equals_the_reference(art, mesh):
    got = REP.render(mesh)
    assert got == JREP.render(mesh)
    assert got.count("\n| ") >= 1


def test_render_improvement_equals_the_reference(art):
    got = REP.render_improvement("16x16")
    assert got == JREP.render_improvement("16x16")
    assert "2.78x" in got       # 0.139 / 0.05


def test_a_record_without_temp_or_collective_renders_dashes(art):
    rec = record("smollm-360m", "train_4k", "16x16", 0.2, temp=None)
    rec["roofline"]["t_collective_s"] = None
    (art / "smollm-360m.train_4k.16x16.json").write_text(json.dumps(rec))
    row = [ln for ln in REP.render("16x16").splitlines()
           if ln.startswith("| smollm-360m")]
    assert row == ["| smollm-360m | train_4k | 0.067 | 0.200 | - | memory "
                   "| 0.333 | 0.53 | - |"]
    with pytest.raises(TypeError):
        JREP.render("16x16")


def test_art_dir_is_the_ports_own():
    assert REP.ART_DIR.name == "dryrun_torch"
    assert REP.ART_DIR.parent == JREP.ART_DIR.parent
