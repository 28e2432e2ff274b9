"""The perf hill-climb: the port of the JAX package's
``launch/hillclimb.py``.

Runs named optimization variants against a cell's baseline, re-traces,
re-analyses (``launch/dryrun.py::lower_cell``), and records hypothesis ->
change -> before -> after.

The ``flash`` variant applies the flash-attention *cost substitution*.
The port's model traces the plain route, whose self-attention over a
whole sequence is ``kernels/ref.py::flash_attention_ref``
(``models/attention.py::_flash``): dense, its float32 S x S logits and
probabilities written to HBM.  The CUDA kernel
(``kernels/csrc/flash_attention.cu``) keeps every tile on chip, so its
HBM traffic is q/k/v/o (+do, dq/dk/dv in a backward).  Both sides of the
substitution are counted by the SAME walker: the plain attention's
walker bytes per layer (``attention_bytes_per_layer``) are replaced with
the kernel-true bytes, which keep the reference's formula (a training
layer's kernel reads the forward twice, for the layer's recompute).

Where it differs from the reference: it walks the attention the port's
``Model`` traces (dense: a forward, and a training layer's backward with
the recompute every remat policy makes of the attention), not the
reference's chunked attention; and it counts every layer whose mixer is
attention, MoE ones too, where the reference's ``kind == "attn"`` leaves
out the ``attn+moe`` layers of granite and llama4.  The ``save_dots``
and ``save_mixer`` variants trace their own policy
(``models/remat.py``).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen3_decode
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --all
"""
from __future__ import annotations

import argparse
import json
import pathlib

import torch

from ..configs import get_config
from ..core.gpu_model import RooflineTerms
from ..kernels.forward import PLAIN
from ..models import attention as ATT
from ..models.common import ModelConfig
from .costmodel import graph_cost
from .dryrun import fake_world, lower_cell
from .shapes import SHAPES, adjust_config

ART = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
       / "hillclimb_torch")

# ---------------------------------------------------------------------------
# flash-attention byte substitution
# ---------------------------------------------------------------------------

def attention_bytes_per_layer(cfg: ModelConfig, batch: int, seq: int,
                              training: bool) -> dict:
    """Walker bytes of one layer's plain self-attention with window
    ``cfg.window``, as the port's ``Model`` traces it (``ATT._flash`` on
    ``kernels.forward.PLAIN``), vs the CUDA kernel's true HBM traffic, at
    global shapes.  A training layer under ``cfg.remat`` walks a second
    forward, its recompute (the reference's ``fwd.bytes +
    grad.bytes``)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (torch.empty((batch, seq, n, hd), dtype=cfg.dtype,
                           device="meta", requires_grad=training)
               for n in (h, kv, kv))

    def attn(q, k, v):
        return ATT._flash(PLAIN, q, k, v, True, int(cfg.window))

    if training:
        def value_and_grad(q, k, v):
            out = attn(q, k, v).float().sum()
            return out, torch.autograd.grad(out, (q, k, v))
        walked = graph_cost(value_and_grad, q, k, v)
        if cfg.remat:
            walked += graph_cost(attn, q, k, v)
    else:
        walked = graph_cost(attn, q, k, v)

    el = 2  # bytes (bf16)
    qb = batch * seq * h * hd * el
    kb = batch * seq * kv * hd * el
    kernel_fwd = qb + 2 * kb + qb                      # read q,k,v; write o
    kernel_bwd = (2 * qb + 2 * kb) + qb + (qb + 2 * kb)
    # read q,k,v,o,do; write dq,dk,dv (flash backward recomputes tiles)
    if training:
        # forward + (recomputed forward + backward)
        kernel = kernel_fwd + (kernel_fwd + kernel_bwd)
    else:
        kernel = kernel_fwd
    return {"xla_bytes": float(walked.bytes), "kernel_bytes": float(kernel),
            "delta": float(walked.bytes - kernel),
            "xla_flops": float(walked.flops)}


def block_skip_factor(seq: int, window: int) -> float:
    """Fraction of the full S x S score work a block-skipping kernel
    actually computes (x1.1 block-granularity overhead)."""
    if window and 0 < window < seq:
        valid = seq * window - window * window / 2.0
    else:
        valid = seq * (seq + 1) / 2.0      # causal triangle
    return min(1.0, 1.1 * valid / (seq * seq))


def _attention_windows(cfg: ModelConfig) -> list:
    """The window of each layer whose mixer is attention (0 = global)."""
    pat = cfg.attn_pattern or ("global",)
    return [cfg.window if pat[i % len(pat)] == "local" else 0
            for i, kind in enumerate(cfg.layer_kinds())
            if kind.split("+")[0] == "attn"]


def flops_skip_delta(cfg: ModelConfig, batch: int, seq: int,
                     training: bool) -> float:
    """Total FLOPs removed by causal/window block skipping across layers."""
    delta = 0.0
    # one walker measurement per distinct window value
    cache = {}
    for w in _attention_windows(cfg):
        if w not in cache:
            cache[w] = attention_bytes_per_layer(cfg.replace(window=w),
                                                 batch, seq, training)
        factor = block_skip_factor(seq, w)
        delta += cache[w]["xla_flops"] * (1.0 - factor)
    return delta


def apply_flash_substitution(record: dict, cfg: ModelConfig,
                             shape_name: str, skip: bool = False,
                             batch: int = 0) -> dict:
    """``record`` with the plain attention's walker bytes of every
    attention layer replaced by the kernel's (and, with ``skip``, the
    FLOPs of masked blocks removed); ``batch`` is the record's batch
    where a cell was cut to fit a card (0: the shape's global batch)."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return record
    batch = batch or shape.global_batch
    n_attn = len(_attention_windows(cfg))
    sub = attention_bytes_per_layer(cfg, batch, shape.seq,
                                    shape.kind == "train")
    r = record["roofline"]
    new_bytes = max(0.0, r["hbm_bytes"] - n_attn * sub["delta"])
    new_flops = r["flops"]
    if skip:
        new_flops = max(0.0, new_flops - flops_skip_delta(
            cfg, batch, shape.seq, shape.kind == "train"))
    terms = RooflineTerms(flops=new_flops, hbm_bytes=new_bytes,
                          collective_bytes=r["collective_bytes"],
                          chips=r["chips"])
    r2 = dict(r)
    r2.update(terms.as_dict())
    r2["model_flops"] = r["model_flops"]
    r2["model_flops_ratio"] = (r["model_flops"] / new_flops
                               if new_flops else 0.0)
    r2["flash_substitution"] = {**sub, "n_attn_layers": n_attn,
                                "block_skip": skip}
    out = dict(record)
    out["roofline"] = r2
    return out


# ---------------------------------------------------------------------------
# cells x variants
# ---------------------------------------------------------------------------

CELLS = {
    # worst roofline fraction: decode is cache-read bound AND the baseline
    # per-device KV cache (batch/16 only) does not even fit HBM
    "qwen3_decode": {
        "arch": "qwen3-0.6b", "shape": "decode_32k",
        "variants": {
            "baseline": {},
            "cache2d": {"rules": {"cache_seq": "model"}},
            "cache2d+int8kv": {"rules": {"cache_seq": "model"},
                               "cfg": {"cache_dtype": torch.int8}},
        },
    },
    # most collective/MoE-bound + worst memory blowup
    "llama4_train": {
        "arch": "llama4-maverick-400b-a17b", "shape": "train_4k",
        "variants": {
            "baseline": {},
            "scatter": {"cfg": {"moe_dispatch": "scatter"}},
            "onehot+blk16k": {"cfg": {"moe_block": 16384}},     # control
            "scatter+blk16k": {"cfg": {"moe_dispatch": "scatter",
                                       "moe_block": 16384}},
            "scatter+blk64k": {"cfg": {"moe_dispatch": "scatter",
                                       "moe_block": 65536}},
        },
    },
    # most representative of the paper's technique (tiling/kernel DSE)
    "gemma3_train": {
        "arch": "gemma3-27b", "shape": "train_4k",
        "variants": {
            "baseline": {},
            "flash": {"flash": True},
            "flash+save_dots": {"flash": True,
                                "cfg": {"remat_policy": "save_dots"}},
            "flash+save_mixer": {"flash": True,
                                 "cfg": {"remat_policy": "save_mixer"}},
            "flash+blk1024": {"flash": True, "cfg": {"attn_block": 1024}},
            "flash+skip": {"flash": True, "skip": True},
        },
    },
}


def run_cell(name: str, out_dir: pathlib.Path = ART) -> None:
    """Every variant of ``CELLS[name]``; needs a process group of 256
    (``dryrun.fake_world(False)``)."""
    spec = CELLS[name]
    out_dir.mkdir(parents=True, exist_ok=True)
    for vname, v in spec["variants"].items():
        try:
            rec, _ = lower_cell(spec["arch"], spec["shape"], False,
                                rules_override=v.get("rules"),
                                cfg_override=v.get("cfg"))
            if v.get("flash"):
                cfg = adjust_config(get_config(spec["arch"]),
                                    SHAPES[spec["shape"]])
                if v.get("cfg"):
                    cfg = cfg.replace(**v["cfg"])
                rec = apply_flash_substitution(rec, cfg, spec["shape"],
                                               skip=v.get("skip", False))
        except Exception as exc:   # pragma: no cover
            rec = {"status": "error", "error": f"{type(exc).__name__}: {exc}"}
        out = out_dir / f"{name}.{vname}.json"
        out.write_text(json.dumps(rec, indent=1, default=str))
        r = rec.get("roofline", {})
        mem = rec.get("memory", {})
        print(f"{name:14s} {vname:18s} "
              f"t_comp={r.get('t_compute_s', 0):.3f} "
              f"t_mem={r.get('t_memory_s', 0):.3f} "
              f"t_coll={r.get('t_collective_s')} "
              f"bound={r.get('bound', '?'):10s} "
              f"frac={r.get('roofline_fraction', 0):.3f} "
              f"args={mem.get('argument_bytes', 0) / 1e9:.1f}GB "
              f"{rec.get('error', '')}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    names = list(CELLS) if args.all or not args.cell else [args.cell]
    with fake_world(False):
        for n in names:
            run_cell(n, pathlib.Path(args.out))


if __name__ == "__main__":
    main()
