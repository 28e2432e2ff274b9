"""Multi-pod dry run: trace every (architecture x input shape) cell of the
port on the ``meta`` device and record its memory, cost and roofline on
the production mesh.  The port of the JAX package's ``launch/dryrun.py``.

The reference compiles each cell on 512 placeholder host devices and
runs nothing.  The port runs nothing either:

* FLOPs and HBM bytes come from the cost walker (``launch/costmodel.py``)
  over the cell's global step -- ``make_train_step`` (AdamW; bf16
  moments above 100e9 parameters), ``make_prefill_step`` or
  ``make_serve_step`` over ``make_cache`` -- with the state and batch as
  ``meta`` tensors.  It traces the plain route, ``Model(cfg,
  impl=kernels.forward.PLAIN)``: the kernel wrappers refuse ``meta``
  tensors (``kernels/_dispatch.py``), and the count must not depend on
  what implements a kernel.  Two depths are traced (one and two periods
  of the layer pattern, plus the remainder) and the difference is
  multiplied out to the full depth (``depth_cost``), as the reference's
  walker multiplies a scan body by its trip count.
* ``argument_bytes`` and ``output_bytes`` are the per-device bytes of the
  step's inputs and outputs laid out on the production mesh: the state by
  ``make_state_shardings``, the batch by ``_batch_shardings``, the cache
  by ``_cache_pspecs``, each leaf's local shape from ``distribute_tensor``
  of a ``meta`` tensor (``src_data_rank=None``) on a mesh of the
  ``fake`` process group.  ``main`` starts that group itself (one
  process, world 256 or 512, ``fake_world``), where the reference sets
  ``XLA_FLAGS`` before any import; importing this module starts
  nothing.
* ``temp_bytes``, ``alias_bytes`` and the collective term come from
  rank 0's partitioned step (``launch/program.py``: ``local_program``
  builds it on the partitioned route, ``Model(cfg, impl=kernels.ops.
  partitioned(kernel_shaped(), mesh, rules))``, its state, batch and
  cache made from rank 0's shards on ``meta``; ``read_step`` runs it
  once under a dispatch mode): the peak of the bytes its ops hold on top
  of its arguments, the argument bytes it writes in place, and the
  output bytes of every collective it issues, by kind.  Every rank runs
  the same program, so the roofline's ``collective_bytes`` is the
  chips times rank 0's (``collective_bytes_per_device``) and
  ``t_collective_s`` is rank 0's bytes over the NVLink rate.  The
  program of a train or prefill cell takes the cell's front-end inputs
  too (whisper's frames, pixtral's patches).  Every cell is read: a
  decode cell whose KV cache is split on the sequence (``long_500k``,
  whose batch of 1 puts the cache on ``cache_seq``, and the
  ``--optimized`` decode cells, ``cache_seq`` on ``model``) merges its
  attention's partial softmaxes across the cache's sequence axes
  (``models/attention.py``), and an ``--optimized`` decode cell's int8
  cache quantizes on its local rows.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all    # 40 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
Artifacts land in artifacts/dryrun_torch/<arch>.<shape>.<mesh>[.opt].json.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
from contextlib import contextmanager
from typing import Callable, Dict, Tuple

import torch

from ..configs import ARCHS, get_config
from ..kernels.forward import PLAIN
from ..models.common import (ModelConfig, P, TensorSpec, placements,
                             tree_map, with_axis_sizes)
from ..models.transformer import Model
from ..optim.optimizers import AdamW, constant_schedule
from . import roofline as RL
from .costmodel import Cost, graph_cost
from .mesh import make_production_mesh
from .program import local_program, read_step
from .serve import cache_pspecs as _cache_pspecs
from .serve import make_prefill_step, make_serve_step
from .shapes import (SHAPES, adjust_config, batch_input_specs,
                     cell_is_runnable, cell_rules)
from .train import batch_shardings as _batch_shardings
from .train import leaves, make_state_shardings, make_train_step

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")

# the train step's metrics: loss, ce, aux, lr, grad_norm (float32 scalars)
TRAIN_METRICS_BYTES = 5 * 4


def _fake_backend() -> None:
    """Register PyTorch's ``fake`` process group (``FakeProcessGroup``:
    every rank's collectives return at once, moving nothing) as the
    ``fake`` backend, once; what PyTorch's own test helper registers."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup
    if dist.Backend.FAKE.upper() in dist.Backend._plugins:
        return
    dist.Backend.register_backend(
        dist.Backend.FAKE,
        lambda common, opts: FakeProcessGroup._create_internal(
            common.group_rank, common.group_size, opts),
        extended_api=True, devices=["cpu", "cuda"])


@contextmanager
def fake_world(multi_pod: bool):
    """A ``fake`` process group of world 256 (512 with ``multi_pod``) in
    this one process, rank 0, destroyed on exit: what the production
    meshes are built over."""
    import torch.distributed as dist
    _fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(s: TensorSpec, grad: bool = False) -> torch.Tensor:
    t = torch.empty(s.shape, dtype=s.dtype, device="meta")
    return t.requires_grad_() if grad else t


def local_bytes(specs, pairs) -> int:
    """Bytes one device holds of the ``TensorSpec`` tree ``specs`` laid
    out by the matching tree of ``(mesh, placements)`` ``pairs``: each
    leaf's local shape from ``distribute_tensor`` of a ``meta`` tensor."""
    from torch.distributed.tensor import distribute_tensor
    total = 0
    for s, (mesh, pl) in zip(leaves(specs), leaves(pairs),
                             strict=True):
        d = distribute_tensor(_meta(s), mesh, pl, src_data_rank=None)
        local = d.to_local()
        total += local.numel() * local.element_size()
    return total


def _pairs(mesh, pspecs):
    return tree_map(lambda s: (mesh, placements(s, mesh)), pspecs)


def period(cfg: ModelConfig) -> int:
    """Layers after which the stack repeats: the block pattern and the
    window pattern both."""
    return math.lcm(len(cfg.pattern), len(cfg.attn_pattern or ("global",)))


def depth_cost(cfg: ModelConfig, cost_of: Callable[[ModelConfig], Cost]
               ) -> Cost:
    """``cost_of(cfg)`` at full depth from two traces: ``p + r`` and
    ``2p + r`` layers (``p`` the period, ``r`` the remainder), the
    difference -- one period's ops, the layer-stacked leaves' optimizer
    work included -- taken ``n // p - 1`` times more.  Exact, since the
    step is linear in the number of periods; a stack of at most two
    periods is traced whole."""
    p = period(cfg)
    k, r = divmod(cfg.n_layers, p)
    if k <= 2:
        return cost_of(cfg)
    one = cost_of(cfg.replace(n_layers=p + r))
    two = cost_of(cfg.replace(n_layers=2 * p + r))
    return one + (two - one).scaled(k - 1)


def step_cost(cfg: ModelConfig, kind: str, batch: int, seq: int,
              rules=None, mv_dtype=torch.float32,
              specs: Dict = None) -> Cost:
    """The walker's cost of one global step of ``kind`` (``train``,
    ``prefill`` or ``decode``) on the plain route at ``cfg``'s depth
    (through ``depth_cost``): ``batch`` x ``seq`` tokens (decode: one
    token over a ``seq``-row cache), the batch as ``specs`` (the cell's
    ``batch_input_specs``; tokens alone by default)."""
    def cost_of(c: ModelConfig) -> Cost:
        fn, args = step_program(c, kind, batch, seq, rules, mv_dtype,
                                specs)
        return graph_cost(fn, *args)
    return depth_cost(cfg, cost_of)


def step_program(cfg: ModelConfig, kind: str, batch: int, seq: int,
                 rules=None, mv_dtype=torch.float32, specs: Dict = None
                 ) -> Tuple[Callable, tuple]:
    """``(fn, args)``: the plain route's step of ``kind`` and its
    ``meta`` inputs, as ``step_cost`` traces it."""
    if specs is None:
        specs = {"tokens": TensorSpec((batch, 1 if kind == "decode"
                                       else seq), torch.int32)}
    model = Model(cfg, impl=PLAIN)
    batch_in = {k: _meta(s) for k, s in specs.items()}
    if kind == "train":
        params = tree_map(lambda s: _meta(s, grad=True), model.abstract())
        opt = AdamW(schedule=constant_schedule(1e-4), mv_dtype=mv_dtype)
        state = {"params": params, "opt": opt.init(params)}
        return make_train_step(model, opt, rules), (state, batch_in)
    params = tree_map(_meta, model.abstract())
    if kind == "prefill":
        step = make_prefill_step(model, rules,
                                 max_len=seq + cfg.n_patches + 8)
        return step, (params, batch_in)
    cache = tree_map(_meta, model.make_cache(batch, seq, abstract=True))
    return make_serve_step(model, rules), (params, cache,
                                           batch_in["tokens"])


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               rules_override=None, cfg_override=None):
    """Trace one cell; returns ``(record, cost)``.  Needs a process group
    of the mesh's size (``fake_world``)."""
    shape = SHAPES[shape_name]
    cfg = adjust_config(get_config(arch), shape)
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = 512 if multi_pod else 256
    data_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    rules = cell_rules(shape, multi_pod, data_size)
    if rules_override:
        rules.update(rules_override)
    rules = with_axis_sizes(rules, mesh)
    model = Model(cfg, impl=PLAIN)

    params_abs = model.abstract()
    params_sh = _pairs(mesh, model.specs(rules))
    in_specs = batch_input_specs(cfg, shape)
    batch_sh = _batch_shardings(mesh, rules, in_specs)

    defs = model.param_defs()
    moe_frac = 1.0
    if cfg.n_experts:
        moe_frac = (cfg.top_k + (1 if cfg.shared_expert else 0)) / cfg.n_experts
    n_total, n_active = RL.count_params(defs, {"expert_frac": moe_frac})

    b = shape.global_batch
    t0 = time.time()
    mv = torch.float32
    if shape.kind == "train":
        # bf16 optimizer moments for 100B+ models (llama4: 400B x 10B
        # per param would exceed 16GB/chip with f32 moments)
        mv = torch.bfloat16 if n_total > 100e9 else torch.float32
        opt = AdamW(schedule=constant_schedule(1e-4), mv_dtype=mv)
        moments = tree_map(lambda s: TensorSpec(s.shape, mv), params_abs)
        state_abs = {"params": params_abs,
                     "opt": {"m": moments, "v": moments,
                             "step": TensorSpec((), torch.int32)}}
        state_sh = make_state_shardings(model, opt, rules, mesh)
        state_bytes = local_bytes(state_abs, state_sh)
        argument = state_bytes + local_bytes(in_specs, batch_sh)
        output = state_bytes + TRAIN_METRICS_BYTES
        tokens = shape.global_batch * shape.seq
        training = True
    elif shape.kind == "prefill":
        # cache must hold the token sequence plus any patch prefix
        max_len = shape.seq + cfg.n_patches + 8
        cache_abs = model.make_cache(b, max_len, abstract=True)
        argument = (local_bytes(params_abs, params_sh)
                    + local_bytes(in_specs, batch_sh))
        logits = {"logits": TensorSpec((b, cfg.vocab_size), torch.float32)}
        output = (local_bytes(logits, {"logits": (mesh, placements(
            P(rules.get("batch"), None), mesh))})
            + local_bytes(cache_abs, _pairs(
                mesh, _cache_pspecs(model, cache_abs, rules))))
        tokens = shape.global_batch * shape.seq
        training = False
    else:  # decode
        cache_abs = model.make_cache(b, shape.seq, abstract=True)
        cache_bytes = local_bytes(cache_abs, _pairs(
            mesh, _cache_pspecs(model, cache_abs, rules)))
        tok = {"tokens": in_specs["tokens"]}
        argument = (local_bytes(params_abs, params_sh) + cache_bytes
                    + local_bytes(tok, {"tokens": batch_sh["tokens"]}))
        nxt = {"next": TensorSpec((b,), torch.int32)}
        output = cache_bytes + local_bytes(nxt, {"next": (
            mesh, placements(P(rules.get("batch")), mesh))})
        tokens = shape.global_batch
        training = False
    cost = step_cost(cfg, shape.kind, b, shape.seq, rules, mv, in_specs)
    step, inputs = local_program(cfg, shape.kind, b, shape.seq, mesh, rules,
                                 mv_dtype=mv)
    read = read_step(step, *inputs)
    del step, inputs
    trace_s = time.time() - t0

    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "status": "ok",
        "compile_us": trace_s * 1e6,
        "n_params_total": n_total,
        "n_params_active": n_active,
        "memory": {
            "argument_bytes": argument,
            "output_bytes": output,
            "temp_bytes": read["temp_bytes"],
            "alias_bytes": read["alias_bytes"],
        },
    }
    # every rank runs rank 0's program: the global bytes are chips times
    # its own
    record["roofline"] = {
        **RL.analyze(cost, chips, n_active, tokens, training,
                     collective_bytes=chips * read["collective_bytes"],
                     by_kind={k: chips * v for k, v in
                              read["collective_by_kind"].items()}),
        "collective_bytes_per_device": read["collective_bytes"]}
    return record, cost


def optimized_overrides(arch: str, shape_name: str):
    """The winning §Perf variants, generalized to every cell:
    decode -> 2-D cache sharding + dynamic-scale int8 KV;
    MoE train/prefill -> scatter dispatch + 16k dispatch blocks;
    train/prefill -> flash-attention kernel cost substitution."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules, cfgo = {}, {}
    flash = False
    if shape.kind == "decode":
        if shape.global_batch >= 16:
            rules["cache_seq"] = "model"
        cfgo["cache_dtype"] = torch.int8
    else:
        flash = True
        if cfg.n_experts:
            cfgo["moe_dispatch"] = "scatter"
            cfgo["moe_block"] = 16384
    return rules, cfgo, flash


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, optimized: bool = False) -> dict:
    ok, why = cell_is_runnable(arch, shape_name)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    tag = ".opt" if optimized else ""
    out_path = out_dir / f"{arch}.{shape_name}.{mesh_tag}{tag}.json"
    if not ok:
        record = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "status": "skipped", "reason": why}
    else:
        try:
            if optimized:
                rules_o, cfg_o, flash = optimized_overrides(arch, shape_name)
                record, cost = lower_cell(arch, shape_name, multi_pod,
                                          rules_override=rules_o,
                                          cfg_override=cfg_o)
                if flash:
                    from .hillclimb import apply_flash_substitution
                    cfg = adjust_config(get_config(arch), SHAPES[shape_name])
                    if cfg_o:
                        cfg = cfg.replace(**cfg_o)
                    record = apply_flash_substitution(record, cfg,
                                                      shape_name, skip=True)
            else:
                record, cost = lower_cell(arch, shape_name, multi_pod)
            print(f"  cost: flops={cost.flops:.3e} bytes={cost.bytes:.3e} "
                  f"gemm_flops={cost.gemm_flops:.3e}; traced in "
                  f"{record['compile_us'] / 1e6:.1f} s")
        except Exception as exc:
            record = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                      "status": "error", "error": f"{type(exc).__name__}: {exc}",
                      "trace": traceback.format_exc()[-2000:]}
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    r = record.get("roofline", {})
    print(f"[{record['status']:7s}] {arch} x {shape_name} x {mesh_tag}"
          + (f"  bound={r.get('bound')} frac={r.get('roofline_fraction', 0):.3f}"
             if r else (f"  ({record.get('reason', record.get('error', ''))})")))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the winning §Perf variants to every cell")
    ap.add_argument("--out", default=str(ART_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.all:
        archs = ARCHS
        shapes = list(SHAPES)
    else:
        archs = [args.arch] if args.arch else ARCHS[:1]
        shapes = [args.shape] if args.shape else ["train_4k"]

    n_fail = 0
    with fake_world(args.multi_pod):
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, args.multi_pod, out_dir,
                               optimized=args.optimized)
                if rec["status"] == "error":
                    n_fail += 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
