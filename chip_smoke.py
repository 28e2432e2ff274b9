#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out FILE] [--phases all|3-9,19,...]

From the repository root, on a machine with one CUDA card (``--phases``
runs the named phases' groups only, ``PHASE_GROUPS``; phases 1-2 always
run, and the kernels line then lists only the launches and checks of
what ran):

1. prints the card, its power limit and the software versions;
2. builds every CUDA kernel of the port from this checkout's sources
   (``src/repro_torch/kernels/csrc/*.cu``), one ``nvcc`` each, all at once,
   and counts the tensor-core instructions in the GEMM's and attention's
   SASS (HGMMA must appear in the GEMM's, HMMA or HGMMA in attention's),
   and the float32 GEMM's TMA loads (UTMALDG) and cp.async copies
   (LDGSTS), both of which must appear, with no spill in ptxas's report
   of any of its instantiations;
3. drives the DSE main path -- ``Study(hw).search(Workload("resnet50"[,
   training=True]), 2048, 2048, objective=...)`` at the 64x64 presets on
   the Table VIII power-of-two lattice (cycles through the fused kernel,
   energy and EDP through the torch reductions, scored on the card), the
   same searches for cycles on the 128-step lattice (5.5M candidates),
   EDP on that lattice for inference, and on the Table VIII lattice for
   inference ``CyclesUnderPowerCap`` at 0.93 W (``POWER_CAP_W``) and
   a custom objective in numpy alone (``EnergyNanEnds``), and
   ``search_many`` over every CNN of the registry -- with the
   ``grid_minmax`` launch count (and its launches by route) and the
   energy reports' devices (``Recorder`` around ``_EnergyFields.grids``)
   set to 0 before each path and read after: a cycles search launches,
   any other launches nothing and builds its report once, from a CUDA
   tensor;
4. holds every result bit-identical to the port's numpy engine (best,
   worst, frontiers, Pareto set, cost and score grids, energy report)
   and the training grids past 2**31, the power cap with candidates on
   both sides, the custom objective's two NaN scores masked;
5. holds ``grid_minmax`` exactly equal to ``grid_minmax_ref`` on the card
   on seeded random, tie, extreme and degenerate grids, on the 128-step
   lattice's sorted projections with equal minima and maxima across a run
   boundary and two column tiles, on both routes (the SIMD tile in shared
   memory, and SIMD rows past it), at 46,341 x 46,341 candidates (answers
   past flat index 2**31) and on the inputs the main path gave it: each
   case on the route it should take and with the same bits on a second
   call, and every main-path launch on the shared route;
6. times the kernel, its plain version and the warm searches (every
   search of phase 3 by ``time_scored``, the 128-step lattice's with one
   call a backend)
   with CUDA events (the kernel also on the device alone, queued behind
   a device sleep, and from the profiler's trace, which must hold one
   kernel a call), beside its bound on this card, and each search's
   device busy time and idle share;
7. drives the LLM searches through the same entry points: Qwen3-0.6B
   (``Workload("qwen3_0_6b", batch=2, seq=2048)``, the prefill's tokens)
   for inference and training, and gemma3-27b training at 512 tokens, at
   the 64x64 presets on the Table VIII lattice, for cycles (through the
   kernel), energy and EDP (scored on the card); the counters set to 0
   before each search and read after it (one ``grid_minmax`` launch a
   cycles search, on the shared route, and no call of the plain
   version; an energy or EDP search's report built once from a CUDA
   tensor); holds each result bit-identical to the numpy engine and the
   kernel's LLM inputs against the plain version, and prints how many
   candidates tie at each grid's minimum and maximum;
8. runs ``method="refine"`` for Qwen3 training and ResNet-50 inference on
   a CUDA study, held equal to the same refine on a numpy study (best,
   evaluations, archive, trajectory) and never worse than the grid;
   serves a burst of 8 requests (ResNet-50 cycles and EDP, Qwen3
   inference and training, gemma3-27b training at 1024 / 1024, Qwen3
   through refine, a duplicate, a misspelt name) from 4 client threads
   through one ``DSEService`` over a CUDA study, holding one failure
   (``InvalidRequest``), a dedup hit, coalescing, one launch for each
   workload of a grid cycles group, the EDP answer's report built on the
   card and every answer bit-identical to a direct search; and arms ``service_request_hang`` once so that an
   abandoned pricing thread prices beside its serial retry, holding the
   launch counts, the answers of both and one kernel workspace;
9. times the LLM searches (warm, and with the frontier and Pareto set
   read; the energy and EDP ones scored on the card) beside the numpy
   engine, with each search's idle share, and the service burst (wall
   time, latency percentiles, coalescing);
10. drives the kernel entry points ``repro_torch.kernels.ops`` at the full
   width of two models, every launch counter set to 0 before each model
   and read after it: a Qwen3-0.6B prefill of 2 x 2048 tokens in bf16
   (all 28 layers; GEMMs, fused add+RMSNorm, causal GQA flash attention,
   the tied LM head) and ResNet-50 at batch 32 (its 53 BN layers in
   float32, its 54 convolutions as bf16 GEMMs), with ``matmul``'s launches
   by route held too (every Qwen3 GEMM on `wgmma`, ResNet-50's on `wgmma`
   but the stem's, whose K = 147) and every ``bn_forward`` launch on the
   vector route;
11. holds each of the four kernels against its plain version on the card,
   on the inputs the models gave it and on the edge cases of
   ``tests/test_kernels.py``, with that file's tolerances (the main
   path's bf16 attention also by the relative error of each query row,
   and float32 attention at its shape), on split-K GEMMs of both types,
   GEMMs on each route and tile, misaligned views, and bf16 attention at
   each head_dim (S 2048 causal, S 333 with a window), ``bn_forward`` at
   channel means shifted by 10, 100 and 1000 over 5 seeds (against the
   plain version's formula in float64, and at 10 and 100 against the
   float32 plain version), and the whole decoder against the same
   composition of plain versions; each batch-norm kernel gives the same
   bits on a second call on every main-path input; the float32 GEMM
   (``f32_cases``) at 2e-4 on every compiled tile over aligned, ragged
   (K or N not a multiple of 4, one row) and offset views, split-K at
   each tile, SmolLM-360M's training-step shapes and recurrentgemma-9b's
   RG-LRU product, the same bits on a second call on each;
12. times each kernel at those shapes beside its plain version, the one
   PyTorch call that computes the same (where there is one) and its bound:
   through the wrapper (CUDA events), on the device alone (the calls
   queued behind a device sleep), and as the profiler's trace sees it
   (where a batch-norm call must show exactly one kernel, its own);
   and times every compiled GEMM tile, with the split count the model
   gives it, against the tile model's pick; and the float32 GEMM at
   SmolLM-360M's gate/up shape (``F32_HEADLINE``) beside ``torch.matmul``;
13. drives one ResNet-50 training step at full width and depth
    (``kernels/training.py``: batch 32, 224 x 224 images, 1000 classes,
    bf16 GEMMs and float32 BN, Goyal et al.'s zero-gamma init, seeded),
    every launch counter set to 0 before it and held after it to
    ``training_launches`` (161 ``matmul``, 53 ``bn_forward``, 53
    ``bn_backward``; in bf16 all GEMMs but the stem's forward on
    `wgmma`; every BN launch on the vector route), then two more SGDM
    steps with finite losses; the same in float32 (every GEMM on `mma`);
14. holds the second step's loss and every gradient against the plain
    step from the same weights, on the same ReLU and max-pool choices
    (relative Frobenius error, limits ``TRAIN_REL``), and holds a control
    to fail each limit (float32: a plain step with noisy GEMMs on its own
    choices; bf16: a plain step whose GEMMs keep two mantissa bits fewer
    than bfloat16, on the same choices); holds
    ``bn_backward`` (and the step's GEMMs and BN forwards) against the
    plain versions on the step's inputs, on the cases of
    ``tests/test_kernels.py``, their bf16 forms and ragged shapes, and
    ``BatchNormFn`` against autograd of the plain forward;
15. times ``bn_backward`` at the stem and over all 53 BN layers beside
    its plain version, its bound and ``native_batch_norm_backward``, and
    the warm step (kernel, plain and float32): by events with the host,
    and its device time from the profiler's trace, split into the GEMM
    kernels, BN forward, BN backward and the rest (with the idle share
    and the non-convolution share on this card beside the port's
    simulator's figure for a 64x64 array); the step's GEMMs by phase
    (fwd, dX, dW), each timed alone beside ``torch.matmul`` on the same
    operands, with each dW's tile, split and blocks; ``MatmulFn``'s
    transposed copies;
16. serves Qwen3-0.6B at full width and depth through the port's model
    stack (``models/transformer.py::Model`` on ``kernels.ops``,
    ``launch/serve.py``'s ``make_prefill_step`` and ``make_serve_step``):
    seeded bf16 weights, batch 4, prompts of 2048 tokens, 32 greedy decode
    steps, every launch counter set to 0 before the prefill and before
    each step and read after it (``serve_launches``: 197 ``matmul``, all
    on `wgmma`, 57 ``fused_add_rmsnorm`` and 28 ``flash_attention`` a
    prefill; 197, 57 and 0 a step); holds the prefill's last logits and
    each teacher-forced step's logits against the same ``Model`` composed
    of the plain versions (worst row's relative error,
    ``SERVE_BF16_ROW_REL``), the kernel route's teacher-forced argmax
    equal to its own greedy tokens, and in float32 a prefill plus decode
    against one forward of the same tokens (``SERVE_F32_ABS``); prints how
    many greedy tokens the two routes share and both routes' last logits
    against a float32 plain prefill; times both routes (prefill ms, decode
    ms a step, tokens/s, one step's device time from the profiler's trace
    and its idle share); and runs ``serve_loop("qwen3-0.6b",
    use_reduced=False)`` at its defaults on the card (float32, every GEMM
    on `mma`, its launches held);
17. trains SmolLM-360M at full width and depth through the port's
    trainer (``launch/train.py::train_loop``: float32, batch 8 x 1024,
    10 AdamW steps at lr 3e-3, seeded, a checkpoint every 5 steps in a
    temporary directory) on ``Model(cfg, impl=ops.differentiable())``,
    every launch counter set to 0 before each run and held after it
    (``train_launches``: 675 ``matmul`` -- forward, dX, dW -- all on
    `mma`, 65 ``fused_add_rmsnorm`` and 32 ``flash_attention`` a step);
    holds every loss finite and prints whether the last 3 average below
    the first 3; reads the step-10 checkpoint back bit for bit; stops a
    second run after 5 steps, resumes it from its checkpoint and holds
    steps 6-10 against the uninterrupted run (``LLM_RESUME_TOL``);
    holds one step (its launches exactly) against the plain route from
    the same weights, with the attention projections rescaled
    (``conditioned``), by the loss, gradient norm, every gradient and
    every updated parameter (``LLM_STEP_REL``), and a control whose
    GEMMs are rounded to bfloat16 to fail each limit; holds each kernel
    on the step's inputs against its plain version; and times the warm
    step of both routes (events, tokens/s, peak memory, device time by
    phase and kernel group from the profiler's trace, idle share, model
    FLOPs against the float32 peak), the step's GEMMs by phase alone
    beside ``torch.matmul``, and the plain backwards alone;
18. holds ``flash_attention`` at head_dim 256 on recurrentgemma's
    shapes (16 query heads over 1 KV head, window 2048, S 2048) in both
    types against its plain version, finds tensor-core instructions in
    its bf16 instantiation's SASS, prints ptxas's registers and spills,
    holds head_dim 96 to raise, and times it beside its bound and SDPA;
    then serves granite-moe-1b-a400m (8 greedy steps), mamba2-130m (8)
    and recurrentgemma-9b (4) at full width and depth through
    ``Model`` and ``make_prefill_step``/``make_serve_step``: seeded bf16
    weights, batch 4, prompts of 2048 tokens, every launch counter set
    to 0 before the prefill and before each step and read after it
    (``serve_launches``: granite 2,425 ``matmul``, 49
    ``fused_add_rmsnorm``, 24 ``flash_attention`` a prefill; mamba2
    49/25/0; recurrentgemma 293/77/12; a step the same less the
    attentions; granite and recurrentgemma from ``conditioned``
    weights, whose logits at the reference's init are printed); holds
    each teacher-forced step's logits against the plain route
    (``SERVE_BF16_ROW_REL``, or ``MIXER_CONTROL_FACTOR`` times the plain
    route with its GEMM sums reordered where bf16's own floor is above
    it; granite's plain route on the kernel route's MoE choices,
    ``models.moe.Routing``, printing how many choices differ unpinned),
    each kernel on the inputs the model gave it, a float32 prefill plus
    decode against a forward and a float32 prefill of 1 x 2048 tokens
    against the plain route's on the same weights (both
    ``SERVE_F32_ABS``; granite at ``moe_capacity`` 8.0, on the kernel
    route's MoE choices; the plain route with its GEMM sums reordered
    printed beside); times the kernel route (prefill, decode a step,
    tokens/s, device time by part and idle share, peak memory) and the
    plain prefill; and runs ``serve_loop(arch, use_reduced=False)`` on
    each (float32, every GEMM on `mma`, launches held);
19. trains granite-moe-1b-a400m (24 layers, batch 8 x 1024, under
    ``remat_policy="full"``: each layer checkpointed, its recompute in
    the backward) through ``make_train_step``, 2 AdamW steps, its peak
    memory held under the card's 80 GB and printed beside the meta
    reckoning (``dry_reckoning``, in a process of its own on the CPU);
    mamba2-130m (24 layers, 8 x 1024) through ``train_loop``, 4 steps;
    and recurrentgemma-9b at one period of its pattern (3 layers, 4 x
    2048) through ``make_train_step``, 4 steps; float32, on ``Model(cfg,
    impl=ops.differentiable())``: every counter set to 0 before each run
    or step and held after it (``train_launches``: 9,699 / 97 / 48,
    147 / 25 / 0 and 72 / 7 / 1 a step, every GEMM on `mma`), finite
    losses; mamba2 stopped after 2 steps and resumed from its
    checkpoint against the uninterrupted run, the checkpoint read back
    bit for bit; one step of each against the plain route from
    ``conditioned`` weights (``LLM_STEP_REL``, granite under ``full`` on
    both routes, on the kernel route's MoE choices through
    ``Model.loss(routing=...)``, printing how many choices differ
    unpinned) with a bf16-GEMM control failing each limit; each kernel
    on the step's inputs against its plain version; granite without
    remat at 4 x 1024 (``REMAT_OFF_BATCH``): 2 steps through
    ``train_loop`` (7,275 / 49 / 24 launches a step held) and one
    kernel-route step with remat off and one under ``full`` from the
    same weights, every gradient bit-equal (``hold_remat_off``);
    granite's step under each of ``full``, ``save_dots`` and
    ``save_mixer`` at 8 x 1024 from the same weights and batch
    (``hold_policies``: two steps a policy on one model and state,
    launches held on each, 9,699 / 9,579 / 9,675 GEMMs, the first
    step's gradients bit-equal to ``full``'s; the warm second step's
    ms, its recomputes' ms by CUDA events, its peak memory); and both
    routes' warm steps timed (events, the median of 2 after one, one
    after one for granite; tokens/s, peak memory; the kernel route's
    device time by phase and the recompute's share, idle share; the
    plain routes by events alone);
20. serves gemma3-27b (batch 2 x 2048, 4 steps: the 5:1 local:global
    schedule with window 1024), pixtral-12b (4 x 2048 after 64 stub
    patches, 4 steps), stablelm-1.6b (4 x 2048, 8 steps: LayerNorm, no
    fused norm) and whisper-tiny (4 x 384 decoder tokens after 1500
    encoder frames, 8 steps) at full width and depth, as phase 18 serves
    the mixers (``serve_model``, from ``conditioned`` weights):
    launches a prefill and a step held (``serve_launches``: 435/125/62,
    281/81/40, 169/0/24 and 73/0/8 a prefill), bf16 logits against the
    plain route with the control printed, each kernel on the model's
    inputs (gemma3's windowed and global attention, whisper's
    non-causal encoder attention at S 1500, also against float64
    attention over its real keys, with the reference kernel's
    zero-padded keys as a control that must fail), the float32 holds
    (gemma3 at one period, 6 layers: its float32 weights do not fit the
    card) and ``serve_loop(arch, use_reduced=False)`` for all but
    gemma3;
21. serves llama4-maverick-400b-a17b at full width (d 5120, 40/8 heads,
    128 experts top-1 and the shared expert, d_ff 8192, vocab 202,048,
    untied head) and one period of its ``("attn+moe", "attn")`` pattern
    (``Served.layers`` 2: 18.553 B parameters, 37.1 GB in bf16), batch 4
    x 2048, 8 greedy steps, from ``conditioned`` weights, as phase 18
    serves granite (``serve_model``: launches 400/5/2 a prefill and
    400/5/0 a step held, the bf16 logits against the plain route on the
    kernel route's MoE choices, each kernel on the model's inputs), with
    no float32 whole-model hold and no ``serve_loop`` (74.2 GB in
    float32); over a one-rank (1, 1) ``("data", "model")`` mesh on NCCL,
    the gradient
    compression (``optim/compression.py``) over a float32 tree shaped as
    Qwen3-0.6B's parameters: ``quantize`` and ``dequantize`` bit-equal
    to the same calls on the CPU (each leaf's first and last 2**20
    elements, two rounds), ``compressed_psum`` over the one-rank group
    equal to ``dequantize(quantize(g, err))``, ``quantize`` timed beside
    its bytes bound; then, the bf16 model freed, llama4's MoE layer
    alone in float32 (16.233 B parameters, 64.9 GB, its memory reckoned
    on the meta device first) on 1 x 2048 tokens, the kernel route
    against the plain route on pinned routing (``SERVE_F32_ABS``, 388
    launches, every GEMM on `mma`);
22. holds the dry run's count (``launch/{costmodel,roofline,dryrun,
    hillclimb}.py``) against the card: the 16 x 16 record of Qwen3-0.6B's
    ``train_4k`` on the ``fake`` backend, in a process of its own (one
    default process group a process); then Qwen3-0.6B at full width and
    depth (bf16, seed 2026, ``conditioned`` weights) on three cells of
    ``launch/shapes.py`` cut in batch only (``DRY_CELLS``: ``train_4k``
    at 2 x 4096, ``prefill_32k`` at 1 x 32,768, ``decode_32k`` at 8 over
    a 32,768-row cache; ``train_4k`` under the configs' default
    ``remat_policy="full"``, as the reference's cell), each reckoned on
    the meta device first (``dry_reckoning``); for each, the walker's
    roofline on one card
    (plain route, and for train and prefill after the hill-climb's flash
    substitution with block skipping), the walker's GEMM FLOPs equal to
    ``FlopCounterMode``'s over the same traces, the kernel route on the
    card with its launches held (``chunked_train_launches`` a training
    step, ``serve_launches`` a prefill and each of 8 decode steps), ms by
    events (median of 3; decode a step over 8), device ms and idle share
    from the profiler, peak memory; the roofline step time at most
    ``DRY_SLACK`` x the device ms, the state's bytes at most the peak;
    prints roofline / device ms and the model-FLOPs utilisation; then
    one gemma3-27b attention layer (1 x 4096, 32/16 heads, window 1024
    and global) through ``flash_attention`` against its plain version
    and timed against the hill-climb's bound (kernel-true bytes,
    block-skipped FLOPs), which it may not beat by more than
    ``DRY_SLACK``, the plain route timed beside the walker's count;
23. runs the port's static checks and examples on the card machine,
    every process started at once and each stopped at
    ``EXAMPLE_TIMEOUT_S``: ``python -m repro_torch.analysis --baseline
    analysis-baseline-torch.json`` over this checkout (rc 0, its file and
    finding counts printed); a lock witness in a process of its own
    (``lock_witness``: every lock of the analysis manifest's
    ``lock_order`` replaced by a recording wrapper, phase 8's burst from
    4 client threads through one ``DSEService`` over a CUDA study on cold
    table caches, every observed nesting ordered by
    the manifest, each lock of ``WITNESSED`` taken, every answer
    bit-identical to a direct search); and the five ``examples/torch_*.py``
    run as a user runs them, on the card, each with rc 0
    (``torch_train_resume`` holding its own drift, the serving examples
    serving on cuda, ``torch_simulate_accelerator`` printing on the card
    the lines it prints with ``--device cpu``);
24. runs the partitioned route (``kernels.ops.partitioned``: the kernels
    on the local shards of ``DTensor``s) on the card.  (a) Over a
    one-rank (1, 1) ``("data", "model")`` NCCL mesh, Qwen3-0.6B at full
    width and depth (bf16, seed 2026, ``conditioned`` weights; the
    state placed by ``make_state_shardings``, the batch by
    ``batch_shardings``): a prefill of 2 x 2048, 4 greedy decode steps
    and one AdamW step at 2 x 1024 under remat ``full``, each held bit
    for bit against the unpartitioned kernel route from the same weights
    (logits, tokens and cache; loss, every gradient, the new parameters
    and moments), with each kernel's launches equal to that route's.
    (b) On PyTorch's ``fake`` process group at world 256, as rank 0 of
    the 16 x 16 mesh, rank 0's local program of Qwen3's ``train_4k``
    (16 x 4096 local), ``prefill_32k`` (2 x 32,768) and ``decode_32k``
    (8 over 32,768 rows) with the real kernels (``launch/program.py``'s
    ``local_program``; a fake collective moves nothing, so its values
    are not held): the allocator's peak within ``PART_PEAK_MARGIN_GB``
    of the dry run's ``argument_bytes + temp_bytes`` for the cell (the
    record from ``python -m repro_torch.launch.dryrun`` in a process of
    its own), the collectives' bytes by kind read on the card equal to
    the dry run's, a warm step's ms by events and device ms from the
    profiler.

Each phase group's seconds are printed, with its float32 GEMM launches by
how the kernel's ring was filled (TMA or cp.async; phase 17's all on
TMA).  Any failed phase raises and the script exits non-zero.  Without CUDA, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels as JSON (``matmul``'s entry times the bf16 LM
head and, under ``"f32"``, the float32 kernel at ``F32_HEADLINE``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the device every phase runs on; kept inputs come back to it from the host
CARD = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, and the scalar (non-tensor-core) float32 rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# 32-bit integer lanes of one SM (NVIDIA's Hopper architecture white paper:
# 16 INT32 units in each of an SM's four partitions).  An int64 add or
# compare takes two INT32 instructions there; grid_minmax's rate is these
# lanes x the card's SMs x the SM clock nvidia-smi reports as its maximum.
INT32_LANES_PER_SM = 64

LATTICE_128 = tuple(range(128, 2049, 128))
BUDGET_KB = 2048
BUDGET_BW = 2048


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def int32_ops_per_s() -> float:
    """INT32 instructions a second of card 0: ``INT32_LANES_PER_SM`` x its
    SMs x ``clocks.max.sm`` from ``nvidia-smi`` (MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def sass_of(source: str) -> str:
    """The SASS of ``source``'s built library (``cuobjdump --dump-sass``)."""
    from repro_torch.kernels import _ext
    tool = Path(_ext.nvcc_path()).parent / "cuobjdump"
    return subprocess.run(
        [str(tool), "--dump-sass", str(_ext.library_path(source))],
        check=True, capture_output=True, text=True, timeout=300).stdout


def sass_counts(sources=("matmul.cu", "flash_attention.cu")) -> dict:
    """Tensor-core instructions in each built library's SASS: HGMMA
    (wgmma) and HMMA (mma.sync)."""
    out = {}
    for source in sources:
        lines = sass_of(source).splitlines()
        out[source] = {op: sum(f" {op}." in ln for ln in lines)
                       for op in ("HGMMA", "HMMA")}
    return out


def f32_gemm_build() -> dict:
    """The float32 GEMM (``mm_f32``) as built: TMA loads (UTMALDG) and
    cp.async copies (LDGSTS) in its SASS, and each instantiation's
    registers and spilled bytes from ptxas's report."""
    sass = sass_of_functions("matmul.cu", "mm_f32",
                             ops=("UTMALDG", "LDGSTS", "FFMA"))
    ops = {op: sum(c[op] for c in sass.values())
           for op in ("UTMALDG", "LDGSTS", "FFMA")}
    spills, regs = {}, {}
    for ln in ptxas_of("matmul.cu", "mm_f32"):
        name, _, text = ln.partition(": ")
        if "spill" in text:     # "N bytes stack frame, N bytes spill ..."
            spills[name] = sum(int(part.split()[0]) for part in
                               text.split(",") if "spill" in part)
        elif "registers" in text:
            regs[name] = int(text.split("Used ")[1].split()[0])
    return {"functions": len(sass), "sass": ops, "registers": regs,
            "spilled_bytes": spills}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

class EnergyNanEnds:
    """A custom objective written in numpy alone, as the JAX package's test
    objective ``_NanBait`` is: E_total read through ``np.asarray``, NaN at
    the grid's fastest and slowest candidates, which the search must mask
    on both sides.  On the card its metrics are CUDA tensors that numpy
    reads by copying them to the host."""
    name = "energy_nan_ends"
    needs_energy = True

    def score(self, m):
        e = np.array(m.energy, dtype=float)
        c = np.asarray(m.cycles)
        e.flat[c.argmin()] = np.nan
        e.flat[c.argmax()] = np.nan
        return e


# The power-capped search's cap: between the least and greatest P_avg of the
# Table VIII inference grid at INFER_PRESETS[64] (its median is 0.93286 W),
# so that about half its candidates are infeasible; ``hold_against_numpy``
# checks that some are and some are not.
POWER_CAP_W = 0.93


def main_path_searches():
    """``(label, study_kwargs, workload_kwargs, objective)`` of every
    search on the main path."""
    from repro_torch.core import INFER_PRESETS, TRAIN_PRESETS
    from repro_torch.core.objectives import CyclesUnderPowerCap
    out = []
    for phase, presets in (("inference", INFER_PRESETS),
                           ("training", TRAIN_PRESETS)):
        hw = presets[64]
        wl = dict(net="resnet50", training=phase == "training")
        out.append((f"table8/{phase}/cycles",
                    dict(hw=hw, backend="torch-fused"), wl, "cycles"))
        for obj in ("energy", "edp"):
            out.append((f"table8/{phase}/{obj}",
                        dict(hw=hw, backend="torch"), wl, obj))
    for phase, presets in (("inference", INFER_PRESETS),
                           ("training", TRAIN_PRESETS)):
        out.append((f"lattice128/{phase}/cycles",
                    dict(hw=presets[64], backend="torch-fused",
                         sizes=LATTICE_128, bws=LATTICE_128),
                    dict(net="resnet50", training=phase == "training"),
                    "cycles"))
    hw, wl = INFER_PRESETS[64], dict(net="resnet50")
    out.append(("lattice128/inference/edp",
                dict(hw=hw, backend="torch-fused", sizes=LATTICE_128,
                     bws=LATTICE_128), wl, "edp"))
    out.append(("table8/inference/power_cap",
                dict(hw=hw, backend="torch-fused"), wl,
                CyclesUnderPowerCap(cap_w=POWER_CAP_W)))
    out.append(("table8/inference/energy_nan_ends",
                dict(hw=hw, backend="torch"), wl, EnergyNanEnds()))
    return out


def run_search(study_kw, wl_kw, objective, device, backend=None):
    from repro_torch.core import Study, Workload
    kw = dict(study_kw)
    hw = kw.pop("hw")
    if backend is not None:
        kw["backend"] = backend
    return Study(hw, device=device, **kw).search(
        Workload(**wl_kw), BUDGET_KB, BUDGET_BW, objective=objective)


def run_search_many(device, backend):
    from repro_torch.core import INFER_PRESETS, Study
    from repro_torch.core.networks import NETWORKS
    return Study(INFER_PRESETS[64], backend=backend, device=device) \
        .search_many({n: n for n in NETWORKS}, BUDGET_KB, BUDGET_BW)


class Recorder:
    """Wraps ``gridtorch.grid_minmax`` to keep, per path, the inputs the
    main path gives the kernel, ``reduce.grid_minmax_ref`` to count
    calls of the plain version (none may come from the main path on the
    card), and ``dse._EnergyFields.grids`` to keep where each energy
    report was built (the device of the cycles grid it was handed, or
    the type of a host array).  ``zero()`` sets the launch counters, the
    count of plain calls and the reports to 0 just before a path;
    ``read()`` and ``reports()`` read them just after.  The wrappers may
    run on a service's pricing threads."""

    def __init__(self):
        from repro_torch.core import dse, gridtorch
        from repro_torch.kernels import reduce
        self.gridtorch, self.reduce = gridtorch, reduce
        self.kernel, self.ref = gridtorch.grid_minmax, reduce.grid_minmax_ref
        self.fields, self.grids = dse._EnergyFields, dse._EnergyFields.grids
        self.label = None
        self.inputs = {}
        self.ref_calls = 0
        self.built_on = []
        self._lock = threading.Lock()

    def __enter__(self):
        def kernel(*args):
            with self._lock:
                self.inputs.setdefault(self.label, args)
            return self.kernel(*args)

        def ref(*args):
            with self._lock:
                self.ref_calls += 1
            return self.ref(*args)

        def grids(fields, l_total):
            with self._lock:
                self.built_on.append(
                    l_total.device.type if isinstance(l_total, torch.Tensor)
                    else type(l_total).__name__)
            return self.grids(fields, l_total)
        self.gridtorch.grid_minmax = kernel
        self.reduce.grid_minmax_ref = ref
        self.fields.grids = grids
        return self

    def __exit__(self, *exc):
        self.gridtorch.grid_minmax = self.kernel
        self.reduce.grid_minmax_ref = self.ref
        self.fields.grids = self.grids

    def zero(self, label=None) -> None:
        kernel = self.reduce.grid_minmax
        kernel.launches = 0
        kernel.routes = dict.fromkeys(kernel.routes, 0)
        with self._lock:
            self.ref_calls = 0
            self.built_on = []
        self.label = label

    def reports(self) -> list:
        """Where each energy report since ``zero`` was built: ``"cuda"``
        for a report built on the card."""
        with self._lock:
            return list(self.built_on)

    def read(self) -> tuple:
        """``(launches, launches by route, plain calls)`` since ``zero``."""
        kernel = self.reduce.grid_minmax
        return kernel.launches, dict(kernel.routes), self.ref_calls


def check_scored(label, objective, launches, reports) -> None:
    """A cycles search builds no energy report (its ``grid_minmax``
    launches are held by its caller, by backend); any other search
    launches nothing and builds its report once, from the cycles grid on
    the card."""
    on = torch.device(CARD).type
    if objective == "cycles":
        check(reports == [], f"{label}: a cycles search built energy "
              f"reports on {reports}")
    else:
        check(launches == 0, f"{label}: {launches} grid_minmax launches, "
              f"expected none")
        check(reports == [on], f"{label}: energy reports built on "
              f"{reports}, expected one from a {on} tensor")


def drive_main_path(device, rec):
    """Run every main-path search once.  Returns the results, per path the
    launches of ``grid_minmax`` and its launches by route (set to 0 just
    before the path, read just after), the wall seconds, the first kernel
    inputs of each path, and where each path's energy reports were
    built."""
    paths = [(label, o, lambda s=s, w=w, o=o: run_search(s, w, o, device))
             for label, s, w, o in main_path_searches()]
    paths.append(("search_many/torch", "cycles",
                  lambda: run_search_many(device, "torch")))
    results, launches, routes, wall_s, built_on = {}, {}, {}, {}, {}
    for label, obj, fn in paths:
        rec.zero(label)
        t0 = time.perf_counter()
        results[label] = fn()
        wall_s[label] = time.perf_counter() - t0
        launches[label], routes[label], ref_calls = rec.read()
        built_on[label] = rec.reports()
        check(ref_calls == 0, f"{label}: plain grid_minmax_ref ran "
              f"{ref_calls} times on the main path on the card")
        check_scored(label, obj, launches[label], built_on[label])
    return results, launches, routes, wall_s, dict(rec.inputs), built_on


# ---------------------------------------------------------------------------
# parity with the numpy engine
# ---------------------------------------------------------------------------

def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def compare(label, got, want) -> int:
    """Hold one result bit-identical to the numpy engine's; returns the
    number of checks made."""
    checks = [
        ("best", _pt(got.best), _pt(want.best)),
        ("worst", _pt(got.worst), _pt(want.worst)),
        ("improvement", got.improvement, want.improvement),
        ("frontier", [_pt(p) for p in got.points],
         [_pt(p) for p in want.points]),
        ("within 5%", [_pt(p) for p in got.within(0.05)],
         [_pt(p) for p in want.within(0.05)]),
        ("pareto", [_pt(p) for p in got.pareto()],
         [_pt(p) for p in want.pareto()]),
        ("size tuples", got.grid.size_tuples, want.grid.size_tuples),
        ("bw tuples", got.grid.bw_tuples, want.grid.bw_tuples),
    ]
    for what, a, b in checks:
        check(a == b, f"{label}: {what} differs from the numpy engine")
    check(got.grid.costs.dtype == np.int64, f"{label}: costs not int64")
    check(np.array_equal(got.grid.costs, want.grid.costs),
          f"{label}: cost grid differs from the numpy engine")
    if want.grid_scores is None:
        check(got.grid_scores is None, f"{label}: unexpected score grid")
    else:
        check(same_bits(got.grid_scores, want.grid_scores),
              f"{label}: score grid differs from the numpy engine")
    report, want_report = got._grid_energy(), want._grid_energy()
    check(report.keys() == want_report.keys() and all(
        same_bits(report[k], want_report[k]) for k in report),
        f"{label}: energy report differs from the numpy engine")
    return len(checks) + 3


def same_bits(a, b) -> bool:
    """Two float64 numpy grids with the same shape and the same bits."""
    return (type(a) is type(b) is np.ndarray
            and a.dtype == b.dtype == np.float64 and a.shape == b.shape
            and np.array_equal(a.view(np.int64), b.view(np.int64)))


def hold_against_numpy(results, device) -> dict:
    n_checks, objectives = 0, {}
    for label, study_kw, wl_kw, obj in main_path_searches():
        want = run_search(study_kw, wl_kw, obj, device, backend="numpy")
        n_checks += compare(label, results[label], want)
        objectives[label] = obj
    many = run_search_many(device, "numpy")
    for name, want in many.items():
        n_checks += compare(f"search_many/{name}",
                            results["search_many/torch"][name], want)
    grid_max = {label: int(results[label].grid.costs.max())
                for label in results if "training/cycles" in label}
    for label, m in grid_max.items():
        check(m > 2 ** 31, f"{label}: training grid max {m} not past 2**31")
    capped = results["table8/inference/power_cap"]
    cap_w = objectives["table8/inference/power_cap"].cap_w
    infeasible = int(np.isinf(capped.grid_scores).sum())
    check(0 < infeasible < capped.grid_scores.size
          and capped.power_of() <= cap_w,
          f"power cap: {infeasible} of {capped.grid_scores.size} candidates "
          f"infeasible, best at {capped.power_of()} W")
    nan_ends = int(np.isnan(
        results["table8/inference/energy_nan_ends"].grid_scores).sum())
    check(nan_ends == 2, f"custom objective: {nan_ends} NaN scores")
    return {"checks": n_checks, "training_grid_max": grid_max,
            "power_cap_w": cap_w,
            "power_cap_infeasible": infeasible,
            "custom_nan_scores": nan_ends}


# ---------------------------------------------------------------------------
# the kernel against its plain version
# ---------------------------------------------------------------------------

def _case(rng, n_conv, n_simd, n_rows, nb, lo=2 ** 31, hi=2 ** 34):
    return (rng.integers(lo, hi, size=(n_conv, nb), dtype=np.int64),
            rng.integers(lo, hi, size=(n_simd, nb), dtype=np.int64),
            rng.integers(0, n_conv, size=n_rows, dtype=np.int64),
            rng.integers(0, n_simd, size=n_rows, dtype=np.int64))


def _placed_ties(n_rows, nb):
    """Two equal minima and two equal maxima in far-apart blocks, the
    later one at the smaller column: first occurrence must win."""
    conv = np.full((n_rows, nb), 5 * 2 ** 32, dtype=np.int64)
    conv[n_rows * 3 // 4, 3] = conv[n_rows // 10, nb - 5] = 2 ** 32
    conv[n_rows - 1, 0] = conv[n_rows // 3, nb - 1] = 9 * 2 ** 32
    return (conv, np.zeros((1, nb), np.int64),
            np.arange(n_rows, dtype=np.int64),
            np.zeros(n_rows, dtype=np.int64))


def main_path_projections(values=LATTICE_128):
    """``(s3_of, v_of)`` of the searches' size tuples on the lattice of
    ``values`` at the main path's budget (2048 KB, tolerance 0.15), as
    ``dse._grid_search_many`` builds them: sorted ``s3_of``."""
    from repro_torch.core import dse
    tuples = dse._tuples(values, 4, BUDGET_KB * 0.85, BUDGET_KB * 1.15)
    _, s3_of = dse._project(tuples, lambda t: t[:3])
    _, v_of = dse._project(tuples, lambda t: t[3])
    return np.asarray(s3_of, np.int64), np.asarray(v_of, np.int64)


def main_path_shapes(seed=2026):
    """The kernel's two main-path shapes from the searches' real
    projections, with seeded random panels past 2**31: the 128-step
    lattice (2345 x 2345, 680 conv and 15 SIMD rows) and Table VIII's
    (311 x 311, 175 and 7)."""
    from repro_torch.core import dse
    rng = np.random.default_rng(seed)
    out = {}
    for label, values in (("lattice128", LATTICE_128),
                          ("table8", dse.SIZES_KB)):
        s3_of, v_of = main_path_projections(values)
        nb = s3_of.shape[0]   # the bandwidths take the same lattice
        out[label] = (
            rng.integers(2 ** 31, 2 ** 34, (s3_of.max() + 1, nb), np.int64),
            rng.integers(2 ** 31, 2 ** 34, (v_of.max() + 1, nb), np.int64),
            s3_of, v_of)
    return out


def _main_path_sorted():
    """The 128-step lattice's real projections with random panels past
    2**31, and two equal minima (and two equal maxima) placed across a
    run boundary of ``s3_of`` and across two column tiles: the later run
    at a column of an earlier tile, so that a merge preferring the smaller
    column over the smaller row would pick the wrong one."""
    conv, simd, s3_of, v_of = main_path_shapes(7)["lattice128"]
    starts = np.flatnonzero(np.diff(s3_of)) + 1     # first row of each run
    for k, value, (c_early, c_late) in ((300, 2 ** 31, (70, 1000)),
                                        (500, 2 ** 36, (130, 2000))):
        a_first, b_first = starts[k - 1], starts[k]     # runs a, then b
        simd[:, [c_early, c_late]] = 2 ** 32
        conv[s3_of[a_first], c_late] = value - 2 ** 32
        conv[s3_of[b_first], c_early] = value - 2 ** 32
    return conv, simd, s3_of, v_of


INDEX_PAST_2_31 = 46_341               # 46341**2 = 2,147,488,281 > 2**31


def index_past_2_31_case():
    """46,341 x 46,341 candidates from two 46,341-wide panels: a conv
    panel of two rows (the second one only for the last grid row) and a
    one-row SIMD panel; the unique minimum and maximum sit on the last
    row, at flat indices past 2**31.  Returns the case and the expected
    ``[min, argmin, max, argmax]``."""
    n = INDEX_PAST_2_31
    rng = np.random.default_rng(31)
    conv = np.repeat(rng.integers(2 ** 31, 2 ** 34, (1, n), np.int64), 2, 0)
    simd = rng.integers(2 ** 31, 2 ** 34, (1, n), np.int64)
    conv[1, 45_000] = -2 ** 40 - simd[0, 45_000]
    conv[1, 46_000] = 2 ** 41 - simd[0, 46_000]
    s3_of = np.zeros(n, np.int64)
    s3_of[-1] = 1
    base = (n - 1) * n
    want = [-2 ** 40, base + 45_000, 2 ** 41, base + 46_000]
    assert want[1] > 2 ** 31 and want[3] > 2 ** 31
    return (conv, simd, s3_of, np.zeros(n, np.int64)), want


def kernel_cases():
    rng = np.random.default_rng(2026)
    i64 = np.iinfo(np.int64)
    cases = {
        "random_past_2_31": _case(rng, 40, 7, 600, 311),
        "ties_few_values": _case(rng, 50, 3, 1500, 97, lo=2 ** 33,
                                 hi=2 ** 33 + 4),
        "ties_placed": _placed_ties(3000, 300),
        "1x1": _case(rng, 1, 1, 1, 1),
        "1xN": _case(rng, 1, 2, 1, 100_003),
        "Nx1": _case(rng, 1000, 3, 100_003, 1),
        "rows_not_multiple_of_tile": _case(rng, 97, 5, 1061, 129),
        "all_int64_max": (np.full((2, 33), i64.max, np.int64),
                          np.zeros((1, 33), np.int64),
                          np.array([1, 0, 1], np.int64),
                          np.zeros(3, np.int64)),
        "all_int64_min": (np.full((2, 33), i64.min, np.int64),
                          np.zeros((1, 33), np.int64),
                          np.array([0, 1, 1], np.int64),
                          np.zeros(3, np.int64)),
        "table8_shape_311x311": _case(rng, 150, 11, 311, 311),
        "lattice128_shape_2345x2345": _case(rng, 680, 16, 2345, 2345),
        "main_path_sorted": _main_path_sorted(),
        # the route that reads the SIMD rows from global memory: 1000 rows
        # of a 64-column tile do not fit in a block's shared memory
        "simd_rows_past_tile": _case(rng, 50, 1000, 3001, 777),
        # a SIMD panel near the shared route's limit (over 48 KB of
        # dynamic shared memory): 27 run slots for 84 random rows an item,
        # so four windows of runs an item
        "simd_rows_at_tile_limit": _case(rng, 60, 420, 4000, 700),
        # unsorted rows, nearly every one a run: 256 rows an item and 93
        # run slots, so three windows an item, over three column tiles
        "unsorted_windows": _case(rng, 2000, 3, 60_000, 130),
    }
    return cases


# the route each case must take; the others take "shared"
CASE_ROUTES = {"simd_rows_past_tile": "global"}


def _one_call(args) -> tuple:
    """One kernel call: its result and the route it took."""
    from repro_torch.kernels.reduce import grid_minmax
    before = dict(grid_minmax.routes)
    got = grid_minmax(*args)
    taken = [r for r, n in grid_minmax.routes.items() if n != before[r]]
    return got, taken


def hold_kernel(cases_dev) -> dict:
    """Exact equality of the kernel and its plain version on the card, the
    route each case takes, and the same bits on a second call; launches
    made here are not the main path's and are not counted."""
    from repro_torch.kernels.reduce import grid_minmax_ref
    max_err, out = 0, {}
    for name, args in cases_dev.items():
        k, taken = _one_call(args)
        again, _ = _one_call(args)
        r = grid_minmax_ref(*args)
        torch.cuda.synchronize()
        err = int((k - r).abs().max()) if not torch.equal(k, r) else 0
        max_err = max(max_err, err)
        out[name] = {"shape": [int(args[2].shape[0]), int(args[0].shape[1])],
                     "n_simd": int(args[1].shape[0]), "route": taken,
                     "kernel": k.tolist(), "ref": r.tolist()}
        check(torch.equal(k, r), f"grid_minmax != grid_minmax_ref on "
              f"{name}: {k.tolist()} vs {r.tolist()}")
        check(torch.equal(k, again), f"grid_minmax gave other bits on a "
              f"second call on {name}: {again.tolist()}")
        want = CASE_ROUTES.get(name, "shared")
        check(taken == [want], f"grid_minmax took route {taken} on {name}, "
              f"expected {want}")
    return {"cases": out, "max_abs_err": max_err}


def hold_index_past_2_31(device) -> dict:
    """The kernel on 46,341 x 46,341 candidates against its plain version
    (which materialises 17 GB of int64 three times over) and the answer
    the case places past flat index 2**31."""
    from repro_torch.kernels.reduce import grid_minmax_ref
    arrs, want = index_past_2_31_case()
    args = tuple(torch.from_numpy(a).to(device) for a in arrs)
    got, taken = _one_call(args)
    ref = grid_minmax_ref(*args)
    torch.cuda.synchronize()
    out = {"shape": [INDEX_PAST_2_31, INDEX_PAST_2_31], "route": taken,
           "kernel": got.tolist(), "ref": ref.tolist(), "want": want}
    del ref
    torch.cuda.empty_cache()
    check(out["kernel"] == want, f"grid_minmax on index_past_2_31: "
          f"{out['kernel']}, expected {want}")
    check(out["ref"] == want, f"grid_minmax_ref on index_past_2_31: "
          f"{out['ref']}, expected {want}")
    return out


def kernel_bound_ms(args, int32_rate) -> tuple:
    """Least time the card needs for one call: each input read once and
    the 32-byte result written once, over HBM bandwidth, against six
    INT32 instructions a candidate (an int64 add and two int64 compares,
    two each) at ``int32_rate``.  Returns ``(bound_ms, bound_by,
    gathered_bytes_ms)``; the last counts the gathered operand rows (16
    bytes per candidate) instead."""
    conv, simd, s3_of, v_of = args
    n = int(s3_of.shape[0]) * int(conv.shape[1])
    nbytes = sum(t.numel() * t.element_size() for t in args) + 32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * n / int32_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", 16 * n / HBM_BYTES_PER_S * 1e3)


def profile_device_ms(fn, iters: int, match: str = "") -> dict:
    """Device time of ``iters`` calls of ``fn`` from the profiler's trace:
    milliseconds per call in kernels and copies whose name contains
    ``match`` (all of them if empty), the wall milliseconds per call
    around them, and the kernel records found.  ``None`` where the trace
    holds no device time.  The trace on the H100 drops some kernel
    records, so the time reads low where ``records`` falls short of the
    launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, records = 0.0, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or match not in evt.name:
            continue
        device_us += evt.device_time_total
        records += 1
    return {"device_ms": device_us / iters / 1e3 if device_us else None,
            "wall_ms": wall / iters * 1e3, "records": records}


def kernel_names(fn, iters: int = 10, traces: int = 3) -> list:
    """The device kernels ``iters`` calls of ``fn`` launch, by name, from
    the profiler's trace (which can drop the record of a single call).
    A trace that holds no device record at all (the profiler on the H100
    now and then drops every one) is taken again, up to ``traces``
    times; an empty list means that every trace was empty."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = sorted({evt.name for evt in prof.events() if
                        evt.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    return names


def check_one_kernel(name: str, names: list) -> None:
    """A call of the wrapper ``name`` (a batch-norm kernel's, or
    ``grid_minmax``) launches exactly one device kernel,
    ``<name>_kernel``: the profiler's trace of its calls holds that
    kernel's name and no other."""
    check(len(names) == 1 and f"{name}_kernel<" in names[0],
          f"{name}: the trace of its calls holds {names}, expected one "
          f"kernel {name}_kernel")


def time_kernel(args, int32_rate) -> dict:
    from repro_torch.kernels.reduce import grid_minmax, grid_minmax_ref
    bound, bound_by, gathered = kernel_bound_ms(args, int32_rate)
    names = kernel_names(lambda: grid_minmax(*args))
    check_one_kernel("grid_minmax", names)
    prof = profile_device_ms(lambda: grid_minmax(*args), iters=50,
                             match="grid_minmax")
    return {"shape": [int(args[2].shape[0]), int(args[0].shape[1])],
            "ms": cuda_ms(lambda: grid_minmax(*args), iters=200, warmup=20),
            "device_ms": queued_ms(lambda: grid_minmax(*args), iters=200,
                                   warmup=20),
            "profiler_ms": prof["device_ms"],
            "kernels_in_trace": names,
            "profiler_records": f"{prof['records']} of 50",
            "plain_ms": cuda_ms(lambda: grid_minmax_ref(*args), iters=50,
                                warmup=5),
            "bound_ms": bound, "bound_by": bound_by,
            "gathered_bytes_bound_ms": gathered}


def _search_and_read(study_kw, wl_kw, obj, device, backend):
    """What a user of a search pays: the search, then its frontier and
    its Pareto set."""
    res = run_search(study_kw, wl_kw, obj, device, backend=backend)
    return len(res.points), len(res.pareto())


def time_scored(label, study_kw, wl_kw, obj, device, backends, iters=3,
                read_iters=None, warmup=1) -> dict:
    """One warm search's row (its tables cached by an earlier search): per
    backend of ``backends``, CUDA events around ``iters`` calls of the
    search after ``warmup`` calls, and around ``read_iters`` (default
    ``iters``) calls of the search followed by reading its frontier and
    Pareto set (the search ends in host copies, so the events bracket all
    of its device work); then the device's busy time in one read search
    on the first backend from the profiler, and so its idle share.  On
    the 128-step lattice every count is 1, and a scored search there is
    not warmed again (the drive and the hold have warmed it) nor read on
    the numpy engine, whose reading walks 5.5M candidates' Pareto set on
    the host for seconds."""
    lattice = label.startswith("lattice128")
    if lattice:
        iters = read_iters = 1
        if obj != "cycles":
            warmup = 0
    row = {}
    for backend in backends:
        row[f"{backend} search_ms"] = cuda_ms(
            lambda b=backend: run_search(study_kw, wl_kw, obj, device,
                                         backend=b),
            iters=iters, warmup=warmup)
        if lattice and obj != "cycles" and backend == "numpy":
            continue
        row[f"{backend} search+read_ms"] = cuda_ms(
            lambda b=backend: _search_and_read(study_kw, wl_kw, obj,
                                               device, b),
            iters=read_iters or iters, warmup=0)
    prof = profile_device_ms(lambda: _search_and_read(
        study_kw, wl_kw, obj, device, backends[0]), iters=1)
    row["device_busy_ms"] = prof["device_ms"]
    row["idle_share"] = None if prof["device_ms"] is None \
        else 1.0 - prof["device_ms"] / prof["wall_ms"]
    return row


def time_searches(device) -> dict:
    """Warm searches (tables cached by the first drive), per main-path
    search: the torch backend it runs on against the numpy engine
    (``time_scored``)."""
    return {label: time_scored(label, study_kw, wl_kw, obj, device,
                               (study_kw["backend"], "numpy"))
            for label, study_kw, wl_kw, obj in main_path_searches()}


# ---------------------------------------------------------------------------
# LLM searches, refine and the service on the card
# ---------------------------------------------------------------------------

QWEN_TOKENS = dict(batch=2, seq=2048)   # the prefill's 2 x 2048 tokens
GEMMA_SEQ = 512
MISSPELT = "qwen3_0_6"
# the hung pricing thread: its group sleeps HANG_S, the watchdog gives up
# after WATCHDOG_S, and the serial retry prices beside it when it wakes
HANG_S, WATCHDOG_S = 2.5, 2.0


def llm_searches():
    """``(label, study_kwargs, workload_kwargs, objective)`` of the LLM
    searches, on the Table VIII lattice at 2048 KB / 2048: Qwen3-0.6B at 2
    x 2048 tokens, inference on the 64x64 inference preset and training on
    the training preset, and gemma3-27b training at 512 tokens; cycles
    through the kernel, energy and EDP through the torch reductions."""
    from repro_torch.core import INFER_PRESETS, TRAIN_PRESETS
    qwen = dict(net="qwen3_0_6b", **QWEN_TOKENS)
    out = []
    for name, presets, wl in (
            ("qwen3/inference", INFER_PRESETS, qwen),
            ("qwen3/training", TRAIN_PRESETS, dict(qwen, training=True)),
            ("gemma3/training", TRAIN_PRESETS,
             dict(net="gemma3-27b", training=True, seq=GEMMA_SEQ))):
        for obj in ("cycles", "energy", "edp"):
            backend = "torch-fused" if obj == "cycles" else "torch"
            out.append((f"llm/{name}/{obj}",
                        dict(hw=presets[64], backend=backend), wl, obj))
    return out


def drive_llm(device, rec) -> dict:
    """Each LLM search once, the counters set to 0 just before it and read
    just after: one ``grid_minmax`` launch a cycles search, on the shared
    route, none for energy and EDP, whose energy report is built once,
    from the cycles grid on the card, and no call of the plain version.
    Then each result held bit-identical to the numpy engine's, each cycles
    search's kernel inputs held against the plain version (twice the same
    bits), and the candidates tied at each grid's minimum and maximum."""
    from repro_torch.core import Workload
    results, out = {}, {}
    for label, study_kw, wl_kw, obj in llm_searches():
        rec.zero(label)
        t0 = time.perf_counter()
        results[label] = run_search(study_kw, wl_kw, obj, device)
        secs = time.perf_counter() - t0
        launches, routes, ref_calls = rec.read()
        built_on = rec.reports()
        want = 1 if obj == "cycles" else 0
        check(launches == want and routes["shared"] == launches,
              f"{label}: {launches} grid_minmax launches by route {routes}, "
              f"expected {want} on shared")
        check(ref_calls == 0, f"{label}: grid_minmax_ref ran {ref_calls} "
              f"times on the card")
        check_scored(label, obj, launches, built_on)
        costs = results[label].grid.costs
        out[label] = {"first_search_s": secs, "launches": launches,
                      "routes": routes, "reports_built_on": built_on,
                      "candidates": int(costs.size),
                      "layers": len(Workload(**wl_kw).layers()),
                      "grid_min": int(costs.min()),
                      "grid_max": int(costs.max()),
                      "tied_at_min": int((costs == costs.min()).sum()),
                      "tied_at_max": int((costs == costs.max()).sum())}
    n_checks = 0
    for label, study_kw, wl_kw, obj in llm_searches():
        want = run_search(study_kw, wl_kw, obj, device, backend="numpy")
        n_checks += compare(label, results[label], want)
    inputs = {label: rec.inputs[label] for label in results
              if label.endswith("/cycles")}
    held = hold_kernel(inputs)
    return {"searches": out, "parity_checks": n_checks,
            "kernel_checks": held, "results": results, "inputs": inputs}


def _same_refine(label, got, want) -> None:
    check(_pt(got.best) == _pt(want.best)
          and _pt(got.worst) == _pt(want.worst),
          f"{label}: refine's best or worst differs from the numpy study's")
    check(got.refine.n_evals == want.refine.n_evals == got.n_candidates,
          f"{label}: refine's evaluation count differs")
    check([_pt(p) for p in got.archive] == [_pt(p) for p in want.archive],
          f"{label}: refine's archive differs")
    check([(s, k, _pt(p)) for s, k, p in got.refine.trajectory]
          == [(s, k, _pt(p)) for s, k, p in want.refine.trajectory],
          f"{label}: refine's trajectory differs")


def hold_refine(device, rec, grid_best) -> dict:
    """``method="refine"`` on a CUDA study, held equal to the same refine
    on a ``backend="numpy"`` study and never worse than the grid's best
    (``grid_best``, by label); refine prices on the host, so it launches
    nothing."""
    from repro_torch.core import INFER_PRESETS, TRAIN_PRESETS, Study, Workload
    out = {}
    for label, hw, wl_kw, grid_label in (
            ("refine/qwen3/training", TRAIN_PRESETS[64],
             dict(net="qwen3_0_6b", training=True, **QWEN_TOKENS),
             "llm/qwen3/training/cycles"),
            ("refine/resnet50/inference", INFER_PRESETS[64],
             dict(net="resnet50"), "table8/inference/cycles")):
        rec.zero(label)
        t0 = time.perf_counter()
        got = Study(hw, device=device).search(
            Workload(**wl_kw), BUDGET_KB, BUDGET_BW, method="refine")
        secs = time.perf_counter() - t0
        launches, _, ref_calls = rec.read()
        want = Study(hw, backend="numpy", device=device).search(
            Workload(**wl_kw), BUDGET_KB, BUDGET_BW, method="refine")
        _same_refine(label, got, want)
        check(got.best.cycles <= grid_best[grid_label],
              f"{label}: refine's best {got.best.cycles} is worse than the "
              f"grid's {grid_best[grid_label]}")
        check(launches == 0 and ref_calls == 0,
              f"{label}: refine launched {launches} kernels and called the "
              f"plain version {ref_calls} times")
        out[label] = {"s": secs, "best": _pt(got.best),
                      "grid_best_cycles": grid_best[grid_label],
                      "n_evals": got.refine.n_evals,
                      "grid_candidates": got.refine.grid_candidates}
    return out


def service_burst():
    """``(tag, workload kwargs, budget, objective, method)`` of the burst:
    ResNet-50 for cycles and EDP, Qwen3 (2 x 2048) for cycles in inference
    and training, gemma3-27b training at 1024 / 1024, Qwen3 through
    refine, a duplicate of the Qwen3 inference query and a misspelt
    name."""
    qwen = dict(net="qwen3_0_6b", **QWEN_TOKENS)
    gemma = dict(net="gemma3-27b", training=True, seq=GEMMA_SEQ)
    return [
        ("resnet50/cycles", dict(net="resnet50"), BUDGET_KB, "cycles", "grid"),
        ("resnet50/edp", dict(net="resnet50"), BUDGET_KB, "edp", "grid"),
        ("qwen3/inference/cycles", qwen, BUDGET_KB, "cycles", "grid"),
        ("qwen3/training/cycles", dict(qwen, training=True), BUDGET_KB,
         "cycles", "grid"),
        ("gemma3/training/cycles", gemma, 1024, "cycles", "grid"),
        ("qwen3/inference/refine", qwen, BUDGET_KB, "cycles", "refine"),
        ("qwen3/inference/cycles/again", qwen, BUDGET_KB, "cycles", "grid"),
        ("misspelt", dict(net=MISSPELT), BUDGET_KB, "cycles", "grid"),
    ]


def _direct(device, req):
    """A direct search of ``req`` on a fresh study of the service's preset
    and device."""
    from repro_torch.core import INFER_PRESETS, Study
    return Study(INFER_PRESETS[64], device=device).search(
        req.workload, req.size_budget_kb, req.bw_budget,
        objective=req.objective, method=req.method)


def _hold_answer(label, got, want) -> None:
    if want.grid is None:
        _same_refine(label, got, want)
    else:
        compare(label, got, want)


def drive_service(device, rec) -> dict:
    """One ``DSEService`` over a CUDA study: the burst submitted from 4
    client threads, then ``start()``.  Held: one request fails, as
    ``InvalidRequest``; a dedup hit and coalescing; one ``grid_minmax``
    launch for each workload of a grid cycles group (all on shared), no
    plain call; the EDP request's energy report built from its cycles grid
    on the card; every answer bit-identical to a direct search."""
    from repro_torch.core import INFER_PRESETS, Study, Workload
    from repro_torch.serve import (DSEClient, DSERequest, DSEService,
                                   InvalidRequest)
    reqs = [DSERequest(Workload(**wl), b, b, objective=obj, method=m,
                       tag=tag)
            for tag, wl, b, obj, m in service_burst()]
    svc = DSEService(Study(INFER_PRESETS[64], device=device),
                     autostart=False, max_batch=len(reqs))
    client = DSEClient(svc)
    tickets = [None] * len(reqs)
    barrier = threading.Barrier(4)

    def submitter(tid):
        barrier.wait()
        for i in range(tid, len(reqs), 4):
            tickets[i] = client.submit(reqs[i])

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        check(not t.is_alive(), "a client thread did not finish submitting")
    rec.zero("service")
    t0 = time.perf_counter()
    svc.start()
    errors = [t.exception(timeout=600) for t in tickets]
    wall = time.perf_counter() - t0
    svc.close(timeout=60)
    launches, routes, ref_calls = rec.read()
    built_on = rec.reports()
    stats = svc.stats()

    priced = {r.dedup_key: r for r, e in zip(reqs, errors) if e is None}
    want_launches = sum(1 for r in priced.values()
                        if r.method == "grid" and r.objective == "cycles")
    scored = sum(1 for r in priced.values()
                 if r.method == "grid" and r.objective != "cycles")
    check(scored >= 1 and built_on == [torch.device(CARD).type] * scored,
          f"service: energy reports built on {built_on}, expected "
          f"{scored} from tensors on the card")
    failed = [(r.tag, e) for r, e in zip(reqs, errors) if e is not None]
    check(len(failed) == 1 and failed[0][0] == "misspelt"
          and isinstance(failed[0][1], InvalidRequest),
          f"service: expected the misspelt request alone to fail as "
          f"InvalidRequest, got {failed}")
    check(stats.dedup_hits >= 1 and stats.coalescing_ratio > 1,
          f"service: dedup_hits {stats.dedup_hits}, coalescing ratio "
          f"{stats.coalescing_ratio}")
    check(launches == want_launches and routes["shared"] == launches,
          f"service: {launches} grid_minmax launches by route {routes}, "
          f"expected {want_launches} on shared")
    check(ref_calls == 0, f"service: grid_minmax_ref ran {ref_calls} times")
    for req, t, err in zip(reqs, tickets, errors):
        if err is None:
            _hold_answer(f"service/{req.tag}", t.result(),
                         _direct(device, req))
    return {"wall_s": wall, "launches": launches, "routes": routes,
            "expected_launches": want_launches,
            "reports_built_on": built_on,
            "failed": [f"{tag}: {type(e).__name__}" for tag, e in failed],
            "stats": {k: getattr(stats, k) for k in (
                "submitted", "completed", "failed", "dedup_hits", "batches",
                "searches", "priced_requests", "latency_p50_s",
                "latency_p95_s", "latency_samples")},
            "coalescing_ratio": stats.coalescing_ratio,
            "batch_occupancy": stats.batch_occupancy}


def drive_hung_service(device, rec) -> dict:
    """``service_request_hang`` armed once: a group of two cycles queries
    sleeps past its watchdog and is abandoned, the group degrades to
    serial pricing, and the abandoned thread wakes and prices the group
    while the serial retry is still pricing (the first serial call waits
    until it has begun).  Held: 4 launches (2 a pricing), all on shared,
    every answer of both threads bit-identical to a direct search, and one
    ``grid_minmax`` workspace, the default stream's."""
    from repro_torch.core import INFER_PRESETS, Study, Workload, faultinject
    from repro_torch.kernels import reduce
    from repro_torch.serve import DSEClient, DSERequest, DSEService
    study = Study(INFER_PRESETS[64], device=device)
    group_started = threading.Event()
    calls, lock = [], threading.Lock()
    search_requests = study.search_requests

    def recorded(requests):
        if len(requests) == 1:
            check(group_started.wait(timeout=60),
                  "hung service: the abandoned thread never priced")
        else:
            group_started.set()
        t0 = time.perf_counter()
        res = search_requests(requests)
        with lock:
            calls.append((len(requests), t0, time.perf_counter(), res))
        return res

    study.search_requests = recorded
    reqs = [DSERequest(Workload("resnet50"), BUDGET_KB, BUDGET_BW),
            DSERequest(Workload("qwen3_0_6b", **QWEN_TOKENS), BUDGET_KB,
                       BUDGET_BW)]
    faultinject.arm("service_request_hang", times=1, arg=HANG_S)
    try:
        svc = DSEService(study, autostart=False, batch_timeout_s=WATCHDOG_S)
        tickets = DSEClient(svc).submit_burst(reqs)
        rec.zero("service/hung")
        svc.start()
        results = [t.result(timeout=120) for t in tickets]
        svc.close(timeout=60)
        deadline = time.perf_counter() + 120
        while len(calls) < 1 + len(reqs) and time.perf_counter() < deadline:
            time.sleep(0.01)
        torch.cuda.synchronize()
        launches, routes, ref_calls = rec.read()
        stats = svc.stats()
        fired = faultinject.fired("service_request_hang")
    finally:
        faultinject.reset()
    groups = [c for c in calls if c[0] == len(reqs)]
    serial = [c for c in calls if c[0] == 1]
    check(fired == 1 and stats.degraded_batches == 1
          and len(groups) == 1 and len(serial) == len(reqs),
          f"hung service: fired {fired}, degraded "
          f"{stats.degraded_batches}, calls {[c[0] for c in calls]}")
    overlap = [s for s in serial
               if s[1] < groups[0][2] and groups[0][1] < s[2]]
    check(bool(overlap), "hung service: the abandoned thread never priced "
          "beside the serial retry")
    check(launches == 2 * len(reqs) and routes["shared"] == launches
          and ref_calls == 0,
          f"hung service: {launches} launches by route {routes}, "
          f"{ref_calls} plain calls, expected {2 * len(reqs)} on shared")
    for i, req in enumerate(reqs):
        want = _direct(device, req)
        compare(f"hung service/serial/{i}", results[i], want)
        compare(f"hung service/abandoned/{i}", groups[0][3][i], want)
    workspaces = sorted(reduce._WORKSPACES)
    default = (0, torch.cuda.default_stream(0).cuda_stream)
    check(workspaces == [default], f"hung service: grid_minmax workspaces "
          f"{workspaces}, expected only the default stream's {default}")
    return {"launches": launches, "routes": routes,
            "overlap_s": min(groups[0][2], overlap[0][2])
            - max(groups[0][1], overlap[0][1]),
            "workspaces": [list(w) for w in workspaces]}


# ``time_scored``'s counts for an LLM search: the search 2 calls and the
# read search 1, no warm-up
LLM_TIMING = dict(iters=2, read_iters=1, warmup=0)


def time_llm_searches(device) -> dict:
    """Warm LLM searches (tables cached, and each engine run once, by
    ``drive_llm``), as ``time_searches`` times the ResNet-50 ones but with
    fewer calls (``LLM_TIMING``)."""
    return {label: time_scored(label, study_kw, wl_kw, obj, device,
                               (study_kw["backend"], "numpy"), **LLM_TIMING)
            for label, study_kw, wl_kw, obj in llm_searches()}


def llm_slice(device, card, report, rec, results) -> int:
    """Phases (a)-(d): the LLM searches, refine on the card, the service
    burst and a hung pricing thread beside its serial retry, and their
    times.  Returns the ``grid_minmax`` launches they made and the number
    of kernel cases they held."""
    t0 = time.perf_counter()
    llm = drive_llm(device, rec)
    for label, row in llm["searches"].items():
        print(f"  LLM search {label}: {row['layers']} layers, "
              f"{row['candidates']} candidates, {row['launches']} "
              f"grid_minmax launches {row['routes']}, grid min "
              f"{row['grid_min']} (tied: {row['tied_at_min']} candidates), "
              f"max {row['grid_max']} (tied: {row['tied_at_max']}), first "
              f"search {row['first_search_s']} s")
    print(f"LLM searches bit-identical to the numpy engine: "
          f"{llm['parity_checks']} checks passed; grid_minmax == "
          f"grid_minmax_ref exactly, and the same bits on a second call, on "
          f"{len(llm['inputs'])} LLM inputs ("
          + ", ".join(f"{lab} {c['shape']}" for lab, c in
                      llm["kernel_checks"]["cases"].items()) + ")")
    grid_best = {label: res.best.cycles for label, res in
                 list(results.items()) + list(llm["results"].items())
                 if label.endswith("/cycles") and res.grid is not None}
    refine = hold_refine(device, rec, grid_best)
    for label, row in refine.items():
        print(f"  {label}: equal to refine on the numpy study; best "
              f"{row['best']} against the grid's {row['grid_best_cycles']} "
              f"cycles, {row['n_evals']} evaluations of "
              f"{row['grid_candidates']}, 0 launches, {row['s']} s")
    service = drive_service(device, rec)
    print(f"service burst (8 requests from 4 threads, then start): "
          f"{service['stats']['completed']} answered, bit-identical to "
          f"direct searches; failed {service['failed']}; dedup hits "
          f"{service['stats']['dedup_hits']}, coalescing ratio "
          f"{service['coalescing_ratio']}, {service['launches']} "
          f"grid_minmax launches (expected {service['expected_launches']}) "
          f"{service['routes']}")
    hung = drive_hung_service(device, rec)
    print(f"hung pricing thread beside its serial retry: {hung['launches']} "
          f"launches {hung['routes']}, {hung['overlap_s']} s of overlap, "
          f"every answer bit-identical; workspaces {hung['workspaces']}")
    times = time_llm_searches(device)
    for label, row in times.items():
        print(f"  warm search {label}: " + ", ".join(
            f"{k} {v}" for k, v in row.items()) + f"  [{card}]")
    print(f"  service burst: wall {service['wall_s']} s, latency p50 "
          f"{service['stats']['latency_p50_s']} s, p95 "
          f"{service['stats']['latency_p95_s']} s over "
          f"{service['stats']['latency_samples']} requests, coalescing "
          f"ratio {service['coalescing_ratio']}, batch occupancy "
          f"{service['batch_occupancy']}, {service['stats']['searches']} "
          f"searches for {service['stats']['priced_requests']} requests  "
          f"[{card}]")
    report["llm"] = {k: llm[k] for k in ("searches", "parity_checks",
                                         "kernel_checks")}
    report["refine"] = refine
    report["service"] = service
    report["service_hung"] = hung
    report["llm_search_ms"] = times
    report["llm_slice_s"] = time.perf_counter() - t0
    print(f"LLM, refine and service phases: {report['llm_slice_s']} s")
    llm_launches = sum(row["launches"] for row in llm["searches"].values())
    return llm_launches + service["launches"] + hung["launches"], \
        len(llm["kernel_checks"]["cases"])


# ---------------------------------------------------------------------------
# the kernel slice: repro_torch.kernels.ops at Qwen3-0.6B and ResNet-50 widths
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_OPS_PER_S = 989e12
SLICE_SEED = 2026
QWEN_BATCH, QWEN_SEQ = 2, 2048          # one prefill of 4096 tokens
RESNET_BATCH = 32
OPS = ("matmul", "fused_add_rmsnorm", "flash_attention", "bn_forward",
       "bn_backward")
# The tolerances of tests/test_kernels.py, (atol, rtol):
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (3e-2, 3e-2)}
ATTN_F32_TOL = (2e-5, 2e-5)
# fused add+norm and BN compare with numpy's assert_allclose default rtol
ADDNORM_F32_TOL = {"y": (1e-5, 1e-7), "res": (1e-6, 1e-7)}
BN_F32_TOL = {"y": (1e-4, 1e-7), "mu": (1e-5, 1e-7), "psi": (1e-4, 1e-7)}
# bn_forward at shifted channel means, seeds of each (hold_shifted_means)
BN_SHIFTS = (10.0, 100.0, 1000.0)
BN_SHIFT_SEEDS = 5
# the BN backward's float32 tolerances there: dx 1e-4, dgamma and dbeta 1e-3
BN_BACK_F32_TOL = {"dx": (1e-4, 1e-4), "dgamma": (1e-3, 1e-3),
                   "dbeta": (1e-3, 1e-3)}
# The whole bf16 decoder against the same composition of plain versions:
# relative Frobenius error of the logits, the bf16 tolerance of the tests
# applied to the norm (the plain attention rounds its logits to bf16 and
# the kernel does not, so elementwise bounds do not carry through layers).
SLICE_BF16_REL = 3e-2
# The main path's bf16 attention, per query row: |got - want| / |want| over
# the row's head_dim.  Late causal queries average ~2048 keys, so their
# outputs are ~0.04 and an elementwise atol of 3e-2 cannot see a lost key
# tile; a row norm can.  On the CPU (seeded N(0,1) q, k, v at S 2048, D
# 128) bf16 against float32 reads 0.0101 at the worst row, and dropping
# one 64-key tile for the later queries 0.77.  The limit is the bf16
# tolerance of the tests applied to the row norm.
ATTN_BF16_ROW_REL = 3e-2

KERNEL_META = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:30"),
    "fused_add_rmsnorm": ("src/repro_torch/kernels/csrc/fused_addnorm.cu",
                          "src/repro/kernels/fused_addnorm.py:27"),
    "bn_forward": ("src/repro_torch/kernels/csrc/bn_forward.cu",
                   "src/repro/kernels/bn.py:50"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66"),
    "bn_backward": ("src/repro_torch/kernels/csrc/bn_backward.cu",
                    "src/repro/kernels/bn.py:121"),
}


def _counters():
    from repro_torch.kernels import ops
    return ops.launch_counters()


def _routes() -> dict:
    """``matmul``'s launches by route, and those with a split-K sum."""
    from repro_torch.kernels import matmul as mm
    return mm.matmul.routes


def _f32_loads() -> dict:
    """``matmul``'s float32 launches by how its ring is filled: ``tma``
    or ``cp.async`` (``gpu_model.f32_tma_ok``)."""
    from repro_torch.kernels import matmul as mm
    return dict(mm.matmul.f32_loads)


def _bn_routes() -> dict:
    """Each batch-norm kernel's launches by route (vector or scalar)."""
    from repro_torch.kernels import bn
    return {"bn_forward": bn.bn_forward.routes,
            "bn_backward": bn.bn_backward.routes}


def zero_counters() -> None:
    """Every launch counter, and the route counters of ``matmul`` and the
    two batch-norm kernels, to 0."""
    for counter in _counters().values():
        counter.launches = 0
    for routes in (_routes(), *_bn_routes().values()):
        for key in routes:
            routes[key] = 0


def check_bn_routes(what: str, launches: dict) -> dict:
    """Every batch-norm launch of the run on the vector route (16-byte
    accesses: every main-path C is a multiple of 8); the routes, copied."""
    routes = {name: dict(r) for name, r in _bn_routes().items()}
    for name, r in routes.items():
        check(r == {"vector": launches.get(name, 0), "scalar": 0},
              f"{what}: {name} routes {r}, expected every one of "
              f"{launches.get(name, 0)} launches on the vector route")
    return routes


def check_routes(what: str, routes: dict, gemms: int, mma: int) -> None:
    """``gemms`` GEMM launches, ``mma`` of them on the `mma` route and
    the rest on `wgmma`."""
    check(routes["mma"] == mma and routes["wgmma"] == gemms - mma,
          f"{what}: matmul routes {routes}, expected {gemms - mma} wgmma "
          f"and {mma} mma")


class RecordingOps:
    """The ``impl`` a model forward is driven with: every call goes on to
    ``kernels.ops``, and the inputs of the first call of each kernel at
    each shape (and flash attention's each non-default ``causal`` and
    ``window``) are kept, by ``(kernel, shapes)``, with the model that
    made it; on the host with ``host=True``, which keeps a training
    step's largest operands off the card."""

    def __init__(self, host: bool = False):
        from repro_torch.kernels import ops
        self.model = None
        self.inputs = {}
        self.host = host
        for name in OPS:
            setattr(self, name, self._recorded(name, getattr(ops, name)))

    def _recorded(self, name, fn):
        def keep(a):
            if not isinstance(a, torch.Tensor):
                return a
            if self.host:
                return a.detach().to("cpu")
            # a parameter is updated in place by later steps: keep the
            # values this call saw
            return a.detach().clone() if isinstance(
                a, torch.nn.Parameter) else a.detach()

        def call(*args, **kwargs):
            key = (name, tuple(tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor))
                   + tuple(kw for kw in sorted(kwargs.items()) if kw not in
                           (("causal", True), ("window", 0))))
            if self.model is not None and key not in self.inputs:
                self.inputs[key] = (self.model, tuple(map(keep, args)),
                                    kwargs)
            return fn(*args, **kwargs)
        return call


def hold_recorded(held, rec, label: str) -> dict:
    """Each kernel on the inputs ``rec`` kept (``RecordingOps``: one call
    a kernel and shape) against its plain version, on the card; ``rec``
    is emptied.  Returns the shapes held by kernel."""
    before = {name: len(held.cases[name]) for name in OPS}
    for (name, shapes), (_, args, kwargs) in rec.inputs.items():
        args = tuple(a.to(CARD) if isinstance(a, torch.Tensor) else a
                     for a in args)
        hold_call(held, name, f"{label} {shapes}", args, kwargs, main=True)
    rec.inputs.clear()
    return {name: len(held.cases[name]) - before[name]
            for name in OPS if len(held.cases[name]) > before[name]}


def qwen_inputs(device):
    from repro_torch.kernels import forward as F
    dims = F.QWEN3_0_6B
    params = F.init_decoder_params(dims, dims.n_layers, SLICE_SEED, device)
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 1)
    ids = torch.randint(0, dims.vocab, (QWEN_BATCH, QWEN_SEQ),
                        generator=gen, device=device)
    return dims, params, ids


def resnet_inputs(device):
    """Per distinct shape of ResNet-50's kernel calls, seeded inputs: x
    (N_eff, C) float32 with gamma, beta for BN; A (M, K) and B (K, N)
    bfloat16, B scaled by 1/sqrt(K), for a GEMM."""
    from repro_torch.kernels import forward as F
    calls = F.resnet50_calls(RESNET_BATCH)
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 2)

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std
    inputs = {}
    for kind, _, shape in calls:
        if shape in inputs:
            continue
        if kind == "bn_forward":
            n, c = shape
            inputs[shape] = (rn(n, c), rn(c), rn(c))
        else:
            m, k, n = shape
            inputs[shape] = (rn(m, k).to(torch.bfloat16),
                             rn(k, n, std=k ** -0.5).to(torch.bfloat16))
    return calls, inputs


def drive_slice(device):
    """Drive the two models through ``ops`` once each, every launch
    counter set to 0 just before a model and read just after.  Returns
    the outputs, the launches per model, the recorded kernel inputs and
    the wall seconds."""
    from repro_torch.kernels import forward as F
    dims, params, ids = qwen_inputs(device)
    calls, rinputs = resnet_inputs(device)
    rec = RecordingOps()
    runs = {"qwen3_0_6b": lambda: F.decoder_forward(
                ids, params, dims, dims.n_layers, impl=rec),
            "resnet50": lambda: F.resnet50_forward(calls, rinputs, impl=rec)}
    outs, launches, wall, routes, bn_routes = {}, {}, {}, {}, {}
    for model, fn in runs.items():
        rec.model = model
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[model] = fn()
        torch.cuda.synchronize()
        wall[model] = time.perf_counter() - t0
        launches[model] = {name: c.launches
                           for name, c in _counters().items()}
        routes[model] = dict(_routes())
        bn_routes[model] = check_bn_routes(model, launches[model])
    want = {"qwen3_0_6b": F.decoder_launches(dims),
            "resnet50": {"bn_forward": 53, "matmul": 54}}
    for model, per in launches.items():
        for name, n in per.items():
            check(n == want[model].get(name, 0),
                  f"{model}: {name} launched {n} times, expected "
                  f"{want[model].get(name, 0)}")
    # every Qwen3 GEMM on `wgmma`; of ResNet-50's, all but the stem's
    # (K = 147, not a multiple of 8)
    check_routes("qwen3_0_6b", routes["qwen3_0_6b"],
                 want["qwen3_0_6b"]["matmul"], 0)
    check_routes("resnet50", routes["resnet50"], 54, sum(
        shape[1] % 8 != 0 or shape[2] % 8 != 0 for kind, _, shape in calls
        if kind == "matmul"))
    return {"outs": outs, "launches": launches, "per_forward": want,
            "routes": routes, "bn_routes": bn_routes,
            "wall_s": wall, "inputs": rec.inputs,
            "qwen": (dims, params, ids), "resnet": (calls, rinputs)}


def close(got, want, atol, rtol, rows=512):
    """``(max |got - want|, max of |got - want| - atol - rtol |want|)``
    in float32, row block by row block; the second is <= 0 when
    ``got`` is within tolerance everywhere."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape/type {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    err, excess = 0.0, float("-inf")
    if got.numel() == 0:
        return err, excess
    g2 = got.reshape(got.shape[0], -1)
    w2 = want.reshape(g2.shape)
    for i in range(0, g2.shape[0], rows):
        g, w = g2[i:i + rows].float(), w2[i:i + rows].float()
        d = (g - w).abs()
        check(bool(torch.isfinite(g).all()), "non-finite kernel output")
        err = max(err, float(d.max()))
        excess = max(excess, float((d - atol - rtol * w.abs()).max()))
    return err, excess


class Held:
    """Kernel-versus-plain checks of one run, per kernel."""

    def __init__(self):
        self.cases = {name: [] for name in OPS}
        self.row_rel = {}        # label -> worst and whole relative error
        self.rel_fro = {}        # label -> relative Frobenius error by output
        self.same_bits = {}      # kernel -> calls held bit-identical twice

    def add(self, name, label, pairs):
        """``pairs``: (output name, got, want, (atol, rtol))."""
        worst = 0.0
        for what, got, want, (atol, rtol) in pairs:
            err, excess = close(got, want, atol, rtol)
            worst = max(worst, err)
            check(excess <= 0, f"{name} {label} {what}: max abs err {err} "
                  f"outside atol {atol}, rtol {rtol}")
        self.cases[name].append((label, worst))

    def max_err(self, name):
        return max((e for _, e in self.cases[name]), default=0.0)


def hold_call(held, name, label, args, kwargs, main=False):
    """One kernel call against its plain version on the same inputs;
    ``main``: the inputs came from a model forward."""
    from repro_torch.kernels import ops, ref
    if name == "matmul":
        if "splits" in kwargs:     # a split count of its own: the wrapper
            from repro_torch.kernels import matmul as mm
            got = mm.matmul(*args, **kwargs)
        else:
            got = ops.matmul(*args, **kwargs)
        want = ref.matmul_ref(*args[:2])
        held.add(name, label, [("c", got, want, TOL[args[0].dtype])])
    elif name == "flash_attention":
        q, k, v, h, kv = args[:5]
        causal = kwargs.get("causal", args[5] if len(args) > 5 else True)
        window = kwargs.get("window", args[6] if len(args) > 6 else 0)
        got = ops.flash_attention(*args, **kwargs)
        want = ref.flash_attention_ref(q, k, v, h, kv, causal, window)
        tol = ATTN_F32_TOL if q.dtype == torch.float32 else TOL[q.dtype]
        held.add(name, label, [("out", got, want, tol)])
        if main and q.dtype == torch.bfloat16:
            g, w = got.float(), want.float()
            rows = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
            held.row_rel[label] = {"worst_row": rows, "whole": float(
                (g - w).norm() / w.norm())}
            check(rows <= ATTN_BF16_ROW_REL, f"{name} {label}: a query row "
                  f"off its plain version by {rows} (relative), above "
                  f"{ATTN_BF16_ROW_REL}")
    elif name == "fused_add_rmsnorm":
        y, res = ops.fused_add_rmsnorm(*args, **kwargs)
        yr, resr = ref.fused_add_rmsnorm_ref(*args[:3])
        if args[0].dtype == torch.float32:
            tols = ADDNORM_F32_TOL
        else:   # res: the float32 sum rounded once in both, so bit-equal
            tols = {"y": TOL[args[0].dtype], "res": (0.0, 0.0)}
        held.add(name, label, [("y", y, yr, tols["y"]),
                               ("res", res, resr, tols["res"])])
    elif name == "bn_backward":
        got = ops.bn_backward(*args, **kwargs)
        want = ref.bn_backward_ref(*args[:5])
        tols = BN_BACK_F32_TOL if args[0].dtype == torch.float32 else \
            dict.fromkeys(BN_BACK_F32_TOL, TOL[args[0].dtype])
        held.add(name, label, [(what, g, w, tols[what]) for what, g, w in
                               zip(("dx", "dgamma", "dbeta"), got, want)])
        if main:
            held.rel_fro[label] = {what: float((g.float() - w.float()).norm()
                                               / w.float().norm())
                                   for what, g, w in zip(
                                       ("dx", "dgamma", "dbeta"), got, want)}
            hold_same_bits(held, name, label, got,
                           ops.bn_backward(*args, **kwargs))
    else:
        got = ops.bn_forward(*args, **kwargs)
        want = ref.bn_forward_ref(*args[:3])
        hold_bn_forward(held, label, got, want, args[0].dtype)
        if main:
            hold_same_bits(held, name, label, got,
                           ops.bn_forward(*args, **kwargs))
    torch.cuda.synchronize()


def hold_bn_forward(held, label, got, want, dtype):
    """``(y, mu, psi)`` within ``tests/test_kernels.py``'s tolerances
    (``y`` at 3e-2 for bfloat16 x)."""
    tols = BN_F32_TOL if dtype == torch.float32 else {
        "y": TOL[dtype], "mu": BN_F32_TOL["mu"], "psi": BN_F32_TOL["psi"]}
    held.add("bn_forward", label, [
        (what, g, w.to(g.dtype), tols[what])
        for what, g, w in zip(("y", "mu", "psi"), got, want)])


def hold_same_bits(held, name, label, got, again):
    """A second call on the same inputs gives the same bits."""
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(same, f"{name} {label}: a second call gave other bits")
    held.same_bits[name] = held.same_bits.get(name, 0) + 1


def edge_cases(device):
    """``(name, label, args, kwargs)``: the cases of tests/test_kernels.py
    (zero dims, ragged m/n/k, GQA groups 1, 2 and 8, window 16 causal and
    not, bf16), a ragged non-causal S and bf16 forms of each kernel, then
    ``redesign_cases``."""
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 3)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in ((64, 64, 64), (200, 90, 130), (128, 256, 512),
                        (33, 17, 65), (1, 128, 7)):
            for tile in ((64, 64, 64), (32, 64, 128), (128, 64, 32), None):
                kw = {} if tile is None else dict(zip(("bm", "bn", "bk"),
                                                      tile))
                out.append(("matmul", f"{dtype} {(m, n, k)} {tile}",
                            (rn(m, k, dtype=dtype), rn(k, n, dtype=dtype)),
                            kw))
    for m, n, k in ((0, 8, 8), (8, 0, 8), (8, 8, 0), (0, 0, 0), (1, 1, 0)):
        for kw in ({}, dict(bm=64, bn=64, bk=64)):
            out.append(("matmul", f"zero dim {(m, n, k)} {kw}",
                        (torch.zeros((m, k), device=device),
                         torch.zeros((k, n), device=device)), kw))
    for heads, kv in ((4, 4), (4, 2), (8, 1)):
        for causal, window in ((True, 0), (True, 16), (False, 0),
                               (False, 16)):
            for s in (64, 96, 40):
                b, d = 2, 16
                out.append(("flash_attention",
                            f"h{heads} kv{kv} causal={causal} w{window} S{s}",
                            (rn(b * heads, s, d), rn(b * kv, s, d),
                             rn(b * kv, s, d), heads, kv),
                            dict(causal=causal, window=window, bq=32, bk=32)))
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64, 128):
            out.append(("flash_attention", f"{dtype} D{d} S300 GQA2",
                        (rn(4, 300, d, dtype=dtype), rn(2, 300, d, dtype=dtype),
                         rn(2, 300, d, dtype=dtype), 2, 1),
                        dict(causal=d != 64)))
    # the main path's attention shape in float32 (B 2, 16 heads, 8 KV)
    out.append(("flash_attention", "float32 (32, 2048, 128) causal GQA2",
                (rn(32, 2048, 128), rn(16, 2048, 128), rn(16, 2048, 128),
                 16, 8), {}))
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((100, 64), (256, 128), (7, 96)):
            out.append(("fused_add_rmsnorm", f"{dtype} {(rows, d)}",
                        (rn(rows, d, dtype=dtype), rn(rows, d, dtype=dtype),
                         rn(d)), dict(block_rows=64)))
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in ((300, 70), (256, 128), (64, 33)):
            out.append(("bn_forward", f"{dtype} {(n, c)}",
                        (rn(n, c, dtype=dtype), rn(c), rn(c)),
                        dict(block_rows=64, block_c=32)))
    # a shifted mean (+10)
    out.append(("bn_forward", "shift 10 (4096, 64)",
                (rn(4096, 64) + 10.0, rn(64), rn(64)), {}))
    return out + redesign_cases(device)


# recurrentgemma-9b's RG-LRU input products w_r and w_i at its prefill's
# 4 x 2048 tokens, (m, k, n)
RG_LRU_GEMM = (8192, 4096, 4096)


def f32_cases(device):
    """``(label, a, b, kwargs)`` of the float32 GEMM's own holds, drawn
    one at a time from a generator of their own (the LM head's operands
    are 1.6 GB): every compiled float32 tile on aligned, ragged (K or N
    not a multiple of 4, one row) and 4-byte-offset operands (the ragged
    and offset ones on the cp.async path), and split-K at each tile with
    K = 5 bk + 7 in 4 splits; then SmolLM-360M's training-step shapes
    (fwd, dX, dW of each forward GEMM at 8 x 1024 tokens) and
    recurrentgemma-9b's RG-LRU product at the model's pick, B scaled by
    1 / sqrt(k) as a layer's weights are."""
    from repro_torch.configs import get_config
    from repro_torch.core.gpu_model import F32_TILES
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 9)

    def rn(m, k, n, offset=False, scale=1.0):
        e = 1 if offset else 0
        a = torch.randn(m * k + e, generator=gen, device=device)[e:]
        b = torch.randn(k * n + e, generator=gen, device=device)[e:]
        return a.view(m, k), (b * scale).view(k, n)
    for tile in F32_TILES:
        kw = dict(zip(("bm", "bn", "bk"), tile))
        for m, n, k in ((256, 512, 1024), (33, 17, 65), (1, 128, 7),
                        (200, 90, 130)):
            yield (f"f32 {(m, n, k)} {tile}", *rn(m, k, n), kw)
        yield (f"f32 offset views (129, 72, 200) {tile}",
               *rn(129, 200, 72, offset=True), kw)
        k = 5 * tile[2] + 7
        yield (f"f32 split-K (100, 72, {k}) {tile} splits 4",
               *rn(100, k, 72), dict(kw, splits=4))
    shapes = {}
    for m, k, n, _ in llm_gemm_shapes(get_config(LLM_ARCH), LLM_BATCH,
                                      LLM_SEQ):
        for phase, mkn in (("fwd", (m, k, n)), ("dX", (m, n, k)),
                           ("dW", (k, m, n))):
            shapes.setdefault((phase, mkn), None)
    shapes[("rg-lru", RG_LRU_GEMM)] = None
    for phase, (m, k, n) in shapes:
        yield (f"f32 {phase} {(m, n, k)}", *rn(m, k, n, scale=k ** -0.5),
               {})


def hold_f32(held, label, a, b, kw) -> None:
    """One float32 GEMM within 2e-4 of ``matmul_ref``, and the same bits
    on a second call (a ``splits`` of its own goes to the wrapper)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref
    if "splits" in kw:
        def call():
            return mm.matmul(a, b, kw["bm"], kw["bn"], kw["bk"],
                             splits=kw["splits"])
    else:
        def call():
            return ops.matmul(a, b, **kw)
    got = call()
    held.add("matmul", label, [("c", got, ref.matmul_ref(a, b),
                                TOL[torch.float32])])
    hold_same_bits(held, "matmul", label, (got,), (call(),))


def bn_forward_f64(x, g, b, eps=1e-5):
    """``ref.bn_forward_ref``'s two-pass formula in float64 (the plain
    version casts x to float32)."""
    xd = x.double()
    mu = xd.mean(0)
    psi = torch.rsqrt(xd.var(0, correction=0) + eps)
    return (xd - mu) * psi * g.double() + b.double(), mu, psi


def hold_shifted_means(held, device) -> dict:
    """``bn_forward`` at channel means shifted by 10, 100 and 1000
    ((4096, 64) float32, 5 seeds, from a generator of their own) within
    ``BN_F32_TOL``: against the plain version's formula in float64 at
    every shift, and against the float32 plain version at 10 and 100.
    At 1000 the float32 plain version is itself no yardstick: its mean
    lies an ulp of 1000 (6.1e-5) or more from the float64 one, which
    moves its y by that times psi * gamma, past the y tolerance (1.2e-4
    and 2.4e-4 on the H100 in two draws).  Returns the largest error of
    the kernel and of the float32 plain version against float64, by
    shift."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 8)
    errs = {}
    for shift in BN_SHIFTS:
        for seed in range(BN_SHIFT_SEEDS):
            x = torch.randn((4096, 64), generator=gen, device=device) + shift
            g, b = (torch.randn(64, generator=gen, device=device)
                    for _ in range(2))
            got = ops.bn_forward(x, g, b)
            exact = bn_forward_f64(x, g, b)
            label = f"shift {shift} seed {seed} (4096, 64)"
            hold_bn_forward(held, f"{label} vs float64", got, exact,
                            x.dtype)
            plain = ref.bn_forward_ref(x, g, b)
            if shift < 1000:
                hold_bn_forward(held, label, got, plain, x.dtype)
            for who, outs in (("kernel", got), ("plain f32", plain)):
                for what, a, w in zip(("y", "mu", "psi"), outs, exact):
                    key = f"{shift} {who} {what}"
                    errs[key] = max(errs.get(key, 0.0),
                                    float((a.double() - w).abs().max()))
    torch.cuda.synchronize()
    return errs


def redesign_cases(device):
    """The cases of the tensor-core attention and the `wgmma`/split-K GEMM,
    drawn from a generator of their own so that the cases above keep
    their inputs."""
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 7)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    out = []
    # split-K in both types, K not a multiple of splits * bk, on each route
    for dtype in (torch.float32, torch.bfloat16):
        for (m, n, k), tile, splits in (
                ((200, 96, 1000), (128, 64, 64), 7),
                ((147, 64, 4099), (128, 128, 64), 13),
                ((147, 64, 4104), (128, 64, 64), 13),
                ((33, 17, 650), (32, 64, 32), 5),
                ((300, 256, 2050), (128, 256, 64), 3),
                ((64, 40, 777), (64, 64, 128), 6)):
            out.append(("matmul", f"{dtype} split-K {(m, n, k)} {tile} "
                        f"splits {splits}",
                        (rn(m, k, dtype=dtype), rn(k, n, dtype=dtype)),
                        dict(zip(("bm", "bn", "bk"), tile), splits=splits)))
    # each route at each of its tiles: wgmma (bf16, aligned, K and N
    # multiples of 8) and mma (the same GEMMs in f32, or from views that
    # start 2 bytes past a 16-byte boundary)
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in ((256, 512, 1024), (300, 200, 96), (1, 64, 64)):
            for tile in ((128, 64, 64), (128, 128, 64), (128, 256, 64)):
                out.append(("matmul", f"{dtype} route {(m, n, k)} {tile}",
                            (rn(m, k, dtype=dtype), rn(k, n, dtype=dtype)),
                            dict(zip(("bm", "bn", "bk"), tile))))
    for m, n, k in ((256, 512, 1024), (129, 72, 200)):
        a = rn(m * k + 1, dtype=torch.bfloat16)[1:].view(m, k)
        b = rn(k * n + 1, dtype=torch.bfloat16)[1:].view(k, n)
        out.append(("matmul", f"bf16 misaligned views {(m, n, k)}", (a, b),
                    {}))
    # bf16 on the tensor cores at S 2048 (causal) and a ragged
    # non-causal window, each head_dim
    for d in (16, 32, 64, 128):
        out.append(("flash_attention", f"bf16 D{d} S2048 causal GQA4",
                    (rn(8, 2048, d, dtype=torch.bfloat16),
                     rn(2, 2048, d, dtype=torch.bfloat16),
                     rn(2, 2048, d, dtype=torch.bfloat16), 4, 1), {}))
        out.append(("flash_attention", f"bf16 D{d} S333 window 100 "
                    f"non-causal GQA2",
                    (rn(4, 333, d, dtype=torch.bfloat16),
                     rn(2, 333, d, dtype=torch.bfloat16),
                     rn(2, 333, d, dtype=torch.bfloat16), 2, 1),
                    dict(causal=False, window=100)))
    return out


def hold_slice(slice_run, device) -> Held:
    """Every kernel against its plain version on the card: on the inputs
    the main path gave it (one per shape), on the edge cases, and the
    whole bf16 decoder against the composition of the plain versions; a
    float32 decoder cut to small widths is held elementwise."""
    from repro_torch.kernels import forward as F
    held = Held()
    for (name, shapes), (model, args, kwargs) in \
            slice_run["inputs"].items():
        hold_call(held, name, f"main path {model} {shapes}", args, kwargs,
                  main=True)
    for name, label, args, kwargs in edge_cases(device):
        hold_call(held, name, label, args, kwargs)
    for label, a, b, kw in f32_cases(device):
        hold_f32(held, label, a, b, kw)
    del a, b
    torch.cuda.synchronize()
    shifted = hold_shifted_means(held, device)

    dims, params, ids = slice_run["qwen"]
    got = slice_run["outs"]["qwen3_0_6b"]
    check(got.shape == (QWEN_BATCH * QWEN_SEQ, dims.vocab)
          and bool(torch.isfinite(got).all()),
          f"decoder logits {tuple(got.shape)} not finite or misshapen")
    want = F.decoder_forward(ids, params, dims, dims.n_layers, impl=F.PLAIN)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    check(rel <= SLICE_BF16_REL, f"bf16 decoder logits off the plain "
          f"composition by {rel} (relative), above {SLICE_BF16_REL}")
    small = F.DecoderDims(d_model=128, n_heads=4, n_kv=2, head_dim=32,
                          d_ff=256, vocab=512, n_layers=2)
    sp = F.init_decoder_params(small, 2, SLICE_SEED, device, torch.float32)
    sids = torch.randint(0, small.vocab, (2, 96), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(SLICE_SEED))
    err, excess = close(F.decoder_forward(sids, sp, small, 2),
                        F.decoder_forward(sids, sp, small, 2,
                                          impl=F.PLAIN), *TOL[torch.float32])
    check(excess <= 0, f"f32 small decoder off its plain composition by "
          f"{err}")
    for out in slice_run["outs"]["resnet50"]:
        tensors = out if isinstance(out, tuple) else (out,)
        check(all(bool(torch.isfinite(t).all()) for t in tensors),
              "ResNet-50 slice output not finite")
    return {"held": held, "decoder_bf16_rel_err": rel,
            "decoder_f32_small_max_err": err, "bn_shifted_max_err": shifted}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, nbytes, peak):
    """Least milliseconds for ``flops`` at ``peak`` and ``nbytes`` at
    3.35 TB/s, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def queued_ms(fn, iters: int, calls: int = 1, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn`` (which makes ``calls``
    wrapper calls) without host gaps: the calls are enqueued behind a
    device-side sleep that outlasts their host time (about 0.2 ms a
    wrapper call at 2 GHz), so the CUDA events around them bracket
    back-to-back device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * calls * 4e5))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_op(fn, plain, library, flops, nbytes, peak, match, iters,
            calls=1, kernels_per_call=1):
    """``ms``: events around calls through the wrapper, host included;
    ``device_ms``: the same calls queued behind a device sleep;
    ``profiler_ms``: the profiler's kernel time a call, with the kernel
    records it found and the launches made while it traced;
    ``library_ms`` and ``library_device_ms``: the PyTorch call that
    computes the same, by events with the host and queued."""
    b, by = bound(flops, nbytes, peak)
    n_prof = max(2, iters // 2)
    prof = profile_device_ms(fn, iters=n_prof, match=match)
    return {"ms": cuda_ms(fn, iters=iters),
            "device_ms": queued_ms(fn, iters=iters, calls=calls),
            "profiler_ms": prof["device_ms"],
            "profiler_records": f"{prof['records']} of "
                                f"{n_prof * kernels_per_call}",
            "plain_ms": cuda_ms(plain, iters=max(2, iters // 2), warmup=1),
            "library_ms": None if library is None
            else cuda_ms(library, iters=iters),
            "library_device_ms": None if library is None
            else queued_ms(library, iters=iters, calls=calls),
            "bound_ms": b, "bound_by": by}


def time_attention(q, k, v, h, kv, window=0) -> dict:
    """``time_op`` of a causal bf16 ``flash_attention`` call beside SDPA
    (whose causal mask stands for ``window`` only when it is 0 or covers
    the sequence), with the kernels SDPA runs and the rate of each."""
    import torch.nn.functional as tf
    from repro_torch.kernels import ops, ref
    bh, s, d = q.shape
    check(window == 0 or window >= s, f"SDPA's causal mask does not "
          f"stand for window {window} over {s} positions")
    pairs = bh * s * (s + 1) // 2            # causal: k_pos <= q_pos
    b = bh // h
    qb, kb = q.view(b, h, s, d), k.view(b, kv, s, d)
    vb = v.view(b, kv, s, d)

    def sdpa():
        return tf.scaled_dot_product_attention(qb, kb, vb, is_causal=True,
                                               enable_gqa=True)
    t = time_op(lambda: ops.flash_attention(q, k, v, h, kv, window=window),
                lambda: ref.flash_attention_ref(q, k, v, h, kv, True, window),
                sdpa, 4.0 * d * pairs, 2 * _nbytes(q) + _nbytes(k, v),
                BF16_OPS_PER_S, "flash_fwd", iters=20)
    # what the yardstick runs, and the rate each reaches
    t["library_kernels"] = kernel_names(sdpa)
    for key in ("device_ms", "library_ms"):
        t[f"{key[:-3]}_tflops"] = 4.0 * d * pairs / (t[key] * 1e9)
    return t


def time_slice(slice_run) -> dict:
    """Times at the main path's shapes: CUDA events around repeated calls
    after a warm-up; device time from the profiler's trace of the kernel
    names; bound from this run's inputs."""
    import torch.nn.functional as tf
    from repro_torch.kernels import ops, ref
    out = {}
    for (name, shapes), (model, args, kwargs) in \
            slice_run["inputs"].items():
        label = f"{name} {shapes}"
        if model != "qwen3_0_6b" and label not in HEADLINE.values():
            continue      # ResNet-50's calls are timed as whole sequences
        if name == "matmul":
            a, b = args[:2]
            (m, k), n = a.shape, b.shape[1]
            peak = BF16_OPS_PER_S if a.dtype == torch.bfloat16 \
                else SCALAR_OPS_PER_S
            c_bytes = m * n * a.element_size()
            out[label] = time_op(
                lambda: ops.matmul(*args, **kwargs),
                lambda: ref.matmul_ref(a, b), lambda: torch.matmul(a, b),
                2.0 * m * n * k, _nbytes(a, b) + c_bytes, peak, "mm_",
                iters=10 if n > 100_000 else 20)
        elif name == "fused_add_rmsnorm":
            x, r, s = args[:3]
            out[label] = time_op(
                lambda: ops.fused_add_rmsnorm(*args, **kwargs),
                lambda: ref.fused_add_rmsnorm_ref(x, r, s), None,
                5.0 * x.numel(), 2 * _nbytes(x, r) + _nbytes(s),
                SCALAR_OPS_PER_S, "addnorm", iters=50)
        elif name == "flash_attention":
            out[label] = time_attention(*args[:5], kwargs.get("window", 0))
        else:
            x, g, b = args[:3]
            out[label] = time_op(
                lambda: ops.bn_forward(*args, **kwargs),
                lambda: ref.bn_forward_ref(x, g, b),
                lambda: tf.batch_norm(x, None, None, g, b, training=True),
                7.0 * x.numel(), 2 * _nbytes(x) + _nbytes(g, b) + 8 * g.numel(),
                SCALAR_OPS_PER_S, "bn_forward_kernel", iters=20)
            out[label]["kernel_names"] = kernel_names(
                lambda: ops.bn_forward(*args, **kwargs))
            check_one_kernel("bn_forward", out[label]["kernel_names"])
    # the whole ResNet-50 sequences, 53 BN layers and 54 GEMMs
    from repro_torch.kernels import forward as F
    calls, rinputs = slice_run["resnet"]
    for kind, lib in (("bn_forward", lambda x, g, b: tf.batch_norm(
            x, None, None, g, b, training=True)), ("matmul", torch.matmul)):
        seq = [c for c in calls if c[0] == kind]
        flops = sum(2.0 * m * k * n for _, _, (m, k, n) in seq) \
            if kind == "matmul" else sum(7.0 * n * c for _, _, (n, c) in seq)
        nbytes = 0
        for _, _, shape in seq:
            ins = rinputs[shape]
            if kind == "matmul":
                nbytes += _nbytes(*ins) + shape[0] * shape[2] * 2
            else:
                nbytes += 2 * _nbytes(ins[0]) + _nbytes(*ins[1:]) \
                    + 8 * shape[1]
        out[f"resnet50 all {len(seq)} {kind}"] = time_op(
            lambda s=seq: F.resnet50_forward(s, rinputs),
            lambda s=seq: F.resnet50_forward(s, rinputs, impl=F.PLAIN),
            lambda s=seq, f=lib: [f(*rinputs[sh]) for _, _, sh in s],
            flops, nbytes,
            BF16_OPS_PER_S if kind == "matmul" else SCALAR_OPS_PER_S,
            "mm_" if kind == "matmul" else "bn_forward_kernel", iters=5,
            calls=len(seq), kernels_per_call=len(seq))
    return out


def time_tiles(slice_run) -> dict:
    """Device milliseconds (calls queued behind a device sleep) of every
    compiled GEMM tile at each bf16 GEMM shape of the main path, each with
    the split count the model (``gpu_model.select_matmul_block``) gives
    that tile and on the route the tile takes there, beside the model's
    own pick; and the sums over the shapes for the model's pick, the
    fastest tile of each shape and each fixed tile."""
    from repro_torch.core.gpu_model import MATMUL_TILES, select_matmul_block
    from repro_torch.kernels import matmul as mm
    shapes = {}
    for (name, _), (_, args, _) in slice_run["inputs"].items():
        if name == "matmul":
            a, b = args[:2]
            shapes[(a.shape[0], a.shape[1], b.shape[1])] = (a, b)
    per, sums = {}, {"model": 0.0, "fastest": 0.0}
    sums.update({str(t): 0.0 for t in MATMUL_TILES})
    for (m, k, n), (a, b) in shapes.items():
        blk = select_matmul_block(m, n, k, bytes_in=2, bytes_out=2)
        pick = (blk.bm, blk.bn, blk.bk)
        splits = {t: select_matmul_block(m, n, k, 2, 2, tile=t).splits
                  for t in MATMUL_TILES}
        ms = {t: queued_ms(lambda t=t: mm.matmul(a, b, *t,
                                                 splits=splits[t]),
                           iters=3 if n > 100_000 else 10, warmup=1)
              for t in MATMUL_TILES}
        fastest = min(ms, key=ms.get)
        per[str((m, k, n))] = {"model_tile": str(pick),
                               "model_splits": blk.splits,
                               "model_route": blk.route,
                               "model_ms": ms[pick],
                               "fastest_tile": str(fastest),
                               "fastest_splits": splits[fastest],
                               "fastest_ms": ms[fastest],
                               "ms": {str(t): v for t, v in ms.items()},
                               "splits": {str(t): v
                                          for t, v in splits.items()}}
        sums["model"] += ms[pick]
        sums["fastest"] += ms[fastest]
        for t, v in ms.items():
            sums[str(t)] += v
    return {"shapes": per, "sum_ms": sums}


# the shape each kernel's line of the JSON report is timed at
HEADLINE = {
    "matmul": "matmul ((4096, 1024), (1024, 151936))",
    "fused_add_rmsnorm": "fused_add_rmsnorm ((4096, 1024), (4096, 1024), "
                         "(1024,))",
    "flash_attention": "flash_attention ((32, 2048, 128), (16, 2048, 128), "
                       "(16, 2048, 128))",
    "bn_forward": "bn_forward ((401408, 64), (64,), (64,))",
}


# the float32 GEMM's line of the JSON report: SmolLM-360M's gate and up
# projections at 8 x 1024 tokens, (m, k, n)
F32_HEADLINE = (8192, 960, 2560)


def time_f32_headline(device) -> dict:
    """``time_op`` of the float32 GEMM at ``F32_HEADLINE`` (the model's
    pick) beside ``torch.matmul`` in float32 (TF32 off) and its bound at
    the CUDA cores' 67 TFLOP/s."""
    from repro_torch.core.gpu_model import select_matmul_block
    from repro_torch.kernels import ops, ref
    m, k, n = F32_HEADLINE
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 10)
    a = torch.randn((m, k), generator=gen, device=device)
    b = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    blk = select_matmul_block(m, n, k, 4, 4)
    t = time_op(lambda: ops.matmul(a, b), lambda: ref.matmul_ref(a, b),
                lambda: torch.matmul(a, b), 2.0 * m * n * k,
                _nbytes(a, b) + m * n * 4, SCALAR_OPS_PER_S, "mm_f32",
                iters=20)
    out = {key: t[key] for key in ("ms", "device_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_device_ms")}
    out.update(timed_on=f"matmul (({m}, {k}), ({k}, {n})) float32",
               tile=str((blk.bm, blk.bn, blk.bk)), splits=blk.splits,
               device_tflops=2.0 * m * n * k / (t["device_ms"] * 1e9))
    return out


def kernel_slice(device, card, report) -> list:
    """Drive, hold and time the kernel slice; the JSON entries of its four
    kernels."""
    run = drive_slice(device)
    report["slice_launches"] = run["launches"]
    report["slice_launches_per_forward"] = run["per_forward"]
    report["slice_wall_s"] = run["wall_s"]
    report["slice_matmul_routes"] = run["routes"]
    print(f"slice launches (counters 0 before each model): "
          f"{run['launches']}")
    print(f"  matmul launches by route, and those with a split-K sum: "
          f"{run['routes']}")
    report["slice_bn_routes"] = run["bn_routes"]
    print(f"  batch-norm launches by route: {run['bn_routes']}")
    for model, s in run["wall_s"].items():
        print(f"  first {model} forward through ops: {s} s  [{card}]")
    held = hold_slice(run, device)
    checks = {name: len(held["held"].cases[name]) for name in OPS}
    report["slice_checks"] = {name: held["held"].cases[name] for name in OPS}
    report["decoder_bf16_rel_err"] = held["decoder_bf16_rel_err"]
    report["decoder_f32_small_max_err"] = held["decoder_f32_small_max_err"]
    report["attention_row_rel_err"] = held["held"].row_rel
    print(f"kernels == plain versions within tolerance: {checks} cases; "
          f"bf16 decoder logits relative error "
          f"{held['decoder_bf16_rel_err']} (limit {SLICE_BF16_REL}); "
          f"f32 small decoder max abs err "
          f"{held['decoder_f32_small_max_err']}")
    for label, rel in held["held"].row_rel.items():
        print(f"  {label}: relative error {rel} (worst row limit "
              f"{ATTN_BF16_ROW_REL})")
    report["slice_same_bits"] = held["held"].same_bits
    report["bn_shifted_max_err"] = held["bn_shifted_max_err"]
    print(f"  bit-identical on a second call, main-path inputs: "
          f"{held['held'].same_bits}")
    print(f"  bn_forward at shifted means, {BN_SHIFT_SEEDS} seeds each, "
          f"max abs err against the float64 formula: "
          f"{held['bn_shifted_max_err']}")
    times = time_slice(run)
    report["slice_times"] = times
    for label, t in times.items():
        print(f"  {label}: " + ", ".join(f"{k} {v}" for k, v in t.items())
              + f"  [{card}]")
    tiles = time_tiles(run)
    report["matmul_tiles"] = tiles
    for shape, row in tiles["shapes"].items():
        print(f"  matmul tiles {shape}: model {row['model_tile']} "
              f"x{row['model_splits']} ({row['model_route']}) "
              f"{row['model_ms']} ms, fastest {row['fastest_tile']} "
              f"x{row['fastest_splits']} {row['fastest_ms']} ms  [{card}]")
    print(f"  matmul tiles, sum over {len(tiles['shapes'])} shapes (ms): "
          f"{tiles['sum_ms']}  [{card}]")
    entries = []
    for name in ("matmul", "fused_add_rmsnorm", "bn_forward",
                 "flash_attention"):
        source, replaces = KERNEL_META[name]
        t = times[HEADLINE[name]]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(per[name] for per in run["launches"].values()),
            "checks": checks[name],
            "max_abs_err": held["held"].max_err(name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "profiler_ms": t["profiler_ms"], "timed_on": HEADLINE[name]})
    f32 = entries[0]["f32"] = time_f32_headline(device)
    report["f32_headline"] = f32
    print(f"  matmul float32 {F32_HEADLINE} (m, k, n): " + ", ".join(
        f"{k} {v}" for k, v in f32.items()) + f"  [{card}]")
    return entries


# ---------------------------------------------------------------------------
# the training slice: a full-width ResNet-50 training step through
# MatmulFn and BatchNormFn (kernels/training.py)
# ---------------------------------------------------------------------------

TRAIN_BATCH = 32
TRAIN_SEED = 2026
TRAIN_STEPS = 3
# The step against its plain version, from the same weights and on the same
# ReLU and max-pool choices (``Network.forward``'s ``pin``): relative
# Frobenius error of the loss and of every parameter's gradient.  float32:
# the dgamma/dbeta tolerance of tests/test_kernels.py.  bfloat16 GEMMs:
# twice the reading of bf16 against float32 GEMMs of the plain step on the
# CPU at batch 4 (0.0299 at the weights after one step, worst gradient;
# scripts/training_conditioning.py --device cpu --zero-gamma --after-step),
# which is above half the bf16 tolerance 3e-2 (PERF.md, before the chip run).
TRAIN_REL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
# Controls, each held to read above its dtype's limit.  float32: the plain
# step with every GEMM output times 1 + 1e-7 N(0, 1) (another summation
# order), against the plain step without pinned choices: why the check
# pins them.  bf16: the plain step with every GEMM's operands and output
# rounded to 5 explicit mantissa bits, two fewer than bfloat16's, on the
# pinned choices: a step whose GEMMs lost precision that the limit fails.
TRAIN_NOISE = 1e-7
TRAIN_CONTROL_BITS = 5


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded to nearest, ties to even, to ``bits`` explicit
    mantissa bits (bfloat16 has 7), in ``x``'s dtype."""
    shift = 23 - bits
    i = x.float().view(torch.int32)
    i = i + ((1 << (shift - 1)) - 1) + ((i >> shift) & 1)
    return (i & -(1 << shift)).view(torch.float32).to(x.dtype)


def control_plain(matmul, base=None):
    """``base``'s plain versions (``kernels.training.PLAIN`` by default)
    with ``matmul`` for the GEMM."""
    if base is None:
        from repro_torch.kernels.training import PLAIN as base
    return SimpleNamespace(**{**vars(base), "matmul": matmul})


def reordered_plain():
    """The serving path's plain versions (``kernels.forward.PLAIN``) with
    each GEMM's float32 sum taken over the two halves of K and added:
    the same function, its sums in another order.  B is taken a block of
    columns at a time (about 2**26 entries), so that gemma3-27b's (5376,
    262144) head is never whole in float32."""
    from repro_torch.kernels import forward as F

    def matmul(a, b):
        k = a.shape[1] // 2
        out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                          device=a.device)
        a0, a1 = a[:, :k].float(), a[:, k:].float()
        cols = max(1, (1 << 26) // max(a.shape[0], b.shape[0]))
        for j in range(0, b.shape[1], cols):
            out[:, j:j + cols] = (a0 @ b[:k, j:j + cols].float()
                                  + a1 @ b[k:, j:j + cols].float())
        return out
    return control_plain(matmul, F.PLAIN)


def noisy_plain(rel: float, generator: torch.Generator):
    """The plain versions with every GEMM output times
    ``1 + rel * N(0, 1)``, the noise drawn from ``generator``."""
    from repro_torch.kernels import ref

    def matmul(a, b):
        c = ref.matmul_ref(a, b).float()
        eps = torch.randn(c.shape, generator=generator, device=c.device)
        return (c * (1 + rel * eps)).to(a.dtype)
    return control_plain(matmul)


def rounded_plain(bits: int):
    """The plain versions with every GEMM's operands and output rounded
    to ``bits`` mantissa bits (``round_mantissa``)."""
    from repro_torch.kernels import ref

    def matmul(a, b):
        return round_mantissa(ref.matmul_ref(round_mantissa(a, bits),
                                             round_mantissa(b, bits)), bits)
    return control_plain(matmul)


def grad_errors(loss, grads, want_loss, want_grads) -> dict:
    """Relative Frobenius errors of the loss and of each gradient."""
    from repro_torch.kernels.training import relative_errors
    errs = relative_errors(grads, want_grads)
    worst = max(errs, key=errs.get)
    return {"loss": abs(float(loss) - float(want_loss))
            / abs(float(want_loss)), "max": errs[worst], "worst": worst,
            "median": sorted(errs.values())[len(errs) // 2], "all": errs}


def training_inputs(device):
    from repro_torch.core.networks import resnet50
    from repro_torch.kernels import training as T
    layers = resnet50(batch=TRAIN_BATCH)
    arrs = T.init_params(layers, TRAIN_SEED, zero_gamma=True)
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED + 1)
    images = torch.randn((TRAIN_BATCH, 224, 224, 3), generator=gen,
                         device=device)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                           device=device)
    return layers, arrs, images, labels


def drive_training(device, dtype, layers, arrs, images, labels, rec=None):
    """``TRAIN_STEPS`` SGDM steps of the kernel network with GEMMs in
    ``dtype``: every launch counter set to 0 just before the first step
    and read just after it; the second step, which records its ReLU and
    pooling choices (and, with ``rec``, its kernel inputs), is held
    against the plain step from the same weights on those choices, and
    the dtype's control (``TRAIN_NOISE``, ``TRAIN_CONTROL_BITS``) is held
    to fail the same limit.  Returns the launches, losses, errors and
    wall seconds."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import training as T
    impl = ops if rec is None else rec
    net = T.Network(layers, T.params_from_numpy(arrs, device), impl=impl,
                    gemm_dtype=dtype)
    opt = T.make_optimizer(net)
    out = {"losses": [], "wall_s": []}
    decisions = None
    for step in range(TRAIN_STEPS):
        if step == 0:
            zero_counters()
        if step == 1:
            weights = {k: p.detach().clone() for k, p in net.params().items()}
            decisions = {}
            if rec is not None:
                rec.model = f"resnet50 training step {dtype}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = T.train_step(net, opt, images, labels, decisions)
        torch.cuda.synchronize()
        out["wall_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(loss))
        if step == 0:
            out["launches"] = {n: c.launches for n, c in _counters().items()}
            out["routes"] = dict(_routes())
            out["bn_routes"] = check_bn_routes(f"training step {dtype}",
                                               out["launches"])
        if step == 1:
            if rec is not None:
                rec.model = None
            grads = {k: p.grad.detach().clone()
                     for k, p in net.params().items()}
            kernel_loss, choices, decisions = loss, decisions, None
    check(all(np.isfinite(out["losses"])), f"{dtype} step losses "
          f"{out['losses']} not finite")
    want = T.training_launches(layers)
    for name, n in out["launches"].items():
        check(n == want.get(name, 0), f"training step {dtype}: {name} "
              f"launched {n} times, expected {want.get(name, 0)}")
    # bf16: all on `wgmma` but the stem's forward (K = 147; the stem has
    # no dX, and its dW reads (147, n oh ow) @ (n oh ow, 64)); f32: `mma`
    check_routes(f"training step {dtype}", out["routes"], want["matmul"],
                 1 if dtype == torch.bfloat16 else want["matmul"])
    del net, opt
    plain = T.Network(layers, weights, impl=T.PLAIN, gemm_dtype=dtype)
    pl, pg = T.loss_and_grads(plain, images, labels, choices, pin=True)
    out["pinned"] = grad_errors(kernel_loss, grads, pl, pg)
    if dtype == torch.float32:
        pl, pg = T.loss_and_grads(plain, images, labels)
        impl, pin = noisy_plain(TRAIN_NOISE, torch.Generator(
            device=device).manual_seed(TRAIN_SEED)), None
    else:
        impl, pin = rounded_plain(TRAIN_CONTROL_BITS), choices
    control = T.Network(layers, weights, impl=impl, gemm_dtype=dtype)
    cl, cg = T.loss_and_grads(control, images, labels, pin, pin is not None)
    out["control"] = grad_errors(cl, cg, pl, pg)
    limit = TRAIN_REL[dtype]
    p, c = out["pinned"], out["control"]
    check(p["loss"] <= limit and p["max"] <= limit,
          f"{dtype} training step off its plain version: loss {p['loss']}, "
          f"gradient {p['worst']} {p['max']} (relative), limit {limit}")
    check(c["max"] > limit, f"{dtype} control within the limit {limit}: "
          f"gradient {c['worst']} {c['max']} (relative)")
    return out


def bn_backward_cases(device):
    """``(label, args, kwargs)`` of ``bn_backward``: the cases of
    tests/test_kernels.py ((300, 70), (256, 128), (64, 33) with 64 x 32
    tiles, and the autodiff case (128, 16) with 64 x 16), their bfloat16
    forms, and ragged N and C with the default tile; mu and psi from the
    plain forward of the same x."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 4)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for (n, c), tile in (((300, 70), (64, 32)), ((256, 128), (64, 32)),
                             ((64, 33), (64, 32)), ((128, 16), (64, 16)),
                             ((1001, 67), (256, 128)),
                             ((4099, 1030), (256, 128))):
            x, dy, g = rn(n, c).to(dtype), rn(n, c).to(dtype), rn(c) + 1.0
            _, mu, psi = ref.bn_forward_ref(x, g, rn(c))
            out.append((f"{dtype} {(n, c)} tile {tile}", (x, dy, g, mu, psi),
                        dict(block_rows=tile[0], block_c=tile[1])))
    return out


def hold_autodiff(device) -> float:
    """``BatchNormFn`` (the kernels) against autograd of the plain forward
    on the autodiff case of tests/test_kernels.py, tolerance 1e-3."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bn import BatchNormFn
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 5)
    x, g = (torch.randn(s, generator=gen, device=device)
            for s in ((128, 16), (16,)))
    g = g + 1.0
    dy = torch.randn((128, 16), generator=gen, device=device)
    b = torch.zeros(16, device=device)
    grads = []
    for fwd in (lambda x, g, b: BatchNormFn.apply(x, g, b),
                lambda x, g, b: ref.bn_forward_ref(x, g, b)[0]):
        ins = [t.clone().requires_grad_() for t in (x, g, b)]
        (fwd(*ins) * dy).sum().backward()
        grads.append([t.grad for t in ins])
    err = 0.0
    for got, want in zip(*grads):
        e, excess = close(got, want, 1e-3, 1e-3)
        err = max(err, e)
        check(excess <= 0, f"BatchNormFn gradient off autograd by {e}")
    return err


def hold_training(rec, device) -> Held:
    """Every kernel on the inputs the training step gave it (the first
    call at each shape, from the held step) against its plain version;
    ``bn_backward`` also on its edge cases."""
    held = Held()
    for (name, shapes), (model, args, kwargs) in rec.inputs.items():
        hold_call(held, name, f"{model} {shapes}", args, kwargs, main=True)
    for label, args, kwargs in bn_backward_cases(device):
        hold_call(held, "bn_backward", label, args, kwargs)
    return held


def _bn_back_call(args):
    from repro_torch.kernels import ops, ref
    x, dy, g, mu, psi = args
    return (lambda: ops.bn_backward(x, dy, g, mu, psi),
            lambda: ref.bn_backward_ref(x, dy, g, mu, psi),
            lambda: torch.ops.aten.native_batch_norm_backward(
                dy, x, g, None, None, mu, psi, True, 1e-5,
                [True, True, True]))


def bn_backward_work(args):
    """Operations (a dozen an element: x^, the two sums, Eq. 28) and
    bytes (x and dy read once, dx written once, the vectors) of one
    call."""
    x, dy, g, mu, psi = args
    return 12.0 * x.numel(), 3 * _nbytes(x) + _nbytes(g, mu, psi) \
        + 8 * g.numel()


def time_bn_backward(rec, layers) -> dict:
    """``bn_backward`` at the stem (401408 x 64, f32, at batch 32) and
    over all 53 BN layers of the step, on the held step's inputs, beside
    its plain version and ``native_batch_norm_backward``."""
    from repro_torch.core.layers import SimdLayer
    inputs = {shapes[0]: args for (name, shapes), (_, args, _) in
              rec.inputs.items() if name == "bn_backward"}
    seq = [(l.h * l.w * l.n, l.c) for l in layers
           if isinstance(l, SimdLayer) and l.op == "bn"]
    out = {}
    stem = inputs[seq[0]]
    fn, plain, lib = _bn_back_call(stem)
    flops, nbytes = bn_backward_work(stem)
    out["stem"] = dict(
        time_op(fn, plain, lib, flops, nbytes, SCALAR_OPS_PER_S,
                "bn_backward_kernel", iters=20),
        shape=list(seq[0]), kernel_names=kernel_names(fn))
    check_one_kernel("bn_backward", out["stem"]["kernel_names"])
    calls = [_bn_back_call(inputs[shape]) for shape in seq]
    work = [bn_backward_work(inputs[shape]) for shape in seq]
    out["all BN layers"] = dict(
        time_op(lambda: [c[0]() for c in calls],
                lambda: [c[1]() for c in calls],
                lambda: [c[2]() for c in calls],
                sum(w[0] for w in work), sum(w[1] for w in work),
                SCALAR_OPS_PER_S, "bn_backward_kernel", iters=5,
                calls=len(seq), kernels_per_call=len(seq)),
        layers=len(seq))
    return out


STEP_KERNELS = (("GEMM", ("::mm_bf16<", "::mm_f32<", "::mm_wgmma<",
                           "::splitk_sum<")),
                ("BN bwd", ("bn_backward_kernel",)),
                ("BN fwd", ("bn_forward_kernel",)))


def profile_step(step, groups=STEP_KERNELS) -> dict:
    """Device time of one step from the profiler's trace: every kernel,
    copy and set record summed (one stream, so nothing overlaps), split
    into the port's kernels by name (``groups``: the GEMM and BN kernels
    by default) and everything else; the records of each, and the 12
    kernels with the most time.  The
    trace may drop a few records of the port's kernels, so ``records``
    is to be read against the launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    from repro_torch.models.remat import RECOMPUTE_SPAN
    by_name, parts, records = {}, {}, {}
    for evt in prof.events():
        # a remat step's recompute spans have device-side records too
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.name == RECOMPUTE_SPAN:
            continue
        ms = evt.device_time_total / 1e3
        t, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (t + ms, n + 1)
        part = next((p for p, keys in groups
                     if any(k in evt.name for k in keys)), "other")
        parts[part] = parts.get(part, 0.0) + ms
        records[part] = records.get(part, 0) + 1
    top = sorted(((k, t, n) for k, (t, n) in by_name.items()),
                 key=lambda r: -r[1])[:12]
    return {"device_ms": sum(parts.values()), "parts_ms": parts,
            "records": records, "top": top}


def time_gemm_phases(layers, dtype, device) -> dict:
    """Device milliseconds of the step's GEMMs by phase, each GEMM timed
    alone (queued) on seeded operands of its shape, through ``ops.matmul``
    and through ``torch.matmul`` (the yardstick, used nowhere in the
    port): fwd (m, k) @ (k, n), dX (m, n) @ (n, k) but for the first
    convolution, dW (k, m) @ (m, n); and each dW shape's milliseconds,
    GEMMs of the step, and the tile, split, route and blocks (tiles times
    splits) ``ops.matmul`` picks."""
    from repro_torch.core.gpu_model import select_matmul_block
    from repro_torch.core.layers import ConvLayer
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 6)
    cache, out = {}, {"fwd": 0.0, "dX": 0.0, "dW": 0.0, "dW_shapes": {}}
    out.update({f"torch {p}": 0.0 for p in ("fwd", "dX", "dW")})
    convs = [l for l in layers if isinstance(l, ConvLayer)]
    for i, l in enumerate(convs):
        m, k, n = l.n * l.oh * l.ow, l.kh * l.kw * l.ic, l.oc
        for phase, (r, inner, c) in (("fwd", (m, k, n)), ("dX", (m, n, k)),
                                     ("dW", (k, m, n))):
            if phase == "dX" and i == 0:
                continue
            if (r, inner, c) not in cache:
                a = torch.randn((r, inner), generator=gen,
                                device=device).to(dtype)
                b = (torch.randn((inner, c), generator=gen, device=device)
                     * inner ** -0.5).to(dtype)
                cache[(r, inner, c)] = (
                    queued_ms(lambda: ops.matmul(a, b), iters=3, warmup=1),
                    queued_ms(lambda: torch.matmul(a, b), iters=3, warmup=1))
                del a, b
            out[phase] += cache[(r, inner, c)][0]
            out[f"torch {phase}"] += cache[(r, inner, c)][1]
            if phase == "dW":
                size = torch.tensor([], dtype=dtype).element_size()
                blk = select_matmul_block(r, c, inner, bytes_in=size,
                                          bytes_out=size)
                row = out["dW_shapes"].setdefault(f"{r}x{inner}x{c}", {
                    "ms": cache[(r, inner, c)][0],
                    "torch_ms": cache[(r, inner, c)][1], "gemms": 0,
                    "tile": [blk.bm, blk.bn, blk.bk], "splits": blk.splits,
                    "route": blk.route,
                    "blocks": -(-r // blk.bm) * -(-c // blk.bn)
                    * blk.splits})
                row["gemms"] += 1
    return out


def time_transposes(rec, layers) -> float:
    """Device milliseconds of ``MatmulFn``'s transposed copies in one
    step: for each convolution A^T for its dW GEMM and, but for the
    first, B^T for its dX GEMM; queued, on the held step's operands."""
    from repro_torch.core.layers import ConvLayer
    convs = [l for l in layers if isinstance(l, ConvLayer)]
    per_shape, total = {}, 0.0
    for i, l in enumerate(convs):
        m, k, n = l.n * l.oh * l.ow, l.kh * l.kw * l.ic, l.oc
        key = ((m, k), (k, n))
        if key not in per_shape:
            a, b = rec.inputs[("matmul", key)][1][:2]
            per_shape[key] = (
                queued_ms(lambda: a.t().contiguous(), iters=5),
                queued_ms(lambda: b.t().contiguous(), iters=5))
        ta, tb = per_shape[key]
        total += ta + (tb if i else 0.0)
    return total


def time_step(device, layers, arrs, images, labels) -> dict:
    """The warm step (forward, backward, SGDM update) of the kernel
    network (bf16 GEMMs), the plain network (bf16) and the float32 kernel
    network: ms by CUDA events with the host, and the profiler's device
    time of one step, its split and its idle share; for the kernel steps
    also the GEMMs by phase, each timed alone."""
    from repro_torch.core.layers import ConvLayer
    from repro_torch.kernels import ops
    from repro_torch.kernels import training as T
    out = {}
    for label, dtype, impl in (("kernel bf16", torch.bfloat16, ops),
                               ("plain bf16", torch.bfloat16, T.PLAIN),
                               ("kernel f32", torch.float32, ops)):
        net = T.Network(layers, T.params_from_numpy(arrs, device),
                        impl=impl, gemm_dtype=dtype)
        opt = T.make_optimizer(net)

        def step():
            T.train_step(net, opt, images, labels)
        row = {"ms": cuda_ms(step, iters=3, warmup=1)}
        zero_counters()
        row.update(profile_step(step))
        row["launches"] = {n: c.launches for n, c in _counters().items()
                           if c.launches}
        busy = row["device_ms"] or None      # None: the trace has none
        row["idle_share"] = busy and 1.0 - busy / row["ms"]
        if impl is ops:
            row["nonconv_share"] = busy and 1.0 - row["parts_ms"].get(
                "GEMM", 0.0) / busy
            row["gemm_alone_ms"] = time_gemm_phases(layers, dtype, device)
        out[label] = row
        del net, opt
    convs = [l for l in layers if isinstance(l, ConvLayer)]
    flops = [2.0 * l.n * l.oh * l.ow * l.kh * l.kw * l.ic * l.oc
             for l in convs]
    out["gemm_gflop"] = {"fwd": sum(flops) / 1e9,
                         "dX": sum(flops[1:]) / 1e9, "dW": sum(flops) / 1e9}
    out["gemm_bound_ms"] = (3 * sum(flops) - flops[0]) / BF16_OPS_PER_S * 1e3
    return out


def training_slice(device, card, report):
    """Drive, hold and time the training step; the JSON entry of
    ``bn_backward`` and the launches of the counted step by kernel."""
    from repro_torch.core import TRAIN_PRESETS, simulate
    from repro_torch.kernels import training as T
    layers, arrs, images, labels = training_inputs(device)
    rec = RecordingOps()
    rec.model = None
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        runs[dtype] = drive_training(device, dtype, layers, arrs, images,
                                     labels, rec if dtype == torch.bfloat16
                                     else None)
        r = runs[dtype]
        print(f"training step, ResNet-50 batch {TRAIN_BATCH} 224x224, "
              f"GEMMs {dtype}, BN float32: launches of the first step "
              f"(counters 0 before it) {r['launches']}, matmul by route "
              f"{r['routes']}, batch norm by route {r['bn_routes']}; "
              f"losses of "
              f"{TRAIN_STEPS} SGDM steps {r['losses']}; wall s "
              f"{r['wall_s']}  [{card}]")
        control = (f"noisy GEMMs {TRAIN_NOISE}, its own choices"
                   if dtype == torch.float32 else
                   f"GEMMs rounded to {TRAIN_CONTROL_BITS} mantissa bits")
        print(f"  against the plain step, limit {TRAIN_REL[dtype]} (the "
              f"control must exceed it):")
        for what, label in (("pinned", "kernel step"),
                            ("control", f"control ({control})")):
            e = r[what]
            print(f"    {label}: loss {e['loss']}, gradients max {e['max']} "
                  f"({e['worst']}), median {e['median']}")
    report["training"] = {str(d): r for d, r in runs.items()}
    report["training_launches_expected"] = T.training_launches(layers)

    held = hold_training(rec, device)
    autodiff = hold_autodiff(device)
    checks = {name: len(held.cases[name]) for name in OPS
              if held.cases[name]}
    report["training_checks"] = held.cases
    report["bn_backward_main_rel_fro"] = held.rel_fro
    report["batchnormfn_autodiff_max_err"] = autodiff
    print(f"training kernels == plain versions within tolerance: {checks} "
          f"cases; BatchNormFn vs autograd max abs err {autodiff}")
    worst = {what: max(v[what] for v in held.rel_fro.values())
             for what in ("dx", "dgamma", "dbeta")}
    print(f"  bn_backward on the step's {len(held.rel_fro)} shapes, worst "
          f"relative Frobenius error {worst}; bit-identical on a second "
          f"call: {held.same_bits}")
    report["training_same_bits"] = held.same_bits

    bn_times = time_bn_backward(rec, layers)
    report["bn_backward_times"] = bn_times
    for label, t in bn_times.items():
        print(f"  bn_backward {label}: " + ", ".join(
            f"{k} {v}" for k, v in t.items()) + f"  [{card}]")
    steps = time_step(device, layers, arrs, images, labels)
    steps["transposes_ms"] = time_transposes(rec, layers)
    model = simulate(TRAIN_PRESETS[64], "resnet50", mode="training")
    steps["model_64x64_nonconv_share"] = model.nonconv_fraction()
    report["training_step_times"] = steps
    for label in ("kernel bf16", "plain bf16", "kernel f32"):
        t = steps[label]
        print(f"  step {label}: " + ", ".join(
            f"{k} {v}" for k, v in t.items() if k != "top") + f"  [{card}]")
        for name, ms, count in t["top"]:
            print(f"    profiler: {name[:70]}: {ms} ms, {count} records")
    for label in ("kernel bf16", "kernel f32"):
        for shape, row in steps[label]["gemm_alone_ms"]["dW_shapes"].items():
            print(f"    {label} dW {shape} x{row['gemms']}: {row['ms']} ms "
                  f"(torch.matmul {row['torch_ms']}), tile {row['tile']} "
                  f"x{row['splits']} {row['route']}, {row['blocks']} "
                  f"blocks  [{card}]")
    print(f"  MatmulFn transposed copies in one step: "
          f"{steps['transposes_ms']} ms (device, queued)  [{card}]")
    print(f"  step GEMMs {steps['gemm_gflop']} GFLOP, bound "
          f"{steps['gemm_bound_ms']} ms in bf16")
    print(f"  non-convolution share of the step on this card (the "
          f"profiler's device time outside the GEMM kernels): "
          f"{steps['kernel bf16']['nonconv_share']} (bf16 GEMMs), "
          f"{steps['kernel f32']['nonconv_share']} (f32)  [{card}]")
    print(f"  the model's figure for a 64x64 array, not a time on this "
          f"card: simulate(TRAIN_PRESETS[64], 'resnet50', "
          f"mode='training').nonconv_fraction() = "
          f"{steps['model_64x64_nonconv_share']}")

    source, replaces = KERNEL_META["bn_backward"]
    t = bn_times["stem"]
    entry = {
        "name": "bn_backward", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": runs[torch.bfloat16]["launches"]["bn_backward"],
        "checks": len(held.cases["bn_backward"]) + 1,
        "max_abs_err": max(held.max_err("bn_backward"), autodiff),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"], "profiler_ms": t["profiler_ms"],
        "timed_on": f"bn_backward {tuple(t['shape'])} f32 (the stem)"}
    return entry, runs[torch.bfloat16]["launches"]


# ---------------------------------------------------------------------------
# the serving slice: Qwen3-0.6B through the port's model stack
# (models/transformer.py, launch/serve.py) at full width and depth
# ---------------------------------------------------------------------------

SERVE_SEED = 2026
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# The float32 hold: prefill of SERVE_F32_PROMPT tokens, then
# SERVE_F32_STEPS teacher-forced decode steps, against one forward over
# all of them; the limit of tests/test_decode.py.
SERVE_F32_PROMPT, SERVE_F32_STEPS = 256, 16
SERVE_F32_ABS = 5e-3
# bf16 logits of the kernel route against the plain route from the same
# weights and tokens, per row: |got - want| / |want| over the vocabulary;
# the bf16 tolerance of the tests applied to the row norm, as phase 11
# holds attention (ATTN_BF16_ROW_REL).
SERVE_BF16_ROW_REL = 3e-2
# the serving path's kernels in the profiler's trace, by name
SERVE_KERNELS = STEP_KERNELS[:1] + (("attention", ("flash_fwd",)),
                                    ("add+norm", ("addnorm<",)))


def serve_launches(cfg, prefill: bool) -> dict:
    """Kernel launches of one prefill or decode step of ``Model(cfg)``,
    for any of the ten configs (an encoder-decoder's prefill given its
    frames): per layer its mixer's GEMMs (attention: q, k, v, o and, in a
    prefill, one flash attention; mamba2: in and out; RG-LRU: x, gate, r,
    i, out), its cross-attention's (q and o; in a prefill also k and v
    of the encoder's output), its FFN's (dense: 3; MoE: the router and 3
    for each expert and for a shared expert), then the LM head; an
    encoder-decoder's prefill first runs its encoder (a layer: 4
    attention GEMMs, one non-causal flash attention and the FFN's 3).
    An RMSNorm config fuses each residual add with the norm after it:
    one ``fused_add_rmsnorm`` before each mixer, cross-attention and FFN,
    and a final one (the encoder's likewise); LayerNorm runs in plain
    PyTorch."""
    mixer = {"attn": 4, "mamba2": 2, "rglru": 5}
    rms = int(cfg.norm_type == "rmsnorm")
    cross = cfg.encoder_layers > 0
    out = {"matmul": 1, "fused_add_rmsnorm": rms, "flash_attention": 0}

    def add(gemms, norms, flash=0):
        out["matmul"] += gemms
        out["fused_add_rmsnorm"] += rms * norms
        out["flash_attention"] += flash
    for entry in cfg.layer_kinds():
        kind = entry.split("+")[0]
        add(mixer[kind], 1, int(prefill and kind == "attn"))
        if cross:
            add(2 + 2 * prefill, 1)
        if cfg.d_ff:
            add(1 + 3 * cfg.n_experts + 3 * cfg.shared_expert
                if entry.endswith("+moe") else 3, 1)
    if cross and prefill:
        n = cfg.encoder_layers
        ffn = bool(cfg.d_ff)
        add(n * (4 + 3 * ffn), n * (1 + ffn) + 1, n)
    return out


def train_launches(cfg) -> dict:
    """Kernel launches of one training step of ``Model(cfg,
    impl=ops.differentiable())`` without ``ce_chunk``, on the frontend
    inputs ``train_loop`` gives: each of a prefill's GEMMs forward, and
    its dX and dW in the backward (every GEMM input needs a gradient: the
    first layer's through the embedding); a prefill's add+norms and flash
    attentions forward only, their backwards being plain PyTorch; and
    under ``cfg.remat`` the backward's recompute (``recompute_launches``).
    """
    out = serve_launches(cfg, True)
    out = {**out, "matmul": 3 * out["matmul"]}
    for name, n in recompute_launches(cfg).items():
        out[name] += n
    return out


def recompute_launches(cfg) -> dict:
    """The launches a rematerialised step's backward adds
    (``cfg.remat``, ``models/remat.py``): each group of ``cfg.pattern``
    (the remainder layers are not wrapped) and each encoder layer (under
    ``full``) runs again, its add+norms and flash attentions all, its
    GEMMs less those its policy keeps -- ``save_dots`` every GEMM but the
    experts', ``save_mixer`` each mixer's output projection -- and, under
    every policy, less the group's last GEMM where that GEMM's output is
    the group's output (a dense FFN's down projection; without an FFN
    the last projection).  A MoE group's last product is its combine
    einsum, before whose saved inputs the recompute stops.  The two
    rules are made in one place each, ``models/remat.py``'s
    ``Tape.keep`` of the group's output and ``models/moe.py``'s aux
    loss ahead of the dispatch (the module docstring of
    ``models/remat.py`` states both)."""
    out = dict.fromkeys(("matmul", "fused_add_rmsnorm", "flash_attention"),
                        0)
    if not cfg.remat:
        return out
    mixer = {"attn": 4, "mamba2": 2, "rglru": 5}
    rms = int(cfg.norm_type == "rmsnorm")
    cross = 4 * (cfg.encoder_layers > 0)
    dense = bool(cfg.d_ff)

    def group(entries, policy):
        for j, entry in enumerate(entries):
            kind, moe = entry.split("+")[0], entry.endswith("+moe")
            experts = 3 * cfg.n_experts if moe else 0
            ffn = (1 + experts + 3 * cfg.shared_expert if moe else 3) \
                if dense else 0
            last = j == len(entries) - 1 and not moe
            if policy == "save_dots":
                gemms = experts
            else:
                gemms = mixer[kind] + cross + ffn - last
                if policy == "save_mixer" and (dense or cross or not last):
                    gemms -= 1
            out["matmul"] += gemms
            out["fused_add_rmsnorm"] += rms * (1 + bool(cross) + dense)
            out["flash_attention"] += int(kind == "attn")
    for _ in range(cfg.n_layers // len(cfg.pattern)):
        group(cfg.pattern, cfg.remat_policy)
    if cross:
        for _ in range(cfg.encoder_layers):
            out["matmul"] += 4 + 3 * dense - 1
            out["fused_add_rmsnorm"] += rms * (1 + dense)
            out["flash_attention"] += 1
    return out


def counted(what: str, fn, want: dict, route):
    """``fn()`` with every counter set to 0 just before it and read just
    after; the launches must equal ``want`` and every GEMM take
    ``route`` (None: any route).  Returns the result, the launches and
    the GEMM routes."""
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    got = {name: c.launches for name, c in _counters().items()}
    for name, n in got.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    routes = dict(_routes())
    check(route is None or routes[route] == want["matmul"],
          f"{what}: matmul routes {routes}, expected all {want['matmul']} "
          f"on {route}")
    return out, got, routes


def row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's |got - want| / |want| (rows: the last axis)."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def greedy(prefill, step, params, prompts, steps: int, count=None,
           routes=None, extras=None):
    """Tokens (B, 1 + steps) of a prefill of ``prompts`` (and the
    frontend inputs ``extras``) and ``steps`` serve steps, and the
    launches of the prefill and of each step when ``count`` gives
    ``(label, launches a prefill, launches a step, route)``; the GEMM
    launches by route are added into ``routes`` if given."""
    def run_prefill():
        return prefill(params, {"tokens": prompts, **(extras or {})})

    def add(by_route):
        for key, n in by_route.items():
            routes[key] = routes.get(key, 0) + n
    if count:
        label, want_prefill, want_step, route = count
        (last, cache), pre, by_route = counted(
            f"{label} prefill", run_prefill, want_prefill, route)
        if routes is not None:
            add(by_route)
    else:
        last, cache = run_prefill()
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    out, per_step = [tok], []
    for i in range(steps):
        if count:
            (nxt, cache), got, by_route = counted(
                f"{label} decode step {i}", lambda: step(params, cache, tok),
                want_step, route)
            per_step.append(got)
            if routes is not None:
                add(by_route)
        else:
            nxt, cache = step(params, cache, tok)
        tok = nxt[:, None]
        out.append(tok)
    launches = None
    if count:
        launches = {name: pre[name] + sum(s[name] for s in per_step)
                    for name in pre}
    return torch.cat(out, dim=1), launches


def teacher_forced(model, params, prompts, tokens, max_len, routing=None,
                   extras=None):
    """Last-position logits of a prefill of ``prompts`` (and the frontend
    inputs ``extras``), then of a decode step on each of ``tokens`` (B,
    T) in turn; ``routing`` records or replays the MoE choices
    (``models.moe.Routing``)."""
    last, cache = model.prefill(params, prompts, max_len, routing=routing,
                                **(extras or {}))
    logits = [last]
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(params, tokens[:, i:i + 1], cache,
                                      routing=routing)
        logits.append(lg)
    return logits


def time_route(prefill, step, params, prompts, steps: int,
               extras=None, traced: bool = True) -> dict:
    """Warm times of one route: prefill ms (events, the mean of 2 after
    one, a fresh cache each), decode ms a step and tokens/s over
    ``steps`` greedy steps (events around the host loop), and
    (``traced``) the device time of a prefill and of a decode step from
    the profiler's trace, hence their busy and idle shares."""
    batch = {"tokens": prompts, **(extras or {})}
    # 2 timed prefills and 1 traced, for the command's time limit
    prefill_ms = cuda_ms(lambda: prefill(params, batch), iters=2,
                         warmup=1)
    last, cache = prefill(params, batch)
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        nxt, cache = step(params, cache, tok)
        tok = nxt[:, None]
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / steps
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
           "tokens_per_s": prompts.shape[0] * 1e3 / step_ms}
    if not traced:
        return out
    pprof = profile_device_ms(lambda: prefill(params, batch), iters=1)
    # the trace of 4 more steps (and 1 before it) on a fresh prefill's cache
    _, cache = prefill(params, batch)
    prof = profile_device_ms(lambda: step(params, cache, tok), iters=4)
    traced_shares(out, pprof["device_ms"], prof["device_ms"])
    out["decode_trace_records"] = prof["records"]
    return out


def traced_shares(times: dict, prefill_device_ms, decode_device_ms) -> None:
    """A prefill's and a decode step's device ms from a trace into
    ``time_route``'s ``times``, with their busy and idle shares."""
    pbusy = None if prefill_device_ms is None else \
        prefill_device_ms / times["prefill_ms"]
    busy = None if decode_device_ms is None else \
        decode_device_ms / times["decode_ms_per_step"]
    times.update(prefill_device_ms=prefill_device_ms,
                 prefill_idle=None if pbusy is None else 1.0 - pbusy,
                 decode_device_ms=decode_device_ms, decode_busy=busy,
                 decode_idle=None if busy is None else 1.0 - busy)


def serving_slice(device, card, report) -> dict:
    """Phase 16: serve Qwen3-0.6B at full width and depth through
    ``make_prefill_step``/``make_serve_step`` on the kernels, hold it
    against the plain route and a float32 forward, time both routes, and
    run ``serve_loop`` at its defaults on the card.  Returns the
    main-path launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import forward as F
    from repro_torch.launch import serve
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen3-0.6b")
    n = cfg.n_layers
    model, plain = Model(cfg), Model(cfg, impl=F.PLAIN)
    params = model.init(torch.Generator(device=device)
                        .manual_seed(SERVE_SEED))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            device=device, generator=torch.Generator(
                                device=device).manual_seed(SERVE_SEED + 1))
    max_len = SERVE_PROMPT + SERVE_GEN + 8
    steps = {name: (serve.make_prefill_step(m, None, max_len),
                    serve.make_serve_step(m, None))
             for name, m in (("kernels", model), ("plain", plain))}
    out = {"config": f"qwen3-0.6b, {n} layers, bf16, batch {SERVE_BATCH}, "
                     f"prompt {SERVE_PROMPT}, {SERVE_GEN} decode steps",
           "params": model.n_params()}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, launches = greedy(*steps["kernels"], params, prompts, SERVE_GEN,
                              count=("qwen3 bf16", serve_launches(cfg, True),
                                     serve_launches(cfg, False), "wgmma"))
    out["first_run_s"] = time.perf_counter() - t0
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launches
    out["launches_per_prefill"] = serve_launches(cfg, True)
    out["launches_per_decode_step"] = serve_launches(cfg, False)
    check(tokens.shape == (SERVE_BATCH, SERVE_GEN + 1) and
          bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"greedy tokens {tuple(tokens.shape)} misshapen or out of range")
    print(f"serving Qwen3-0.6B ({out['params']} parameters, bf16, batch "
          f"{SERVE_BATCH} x {SERVE_PROMPT} prompt tokens, {SERVE_GEN} "
          f"greedy steps) through make_prefill_step/make_serve_step: "
          f"launches a prefill {out['launches_per_prefill']} and a decode "
          f"step {out['launches_per_decode_step']}, every GEMM on wgmma, "
          f"held on the prefill and each of the {SERVE_GEN} steps; first "
          f"run {out['first_run_s']} s, peak memory "
          f"{out['peak_memory_gb']} GB  [{card}]")

    # the kernel route against the plain route, teacher-forced on the
    # kernel route's greedy tokens, from the same weights
    feed = tokens[:, :-1]
    got = teacher_forced(model, params, prompts, feed, max_len)
    want = teacher_forced(plain, params, prompts, feed, max_len)
    rels = [row_rel(g, w) for g, w in zip(got, want)]
    out["bf16_row_rel_prefill"] = rels[0]
    out["bf16_row_rel_decode_max"] = max(rels[1:])
    for i, r in enumerate(rels):
        check(r <= SERVE_BF16_ROW_REL, f"bf16 serving logits at step {i} "
              f"(0: the prefill) off the plain route by {r} (worst row, "
              f"relative), above {SERVE_BF16_ROW_REL}")
    forced = torch.stack([g.argmax(-1) for g in got[:-1]], dim=1)
    out["teacher_forced_equal_greedy"] = int((forced == tokens[:, :-1])
                                             .sum())
    check(out["teacher_forced_equal_greedy"] == tokens[:, :-1].numel(),
          "the kernel route's teacher-forced argmax differs from its own "
          "greedy tokens: the route is not deterministic")
    plain_tokens, _ = greedy(*steps["plain"], params, prompts, SERVE_GEN)
    out["greedy_agree"] = int((plain_tokens == tokens).sum())
    out["greedy_total"] = tokens.numel()
    # bf16 itself: both routes against a float32 plain prefill from the
    # same (bf16) weights
    p32 = tree_map(lambda t: t.float(), params)
    last32, _ = Model(cfg.replace(dtype=torch.float32), impl=F.PLAIN) \
        .prefill(p32, prompts, max_len)
    out["bf16_vs_f32_row_rel"] = {"kernels": row_rel(got[0], last32),
                                  "plain": row_rel(want[0], last32)}
    del got, want, last32
    print(f"  bf16 logits against the plain route (worst row, relative; "
          f"limit {SERVE_BF16_ROW_REL}): prefill {rels[0]}, decode steps "
          f"max {out['bf16_row_rel_decode_max']}; teacher-forced argmax "
          f"equal to the greedy tokens {out['teacher_forced_equal_greedy']}"
          f" of {feed.numel()}; greedy tokens of the two routes agree "
          f"{out['greedy_agree']} of {out['greedy_total']}; last prefill "
          f"logits against a float32 plain prefill: "
          f"{out['bf16_vs_f32_row_rel']}")

    # float32: prefill + decode against one forward of the same tokens
    m32 = Model(cfg.replace(dtype=torch.float32))
    total = SERVE_F32_PROMPT + SERVE_F32_STEPS
    ids = prompts[:, :total]
    with torch.inference_mode():
        full, _, _ = m32.forward(p32, ids)
    got32 = teacher_forced(m32, p32, ids[:, :SERVE_F32_PROMPT],
                           ids[:, SERVE_F32_PROMPT:], total + 8)
    errs = [float((g - full[:, SERVE_F32_PROMPT - 1 + i]).abs().max())
            for i, g in enumerate(got32)]
    out["f32_prefill_decode_vs_forward_max_abs"] = max(errs)
    out["f32_logits_max_abs"] = float(full.abs().max())
    check(max(errs) <= SERVE_F32_ABS, f"f32 prefill + decode off the "
          f"forward by {max(errs)}, above {SERVE_F32_ABS}")
    del full, got32, p32
    print(f"  float32, all {n} layers: prefill of {SERVE_F32_PROMPT} + "
          f"{SERVE_F32_STEPS} decode steps against one forward, max abs "
          f"err {max(errs)} (limit {SERVE_F32_ABS}; logits reach "
          f"{out['f32_logits_max_abs']})")

    out["times"] = {name: time_route(*steps[name], params, prompts,
                                     SERVE_GEN) for name in steps}
    for name, t in out["times"].items():
        print(f"  {name} route: prefill {t['prefill_ms']} ms (device "
              f"{t['prefill_device_ms']} ms, idle {t['prefill_idle']}); decode "
              f"{t['decode_ms_per_step']} ms a step ({t['tokens_per_s']} "
              f"tokens/s); one step's device time {t['decode_device_ms']} "
              f"ms ({t['decode_trace_records']} records of 4 steps), busy "
              f"{t['decode_busy']}, idle {t['decode_idle']}  [{card}]")

    # where a kernel-route prefill and decode step spend the device's time
    pre, step = steps["kernels"]
    batch = {"tokens": prompts}
    last, cache = pre(params, batch)
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    out["trace"] = {"prefill": profile_step(lambda: pre(params, batch),
                                            SERVE_KERNELS),
                    "decode step": profile_step(
                        lambda: step(params, cache, tok), SERVE_KERNELS)}
    del last, cache
    for name, t in out["trace"].items():
        print(f"  kernels route, one {name} in the profiler's trace: device "
              f"{t['device_ms']} ms, by part {t['parts_ms']} ms, records "
              f"{t['records']}  [{card}]")
        for kname, ms, count in t["top"][:6]:
            print(f"    {kname[:70]}: {ms} ms, {count} records")

    # the reference's demo at its defaults, full size, on the card
    logs = []
    (res, loop_launches, routes) = counted(
        "serve_loop", lambda: serve.serve_loop(
            "qwen3-0.6b", use_reduced=False, device=device,
            log=logs.append),
        {name: k + 15 * serve_launches(cfg, False)[name]
         for name, k in serve_launches(cfg, True).items()}, "mma")
    check(res["generated"].shape == (4, 16) and
          ((res["generated"] >= 0) & (res["generated"] < cfg.vocab_size))
          .all(), f"serve_loop tokens {res['generated'].shape}")
    out["serve_loop"] = {"elapsed_s": res["elapsed_s"], "log": logs[0],
                         "launches": loop_launches}
    print(f"  serve_loop('qwen3-0.6b', use_reduced=False) at its defaults "
          f"(batch 4, prompt 16, 16 tokens, float32): {logs[0]}; "
          f"launches {loop_launches}, every GEMM on mma  [{card}]")
    report["serving"] = out
    return {name: launches[name] + loop_launches[name] for name in launches}


# ---------------------------------------------------------------------------
# the LLM training slice: SmolLM-360M through launch/train.py at full
# width and depth
# ---------------------------------------------------------------------------

LLM_ARCH = "smollm-360m"
LLM_STEPS, LLM_BATCH, LLM_SEQ = 10, 8, 1024
LLM_CKPT_EVERY, LLM_STOP_AFTER = 5, 5
LLM_LR = 3e-3                     # the trainer's command line default
LLM_SEED = 2026
# One step of the kernel route against the plain route (Model(cfg,
# impl=PLAIN), autograd through the plain versions) from the same
# weights and batch: relative error of the loss and of the gradient norm,
# and the worst leaf's relative Frobenius error of its gradient and of
# its updated value.  Set before the first chip run, between what
# float32 GEMMs summed in another order and GEMMs rounded to bfloat16
# (the control, ``LLM_CONTROL_BITS``) moved in a CPU proxy of the step;
# the phase prints the kernel route's and the control's readings.
LLM_STEP_REL = {"loss": 1e-6, "grad_norm": 1e-5, "grad": 1e-3,
                "param": 1e-3}
LLM_CONTROL_BITS = 7              # bfloat16's explicit mantissa bits
# The resumed run's losses against the uninterrupted run's: the limit of
# tests/test_checkpoint.py (rtol = atol = 2e-4).
LLM_RESUME_TOL = 2e-4
LLM_KERNELS = STEP_KERNELS[:1] + (("attention", ("flash_fwd",)),
                                  ("add+norm", ("addnorm<",)))


def conditioned(params: dict) -> dict:
    """``params`` with every attention's projections (self-, cross- and
    an encoder's) rescaled to a standard deviation of 1/sqrt(their whole
    fan-in): wq, wk, wv (d, heads, hd) by sqrt(heads / d), wo (heads,
    hd, d) by 1/sqrt(heads).  The reference's init takes the fan-in from
    the heads axis (shape[-2]), which saturates the softmax (SmolLM's
    step turns chaotic, whisper's attention logits reach hundreds)."""
    import math
    if not isinstance(params, dict):
        return params
    out = {k: conditioned(v) for k, v in params.items()}
    if {"wq", "wk", "wv", "wo"} <= set(params):
        for w in ("wq", "wk", "wv"):
            out[w] = params[w] * math.sqrt(params[w].shape[-2]
                                           / params[w].shape[-3])
        out["wo"] = params["wo"] / math.sqrt(params["wo"].shape[-3])
    return out


class KeepGrads:
    """An optimizer that keeps the gradients it is handed."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def llm_adamw():
    """AdamW at ``train_loop``'s schedule for ``LLM_STEPS`` steps."""
    from repro_torch.optim import AdamW, cosine_schedule
    return AdamW(schedule=cosine_schedule(
        LLM_LR, warmup=max(2, LLM_STEPS // 10), total=LLM_STEPS))


def held_step(cfg, impl, params, batch, count=False, routing=None):
    """One ``make_train_step`` step of ``Model(cfg, impl=impl)`` from
    ``params`` (``llm_adamw``): the loss, gradient norm, step ms by
    events, gradients and updated parameters; with ``count`` the
    launches and GEMM routes of
    the step, every counter set to 0 just before it.  ``routing``
    records or replays the MoE choices (``Model.loss``)."""
    from functools import partial
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    model = Model(cfg, impl=impl)
    if routing is not None:
        model = SimpleNamespace(loss=partial(model.loss, routing=routing))
    opt = KeepGrads(llm_adamw())
    p = train.trainable(params)
    state = {"params": p, "opt": opt.init(p)}
    step = train.make_train_step(model, opt, None)
    if count:
        zero_counters()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    new, metrics = step(state, batch)
    stop.record()
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "ms": start.elapsed_time(stop)}
    if count:
        out["launches"] = {n: c.launches for n, c in _counters().items()}
        out["routes"] = dict(_routes())
    out["grads"] = dict(leaf_items(opt.grads))
    out["params"] = {k: v.detach() for k, v in leaf_items(new["params"])}
    return out


def on_host(step: dict) -> dict:
    """``held_step``'s gradients and updated parameters moved to the
    host, so that the next route's step has the card to itself
    (recurrentgemma's step peaks at 78 GB)."""
    for part in ("grads", "params"):
        step[part] = {k: v.to("cpu") for k, v in step[part].items()}
    return step


def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| (Frobenius), in float64 on the card a block
    of rows at a time (a float64 copy of recurrentgemma's 1.05 B-entry
    embedding would take 8.4 GB), each block moved there as it is."""
    g = got.reshape(got.shape[0] if got.dim() else 1, -1)
    w = want.reshape(g.shape)
    rows = max(1, (1 << 25) // max(1, g.shape[1]))
    num = den = 0.0
    for i in range(0, g.shape[0], rows):
        gi = g[i:i + rows].to(CARD).double()
        wi = w[i:i + rows].to(CARD).double()
        num += float(((gi - wi) ** 2).sum())
        den += float((wi ** 2).sum())
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return (num / den) ** 0.5


def step_errors(got: dict, want: dict) -> dict:
    """Relative errors of ``got``'s step against ``want``'s: loss, norm,
    and the worst leaf of the gradients and of the updated parameters."""
    out = {k: abs(got[k] - want[k]) / abs(want[k])
           for k in ("loss", "grad_norm")}
    for part, key in (("grads", "grad"), ("params", "param")):
        errs = {name: rel_fro(got[part][name], want[part][name])
                for name in want[part]}
        worst = max(errs, key=errs.get)
        out[key], out[f"{key}_worst"] = errs[worst], worst
        out[f"{key}_median"] = sorted(errs.values())[len(errs) // 2]
    return out


def hold_step(cfg, params, batch, per_step: dict, label: str) -> tuple:
    """One step of the kernel route (``ops.differentiable``, its launches
    held to ``per_step`` and every GEMM on `mma`) against the plain route
    from the same weights and batch, by the loss, gradient norm, every
    gradient and every updated parameter (``LLM_STEP_REL``), and a
    control whose GEMMs are rounded to bfloat16 held to fail each limit;
    a MoE model's plain route and control on the kernel route's expert
    choices (``models.moe.Routing``), with the share of (token, layer)
    choices the plain route's own forward makes otherwise.  Returns the
    numbers and the kernel inputs of the step (``RecordingOps``, kept on
    the host)."""
    from repro_torch.kernels import forward as F
    from repro_torch.kernels import ops
    from repro_torch.models.moe import Routing
    from repro_torch.models.transformer import Model
    moe = cfg.n_experts > 0
    chosen = Routing() if moe else None
    rec = RecordingOps(host=True)
    rec.model = label
    kern = on_host(held_step(cfg, ops.differentiable(rec), params, batch,
                             count=True, routing=chosen))
    rec.model = None
    held_launches(label, kern, per_step)
    out = {"launches": kern["launches"]}
    pinned = chosen.pinned if moe else (lambda: None)
    plain = held_step(cfg, F.PLAIN, params, batch, routing=pinned())
    out["step_vs_plain"] = e = step_errors(kern, plain)
    del kern
    plain = on_host(plain)
    control = held_step(cfg, ops.differentiable(control_plain(
        rounded_plain(LLM_CONTROL_BITS).matmul, F.PLAIN)), params, batch,
        routing=pinned())
    out["control_vs_plain"] = c = step_errors(control, plain)
    del control, plain
    for key, limit in LLM_STEP_REL.items():
        check(e[key] <= limit, f"{label} off the plain route: {key} "
              f"{e[key]} (relative; {e.get(key + '_worst', '')}), limit "
              f"{limit}")
        check(c[key] > limit, f"{label}: bf16 control within the {key} "
              f"limit {limit}: {c[key]}")
    if moe:
        free = Routing()
        with torch.no_grad():
            Model(cfg, impl=F.PLAIN).loss(params, batch, routing=free)
        flips, total = routing_flips(chosen, free)
        out["routing_unpinned"] = {"differs": flips, "of": total,
                                   "share": flips / total}
        del free
    return out, rec


def phased_step(model, opt, state, batch):
    """``make_train_step``'s work with a device sleep (``spin_kernel`` in
    the trace) between the forward, the backward and the update."""
    from repro_torch.launch import train
    from repro_torch.models.common import tree_map
    params = state["params"]
    loss, _ = model.loss(params, batch)
    torch.cuda._sleep(1000)
    grads = iter(torch.autograd.grad(loss, train.leaves(params)))
    grads = tree_map(lambda _: next(grads), params)
    torch.cuda._sleep(1000)
    with torch.no_grad():
        opt.update(grads, state["opt"], params)


def profile_phases(fn) -> dict:
    """Device ms of one call of ``fn`` from the profiler's trace, by
    phase (the records between ``spin_kernel``s, in start order: forward,
    backward, update) and by kernel group within each (``LLM_KERNELS``
    and the rest), the sleeps themselves excluded; and the device ms of
    the kernels inside the layer groups' recomputes (``models/remat.py``'s
    span; 0 without remat)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from repro_torch.models.remat import RECOMPUTE_SPAN
    cuda = torch.autograd.DeviceType.CUDA
    # the layer groups' recomputes (a remat step): the kernels launched
    # inside their spans; the spans' own device-side records are not
    # kernels
    recompute = sum(e.device_time_total for e in prof.events()
                    if e.name == RECOMPUTE_SPAN and e.device_type != cuda)
    evts = sorted((e for e in prof.events()
                   if e.device_type == cuda and e.name != RECOMPUTE_SPAN),
                  key=lambda e: e.time_range.start)
    phases, records = [{}], [0]
    for evt in evts:
        if "spin_kernel" in evt.name:
            phases.append({})
            records.append(0)
            continue
        part = next((p for p, keys in LLM_KERNELS
                     if any(k in evt.name for k in keys)), "other")
        phases[-1][part] = phases[-1].get(part, 0.0) + \
            evt.device_time_total / 1e3
        records[-1] += 1
    names = ("forward", "backward", "update")
    if len(phases) != 3:       # the sleeps were not in the trace
        return {"device_ms": sum(sum(p.values()) for p in phases),
                "phases": None, "records": records,
                "recompute_device_ms": recompute / 1e3}
    return {"device_ms": sum(sum(p.values()) for p in phases),
            "phases": dict(zip(names, phases)),
            "records": dict(zip(names, records)),
            "recompute_device_ms": recompute / 1e3}


def llm_gemm_shapes(cfg, batch: int, seq: int) -> list:
    """``(m, k, n, count)`` of the step's forward GEMMs: the layers' q, k,
    v, o, gate, up and down at ``batch * seq`` rows, the head at
    ``batch * (seq - 1)``."""
    rows, d, f = batch * seq, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    n = cfg.n_layers
    return [(rows, d, q, n), (rows, d, kv, 2 * n), (rows, q, d, n),
            (rows, d, f, 2 * n), (rows, f, d, n),
            (batch * (seq - 1), d, cfg.vocab_size, 1)]


def time_llm_gemms(cfg, device) -> dict:
    """Device ms of the step's GEMMs by phase, each shape timed alone
    (queued) through ``ops.matmul`` and ``torch.matmul`` on seeded float32
    operands: fwd (m, k) @ (k, n), dX (m, n) @ (n, k), dW (k, m) @ (m, n);
    summed over the step's count of each."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(LLM_SEED + 3)
    out = {f"{lib} {p}": 0.0 for lib in ("kernel", "torch")
           for p in ("fwd", "dX", "dW")}
    for m, k, n, count in llm_gemm_shapes(cfg, LLM_BATCH, LLM_SEQ):
        for phase, (r, inner, c) in (("fwd", (m, k, n)), ("dX", (m, n, k)),
                                     ("dW", (k, m, n))):
            a = torch.randn((r, inner), generator=gen, device=device)
            b = torch.randn((inner, c), generator=gen, device=device) \
                * inner ** -0.5
            out[f"kernel {phase}"] += count * queued_ms(
                lambda: ops.matmul(a, b), iters=3, warmup=1)
            out[f"torch {phase}"] += count * queued_ms(
                lambda: torch.matmul(a, b), iters=3, warmup=1)
            del a, b
    return out


def time_plain_backwards(cfg, device) -> dict:
    """Device ms of one step's plain backwards, each timed alone (queued)
    on seeded inputs of the step's shapes: attention's (the recomputed
    ``flash_attention_ref`` and its gradients) times n, add+norm's times
    2n + 1."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(LLM_SEED + 4)
    n, b, s, d = cfg.n_layers, LLM_BATCH, LLM_SEQ, cfg.d_model

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q = rn(b * cfg.n_heads, s, cfg.hd).requires_grad_()
    k, v = (rn(b * cfg.n_kv_heads, s, cfg.hd).requires_grad_()
            for _ in range(2))
    dout = rn(*q.shape)

    def attn():
        torch.autograd.grad(ref.flash_attention_ref(
            q, k, v, cfg.n_heads, cfg.n_kv_heads, True, 0), (q, k, v), dout)
    x, r = (rn(b * s, d).requires_grad_() for _ in range(2))
    sc = (rn(d) + 1.0).requires_grad_()
    dy, dres = rn(b * s, d), rn(b * s, d)

    def addnorm():
        torch.autograd.grad(ref.fused_add_rmsnorm_ref(x, r, sc),
                            (x, r, sc), (dy, dres))
    return {"attention": n * queued_ms(attn, iters=3, warmup=1),
            "add+norm": (2 * n + 1) * queued_ms(addnorm, iters=5, warmup=1)}


def time_llm_route(cfg, impl, params, batch, timed: int = 3,
                   profiled: bool = True) -> dict:
    """Warm steps of one route from ``params``: each step's ms by CUDA
    events (the median of ``timed`` after one; of 2, the slower),
    tokens/s, the peak memory of those steps, and (``profiled``) one
    phased step's device time from the profiler's trace, hence the idle
    share."""
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    model = Model(cfg, impl=impl)
    opt = llm_adamw()
    step = train.make_train_step(model, opt, None)
    p = train.trainable(params)
    state = {"params": p, "opt": opt.init(p)}
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(timed + 1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        if i:
            ms.append(start.elapsed_time(stop))
    step_ms = sorted(ms)[len(ms) // 2]
    out = {"step_ms": step_ms, "steps_ms": ms,
           "tokens_per_s": batch["tokens"].numel() * 1e3 / step_ms,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not profiled:
        return out
    trace = profile_phases(lambda: phased_step(model, opt, state, batch))
    out.update(trace)
    out["idle_share"] = 1.0 - trace["device_ms"] / out["step_ms"] \
        if trace["device_ms"] else None
    return out


def train_run(what: str, arch: str, steps: int, per_step: dict, kw: dict,
              **extra) -> tuple:
    """``train_loop(arch, **kw, **extra)`` for ``steps`` steps with every
    counter set to 0 just before it and read just after: ``steps`` x
    ``per_step`` launches, every GEMM on `mma`, ``steps`` finite losses.
    Returns the result (with the gradient norms its log printed), the
    wall seconds, the launches and the GEMM routes."""
    from repro_torch.launch import train
    zero_counters()
    logs = []
    t0 = time.perf_counter()
    res = train.train_loop(arch, log=logs.append, **kw, **extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["grad_norms"] = [float(ln.split(" gnorm ")[1].split()[0])
                         for ln in logs if " gnorm " in ln]
    got = {name: c.launches for name, c in _counters().items()}
    for name, c in got.items():
        want = steps * per_step.get(name, 0)
        check(c == want, f"{what}: {name} launched {c} times, expected "
              f"{want} ({steps} steps)")
    routes = dict(_routes())
    check(routes["mma"] == got["matmul"] and routes["wgmma"] == 0,
          f"{what}: matmul routes {routes}, expected every GEMM on mma")
    check(len(res["losses"]) == steps and all(np.isfinite(res["losses"])),
          f"{what}: losses {res['losses']} not {steps} finite values")
    return res, wall, got, routes


def add_launches(total: dict, more: dict) -> None:
    for name, n in more.items():
        total[name] = total.get(name, 0) + n


def report_losses(out: dict, res: dict) -> None:
    """The run's losses and gradient norms into ``out``, and whether the
    mean of the last 3 losses is below the first 3's."""
    losses = res["losses"]
    out.update(losses=losses, grad_norms=res["grad_norms"],
               first3=float(np.mean(losses[:3])),
               last3=float(np.mean(losses[-3:])))
    out["lowered"] = out["last3"] < out["first3"]
    print(f"  losses {losses}")
    print(f"  gradient norms before clipping {res['grad_norms']}")
    print(f"  mean of the last 3 {out['last3']} below the first 3 "
          f"{out['first3']}: {out['lowered']}")


def train_and_resume(arch: str, per_step: dict, kw: dict, every: int,
                     stop_after: int, card: str, out: dict) -> dict:
    """``train_loop`` of ``kw["steps"]`` steps with a checkpoint every
    ``every`` steps in a temporary directory (launches held, every GEMM
    on `mma`), the last checkpoint read back bit for bit; then a run
    stopped after ``stop_after`` steps and resumed from its checkpoint,
    its losses held against the uninterrupted run's (``LLM_RESUME_TOL``).
    Fills ``out``; returns the launches of the three runs."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    steps = kw["steps"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    launches = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        full, wall, got, routes = train_run(
            f"{arch} train_loop", arch, steps, per_step, kw,
            ckpt_dir=str(tmp / "full"), ckpt_every=every)
        add_launches(launches, got)
        out.update(train_loop_s=wall, routes=routes,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"training {out['config']} ({out['params']} parameters) "
              f"through train_loop on the kernels: {wall} s, peak memory "
              f"{out['peak_memory_gb']} GB; launches a step {per_step} "
              f"held over the run, every GEMM on mma  [{card}]")
        report_losses(out, full)
        losses = full["losses"]
        # the saved checkpoint, read back by the port's loader
        mgr = CheckpointManager(str(tmp / "full"))
        check(mgr.all_steps() == list(range(every, steps + 1, every)),
              f"checkpoints {mgr.all_steps()}")
        saved, extra = mgr.restore(steps, full["state"])
        same = [torch.equal(a, b.detach()) for (_, a), (_, b) in zip(
            leaf_items(saved), leaf_items(full["state"]))]
        check(all(same) and extra["train_step"] == steps,
              f"checkpoint {steps} restored other bits in "
              f"{same.count(False)} of {len(same)} leaves")
        out["checkpoint_leaves_equal"] = len(same)
        final = full["state"]
        del full, saved
        shutil.rmtree(tmp / "full")

        # preempted after stop_after steps, then resumed
        part1, wall1, got, _ = train_run(
            f"{arch} train_loop, stopped", arch, stop_after, per_step, kw,
            ckpt_dir=str(tmp / "resumed"), ckpt_every=every,
            stop_after=stop_after)
        add_launches(launches, got)
        part2, wall2, got, _ = train_run(
            f"{arch} train_loop, resumed", arch, steps - stop_after,
            per_step, kw, ckpt_dir=str(tmp / "resumed"), ckpt_every=every)
        add_launches(launches, got)
        got, want = np.array(part2["losses"]), np.array(losses[stop_after:])
        out["resume_max_abs"] = float(np.abs(got - want).max())
        out["resume_losses_equal"] = bool((got == want).all())
        out["resume_state_equal"] = all(
            torch.equal(a.detach(), b.detach()) for (_, a), (_, b) in zip(
                leaf_items(part2["state"]), leaf_items(final)))
        check(part1["losses"] == losses[:stop_after],
              "the stopped run's losses differ from the first steps")
        check(np.allclose(got, want, rtol=LLM_RESUME_TOL,
                          atol=LLM_RESUME_TOL),
              f"resumed losses {got.tolist()} off the uninterrupted run's "
              f"{want.tolist()}")
        print(f"  stopped after {stop_after} steps ({wall1} s) and resumed "
              f"from the checkpoint ({wall2} s): steps {stop_after + 1}-"
              f"{steps} max abs difference {out['resume_max_abs']} (limit "
              f"{LLM_RESUME_TOL}), losses equal "
              f"{out['resume_losses_equal']}, final state equal "
              f"{out['resume_state_equal']}; checkpoint {steps} read back "
              f"bit for bit ({len(same)} leaves)")
        del part1, part2, final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def print_step_hold(step: dict, per_step: dict) -> None:
    def brief(errs):
        return {k: v for k, v in errs.items() if not k.endswith("median")}
    print(f"  one step (launches {per_step}, held) against the plain route "
          f"from the same conditioned weights (limits {LLM_STEP_REL}): "
          f"{brief(step['step_vs_plain'])}; the control (GEMMs rounded to "
          f"{LLM_CONTROL_BITS} mantissa bits): "
          f"{brief(step['control_vs_plain'])}"
          + (f"; unpinned, the plain route's forward chooses other experts "
             f"for {step['routing_unpinned']['differs']} of "
             f"{step['routing_unpinned']['of']} (token, layer) pairs "
             f"({step['routing_unpinned']['share']})"
             if "routing_unpinned" in step else ""))


def print_route_times(times: dict, card: str) -> None:
    for name, t in times.items():
        print(f"  {name} route: step {t['step_ms']} ms (median of "
              f"{t['steps_ms']}), {t['tokens_per_s']} tokens/s"
              + (f", model FLOPs {t['flop_share_of_f32_peak']} of the "
                 f"float32 peak" if "flop_share_of_f32_peak" in t else "")
              + (f"; one step's device time {t['device_ms']} ms (the "
                 f"layers' recompute {t['recompute_device_ms']}), idle "
                 f"{t['idle_share']}" if "device_ms" in t else
                 "; not profiled")
              + f"; peak memory {t['peak_memory_gb']} GB  [{card}]")
        if "phases" in t:
            print(f"    by phase (ms): {t['phases']}; records "
                  f"{t['records']}")


def step_batch(cfg, batch: int, seq: int, device) -> dict:
    """The token pipeline's first batch (seed ``LLM_SEED``) on the card."""
    from repro_torch.data.pipeline import TokenPipeline
    tokens = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=LLM_SEED
                           ).batch_at(0)["tokens"]
    return {"tokens": torch.from_numpy(tokens).to(device)}


def training_llm_slice(device, card, report) -> dict:
    """Phase 17: train SmolLM-360M at full width and depth through
    ``train_loop`` on the kernels (launches held), resume it from a
    checkpoint against the uninterrupted run, hold one step against the
    plain route with a control, hold each kernel on the step's inputs,
    and time the step.  Returns the main-path launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import forward as F
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    cfg = get_config(LLM_ARCH).replace(dtype=torch.float32, remat=False)
    n = cfg.n_layers
    per_step = train_launches(cfg)
    out = {"config": f"{LLM_ARCH}, {n} layers, d {cfg.d_model}, float32, "
                     f"batch {LLM_BATCH} x {LLM_SEQ}, {LLM_STEPS} AdamW "
                     f"steps at lr {LLM_LR}",
           "params": Model(cfg).n_params(), "launches_per_step": per_step}
    kw = dict(use_reduced=False, steps=LLM_STEPS, batch=LLM_BATCH,
              seq=LLM_SEQ, lr=LLM_LR, seed=LLM_SEED, device=device)
    launches = train_and_resume(LLM_ARCH, per_step, kw, LLM_CKPT_EVERY,
                                LLM_STOP_AFTER, card, out)

    # one step against the plain route, from conditioned weights
    params = conditioned(Model(cfg).init(
        torch.Generator(device=device).manual_seed(LLM_SEED)))
    batch = step_batch(cfg, LLM_BATCH, LLM_SEQ, device)
    step, rec = hold_step(cfg, params, batch, per_step,
                          "smollm-360m training step f32")
    add_launches(launches, step["launches"])
    out.update(step_vs_plain=step["step_vs_plain"],
               control_vs_plain=step["control_vs_plain"])
    print_step_hold(step, per_step)
    held = Held()
    hold_recorded(held, rec, "smollm-360m training step f32")
    out["kernel_checks"] = {name: held.cases[name] for name in per_step}
    print(f"  each kernel on the step's inputs against its plain version: "
          + ", ".join(f"{name} {len(held.cases[name])} shapes, max abs err "
                      f"{held.max_err(name)}" for name in per_step))

    # time it
    init = Model(cfg).init(torch.Generator(device=device)
                           .manual_seed(LLM_SEED))
    out["times"] = {
        "kernels": time_llm_route(cfg, ops.differentiable(), init, batch),
        "plain": time_llm_route(cfg, F.PLAIN, init, batch)}
    out["gemm_alone_ms"] = time_llm_gemms(cfg, device)
    out["plain_backward_alone_ms"] = time_plain_backwards(cfg, device)
    tokens_n = LLM_BATCH * LLM_SEQ
    attn = 6 * LLM_BATCH * cfg.n_heads * LLM_SEQ ** 2 * cfg.hd * n
    out["model_flop"] = 6 * out["params"] * tokens_n + attn
    for t in out["times"].values():
        t["flop_share_of_f32_peak"] = out["model_flop"] / (
            t["step_ms"] / 1e3) / SCALAR_OPS_PER_S
    print_route_times(out["times"], card)
    print(f"  the step's GEMMs, each shape alone (queued ms): "
          f"{out['gemm_alone_ms']}; plain backwards alone: "
          f"{out['plain_backward_alone_ms']}  [{card}]")
    out["launches"] = launches
    out["held"] = {name: (len(held.cases[name]), held.max_err(name))
                   for name in per_step}
    report["training_llm"] = out
    return out


# ---------------------------------------------------------------------------
# the mixers' training step: granite-moe-1b, mamba2-130m and
# recurrentgemma-9b through launch/train.py on the card
# ---------------------------------------------------------------------------

# (arch, layers (None: all), batch, seq, remat policy (None: remat off)),
# each in float32 at LLM_LR from seed LLM_SEED.  granite at 8 x 1024 under
# remat_policy "full": without remat its step keeps 63 GB of activations
# (2.7 GB a layer: the expert products and the one-hot dispatch and
# combine) beside its 21 GB of parameters, gradients and moments, 79 GB
# by the meta reckoning, past the card; with it the layers keep their
# (x, pending) carries and one layer's recompute.  recurrentgemma at one
# period of its pattern, (rglru, rglru, attn): 1.705 B parameters, 27 GB
# of AdamW state (the 38 layers' 9.396 B would take 150 GB), at 4 x 2048,
# so that a sequence spans its whole window.
MIXER_TRAIN = (("granite-moe-1b-a400m", None, 8, 1024, "full"),
               ("mamba2-130m", None, 8, 1024, None),
               ("recurrentgemma-9b", 3, 4, 2048, None))
MIXER_TRAIN_STEPS = 4
# mamba2's run is stopped after MIXER_STOP_AFTER steps and resumed from
# its checkpoint (1.5 GB a save; granite's would be 16 GB, and granite
# and recurrentgemma run make_train_step directly: train_loop takes no
# depth and sets remat off)
MIXER_RESUMED, MIXER_STOP_AFTER = "mamba2-130m", 2
# warm steps each route is timed over (after one), where phase 17 takes 3
MIXER_TIMED_STEPS = 2
# the policies a remat model's step runs under, two steps each from the
# same weights and batch (``hold_policies``); the first is its run's
REMAT_POLICIES = ("full", "save_dots", "save_mixer")
# a remat model's rows where its step without remat fits the card too
# (granite at 4 x 1024: its batch before it trained under remat), for
# the run through ``train_loop`` (which sets remat off) and the
# gradients held bit-equal with and without remat (``hold_remat_off``)
REMAT_OFF_BATCH, REMAT_OFF_STEPS = 4, 2
CARD_GB = 80.0


def start_train_reckoning(arch: str, policy: str, batch: int, seq: int,
                          out_path: str):
    """``dry_reckoning`` of a float32 training step of ``arch`` under
    ``policy`` at ``batch`` x ``seq`` on the meta device, in a process of
    its own that sees no card (granite's takes about 20 s of CPU, which
    it spends while the card trains); its JSON to ``out_path``."""
    code = ("import json, sys, torch; sys.path.insert(0, 'src'); "
            "import chip_smoke as S; "
            "from repro_torch.configs import get_config; "
            "arch, policy, b, s, path = sys.argv[1:]; "
            "cfg = get_config(arch).replace(dtype=torch.float32, "
            "remat=True, remat_policy=policy); "
            "open(path, 'w').write(json.dumps(S.dry_reckoning("
            "cfg, 'train', int(b), int(s))))")
    return subprocess.Popen(
        [sys.executable, "-c", code, arch, policy, str(batch), str(seq),
         out_path], cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def train_reckoning(proc, out_path: str) -> dict:
    """The reckoning ``start_train_reckoning`` started, waited for."""
    _, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"the meta reckoning failed: {err[-2000:]}")
    return json.loads(Path(out_path).read_text())


class RecomputeEvents:
    """A ``Model.recompute_span``: ``models.remat``'s profiler span with a
    pair of CUDA events around it, one pair a layer group's recompute;
    ``ms()`` is their summed stream time."""

    def __init__(self):
        self.pairs = []

    @contextmanager
    def span(self):
        from repro_torch.models import remat
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        with remat.recompute_span():
            pair[0].record()
            try:
                yield
            finally:
                pair[1].record()
                self.pairs.append(pair)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def held_launches(label: str, step: dict, want: dict) -> None:
    """``held_step(count=True)``'s launches equal to ``want``, every GEMM
    on `mma`."""
    for name, n in step["launches"].items():
        check(n == want.get(name, 0), f"{label}: {name} launched {n} "
              f"times, expected {want.get(name, 0)}")
    check(step["routes"]["mma"] == want["matmul"], f"{label}: matmul "
          f"routes {step['routes']}, expected every GEMM on mma")


def grads_differ(got: dict, want: dict) -> list:
    return [k for k, v in got.items() if not torch.equal(v, want[k])]


def hold_policies(cfg, params, batch, card) -> dict:
    """Two steps of the kernel route under each of ``REMAT_POLICIES``, on
    one model and state from ``params``, both on ``batch`` (``counted``:
    each step's launches held to that policy's ``train_launches``, every
    GEMM on `mma`): the first step's gradients bit-equal to the first
    policy's (the LLM kernels have no atomics; those are kept on the
    card), the second timed warm: its ms by events, its recomputes'
    summed ms (``RecomputeEvents``), and its peak memory less the kept
    gradients."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    out, first, kept = {}, None, 0
    for policy in REMAT_POLICIES:
        c = cfg.replace(remat=True, remat_policy=policy)
        want = train_launches(c)
        label = f"{cfg.name} step under {policy}"
        timer = RecomputeEvents()
        opt = KeepGrads(llm_adamw())
        p = train.trainable(params)
        state = {"params": p, "opt": opt.init(p)}
        del p
        step = train.make_train_step(Model(c, impl=ops.differentiable(),
                                           recompute_span=timer.span),
                                     opt, None)
        torch.cuda.empty_cache()
        (state, metrics), got, _ = counted(
            label, lambda: step(state, batch), want, "mma")
        grads, opt.grads = dict(leaf_items(opt.grads)), None
        rec = {"loss": float(metrics["loss"]), "launches": got}
        if first is None:
            first = grads
            kept = sum(g.numel() * g.element_size() for g in first.values())
        else:
            differ = grads_differ(grads, first)
            rec["grads_bit_equal"] = not differ
            check(not differ, f"{label}: {len(differ)} of {len(first)} "
                  f"gradients differ from {REMAT_POLICIES[0]}'s, e.g. "
                  f"{differ[:3]}")
        del grads, metrics
        timer.pairs.clear()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)

        def warm():
            start.record()
            res = step(state, batch)
            stop.record()
            return res
        (state, _), again, _ = counted(f"{label}, warm", warm, want, "mma")
        add_launches(rec["launches"], again)
        torch.cuda.synchronize()
        rec.update(step_ms=start.elapsed_time(stop),
                   recompute_ms=timer.ms(), recomputes=len(timer.pairs),
                   peak_memory_gb=(torch.cuda.max_memory_allocated()
                                   - kept) / 1e9)
        check(rec["recomputes"] == cfg.n_layers // len(cfg.pattern),
              f"{label}: {rec['recomputes']} group recomputes")
        del step, state, opt
        out[policy] = rec
        print(f"  {label}: launches {want} held on each of two steps; the "
              f"warm step {rec['step_ms']} ms, recompute "
              f"{rec['recompute_ms']} ms by events over "
              f"{rec['recomputes']} groups, peak {rec['peak_memory_gb']} GB"
              + (f"; the first step's gradients bit-equal to "
                 f"{REMAT_POLICIES[0]}'s: {rec['grads_bit_equal']}"
                 if "grads_bit_equal" in rec else "") + f"  [{card}]")
    del first
    torch.cuda.empty_cache()
    return out


def hold_remat_off(cfg, params, batch, card) -> dict:
    """One step of the kernel route with remat off and one under
    ``cfg.remat_policy``, from ``params`` on ``batch``'s first
    ``REMAT_OFF_BATCH`` rows (``held_step``): each step's launches held
    to its ``train_launches``, every GEMM on `mma`, and every gradient
    bit-equal across the two (the recompute makes the forward's values
    again; a fault of ``models/remat.py`` that moved the kernel route
    and its plain reference alike, which ``hold_step`` runs under the
    same policy, shows here)."""
    from repro_torch.kernels import ops
    rows = {"tokens": batch["tokens"][:REMAT_OFF_BATCH]}
    out, first = {}, None
    for name, c in (("off", cfg.replace(remat=False)),
                    (cfg.remat_policy, cfg)):
        label = f"{cfg.name} step at {REMAT_OFF_BATCH} rows, remat {name}"
        want = train_launches(c)
        step = held_step(c, ops.differentiable(), params, rows, count=True)
        held_launches(label, step, want)
        out[name] = {"launches": step["launches"], "ms": step["ms"],
                     "loss": step["loss"]}
        if first is None:
            first = step["grads"]
        else:
            differ = grads_differ(step["grads"], first)
            out["grads_bit_equal"] = not differ
            check(not differ, f"{label}: {len(differ)} of {len(first)} "
                  f"gradients differ from the step without remat, e.g. "
                  f"{differ[:3]}")
        del step
    del first
    torch.cuda.empty_cache()
    print(f"  {cfg.name} at {REMAT_OFF_BATCH} x "
          f"{rows['tokens'].shape[1]}: one step with remat off (launches "
          f"{out['off']['launches']}) and one under {cfg.remat_policy} "
          f"(launches {out[cfg.remat_policy]['launches']}), held; every "
          f"gradient bit-equal: {out['grads_bit_equal']}  [{card}]")
    return out


def train_steps(cfg, batch: int, seq: int, steps: int, per_step: dict,
                device) -> tuple:
    """``steps`` steps of ``make_train_step`` on ``Model(cfg,
    impl=ops.differentiable())`` (AdamW at ``train_loop``'s schedule, the
    token pipeline's batches), each step's launches held to ``per_step``
    with every GEMM on `mma`.  Returns the losses, gradient norms and
    wall seconds."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, cosine_schedule
    model = Model(cfg, impl=ops.differentiable())
    opt = AdamW(schedule=cosine_schedule(LLM_LR, warmup=max(2, steps // 10),
                                         total=steps))
    params = train.trainable(model.init(
        torch.Generator(device=device).manual_seed(LLM_SEED)))
    state = {"params": params, "opt": opt.init(params)}
    del params
    step = train.make_train_step(model, opt, None)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=LLM_SEED)
    losses, norms, secs = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        t1 = time.perf_counter()
        tokens = {"tokens": torch.from_numpy(pipe.batch_at(i)["tokens"])
                  .to(device)}
        (state, metrics), _, _ = counted(
            f"{cfg.name} step {i}", lambda: step(state, tokens), per_step,
            "mma")
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        secs.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    return {"losses": losses, "grad_norms": norms, "steps_s": secs}, wall


def train_mixer(arch, layers, batch, seq, policy, device, card,
                held) -> dict:
    """Phase 19 for one model: its training run (``train_loop`` at full
    depth with a resumed run for ``MIXER_RESUMED``; else
    ``make_train_step``, under ``policy``'s remat where it has one, with
    the peak beside the meta reckoning), one step held against the plain
    route with a control, each kernel on the step's inputs, a remat
    model's step under each of ``REMAT_POLICIES``, and both routes
    timed."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import forward as F
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    cfg = get_config(arch).replace(dtype=torch.float32,
                                   remat=policy is not None,
                                   remat_policy=policy or "full")
    if layers:
        cfg = cfg.replace(n_layers=layers)
    per_step = train_launches(cfg)
    # a remat model's run (granite: 8 x 1024 with its recompute) takes 2
    # steps and its routes one timed step each, for the command's limit
    steps = 2 if policy else MIXER_TRAIN_STEPS
    timed = 1 if policy else MIXER_TIMED_STEPS
    remat = f", remat {policy}" if policy else ""
    out = {"config": f"{arch}, {cfg.n_layers} layers, d {cfg.d_model}, "
                     f"float32, batch {batch} x {seq}, {steps} AdamW steps "
                     f"at lr {LLM_LR}{remat}",
           "params": Model(cfg).n_params(), "launches_per_step": per_step,
           "steps": steps}
    kw = dict(use_reduced=False, steps=steps, batch=batch, seq=seq,
              lr=LLM_LR, seed=LLM_SEED, device=device)
    launches = {}
    out["seconds"] = {}
    proc = tmp = None
    t0 = time.perf_counter()
    if arch == MIXER_RESUMED:
        add_launches(launches, train_and_resume(
            arch, per_step, kw, MIXER_STOP_AFTER, MIXER_STOP_AFTER, card,
            out))
    else:
        # the meta reckoning runs on the CPU while the card trains and
        # holds the step; it is read before the policies are timed
        tmp = tempfile.TemporaryDirectory()
        path = str(Path(tmp.name) / "reckoning.json")
        proc = policy and start_train_reckoning(arch, policy, batch, seq,
                                                path)
        torch.cuda.reset_peak_memory_stats()
        res, wall = train_steps(cfg, batch, seq, steps, per_step, device)
        out.update(train_s=wall, steps_s=res["steps_s"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        add_launches(launches, {k: steps * n for k, n in per_step.items()})
        print(f"training {out['config']} ({out['params']} parameters) "
              f"through make_train_step on the kernels: {wall} s (steps "
              f"{res['steps_s']} s), peak memory {out['peak_memory_gb']} "
              f"GB (card {CARD_GB} GB); launches a step {per_step} held "
              f"on every step, every GEMM on mma  [{card}]")
        check(out["peak_memory_gb"] < CARD_GB, f"{arch}: peak "
              f"{out['peak_memory_gb']} GB")
        report_losses(out, res)
        del res
    torch.cuda.empty_cache()
    out["seconds"]["training"] = time.perf_counter() - t0

    # one step against the plain route, from conditioned weights
    t0 = time.perf_counter()
    params = conditioned(Model(cfg).init(
        torch.Generator(device=device).manual_seed(LLM_SEED)))
    tokens = step_batch(cfg, batch, seq, device)
    step, rec = hold_step(cfg, params, tokens, per_step,
                          f"{arch} training step f32{remat}")
    out["seconds"]["held_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, step["launches"])
    for key in ("step_vs_plain", "control_vs_plain", "routing_unpinned"):
        if key in step:
            out[key] = step[key]
    print_step_hold(step, per_step)
    out["held"] = hold_recorded(held, rec, f"main path {arch} training "
                                           f"step f32")
    print(f"  each kernel on the step's inputs (one call a shape) against "
          f"its plain version: {out['held']} shapes held")
    torch.cuda.empty_cache()
    out["seconds"]["kernel_holds"] = time.perf_counter() - t0

    if proc:
        t0 = time.perf_counter()
        out["reckoning"] = r = train_reckoning(proc, path)
        out["seconds"]["reckoning_wait"] = time.perf_counter() - t0
        print(f"  {arch}'s training peak {out['peak_memory_gb']} GB beside "
              f"its meta reckoning {r['total_gb']} GB (state "
              f"{r['state_gb']}, step {r['step_peak_gb']}): peak less "
              f"reckoning {out['peak_memory_gb'] - r['total_gb']} GB")
    if tmp is not None:
        tmp.cleanup()
    if policy:
        # without remat: train_loop's run and the gradients held
        # bit-equal, at the rows where such a step fits the card
        t0 = time.perf_counter()
        off = cfg.replace(remat=False)
        res, wall, got, _ = train_run(
            f"{arch} train_loop, remat off", arch, REMAT_OFF_STEPS,
            train_launches(off), {**kw, "batch": REMAT_OFF_BATCH,
                                  "steps": REMAT_OFF_STEPS})
        add_launches(launches, got)
        out["remat_off"] = {"train_loop_s": wall, "losses": res["losses"],
                            "launches": got}
        print(f"  {arch} through train_loop (remat off) at "
              f"{REMAT_OFF_BATCH} x {seq}, {REMAT_OFF_STEPS} steps: {wall} "
              f"s, losses {res['losses']}, launches a step "
              f"{train_launches(off)} held  [{card}]")
        del res
        torch.cuda.empty_cache()
        out["remat_off"]["steps"] = both = hold_remat_off(cfg, params,
                                                          tokens, card)
        for name in ("off", policy):
            add_launches(launches, both[name]["launches"])
        out["seconds"]["remat_off"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["policies"] = hold_policies(cfg, params, tokens, card)
        for rec_ in out["policies"].values():
            add_launches(launches, rec_["launches"])
        out["seconds"]["policies"] = time.perf_counter() - t0

    # the plain routes by events alone (granite's profiled plain step, at
    # 48,000 device records, took about 30 s; the command's time limit)
    t0 = time.perf_counter()
    out["times"] = {
        "kernels": time_llm_route(cfg, ops.differentiable(), params, tokens,
                                  timed),
        "plain": time_llm_route(cfg, F.PLAIN, params, tokens, timed,
                                profiled=False)}
    out["seconds"]["timing"] = time.perf_counter() - t0
    print_route_times(out["times"], card)
    print(f"  seconds by part: {out['seconds']}")
    out["launches"] = launches
    del params, tokens
    torch.cuda.empty_cache()
    return out


def training_mixers_slice(device, card, report) -> dict:
    """Phase 19: granite-moe-1b (under remat), mamba2-130m and
    recurrentgemma-9b (one period) trained on the card
    (``train_mixer``).  Returns the main-path launches and the kernel
    checks by kernel."""
    held = Held()
    out, launches = {}, {}
    for arch, layers, batch, seq, policy in MIXER_TRAIN:
        out[arch] = train_mixer(arch, layers, batch, seq, policy, device,
                                card, held)
        add_launches(launches, out[arch]["launches"])
    report["training_mixers"] = out
    print(f"mixers' training: main-path launches {launches}")
    return {"launches": launches,
            "held": {name: (len(held.cases[name]), held.max_err(name))
                     for name in OPS if held.cases[name]}}


# ---------------------------------------------------------------------------
# the mixers: granite-moe-1b, mamba2-130m and recurrentgemma-9b served
# through Model and launch/serve.py at full width and depth
# ---------------------------------------------------------------------------

class Served(NamedTuple):
    """A model ``serve_model`` serves in bf16 from weights seeded with
    ``SERVE_SEED``: ``layers`` layers (0: all of them; whole periods of
    the pattern), ``batch`` prompts of ``prompt`` tokens, ``gen`` greedy
    steps; its float32 holds at ``f32_layers`` layers (0: all of them;
    None: none, where no period's float32 weights fit the card, and then
    no ``serve_loop`` either), and ``serve_loop`` at full size where
    ``loop``."""
    arch: str
    gen: int
    batch: int = SERVE_BATCH
    prompt: int = SERVE_PROMPT
    f32_layers: Optional[int] = 0
    loop: bool = True
    layers: int = 0


MIXER_MODELS = (Served("granite-moe-1b-a400m", 8), Served("mamba2-130m", 8),
                Served("recurrentgemma-9b", 4))
# gemma3-27b's bf16 weights take 54.0 GB: batch 2, and its float32 holds
# at one period of its 5:1 local:global pattern (6 layers, 3.887 B
# parameters; the 62 layers' 108 GB do not fit the card, so neither
# does its serve_loop); whisper's decoder positions stop at its
# learned_pos, 448: 384 prompt tokens + 8 steps + 8 (at most 56 steps)
ATTENTION_MODELS = (Served("gemma3-27b", 4, batch=2, f32_layers=6,
                           loop=False),
                    Served("pixtral-12b", 4), Served("stablelm-1.6b", 8),
                    Served("whisper-tiny", 8, prompt=384))
# the float32 hold's MoE capacity: tests/test_decode.py's no-drop 8.0 (at
# the config's 1.25 a prefill drops tokens that a 4-token decode step
# keeps, a property of the reference)
MIXER_F32_CAPACITY = 8.0
# The bf16 logits' limit against the plain route is SERVE_BF16_ROW_REL or,
# where bf16's own floor is above it, this many times the control's
# reading: the plain route with each GEMM's float32 sum reordered
# (``reordered_plain``), on the same tokens and MoE choices.  Two orders
# of the same sums move mamba2's logits by 6-13% and recurrentgemma's by
# 5% (worst row of the prefill and the decode steps, batch 4 x 2048, an
# H100; phase 18 prints it) where granite's move by 1%.  A wrong kernel
# or wiring moves rows by O(1), and each kernel is held on the model's
# inputs beside.
MIXER_CONTROL_FACTOR = 2.0
# An encoder's non-causal bf16 attention against float64 attention over
# its real keys, worst query row's relative error: between bf16's own
# rounding (whisper's encoder reads 0.0028 on an H100, phase 20) and what
# 36 zero-padded, unmasked keys do to the same float64 attention (0.020
# there: the reference Pallas kernel's 512-key block, PALLAS_BLOCK_K).
ENCODER_ROW_REL = 1e-2
PALLAS_BLOCK_K = 512
# recurrentgemma's local attention in a prefill of 4 x 2048 tokens: 16
# query heads over 1 KV head, head_dim 256, window 2048
RG_ATTN = dict(batch=4, heads=16, kv=1, seq=2048, d=256, window=2048)


def routing_flips(got, want) -> tuple:
    """``(tokens, of)``: the (token, MoE layer) pairs whose set of experts
    differs between two runs' recorded choices, of all of them, over the
    calls both runs made (the first ``min`` of each, in order)."""
    flips = total = 0
    for g, w in zip(got.choices, want.choices):
        g, w = g.sort(-1).values, w.to(g.device).sort(-1).values
        flips += int((g != w).any(-1).sum())
        total += g[..., 0].numel()
    return flips, total


def sass_of_functions(source: str, fragment: str,
                      ops=("HGMMA", "HMMA")) -> dict:
    """Instructions ``ops`` (by default the tensor cores': HGMMA and HMMA)
    in the SASS of each function of ``source``'s library whose mangled
    name holds ``fragment``."""
    out, name = {}, ""
    for ln in sass_of(source).splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif fragment in name:
            counts = out.setdefault(name, dict.fromkeys(ops, 0))
            for op in counts:
                counts[op] += f" {op}." in ln or f" {op} " in ln
    return out


def ptxas_of(source: str, fragment: str) -> list:
    """ptxas's register and spill lines for the functions of ``source``
    whose mangled name holds ``fragment`` (this process's build)."""
    from repro_torch.kernels import _ext
    lines, name = [], ""
    for ln in _ext.BUILD_LOGS.get(source, "").splitlines():
        if "entry function '" in ln:
            name = ln.split("entry function '")[1].split("'")[0]
        elif "Function properties for " in ln:
            name = ln.split("Function properties for ")[1].strip()
        if fragment in name and ("registers" in ln or "spill" in ln):
            lines.append(f"{name}: {ln.strip()}")
    return lines


def hold_attention_256(held, device, card) -> dict:
    """``flash_attention`` at head_dim 256 on recurrentgemma's shapes
    (``RG_ATTN``) in both types against its plain version; tensor-core
    instructions in the bf16 instantiation's SASS; ptxas's registers and
    spills of both; the raise of an uncompiled head_dim (96); and the
    bf16 call's times beside its bound and SDPA's."""
    from repro_torch.kernels import ops
    b, h, kv, s, d, w = (RG_ATTN[k] for k in ("batch", "heads", "kv", "seq",
                                               "d", "window"))
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED + 5)

    def rn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    out = {"sass": sass_of_functions("flash_attention.cu",
                                     "flash_fwd_tcILi256E"),
           "ptxas": ptxas_of("flash_attention.cu", "ILi256E")}
    check(any(c["HMMA"] + c["HGMMA"] > 0 for c in out["sass"].values()),
          f"flash_attention.cu: no tensor-core instruction in the head_dim "
          f"256 instantiation's SASS ({out['sass']})")
    for dtype in (torch.float32, torch.bfloat16):   # bf16 last: timed
        q, k, v = (rn(b * n, s, d, dtype=dtype) for n in (h, kv, kv))
        hold_call(held, "flash_attention", f"{dtype} D256 recurrentgemma "
                  f"({b * h}, {s}, {d}) MQA window {w}", (q, k, v, h, kv),
                  dict(causal=True, window=w))
    try:
        ops.flash_attention(*(rn(2 * n, 64, 96, dtype=torch.bfloat16)
                              for n in (2, 1, 1)), 2, 1)
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("not compiled" in raised, f"flash_attention at head_dim 96 did "
          f"not raise as uncompiled: {raised!r}")
    out["head_dim_96"] = raised
    out["times"] = t = time_attention(q, k, v, h, kv, w)
    print(f"  flash_attention head_dim 256, recurrentgemma's prefill "
          f"({b * h}, {s}, {d}) over 1 KV head, window {w}: held in bf16 "
          f"and float32; SASS of the bf16 instantiation {out['sass']}; "
          f"ptxas {out['ptxas']}; head_dim 96 raises ({raised!r})")
    print(f"    bf16: {t['ms']} ms (device {t['device_ms']} ms, "
          f"{t['device_tflops']} TFLOP/s), plain {t['plain_ms']} ms, bound "
          f"{t['bound_ms']} ms ({t['bound_by']}), SDPA {t['library_ms']} "
          f"ms (device {t['library_device_ms']} ms; "
          f"{t['library_kernels']})  [{card}]")
    return out


def to_float(tree: dict) -> dict:
    """``tree`` with every leaf made float32 in place, one leaf at a time:
    a whole float32 copy beside the bf16 weights would not fit the card
    for pixtral-12b (24.5 + 49 GB)."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            to_float(leaf)
        else:
            tree[key] = leaf.float()
    return tree


def first_layers(params: dict, cfg, n: int) -> dict:
    """``params`` of ``Model(cfg)`` cut in place to its first ``n``
    layers, whole periods of its pattern."""
    from repro_torch.models.common import tree_map
    plen = len(cfg.pattern)
    check(n % plen == 0 and n < cfg.n_layers, f"{cfg.name}: {n} layers "
          f"are not whole periods of {cfg.pattern} below {cfg.n_layers}")
    for key in [k for k in params if k.startswith("rem")]:
        del params[key]
    for key in [k for k in params if k.startswith("blk")]:
        params[key] = tree_map(lambda t: t[:n // plen].clone(), params[key])
    return params


def hold_encoder_attention(args) -> dict:
    """An encoder's non-causal ``flash_attention`` call (whisper's: S
    1500, whose last 64-key tile holds 28 keys) against float64 softmax
    attention over its S real keys, by the worst query row's relative
    error (``ENCODER_ROW_REL``); and a control held to fail that limit:
    the same float64 attention over keys and values zero-padded to the
    reference Pallas kernel's 512-key block and left unmasked, which is
    what that kernel computes (``src/repro/kernels/flash_attention.py``
    pads, and masks only by causality and the window)."""
    import math
    from repro_torch.kernels import ops
    q, k, v, h, kv = args[:5]
    got = ops.flash_attention(q, k, v, h, kv, causal=False)
    bh, s, d = q.shape
    b, group = bh // h, h // kv

    def heads(x):
        return x.double().view(b, kv, 1, s, d).expand(
            b, kv, group, s, d).reshape(b, h, s, d)
    logits = q.double().view(b, h, s, d) @ heads(k).transpose(-1, -2) \
        / math.sqrt(d)
    vd = heads(v)
    want = (torch.softmax(logits, -1) @ vd).view(bh, s, d)
    pad = (-s) % PALLAS_BLOCK_K
    padded = torch.cat([logits, logits.new_zeros(b, h, s, pad)], -1)
    control = (torch.softmax(padded, -1)[..., :s] @ vd).view(bh, s, d)
    out = {"shape": (bh, s, d), "padded_keys": pad,
           "row_rel": row_rel(got, want),
           "max_abs": float((got.double() - want).abs().max()),
           "control_row_rel": row_rel(control, want)}
    check(out["row_rel"] <= ENCODER_ROW_REL, f"encoder attention {out} "
          f"off float64 attention over its {s} keys by more than "
          f"{ENCODER_ROW_REL} (worst row, relative)")
    check(out["control_row_rel"] > ENCODER_ROW_REL, f"the zero-padded "
          f"control reads {out['control_row_rel']}, within "
          f"{ENCODER_ROW_REL}: the hold cannot see padded keys")
    return out


def serve_model(spec: Served, device, card, held, more=None) -> dict:
    """Serve ``spec.arch`` at full width and depth (``spec.layers``) in
    bf16 through
    ``make_prefill_step``/``make_serve_step`` (launches held a prefill
    and a step), hold it against the plain route (on the kernel route's
    MoE choices), each kernel on its inputs against its plain version
    (an encoder's attention also against float64), the float32 kernel
    route against a forward and against the plain route, time it, and
    run ``serve_loop(use_reduced=False)``.  ``more(cfg, params, batch,
    max_len)``, if given, runs on the bf16 weights after the timing and
    its result is kept as ``"more"``.  Returns the numbers, with the
    main-path launches by kernel.

    A model with attention is served from ``conditioned`` weights: at
    the reference's init its attention logits reach hundreds (granite's
    ``wk``, (1024, 8, 64), draws std 1/sqrt(8); recurrentgemma's, (4096,
    1, 256), std 1), so each softmax row is one-hot and the plain
    version's bf16 rounding of the logits, the oracle's own arithmetic,
    moves whole rows.  The prefill's logits at the reference's init
    against the plain route are printed, not held."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import forward as F
    from repro_torch.launch import serve
    from repro_torch.models.frontends import synth_frontend_inputs
    from repro_torch.models.moe import Routing
    from repro_torch.models.transformer import Model
    arch, gen = spec.arch, spec.gen
    cfg = get_config(arch)
    if spec.layers:
        cfg = cfg.replace(n_layers=spec.layers)
    moe = cfg.n_experts > 0
    rec = RecordingOps()
    rec.model = arch
    model = Model(cfg, impl=rec)
    params = model.init(torch.Generator(device=device)
                        .manual_seed(SERVE_SEED))
    prompts = torch.randint(0, cfg.vocab_size, (spec.batch, spec.prompt),
                            device=device, generator=torch.Generator(
                                device=device).manual_seed(SERVE_SEED + 1))
    extras = synth_frontend_inputs(cfg, spec.batch, torch.Generator(
        device=device).manual_seed(SERVE_SEED + 2), device=device)
    # the cache holds the patches ahead of the prompt (early fusion)
    skip = cfg.n_patches if "patches" in extras else 0
    max_len = skip + spec.prompt + gen + 8
    attention = any(e.startswith("attn") for e in cfg.pattern)
    pinned = (lambda: chosen.pinned()) if moe else (lambda: None)
    reference_init = None
    if attention:
        rec.model = None
        chosen = Routing() if moe else None
        got = model.prefill(params, prompts, max_len, routing=chosen,
                            **extras)[0]
        want = Model(cfg, impl=F.PLAIN).prefill(
            params, prompts, max_len, routing=pinned(), **extras)[0]
        reference_init = row_rel(got, want)
        del got, want, chosen
        params = conditioned(params)
        rec.model = arch
    want_pre, want_step = serve_launches(cfg, True), serve_launches(cfg, False)
    prefill = serve.make_prefill_step(model, None, max_len)
    step = serve.make_serve_step(model, None)
    out = {"config": f"{arch}, {cfg.n_layers} layers, d {cfg.d_model}, "
                     f"bf16, batch {spec.batch}, prompt {spec.prompt}"
                     + (f" + {cfg.n_patches} patches" if "patches" in extras
                        else "")
                     + (f", {cfg.encoder_seq} encoder frames"
                        if "frames" in extras else "")
                     + f", {gen} decode steps"
                     + (", conditioned attention" if attention else ""),
           "params": model.n_params(), "launches_per_prefill": want_pre,
           "launches_per_decode_step": want_step, "routes": {},
           "bf16_row_rel_prefill_reference_init": reference_init}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, launches = greedy(prefill, step, params, prompts, gen,
                              count=(f"{arch} bf16", want_pre, want_step,
                                     None), routes=out["routes"],
                              extras=extras)
    out["first_run_s"] = time.perf_counter() - t0
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launches
    check(tokens.shape == (spec.batch, gen + 1) and
          bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{arch}: greedy tokens {tuple(tokens.shape)} misshapen or out of "
          f"range")
    print(f"serving {out['config']} ({out['params']} parameters, seed "
          f"{SERVE_SEED}) through make_prefill_step/make_serve_step: "
          f"launches a "
          f"prefill {want_pre} and a decode step {want_step}, held on the "
          f"prefill and each step; GEMMs by route {out['routes']}; first "
          f"run {out['first_run_s']} s, peak memory "
          f"{out['peak_memory_gb']} GB  [{card}]")

    # each kernel on the inputs the model gave it; an encoder's
    # non-causal attention also against float64
    rec.model = None
    encoder = [args for (name, shapes), (_, args, _) in rec.inputs.items()
               if name == "flash_attention" and ("causal", False) in shapes]
    if cfg.encoder_layers:
        check(len(encoder) == 1, f"{arch}: {len(encoder)} recorded "
              f"encoder attentions")
        out["encoder_attention"] = e = hold_encoder_attention(encoder[0])
        print(f"  the encoder's non-causal flash_attention {e['shape']} "
              f"against float64 attention over its keys: worst row "
              f"{e['row_rel']} (limit {ENCODER_ROW_REL}), max abs "
              f"{e['max_abs']}; the reference Pallas kernel's unmasked "
              f"{e['padded_keys']} zero keys read {e['control_row_rel']}")
    del encoder
    out["held"] = hold_recorded(held, rec, f"main path {arch}")
    print(f"  each kernel on {arch}'s inputs (one call a shape) against "
          f"its plain version: {out['held']} shapes held")

    # the kernel route against the plain route from the same weights,
    # teacher-forced on the kernel route's greedy tokens; a MoE model's
    # plain route on the kernel route's choices
    feed = tokens[:, :-1]
    chosen = Routing() if moe else None
    got = teacher_forced(model, params, prompts, feed, max_len, chosen,
                         extras)
    want = teacher_forced(Model(cfg, impl=F.PLAIN), params, prompts, feed,
                          max_len, pinned(), extras)
    ctl = teacher_forced(Model(cfg, impl=reordered_plain()), params,
                         prompts, feed, max_len, pinned(), extras)
    rels = [row_rel(g, w) for g, w in zip(got, want)]
    control = [row_rel(c, w) for c, w in zip(ctl, want)]
    limit = max(SERVE_BF16_ROW_REL, MIXER_CONTROL_FACTOR * max(control))
    out["bf16_row_rel_prefill"] = rels[0]
    out["bf16_row_rel_decode_max"] = max(rels[1:])
    out["bf16_control_row_rel"] = {"prefill": control[0],
                                   "decode_max": max(control[1:])}
    out["bf16_row_rel_limit"] = limit
    for i, r in enumerate(rels):
        check(r <= limit, f"{arch}: bf16 logits at step {i} (0: the "
              f"prefill) off the plain route by {r} (worst row, relative), "
              f"above {limit} (the reordered control reads {control[i]})")
    forced = torch.stack([g.argmax(-1) for g in got[:-1]], dim=1)
    check(torch.equal(forced, tokens[:, :-1].to(forced.dtype)),
          f"{arch}: the kernel route's teacher-forced argmax differs from "
          f"its own greedy tokens")
    del got, want, ctl
    if moe:
        # the plain route's own choices in a prefill, against the kernel
        # route's (the prefill's calls come first in ``chosen``)
        free = Routing()
        Model(cfg, impl=F.PLAIN).prefill(params, prompts, max_len,
                                         routing=free, **extras)
        flips, total = routing_flips(chosen, free)
        out["routing_unpinned"] = {"differs": flips, "of": total,
                                   "share": flips / total}
        del free
    on_choices = ", on the kernel route's MoE choices" if moe else ""
    print(f"  bf16 logits against the plain route (worst row, relative; "
          f"limit {limit}{on_choices}): prefill {rels[0]}, decode steps max "
          f"{out['bf16_row_rel_decode_max']}; the plain route with its "
          f"GEMM sums reordered: prefill {control[0]}, decode steps max "
          f"{max(control[1:])}; "
          f"at the reference's init, not held: prefill {reference_init}; "
          f"teacher-forced argmax equal to the greedy tokens"
          + (f"; unpinned, the plain route's prefill chooses other experts "
             f"for {out['routing_unpinned']['differs']} of "
             f"{out['routing_unpinned']['of']} (token, layer) pairs "
             f"({out['routing_unpinned']['share']})" if moe else ""))
    del chosen

    # times of the kernel route, where its device time goes, and the
    # plain route's prefill
    out["times"] = time_route(prefill, step, params, prompts, gen, extras,
                              traced=False)
    batch = {"tokens": prompts, **extras}
    last, cache = prefill(params, batch)
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    # one trace of each, read for the device time by part and the idle
    out["trace"] = {"prefill": profile_step(lambda: prefill(params, batch),
                                            SERVE_KERNELS),
                    "decode step": profile_step(
                        lambda: step(params, cache, tok), SERVE_KERNELS)}
    traced_shares(out["times"], out["trace"]["prefill"]["device_ms"],
                  out["trace"]["decode step"]["device_ms"])
    del last, cache, prefill, step, model, rec
    plain = Model(cfg, impl=F.PLAIN)
    out["plain_prefill_ms"] = cuda_ms(    # warm: it ran teacher-forced
        lambda: plain.prefill(params, prompts, max_len, **extras), iters=1,
        warmup=0)
    del plain
    t = out["times"]
    print(f"  kernels route: prefill {t['prefill_ms']} ms (device "
          f"{t['prefill_device_ms']} ms, idle {t['prefill_idle']}); decode "
          f"{t['decode_ms_per_step']} ms a step ({t['tokens_per_s']} "
          f"tokens/s), device {t['decode_device_ms']} ms, idle "
          f"{t['decode_idle']}; plain route prefill "
          f"{out['plain_prefill_ms']} ms  [{card}]")
    for name, tr in out["trace"].items():
        print(f"    one {name} in the profiler's trace: device "
              f"{tr['device_ms']} ms, by part {tr['parts_ms']} ms, records "
              f"{tr['records']}  [{card}]")
        for kname, ms, count in tr["top"][:5]:
            print(f"      {kname[:70]}: {ms} ms, {count} records")
    if more is not None:
        out["more"] = more(cfg, params, batch, max_len)
    if spec.f32_layers is None:
        print(f"  float32 holds and serve_loop not run: {arch}'s float32 "
              f"weights at {cfg.n_layers} layers take "
              f"{4 * out['params'] / 1e9} GB")
        out["main_path_launches"] = dict(launches)
        return out

    # float32, on the same weights (a period of them for a model whose
    # float32 weights do not fit the card): prefill + decode against one
    # forward of the same tokens, and the kernel route's prefill against
    # the plain route's
    cfg32 = cfg.replace(dtype=torch.float32)
    if spec.f32_layers:
        first_layers(params, cfg, spec.f32_layers)
        cfg32 = cfg32.replace(n_layers=spec.f32_layers)
    if moe:
        cfg32 = cfg32.replace(moe_capacity=MIXER_F32_CAPACITY)
    p32 = to_float(params)
    del params
    ex32 = {k: v.float() for k, v in extras.items()}
    torch.cuda.empty_cache()
    m32 = Model(cfg32)
    total = SERVE_F32_PROMPT + SERVE_F32_STEPS
    ids = prompts[:, :total]
    with torch.inference_mode():
        full, _, _ = m32.forward(p32, ids, **ex32)
    got32 = teacher_forced(m32, p32, ids[:, :SERVE_F32_PROMPT],
                           ids[:, SERVE_F32_PROMPT:], skip + total + 8,
                           extras=ex32)
    errs = [float((g - full[:, skip + SERVE_F32_PROMPT - 1 + i]).abs().max())
            for i, g in enumerate(got32)]
    out["f32_layers"] = cfg32.n_layers
    out["f32_prefill_decode_vs_forward_max_abs"] = max(errs)
    out["f32_logits_max_abs"] = float(full.abs().max())
    check(max(errs) <= SERVE_F32_ABS, f"{arch}: f32 prefill + decode off "
          f"the forward by {max(errs)}, above {SERVE_F32_ABS}")
    del full, got32
    # batch 1: the kernel route, the plain route on its MoE choices, and
    # the plain route with its GEMM sums reordered
    one = dict(tokens=prompts[:1], max_len=skip + spec.prompt + 8,
               **{k: v[:1] for k, v in ex32.items()})
    chosen = Routing() if moe else None
    lasts = {"kernels": m32.prefill(p32, routing=chosen, **one)[0]}
    del m32
    for name, impl in (("plain", F.PLAIN), ("control", reordered_plain())):
        lasts[name] = Model(cfg32, impl=impl).prefill(p32, routing=pinned(),
                                                      **one)[0]
    out["f32_vs_plain"] = {
        name: {"max_abs": float((lasts[name] - lasts["plain"]).abs().max()),
               "row_rel": row_rel(lasts[name], lasts["plain"])}
        for name in ("kernels", "control")}
    e = out["f32_vs_plain"]["kernels"]["max_abs"]
    check(e <= SERVE_F32_ABS, f"{arch}: the f32 kernel route's prefill "
          f"logits off the plain route's by {e}, above {SERVE_F32_ABS}")
    del p32, lasts, chosen
    torch.cuda.empty_cache()
    print(f"  float32 ({cfg32.n_layers} layers"
          f"{f', moe_capacity {MIXER_F32_CAPACITY}' if moe else ''}): "
          f"prefill of {SERVE_F32_PROMPT} + {SERVE_F32_STEPS} decode steps "
          f"against one forward, max abs err {max(errs)} (limit "
          f"{SERVE_F32_ABS}; logits reach {out['f32_logits_max_abs']}); "
          f"a prefill of 1 x {spec.prompt} against the plain route"
          f"{' on its MoE choices' if moe else ''}: {e} (limit "
          f"{SERVE_F32_ABS}), worst row "
          f"{out['f32_vs_plain']['kernels']['row_rel']}; the plain route "
          f"with its GEMM sums reordered: {out['f32_vs_plain']['control']}")

    # the reference's demo at its defaults, full size, float32
    loop_launches = dict.fromkeys(launches, 0)
    if spec.loop:
        logs = []
        cfg_loop = cfg.replace(dtype=torch.float32)
        loop_want = {name: k + 15 * serve_launches(cfg_loop, False)[name]
                     for name, k in serve_launches(cfg_loop, True).items()}
        res, loop_launches, _ = counted(
            f"serve_loop {arch}", lambda: serve.serve_loop(
                arch, use_reduced=False, device=device, log=logs.append),
            loop_want, "mma")
        check(res["generated"].shape == (4, 16) and
              ((res["generated"] >= 0) & (res["generated"] < cfg.vocab_size))
              .all(), f"serve_loop {arch} tokens {res['generated'].shape}")
        out["serve_loop"] = {"elapsed_s": res["elapsed_s"], "log": logs[0],
                             "launches": loop_launches}
        torch.cuda.empty_cache()
        print(f"  serve_loop({arch!r}, use_reduced=False) at its defaults "
              f"(batch 4, prompt 16, 16 tokens, float32): {logs[0]}; "
              f"launches {loop_launches}, every GEMM on mma  [{card}]")
    else:
        print(f"  serve_loop({arch!r}, use_reduced=False) not run: its "
              f"float32 weights ({4 * out['params'] / 1e9} GB) do not fit "
              f"the card")
    out["main_path_launches"] = {name: launches[name] + loop_launches[name]
                                 for name in launches}
    return out


def mixers_slice(device, card, report) -> dict:
    """Phase 18: ``flash_attention`` at head_dim 256, then granite-moe-1b,
    mamba2-130m and recurrentgemma-9b served at full width and depth
    (``serve_model``).  Returns the main-path launches and the kernel
    checks by kernel."""
    held = Held()
    out = {"attention_256": hold_attention_256(held, device, card)}
    launches = {}
    for spec in MIXER_MODELS:
        t0 = time.perf_counter()
        out[spec.arch] = serve_model(spec, device, card, held)
        out[spec.arch]["seconds"] = time.perf_counter() - t0
        add_launches(launches, out[spec.arch]["main_path_launches"])
    report["mixers"] = out
    print(f"mixers phase: main-path launches {launches}; seconds "
          f"{ {spec.arch: out[spec.arch]['seconds'] for spec in MIXER_MODELS} }")
    return {"launches": launches,
            "held": {name: (len(held.cases[name]), held.max_err(name))
                     for name in OPS if held.cases[name]}}


def serving_attention_slice(device, card, report) -> dict:
    """Phase 20: gemma3-27b, pixtral-12b, stablelm-1.6b and whisper-tiny
    served at full width and depth (``serve_model``).  Returns the
    main-path launches and the kernel checks by kernel."""
    held = Held()
    out, launches = {}, {}
    for spec in ATTENTION_MODELS:
        t0 = time.perf_counter()
        out[spec.arch] = serve_model(spec, device, card, held)
        out[spec.arch]["seconds"] = time.perf_counter() - t0
        add_launches(launches, out[spec.arch]["main_path_launches"])
    report["serving_attention"] = out
    print(f"attention configs' serving: main-path launches {launches}; "
          f"seconds { {a: out[a]['seconds'] for a in out} }")
    return {"launches": launches,
            "held": {name: (len(held.cases[name]), held.max_err(name))
                     for name in OPS if held.cases[name]}}


# ---------------------------------------------------------------------------
# llama4-maverick at one period of its pattern, the port's gradient
# compression and a one-rank mesh's sharding rules on the card
# ---------------------------------------------------------------------------

# llama4-maverick-400b-a17b at one period of its ("attn+moe", "attn")
# pattern, full width: 18.553 B parameters, 37.1 GB in bf16 (the 48
# layers' 397.7 B take 795 GB).  The period's float32 weights take 74.2
# GB, past the card beside anything else, so it has no float32
# whole-model hold and no serve_loop; its MoE layer is held alone in
# float32 once the bf16 model is freed (``hold_moe_f32``).
LLAMA4 = Served("llama4-maverick-400b-a17b", 8, layers=2,
                f32_layers=None, loop=False)
LLAMA4_F32_TOKENS = 2048
# compression's CPU hold: each leaf's first and last QUANT_SLICE elements
QUANT_SLICE = 1 << 20


@contextmanager
def one_rank_mesh(device):
    """A (1, 1) ``("data", "model")`` ``DeviceMesh`` over a one-rank
    process group (NCCL on the card; joined through a ``FileStore`` in a
    temporary directory), torn down on exit."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            yield make_mesh((1, 1), ("data", "model"), device.type)
        finally:
            dist.destroy_process_group()


def _quant_slices(size: int) -> list:
    """``(start, stop)`` of a leaf's first and last ``QUANT_SLICE``
    elements, the last from a block boundary (the whole leaf if small)."""
    from repro_torch.optim.compression import BLOCK
    if size <= 2 * QUANT_SLICE:
        return [(0, size)]
    return [(0, QUANT_SLICE),
            ((size - QUANT_SLICE) // BLOCK * BLOCK, size)]


def hold_compression(device, card) -> dict:
    """``optim.compression`` on the card over a float32 gradient-shaped
    tree of Qwen3-0.6B's parameters (seeded, std 1e-3): ``quantize``
    twice (a zero error, then the carried one) and ``dequantize`` held
    bit-equal to the same calls on the CPU on each leaf's first and last
    ``QUANT_SLICE`` elements; ``compressed_psum`` over the one-rank
    group bit-equal to ``dequantize(quantize(g, err))`` and its new
    errors to ``quantize``'s; ``quantize`` over the whole tree timed by
    CUDA events beside its bytes bound."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.optim import compression as C
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED + 7)
    defs = Model(get_config("qwen3-0.6b")).param_defs()
    grads = tree_map(lambda d: torch.randn(
        d.shape, generator=gen, device=device).mul_(1e-3), defs)
    gs = [g for _, g in leaf_items(grads)]
    n = sum(g.numel() for g in gs)
    err = C.init_error(grads)
    checked = 0
    for _ in range(2):
        new = []
        for (name, g), e in zip(leaf_items(grads),
                                [e for _, e in leaf_items(err)]):
            q, scale, ne = C.quantize(g, e)
            for a, b in _quant_slices(g.numel()):
                qc, sc, ec = C.quantize(g.reshape(-1)[a:b].cpu(),
                                        e.reshape(-1)[a:b].cpu())
                blk = slice(a // C.BLOCK, -(-b // C.BLOCK))
                dq = C.dequantize(q[blk], scale[blk], (b - a,), b - a)
                check(torch.equal(q[blk].cpu(), qc)
                      and torch.equal(scale[blk].cpu(), sc)
                      and torch.equal(ne.reshape(-1)[a:b].cpu(), ec)
                      and torch.equal(dq.cpu(), C.dequantize(
                          qc, sc, (b - a,), b - a)),
                      f"compression {name}[{a}:{b}]: the card's quantize or "
                      f"dequantize differs from the CPU's")
                checked += b - a
            new.append(ne)
        it = iter(new)
        err = tree_map(lambda _: next(it), grads)
    red, perr = C.compressed_psum(grads, err)
    for (name, g), e, r, pe in zip(leaf_items(grads),
                                   [e for _, e in leaf_items(err)],
                                   [r for _, r in leaf_items(red)],
                                   [e for _, e in leaf_items(perr)]):
        q, scale, ne = C.quantize(g, e)
        check(torch.equal(r, C.dequantize(q, scale, g.shape, g.numel()))
              and torch.equal(pe, ne), f"compressed_psum {name} over one "
              f"rank differs from dequantize(quantize(g, err))")
    del red, perr
    es = [e for _, e in leaf_items(err)]
    ms = cuda_ms(lambda: [C.quantize(g, e) for g, e in zip(gs, es)],
                 iters=3, warmup=1)
    # each input read once, each output written once
    nbytes = sum(4 * g.numel() * 3 + (-(-g.numel() // C.BLOCK)) * (
        C.BLOCK + 4) for g in gs)
    out = {"leaves": len(gs), "elements": n, "held_elements_cpu": checked,
           "quantize_ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes": nbytes}
    print(f"compression on the card over Qwen3-0.6B's gradient-shaped "
          f"tree ({out['leaves']} leaves, {n} float32 elements): quantize "
          f"and dequantize bit-equal to the CPU's on {checked} elements "
          f"over two rounds (the second with the carried error); "
          f"compressed_psum over the one-rank group bit-equal to "
          f"dequantize(quantize(g, err)); quantize over the tree {ms} ms, "
          f"bound {out['bound_ms']} ms ({nbytes} bytes)  [{card}]")
    return out


def moe_f32_reckoning(cfg, tokens: int) -> dict:
    """The float32 MoE layer hold's bytes, counted on the meta device (no
    memory, no card): its weights, and the most the plain route of
    ``apply_moe`` on (1, tokens, d) holds at once (``launch.program.
    StepReader``'s peak)."""
    from repro_torch.kernels import forward as F
    from repro_torch.launch.program import StepReader
    from repro_torch.models import moe
    from repro_torch.models.common import param_count, tree_map
    defs = moe.moe_defs(cfg)
    params = tree_map(lambda d: torch.empty(d.shape, device="meta"), defs)
    x = torch.empty((1, tokens, cfg.d_model), device="meta")
    reader = StepReader()
    with reader:
        moe.apply_moe(cfg, params, x, None, impl=F.PLAIN)
    made = reader.peak
    n = param_count(defs)
    return {"params": n, "weights_gb": 4 * n / 1e9,
            "activations_gb": made / 1e9, "input_gb": 4 * x.numel() / 1e9,
            "total_gb": (4 * n + made + 4 * x.numel()) / 1e9}


def hold_moe_f32(device, card, held) -> dict:
    """llama4's MoE layer alone in float32 at full width (128 experts
    top-1 and the shared expert, d 5120, d_ff 8192), its memory reckoned
    on the meta device first: ``apply_moe`` on 1 x ``LLAMA4_F32_TOKENS``
    seeded tokens through the kernels (launches held, every GEMM on
    `mma`) against the plain route on the kernel route's choices, at
    ``SERVE_F32_ABS``; the plain route with its GEMM sums reordered
    printed beside, and the plain route with its GEMMs rounded to
    bfloat16 (``LLM_CONTROL_BITS``, phases 17 and 19's control), which
    must fail the limit; each kernel on its inputs against its plain
    version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import forward as F
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    cfg = get_config(LLAMA4.arch).replace(dtype=torch.float32)
    tokens = LLAMA4_F32_TOKENS
    need = moe_f32_reckoning(cfg, tokens)
    free, total = torch.cuda.mem_get_info()
    out = {"reckoning": need, "card_free_gb": free / 1e9,
           "card_total_gb": total / 1e9}
    print(f"llama4's MoE layer in float32, reckoned on the meta device: "
          f"{need['params']} parameters, {need['weights_gb']} GB of weights, "
          f"at most {need['activations_gb']} GB held at once by the plain "
          f"route on 1 x {tokens} tokens; {out['card_free_gb']} GB free of "
          f"{out['card_total_gb']}  [{card}]")
    check(need["total_gb"] * 1e9 < free, f"llama4's float32 MoE layer "
          f"needs {need['total_gb']} GB, {free / 1e9} GB are free")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED + 8)
    params = init_params(gen, moe.moe_defs(cfg), torch.float32)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=device)
    rec = RecordingOps()
    rec.model = "llama4 MoE f32"
    chosen = moe.Routing()
    want_launches = {"matmul": 1 + 3 * cfg.n_experts
                     + 3 * cfg.shared_expert}
    (got, aux), launches, routes = counted(
        "llama4 MoE layer f32", lambda: moe.apply_moe(
            cfg, params, x, None, impl=rec, routing=chosen),
        want_launches, "mma")
    rec.model = None
    want, want_aux = moe.apply_moe(cfg, params, x, None, impl=F.PLAIN,
                                   routing=chosen.pinned())
    ctl, _ = moe.apply_moe(cfg, params, x, None, impl=reordered_plain(),
                           routing=chosen.pinned())
    bf16, _ = moe.apply_moe(cfg, params, x, None, impl=control_plain(
        rounded_plain(LLM_CONTROL_BITS).matmul, F.PLAIN),
        routing=chosen.pinned())
    out.update(
        launches=launches, routes=routes,
        max_abs=float((got - want).abs().max()),
        row_rel=row_rel(got.reshape(tokens, -1), want.reshape(tokens, -1)),
        aux_abs=float((aux - want_aux).abs()),
        control_max_abs=float((ctl - want).abs().max()),
        bf16_control_max_abs=float((bf16 - want).abs().max()),
        out_max_abs=float(want.abs().max()),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del got, want, ctl, bf16, aux, want_aux
    out["held"] = hold_recorded(held, rec, "llama4 MoE f32")
    del params, x, rec, chosen
    torch.cuda.empty_cache()
    print(f"  apply_moe float32, kernel route against the plain route on "
          f"its MoE choices: max abs {out['max_abs']} (limit "
          f"{SERVE_F32_ABS}; outputs reach {out['out_max_abs']}), worst row "
          f"{out['row_rel']}, aux {out['aux_abs']}; the reordered control "
          f"{out['control_max_abs']}; the bf16-GEMM control "
          f"{out['bf16_control_max_abs']} (must fail the limit); launches "
          f"{launches}, routes "
          f"{routes}; each kernel on its inputs: {out['held']}; peak "
          f"{out['peak_memory_gb']} GB  [{card}]")
    check(out["max_abs"] <= SERVE_F32_ABS, f"llama4's float32 MoE layer: "
          f"the kernel route off the plain route by {out['max_abs']}, above "
          f"{SERVE_F32_ABS}")
    check(out["bf16_control_max_abs"] > SERVE_F32_ABS, f"llama4's float32 "
          f"MoE layer: the plain route with bf16 GEMMs within the limit "
          f"{SERVE_F32_ABS}: {out['bf16_control_max_abs']}")
    return out


def llama4_slice(device, card, report) -> dict:
    """Phase 21: llama4-maverick served at one period of its pattern and
    full width (``serve_model``; the prefill also with ``PROD_RULES``
    over a one-rank NCCL mesh), the gradient compression on the card
    over that group, and the MoE layer alone in float32.  Returns the
    main-path launches and the kernel checks by kernel."""
    held = Held()
    out, secs = {}, {}
    with one_rank_mesh(device) as mesh:
        t0 = time.perf_counter()
        out["serve"] = serve_model(LLAMA4, device, card, held)
        secs["serve"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["compression"] = hold_compression(device, card)
        secs["compression"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["moe_f32"] = hold_moe_f32(device, card, held)
    secs["moe_f32"] = time.perf_counter() - t0
    out["seconds"] = secs
    report["llama4"] = out
    print(f"llama4 phase: main-path launches "
          f"{out['serve']['main_path_launches']}; seconds {secs}")
    return {"launches": out["serve"]["main_path_launches"],
            "held": {name: (len(held.cases[name]), held.max_err(name))
                     for name in OPS if held.cases[name]}}


# ---------------------------------------------------------------------------
# phase 22: the dry run's count held on the card
# ---------------------------------------------------------------------------

DRY_ARCH = "qwen3-0.6b"
DRY_SEED = 2026
# (cell of launch/shapes.py, its batch cut to fit one card)
DRY_CELLS = (("train_4k", 2), ("prefill_32k", 1), ("decode_32k", 8))
DRY_TIMED = 3                     # timed steps or prefills, the median kept
DRY_DECODE_STEPS = 8
# the walker's roofline step time may exceed the measured device time by
# this much at most: a faster reading means the count is wrong.  The
# check is one-sided: a count that is too low always passes it.
DRY_SLACK = 1.05
# The card's peak allocated bytes of a cell, less its reckoning on the
# meta device (``dry_reckoning``), must lie in [-low, high] GB.  On an
# H100 each of the three cells read 0.067 GB (64 MiB: the libraries'
# workspaces, which the meta device never allocates).
DRY_PEAK_MARGIN_GB = (0.1, 0.1)
# A recorded attention whose plain version's float32 S x S logits (all
# heads at once) exceed this is held on its first KV group alone; the
# plain route is compared one KV group at a time (``grouped_plain``).
DRY_PLAIN_ATTN_BYTES = 16e9
# gemma3-27b's attention layer at train_4k's per-layer shape, batch 1
DRY_GEMMA = dict(arch="gemma3-27b", shape="train_4k", batch=1,
                 windows=(1024, 0))


def kv_group(q, k, v, n_heads: int, n_kv: int, j: int = 0) -> tuple:
    """Attention's arguments cut to KV head ``j`` and its group of query
    heads: ``(q, k, v, group, 1)`` in the kernels' layout."""
    bh, s, d = q.shape
    b, g = bh // n_heads, n_heads // n_kv
    return (q.reshape(b, n_kv, g, s, d)[:, j].reshape(b * g, s, d)
            .contiguous(), k.reshape(b, n_kv, s, d)[:, j].contiguous(),
            v.reshape(b, n_kv, s, d)[:, j].contiguous(), g, 1)


def grouped_plain(base=None):
    """``base``'s plain versions (``kernels.forward.PLAIN`` by default)
    with attention taken one KV group at a time (``kv_group``): the same
    function, with the float32 S x S logits of one group's heads at once
    (Qwen3's 16 heads at S 32,768 would need 68.7 GB)."""
    from repro_torch.kernels import forward as F
    base = F.PLAIN if base is None else base

    def flash_attention(q, k, v, n_heads, n_kv, causal=True, window=0):
        bh, s, d = q.shape
        return torch.cat([base.flash_attention(
            *kv_group(q, k, v, n_heads, n_kv, j), causal, window).reshape(
                bh // n_heads, -1, s, d) for j in range(n_kv)],
            dim=1).reshape(bh, s, d)
    return SimpleNamespace(**{**vars(base),
                              "flash_attention": flash_attention})


def dry_inputs(cfg, kind: str, batch: int, seq: int, device, impl=None):
    """The step of ``kind`` on ``Model(cfg, impl)`` (``kernels.ops`` by
    default; on ``meta`` ``kernel_shaped`` stands in for the kernels)
    and its inputs on ``device``: ``(step, state, step_input)``, where
    ``step(state, x)`` returns the next state and the step's output (the
    metrics, the prefill's logits, the next tokens).  Training takes
    AdamW as the dry run does; decode a cache of ``seq`` rows, its
    ``pos`` set ``DRY_DECODE_STEPS`` rows short of the end."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.launch.program import kernel_shaped
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, constant_schedule
    meta = device.type == "meta"
    impl = kernel_shaped() if meta else (impl or ops)
    if kind == "train":
        impl = ops.differentiable(impl)
    model = Model(cfg, impl=impl)
    if meta:
        params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                device=device),
                          model.abstract())
        tokens = torch.empty((batch, 1 if kind == "decode" else seq),
                             dtype=torch.int32, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(DRY_SEED)
        params = conditioned(model.init(gen))
        tokens = torch.randint(0, cfg.vocab_size, (batch, 1 if kind ==
                               "decode" else seq), generator=gen,
                               device=device, dtype=torch.int32)
    if kind == "train":
        opt = AdamW(schedule=constant_schedule(1e-4))
        p = train.trainable(params)
        return (train.make_train_step(model, opt, None),
                {"params": p, "opt": opt.init(p)}, {"tokens": tokens})
    if kind == "prefill":
        prefill = serve.make_prefill_step(model, None,
                                          max_len=seq + cfg.n_patches + 8)

        def prefill_step(params, x):
            return params, prefill(params, x)[0]
        return prefill_step, params, {"tokens": tokens}
    cache = model.make_cache(batch, seq, device=device)
    if not meta:
        for part in cache.values():
            part["k"].normal_(generator=gen).mul_(0.5)
            part["v"].normal_(generator=gen)
            part["pos"].fill_(seq - DRY_DECODE_STEPS)
    decode = serve.make_serve_step(model, None)

    def step(st, x):
        params, cache = st
        return st, decode(params, cache, x)[0]
    return step, (params, cache), tokens


def chunked_train_launches(cfg, seq: int) -> dict:
    """``train_launches`` of a step over ``seq`` tokens whose
    cross-entropy is chunked (``cfg.ce_chunk``): the head's GEMM runs once
    a chunk forward, again in the backward's recompute
    (``torch.utils.checkpoint``), and its dX and dW, where the unchunked
    step runs 3."""
    want = train_launches(cfg)
    if cfg.ce_chunk and seq - 1 > cfg.ce_chunk:
        want["matmul"] += 4 * -(-(seq - 1) // cfg.ce_chunk) - 3
    return want


def start_fake_dryrun(arch: str, shape_name: str, out_dir: str):
    """Starts ``python -m repro_torch.launch.dryrun`` of one cell on the
    16 x 16 mesh in a process of its own (the ``fake`` process group it
    starts is the only default group there).  It runs on the CPU while
    the phase works on the card; its record and log go to ``out_dir``."""
    with open(Path(out_dir) / "log.txt", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape_name, "--out", out_dir], cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def fake_dryrun_record(proc, arch: str, shape_name: str,
                       out_dir: str) -> dict:
    """The record of ``start_fake_dryrun``'s process, once it ends."""
    rc = proc.wait(timeout=600)
    log = (Path(out_dir) / "log.txt").read_text()
    check(rc == 0, f"the dry run of {arch} x {shape_name} failed: "
          f"{log[-4000:]}")
    rec = json.loads((Path(out_dir) / f"{arch}.{shape_name}.16x16.json")
                     .read_text())
    check(rec["status"] == "ok" and rec["memory"]["argument_bytes"] > 0,
          f"the dry run of {arch} x {shape_name}: {rec}")
    return rec


def hold_gemma_substitution(device, card, held) -> dict:
    """The hill-climb's flash substitution on the card: one gemma3-27b
    attention layer at ``train_4k``'s per-layer shape (batch 1, S 4096,
    32/16 heads, head_dim 128), windowed and global.  The kernel held
    against its plain version on the same inputs and timed against its
    bound from ``hillclimb``: the kernel-true bytes, and the plain
    attention's walker FLOPs times ``block_skip_factor``; it may not beat
    the bound by more than ``DRY_SLACK``.  The plain route timed beside
    the walker's bytes and FLOPs."""
    from repro_torch.configs import get_config
    from repro_torch.core.gpu_model import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import hillclimb
    from repro_torch.launch.shapes import SHAPES, adjust_config
    from repro_torch.models.attention import _heads_first
    g = DRY_GEMMA
    cfg = adjust_config(get_config(g["arch"]), SHAPES[g["shape"]])
    s, b = SHAPES[g["shape"]].seq, g["batch"]
    gen = torch.Generator(device=device).manual_seed(DRY_SEED + 1)
    q, k, v = (_heads_first(torch.randn(
        (b, s, n, cfg.hd), generator=gen, device=device, dtype=cfg.dtype))
        for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    args = (q, k, v, cfg.n_heads, cfg.n_kv_heads)
    out = {}
    for w in g["windows"]:
        sub = hillclimb.attention_bytes_per_layer(cfg.replace(window=w), b,
                                                  s, False)
        factor = hillclimb.block_skip_factor(s, w)
        kw = {"causal": True, "window": w}
        hold_call(held, "flash_attention", f"gemma3 attention, window {w}",
                  args, kw, main=True)
        row = {"window": w, "kernel_bytes": sub["kernel_bytes"],
               "walker_bytes": sub["xla_bytes"],
               "walker_flops": sub["xla_flops"], "skip_factor": factor,
               "ms": cuda_ms(lambda: ops.flash_attention(*args, **kw),
                             iters=10),
               "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
                   *args, True, w), iters=3, warmup=1)}
        row["bytes_bound_ms"] = sub["kernel_bytes"] / HBM_BW * 1e3
        row["flops_bound_ms"] = (sub["xla_flops"] * factor
                                 / PEAK_FLOPS_BF16 * 1e3)
        row["bound_ms"] = max(row["bytes_bound_ms"], row["flops_bound_ms"])
        row["walker_ms"] = max(sub["xla_bytes"] / HBM_BW,
                               sub["xla_flops"] / PEAK_FLOPS_BF16) * 1e3
        out[f"window_{w}"] = row
        print(f"  gemma3-27b attention layer (1 x {s}, {cfg.n_heads}/"
              f"{cfg.n_kv_heads} heads, window {w}): kernel {row['ms']} ms "
              f"against its bound {row['bound_ms']} ms (kernel-true bytes "
              f"{row['bytes_bound_ms']} ms, block-skipped FLOPs "
              f"{row['flops_bound_ms']} ms at factor {factor}); plain "
              f"{row['plain_ms']} ms against the walker's "
              f"{row['walker_ms']} ms ({sub['xla_bytes']} bytes, "
              f"{sub['xla_flops']} FLOPs)  [{card}]")
        check(row["ms"] >= row["bound_ms"] / DRY_SLACK, f"gemma3 attention "
              f"window {w}: the kernel's {row['ms']} ms beats its bound "
              f"{row['bound_ms']} ms by more than {DRY_SLACK}")
    return out


def dryrun_slice(device, card, report) -> dict:
    """Phase 22: the dry run's count held on the card.  The 16 x 16
    record of Qwen3-0.6B's ``train_4k`` on the ``fake`` backend (in its
    own process, on the CPU while the rest runs); Qwen3-0.6B at full
    width and depth on three cells cut in batch (``DRY_CELLS``,
    ``dry_cell``); then gemma3-27b's attention layer under the
    hill-climb's substitution.  Returns the main-path launches and the
    kernel checks by kernel."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, adjust_config
    held = Held()
    out, secs, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        proc = start_fake_dryrun(DRY_ARCH, "train_4k", tmp)
        try:
            for shape_name, batch in DRY_CELLS:
                t0 = time.perf_counter()
                cfg = adjust_config(get_config(DRY_ARCH), SHAPES[shape_name])
                out[shape_name] = dry_cell(cfg, shape_name, batch, device,
                                           card, held)
                add_launches(launches, out[shape_name]["launches"])
                secs[shape_name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["gemma3_attention"] = hold_gemma_substitution(device, card,
                                                              held)
            secs["gemma3_attention"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["fake_16x16"] = rec = fake_dryrun_record(
                proc, DRY_ARCH, "train_4k", tmp)
            secs["fake_16x16_wait"] = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    r = rec["roofline"]
    print(f"dry run {DRY_ARCH} x train_4k x 16x16 on the fake backend: "
          f"argument {rec['memory']['argument_bytes']} bytes a device, "
          f"output {rec['memory']['output_bytes']}; flops {r['flops']}, "
          f"hbm {r['hbm_bytes']}, bound {r['bound']}, step "
          f"{r['step_time_s']} s, model FLOPs ratio "
          f"{r['model_flops_ratio']}; traced in {rec['compile_us'] / 1e6} s")
    out["attention_rows"] = held.row_rel
    out["seconds"] = secs
    report["dryrun"] = out
    print(f"dry run phase: each bf16 attention held against its plain "
          f"version, relative error by query row (worst, whole): "
          f"{held.row_rel} (limit {ATTN_BF16_ROW_REL})")
    print(f"dry run phase: main-path launches {launches}; seconds {secs}")
    return {"launches": launches,
            "held": {name: (len(held.cases[name]), held.max_err(name))
                     for name in OPS if held.cases[name]}}


def state_bytes(state) -> int:
    """Bytes of every tensor of a state tree (dicts and tuples)."""
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(state_bytes(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    return 0


def dry_reckoning(cfg, kind: str, batch: int, seq: int) -> dict:
    """The cell's bytes on the meta device, before any run: its state
    (parameters; AdamW's moments for training; the cache for decode),
    and the most held at once while it is made and two kernel-shaped
    steps run from it, so that what a first step leaves (the tied head's
    kept copy) is held through the second, as on the card."""
    from repro_torch.launch.program import StepReader
    reader = StepReader()
    with reader:
        step, state, x = dry_inputs(cfg, kind, batch, seq,
                                    torch.device("meta"))
        made = state_bytes(state)
        for _ in range(2):
            state, _ = step(state, x)
    peak = reader.peak
    return {"state_gb": made / 1e9,
            "step_peak_gb": (peak - made) / 1e9,
            "total_gb": peak / 1e9}


def walked_and_counted(cfg, kind: str, batch: int, seq: int):
    """The walker's ``Cost`` of the cell's plain-route step at full depth
    (``dryrun.depth_cost`` over ``dryrun.step_program``) and
    ``FlopCounterMode``'s FLOPs over the same traces, extrapolated the
    same way."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import costmodel, dryrun
    counted_ = {}

    def cost_of(c):
        fn, args = dryrun.step_program(c, kind, batch, seq)
        gm = costmodel.trace(fn, *args)
        walked = costmodel.walk(gm.graph)
        with FlopCounterMode(display=False) as fc:
            gm(*args)
        counted_[c.n_layers] = costmodel.Cost(
            flops=float(fc.get_total_flops()))
        return walked
    cost = dryrun.depth_cost(cfg, cost_of)
    flops = dryrun.depth_cost(cfg, lambda c: counted_[c.n_layers]).flops
    return cost, flops


def dry_outputs(cfg, kind: str, impl, state, x, seq: int) -> torch.Tensor:
    """The logits a cell's routes are compared by, on ``Model(cfg,
    impl)`` from ``state``: training a forward over the batch, a prefill
    its last position, decode one step from the cache at
    ``DRY_DECODE_STEPS`` rows short of its end."""
    from repro_torch.models.transformer import Model
    model = Model(cfg, impl=impl)
    with torch.no_grad():
        if kind == "train":
            return model.forward(state["params"], x["tokens"])[0]
        if kind == "prefill":
            return model.prefill(state, x["tokens"],
                                 seq + cfg.n_patches + 8)[0]
        params, cache = state
        for part in cache.values():
            part["pos"].fill_(seq - DRY_DECODE_STEPS)
        return model.decode_step(params, x, cache)[0]


def hold_dry_recorded(held, rec, label: str) -> dict:
    """``hold_recorded``, but an attention whose plain version would
    make more than ``DRY_PLAIN_ATTN_BYTES`` of float32 logits is held on
    its first KV group (``kv_group``).  Returns the shapes held by
    kernel."""
    got = {}
    for key in [key for key, (_, args, _) in rec.inputs.items()
                if key[0] == "flash_attention"
                and 4 * args[0].shape[0] * args[0].shape[1] ** 2
                > DRY_PLAIN_ATTN_BYTES]:
        _, args, kwargs = rec.inputs.pop(key)
        args = tuple(a.to(CARD) if isinstance(a, torch.Tensor) else a
                     for a in args)
        hold_call(held, "flash_attention", f"{label} {key[1]}, its first "
                  f"KV group", kv_group(*args[:5]) + args[5:], kwargs,
                  main=True)
        got["flash_attention"] = got.get("flash_attention", 0) + 1
    for name, n in hold_recorded(held, rec, label).items():
        got[name] = got.get(name, 0) + n
    return got


def dry_cell(cfg, shape_name: str, batch: int, device, card, held) -> dict:
    """One of Qwen3-0.6B's cells at full width and depth: the walker's
    roofline (``analyze`` on one card, and for train/prefill after the
    kernel's flash substitution with block skipping); the kernel route
    on the card, its first call (a step, a prefill, ``DRY_DECODE_STEPS``
    steps) through ``RecordingOps`` (launches held, every GEMM on
    `wgmma`), then timed (ms by events, device ms and idle share from
    the profiler, peak memory).  Held: the roofline step time at most
    ``DRY_SLACK`` x the device time; the walker's GEMM FLOPs equal to
    ``FlopCounterMode``'s; the peak within ``DRY_PEAK_MARGIN_GB`` of the
    reckoning; the outputs finite and in range; the kernel route's
    logits within ``SERVE_BF16_ROW_REL`` or ``MIXER_CONTROL_FACTOR`` x
    a control's (the plain route with its GEMM sums reordered), worst
    row, of the plain route's from the same state (``grouped_plain``;
    training also the first step's loss within ``TRAIN_REL``); each
    kernel on the inputs the first call gave it against its plain
    version (``hold_dry_recorded``)."""
    from repro_torch.core.gpu_model import PEAK_FLOPS_BF16
    from repro_torch.kernels import ops
    from repro_torch.launch import hillclimb, roofline
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models.transformer import Model
    shape = SHAPES[shape_name]
    kind, seq = shape.kind, shape.seq
    label = f"{cfg.name} {shape_name} at {batch}"
    out = {"cell": shape_name, "batch": batch, "seq": seq,
           "cut": f"batch {shape.global_batch} -> {batch}"}
    out["reckoning"] = dry_reckoning(cfg, kind, batch, seq)
    free, _ = torch.cuda.mem_get_info()
    check(out["reckoning"]["total_gb"] * 1e9 < free, f"{label}: reckoned "
          f"{out['reckoning']['total_gb']} GB, {free / 1e9} GB free")

    t0 = time.perf_counter()
    cost, counted_flops = walked_and_counted(cfg, kind, batch, seq)
    out["walk_s"] = time.perf_counter() - t0
    _, n_active = roofline.count_params(Model(cfg).param_defs())
    tokens = batch * (1 if kind == "decode" else seq)
    rec = {"roofline": roofline.analyze(cost, 1, n_active, tokens,
                                        kind == "train")}
    out["plain_roofline"] = rec["roofline"]
    if kind != "decode":
        rec = hillclimb.apply_flash_substitution(rec, cfg, shape_name,
                                                 skip=True, batch=batch)
    r = rec["roofline"]
    out["roofline"] = r
    out["gemm_flops"], out["flop_counter_flops"] = cost.gemm_flops, \
        counted_flops
    check(cost.gemm_flops == counted_flops, f"{label}: the walker's GEMM "
          f"FLOPs {cost.gemm_flops} differ from FlopCounterMode's "
          f"{counted_flops}")

    recorded = RecordingOps(host=True)
    step, state, x = dry_inputs(cfg, kind, batch, seq, device,
                                impl=recorded)
    out["state_gb"] = state_bytes(state) / 1e9
    plain = grouped_plain()
    if kind == "train":
        # the plain route's loss from the weights the first step sees
        with torch.no_grad():
            out["plain_loss"] = float(Model(cfg, impl=plain).loss(
                state["params"], x)[0])
    torch.cuda.reset_peak_memory_stats()
    reps = DRY_DECODE_STEPS if kind == "decode" else 1

    def reset():
        if kind == "decode":
            for part in state[1].values():
                part["pos"].fill_(seq - DRY_DECODE_STEPS)

    def run(n=reps):
        nonlocal state
        outs = []
        for _ in range(n):
            state, o = step(state, x)
            outs.append(o)
        return outs

    if kind == "train":
        want = chunked_train_launches(cfg, seq)
    else:
        want = {k: n * reps for k, n in
                serve_launches(cfg, kind == "prefill").items()}
    recorded.model = label
    outs, launches, routes = counted(label, run, want, "wgmma")
    recorded.model = None
    out["launches"], out["routes"] = launches, routes
    if kind == "train":
        out["loss"] = float(outs[0]["loss"])
        out["outputs_ok"] = all(bool(torch.isfinite(o["loss"]))
                                for o in outs)
    elif kind == "prefill":
        out["outputs_ok"] = all(
            o.shape == (batch, cfg.vocab_size) and
            bool(torch.isfinite(o).all()) for o in outs)
    else:
        out["outputs_ok"] = all(
            o.shape == (batch,) and bool(((o >= 0) & (o < cfg.vocab_size))
                                         .all()) for o in outs)
    del outs

    times = []
    for _ in range(DRY_TIMED if kind != "decode" else 1):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    out["ms_each"] = times
    out["ms"] = sorted(times)[len(times) // 2]
    # the trace of one call (decode: the 8 steps), split by kernel
    reset()
    prof = profile_step(run, SERVE_KERNELS)
    out["device_ms"] = prof["device_ms"] / reps if prof["device_ms"] \
        else None
    out["device_parts_ms"] = {k: v / reps
                              for k, v in prof["parts_ms"].items()}
    out["trace_records"] = prof["records"]
    out["trace_top"] = prof["top"][:5]
    out["idle"] = None if out["device_ms"] is None else \
        1.0 - out["device_ms"] / out["ms"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_less_reckoned_gb"] = (out["peak_gb"]
                                    - out["reckoning"]["total_gb"])

    # the kernel route against the plain route from the same state, and
    # the plain route with its GEMM sums reordered against it: bf16's own
    # floor (the limit is phases 18-21's, MIXER_CONTROL_FACTOR)
    t0 = time.perf_counter()
    want_logits = dry_outputs(cfg, kind, plain, state, x, seq)
    got_logits = dry_outputs(cfg, kind, ops, state, x, seq)
    out["row_rel"] = row_rel(got_logits, want_logits)
    del got_logits
    control = dry_outputs(cfg, kind, grouped_plain(reordered_plain()),
                          state, x, seq)
    out["control_row_rel"] = row_rel(control, want_logits)
    out["row_limit"] = max(SERVE_BF16_ROW_REL, MIXER_CONTROL_FACTOR
                           * out["control_row_rel"])
    out["compare_s"] = time.perf_counter() - t0
    del step, state, x, want_logits, control
    torch.cuda.empty_cache()
    out["held"] = hold_dry_recorded(held, recorded, label)

    out["roofline_ms"] = r["step_time_s"] * 1e3
    if out["device_ms"] is not None:
        out["roofline_over_device"] = out["roofline_ms"] / out["device_ms"]
    out["mfu"] = r["model_flops"] / (out["ms"] / 1e3) / PEAK_FLOPS_BF16
    print(f"  {label}: reckoned {out['reckoning']['total_gb']:.2f} GB "
          f"(state {out['reckoning']['state_gb']:.2f}); walker "
          f"{cost.flops} FLOPs ({cost.gemm_flops} GEMM = FlopCounterMode's "
          f"{counted_flops}), {cost.bytes} bytes, traced in "
          f"{out['walk_s']:.1f} s")
    for name, rr in (("plain route", out["plain_roofline"]),
                     ("kernel route" + (" (flash+skip)" if kind != "decode"
                                        else ""), r)):
        print(f"    roofline, {name}: compute {rr['t_compute_s'] * 1e3} ms, "
              f"memory {rr['t_memory_s'] * 1e3} ms, bound {rr['bound']}, "
              f"step {rr['step_time_s'] * 1e3} ms, model FLOPs ratio "
              f"{rr['model_flops_ratio']}")
    print(f"    measured: {out['ms']} ms by events ({out['ms_each']}), "
          f"device {out['device_ms']} ms (by part "
          f"{out['device_parts_ms']}; records {out['trace_records']}), "
          f"idle {out['idle']}; roofline / device "
          f"{out.get('roofline_over_device')} (limit {DRY_SLACK}); MFU "
          f"{out['mfu']}; peak {out['peak_gb']} GB, reckoned "
          f"{out['reckoning']['total_gb']} GB (peak less reckoning "
          f"{out['peak_less_reckoned_gb']} GB, limits "
          f"{DRY_PEAK_MARGIN_GB}; state {out['state_gb']} GB); launches "
          f"{launches}, routes {routes}  [{card}]")
    print(f"    outputs finite and in range: {out['outputs_ok']}; kernel "
          f"route against the plain route from the same state: worst row "
          f"{out['row_rel']} (limit {out['row_limit']}: {SERVE_BF16_ROW_REL}"
          f" or {MIXER_CONTROL_FACTOR} x the reordered control's "
          f"{out['control_row_rel']}; {out['compare_s']:.1f} s)" +
          (f"; first step's loss {out['loss']} against the plain route's "
           f"{out['plain_loss']} (relative limit "
           f"{TRAIN_REL[torch.bfloat16]})" if kind == "train" else "") +
          f"; each kernel on its inputs: {out['held']} shapes held")
    print(f"    the longest kernels of the traced call (name, ms, "
          f"records; decode: {reps} steps): "
          f"{out['trace_top']}")

    check(out["device_ms"] is not None, f"{label}: the profiler's trace "
          f"holds no device time")
    check(out["roofline_ms"] <= DRY_SLACK * out["device_ms"], f"{label}: "
          f"the roofline's {out['roofline_ms']} ms is above {DRY_SLACK} x "
          f"the card's {out['device_ms']} device ms: the count is wrong")
    low, high = DRY_PEAK_MARGIN_GB
    check(-low <= out["peak_less_reckoned_gb"] <= high, f"{label}: the "
          f"peak {out['peak_gb']} GB less the reckoning "
          f"{out['reckoning']['total_gb']} GB is "
          f"{out['peak_less_reckoned_gb']} GB, outside [-{low}, {high}]")
    check(out["outputs_ok"], f"{label}: an output is not finite or out of "
          f"range")
    check(out["row_rel"] <= out["row_limit"], f"{label}: the kernel "
          f"route's logits off the plain route's by {out['row_rel']} "
          f"(worst row), above {out['row_limit']}")
    if kind == "train":
        out["loss_rel"] = abs(out["loss"] - out["plain_loss"]) / abs(
            out["plain_loss"])
        check(out["loss_rel"] <= TRAIN_REL[torch.bfloat16], f"{label}: the "
              f"first step's loss {out['loss']} off the plain route's "
              f"{out['plain_loss']} by {out['loss_rel']} (relative)")
    return out


# ---------------------------------------------------------------------------
# Phase 23: the port's static checks, a lock witness, the port's examples
# ---------------------------------------------------------------------------

ANALYSIS_BASELINE = "analysis-baseline-torch.json"
EXAMPLES = ("quickstart", "serve_batched", "train_resume",
            "simulate_accelerator", "dse_service")
# the locks the witness's burst must take at least once (by the end of
# their id in the manifest's lock_order)
WITNESSED = (":DSEService.self._lock", ":ServiceMetrics.self._lock",
             "core/dse.py:_CACHE_LOCK", "kernels/reduce.py:_WS_LOCK",
             "kernels/reduce.py:_COUNT_LOCK", "kernels/_ext.py:_LOCK")
EXAMPLE_TIMEOUT_S = 600


class _RecordingLock:
    """A lock of the manifest's ``lock_order`` that tells a
    ``LockWitness`` when it is taken and let go."""

    def __init__(self, inner, lock_id: str, witness: "LockWitness"):
        self._inner, self._id, self._witness = inner, lock_id, witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.acquired(self._id)
        return got

    def release(self) -> None:
        self._witness.released(self._id)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LockWitness:
    """Replaces every lock of ``order`` (the analysis manifest's
    ``lock_order``: module globals, ``Class.self.attr`` instance locks,
    ``Class.method`` context managers) with a recording wrapper, and
    keeps each thread's held locks: a lock taken while another is held is
    an observed nesting, ``edges[(held, taken)]``; ``inversions()`` lists
    the nestings the order does not allow.  ``uninstall`` puts every
    original back."""

    def __init__(self, order):
        self.order = tuple(order)
        self.rank = {lock_id: i for i, lock_id in enumerate(self.order)}
        self.counts = dict.fromkeys(self.order, 0)
        self.edges = {}
        self._held = threading.local()
        self._lock = threading.Lock()
        self._undo = []

    def _stack(self) -> list:
        if not hasattr(self._held, "ids"):
            self._held.ids = []
        return self._held.ids

    def acquired(self, lock_id: str) -> None:
        held = self._stack()
        with self._lock:
            self.counts[lock_id] += 1
            for h in dict.fromkeys(held):
                if h != lock_id:
                    self.edges[(h, lock_id)] = \
                        self.edges.get((h, lock_id), 0) + 1
        held.append(lock_id)

    def released(self, lock_id: str) -> None:
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == lock_id:
                del held[i]
                return

    def inversions(self) -> list:
        return sorted(f"{a} -> {b}" for a, b in self.edges
                      if self.rank[a] >= self.rank[b])

    def _patch(self, owner, name: str, value) -> None:
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def install(self) -> "LockWitness":
        import contextlib
        import importlib
        for lock_id in self.order:
            path, _, name = lock_id.partition(":")
            module = importlib.import_module(
                path.removesuffix(".py").replace("/", "."))
            if ".self." in name:
                cls_name, _, attr = name.partition(".self.")
                cls = getattr(module, cls_name)
                init = cls.__dict__["__init__"]

                def wrapped_init(obj, *a, _init=init, _attr=attr,
                                 _id=lock_id, **k):
                    _init(obj, *a, **k)
                    setattr(obj, _attr, _RecordingLock(
                        getattr(obj, _attr), _id, self))
                self._patch(cls, "__init__", wrapped_init)
            elif "." in name:
                cls_name, _, meth = name.partition(".")
                cls = getattr(module, cls_name)
                method = cls.__dict__[meth]

                @contextlib.contextmanager
                def recorded(obj, *a, _method=method, _id=lock_id, **k):
                    self.acquired(_id)      # before: the body may fire
                    try:
                        with _method(obj, *a, **k):
                            yield
                    finally:
                        self.released(_id)
                self._patch(cls, meth, recorded)
            else:
                self._patch(module, name, _RecordingLock(
                    getattr(module, name), lock_id, self))
        return self

    def uninstall(self) -> None:
        while self._undo:
            owner, name, value = self._undo.pop()
            setattr(owner, name, value)


def lock_witness(device=None) -> dict:
    """Phase 23 (b), in a process of its own (so that the grid kernel's
    library is loaded, under ``_ext._LOCK``, by the burst): every lock of
    ``repro_torch.analysis.DEFAULT_MANIFEST.lock_order`` replaced by a
    recording wrapper, then phase 8's burst through one ``DSEService`` over
    a study on ``device`` (``CARD``) on cold table caches, from 4 client
    threads, every answer held bit-identical to a direct search
    (``drive_service``).  Returns the locks' counts, the observed nestings
    and those the order forbids."""
    from repro_torch.analysis import DEFAULT_MANIFEST
    from repro_torch.core.dse import clear_table_caches
    device = torch.device(CARD if device is None else device)
    witness = LockWitness(DEFAULT_MANIFEST.lock_order).install()
    try:
        clear_table_caches()
        t0 = time.perf_counter()
        with Recorder() as rec:
            service = drive_service(device, rec)
        wall = time.perf_counter() - t0
    finally:
        witness.uninstall()
    return {"counts": witness.counts,
            "edges": {f"{a} -> {b}": n
                      for (a, b), n in sorted(witness.edges.items())},
            "inversions": witness.inversions(), "wall_s": wall,
            "launches": service["launches"],
            "expected_launches": service["expected_launches"],
            "failed": service["failed"]}


def _start(args, out_dir: Path, name: str) -> tuple:
    """``args`` started from the repository root with ``src`` on the path,
    stdout and stderr into ``out_dir``."""
    out = open(out_dir / f"{name}.out", "w+")
    err = open(out_dir / f"{name}.err", "w+")
    proc = subprocess.Popen(
        args, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=out, stderr=err, text=True)
    return proc, out, err


def _finish_all(started: dict, timeout: float) -> dict:
    """``{name: (returncode, stdout, stderr, seconds)}`` of ``_start``ed
    processes, each waited for until ``timeout`` seconds from now and
    killed there (returncode None); ``seconds`` is the time from this
    call to the process's end."""
    t0 = time.perf_counter()
    ended = {}
    while len(ended) < len(started):
        for name, (proc, _, _) in started.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            for name, (proc, _, _) in started.items():
                if name not in ended:
                    proc.kill()
                    proc.wait()
                    ended[name] = None
        time.sleep(0.05)
    done = {}
    for name, (proc, out, err) in started.items():
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        rc = None if ended[name] is None else proc.returncode
        done[name] = (rc, texts[0], texts[1], ended[name])
    return done


def analysis_slice(device, card, report) -> dict:
    """Phase 23: (a) ``python -m repro_torch.analysis --baseline
    analysis-baseline-torch.json`` over the shipped tree must exit 0,
    overlapped with (b) ``lock_witness`` in a process of its own, whose
    observed nestings must all be ordered by the manifest and which must
    take each lock of ``WITNESSED``, and (c) the port's five examples run
    as a user runs them, on the card, each with rc 0 (``torch_train_resume``
    holds its own drift; ``torch_simulate_accelerator`` prints on the card
    what it prints with ``--device cpu``)."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        logs = Path(tmp)
        started = {
            "analysis": _start([sys.executable, "-m", "repro_torch.analysis",
                                "--baseline", ANALYSIS_BASELINE], logs,
                               "analysis"),
            "witness": _start([sys.executable, "-c",
                               "import json, sys; sys.path.insert(0, '.'); "
                               "import chip_smoke; print(json.dumps("
                               "chip_smoke.lock_witness()))"], logs,
                              "witness"),
        }
        for name in EXAMPLES:
            started[name] = _start(
                [sys.executable, f"examples/torch_{name}.py"], logs, name)
        started["simulate_accelerator/cpu"] = _start(
            [sys.executable, "examples/torch_simulate_accelerator.py",
             "--device", "cpu"], logs, "simulate_accelerator.cpu")
        done = _finish_all(started, EXAMPLE_TIMEOUT_S)
    out["seconds"] = {name: d[3] for name, d in done.items()}

    def ok(name: str) -> str:
        rc, stdout, stderr, _ = done[name]
        check(rc == 0, f"phase 23: {name} exited {rc}:\n{stdout[-3000:]}\n"
                       f"{stderr[-3000:]}")
        return stdout

    summary = ok("analysis").strip().splitlines()[0]
    m = re.search(r"(\d+) file\(s\), (\d+) finding\(s\)", summary)
    check(m is not None and int(m.group(2)) == 0,
          f"phase 23: the analysis reported {summary!r}")
    out["analysis"] = {"files": int(m.group(1)),
                       "findings": int(m.group(2)), "line": summary}
    print(f"analysis on the shipped tree: {out['analysis']['files']} "
          f"files, {out['analysis']['findings']} findings, rc 0")

    witness = json.loads(ok("witness").strip().splitlines()[-1])
    out["witness"] = witness
    check(witness["inversions"] == [],
          f"phase 23: nestings against the manifest's lock order: "
          f"{witness['inversions']}")
    for suffix in WITNESSED:
        lock_id = next(i for i in witness["counts"] if i.endswith(suffix))
        check(witness["counts"][lock_id] >= 1,
              f"phase 23: the witness never saw {lock_id} taken")
    print(f"lock witness: {sum(witness['edges'].values())} nested "
          f"acquisitions over {len(witness['edges'])} ordered pairs, none "
          f"against the order; taken: " + ", ".join(
              f"{i.rpartition('/')[2]} {n}"
              for i, n in witness["counts"].items())
          + f"; grid_minmax launches {witness['launches']} (expected "
            f"{witness['expected_launches']}); failed {witness['failed']}; "
            f"{witness['wall_s']:.1f} s")
    for pair, n in witness["edges"].items():
        print(f"  nested: {pair} x{n}")

    out["examples"] = {}
    for name in EXAMPLES:
        stdout = ok(name)
        out["examples"][name] = {"lines": len(stdout.splitlines())}
    check("OK — resumed trajectory matches" in done["train_resume"][1],
          "phase 23: torch_train_resume did not hold its drift")
    out["examples"]["train_resume"]["drift"] = re.search(
        r"drift vs uninterrupted run: (\S+)", done["train_resume"][1])[1]
    for name in ("quickstart", "serve_batched"):
        check(" on cuda" in done[name][1],
              f"phase 23: torch_{name} did not serve on the card")
    card_lines = ok("simulate_accelerator").splitlines()
    check(card_lines == ok("simulate_accelerator/cpu").splitlines()
          and len(card_lines) >= 10,
          "phase 23: torch_simulate_accelerator printed on the card what it "
          "did not print on the CPU")
    ex = out["examples"]
    ex["simulate_accelerator"]["same_on_cpu"] = len(card_lines)
    print("examples on the card, rc 0: " + ", ".join(
        f"torch_{n} ({v['lines']} lines)" for n, v in ex.items())
        + f"; train_resume drift {ex['train_resume']['drift']}; "
        f"simulate_accelerator's {ex['simulate_accelerator']['same_on_cpu']}"
        f" lines equal to --device cpu's  [{card}]")
    print("  seconds to each process's end: " + ", ".join(
        f"{n} {t:.1f}" for n, t in out["seconds"].items()))
    report["analysis_phase"] = out
    return {"launches": {"grid_minmax": witness["launches"]}}


# ---------------------------------------------------------------------------
# phase 24: the partitioned route
# ---------------------------------------------------------------------------

PART_ARCH = "qwen3-0.6b"
PART_SEED = 2026
PART_PREFILL = (2, 2048)          # (a)'s prefill: batch, tokens
PART_DECODE_STEPS = 4
PART_TRAIN = (2, 1024)            # (a)'s AdamW step: batch, tokens
PART_LR = 1e-3
# (b)'s cells of launch/shapes.py, each at its full global shape
PART_CELLS = ("train_4k", "prefill_32k", "decode_32k")
# the card's peak allocated bytes of a cell, less the dry run's
# argument_bytes + temp_bytes, in GB (phase 22's limit for its peak)
PART_PEAK_MARGIN_GB = 0.1


def _whole(t):
    from repro_torch.models.common import is_placed
    return t.full_tensor() if is_placed(t) else t


def same_tree(label: str, got, want) -> int:
    """Every leaf of ``got`` (``DTensor``s gathered) the same bits as
    ``want``'s; returns the leaves held."""
    items = list(leaf_items(want))
    got_items = dict(leaf_items(got))
    for name, w in items:
        g = _whole(got_items[name])
        check(g.dtype == w.dtype and g.shape == w.shape
              and torch.equal(g, w), f"{label}{name}: the partitioned "
              f"route differs from the unpartitioned one on one rank")
    return len(items)


def one_rank_partitioned(device, mesh) -> dict:
    """Phase 24 (a): Qwen3-0.6B's prefill, decode steps and AdamW step on
    the partitioned route over the one-rank ``mesh``, each held bit-equal
    to the unpartitioned kernel route from the same weights (on one rank
    every shard is the whole tensor): the prefill's logits and cache,
    each decode step's logits (``Model.decode_step`` on a copy of the
    cache) and the tokens and cache of ``make_serve_step``, the loss,
    every gradient and the updated state.  The unpartitioned route runs
    first; the partitioned route's launches are counted alone and held
    equal to the unpartitioned route's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models.common import (PROD_RULES, place, tree_map,
                                           with_axis_sizes)
    from repro_torch.models.layers import greedy
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, constant_schedule
    cfg = get_config(PART_ARCH)               # bf16; remat "full"
    rules = with_axis_sizes(PROD_RULES, mesh)
    gen = torch.Generator(device=device).manual_seed(PART_SEED)
    params = conditioned(Model(cfg).init(gen))
    (b, s), (tb, ts) = PART_PREFILL, PART_TRAIN
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=device, dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (tb, ts), generator=gen,
                           device=device, dtype=torch.int32)
    max_len = s + PART_DECODE_STEPS + 8
    opt = AdamW(schedule=constant_schedule(PART_LR))
    part = Model(cfg, impl=ops.partitioned(ops, mesh, rules))
    sh = train.make_state_shardings(part, opt, rules, mesh)

    def run(model, params, place_batch, step_rules):
        """Prefill, decode steps and one step; their outputs."""
        out = {}
        logits, cache = serve.make_prefill_step(model, step_rules, max_len)(
            params, {"tokens": place_batch(prompts)})
        out["prefill"] = {"logits": logits, "cache": cache}
        decode = serve.make_serve_step(model, step_rules)
        tok = greedy(logits)
        for i in range(PART_DECODE_STEPS):
            # the logits from a copy of the cache; the tokens and the
            # cache through the serve step
            lg = model.decode_step(params, tok[:, None], tree_map(
                torch.clone, cache), step_rules)[0]
            tok, cache = decode(params, cache, tok[:, None])
            out[f"decode{i}"] = {"logits": lg, "tokens": tok}
        out["cache"] = cache
        p = train.trainable(params)
        keep = KeepGrads(opt)
        new, metrics = train.make_train_step(
            model if step_rules else Model(cfg, impl=ops.differentiable()),
            keep, step_rules)({"params": p, "opt": opt.init(p)},
                              {"tokens": place_batch(tokens)})
        out["step"] = {"state": new, "grads": keep.grads,
                       "loss": metrics["loss"],
                       "grad_norm": metrics["grad_norm"]}
        return out

    zero_counters()
    want = run(Model(cfg), params, lambda t: t, None)
    torch.cuda.synchronize()
    want_launches = {k: c.launches for k, c in _counters().items()}
    dparams = place(params, sh["params"])
    batch_pl = train.batch_shardings(mesh, rules, {"tokens": None})
    zero_counters()
    got = run(part, dparams,
              lambda t: place({"tokens": t}, batch_pl)["tokens"], rules)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in _counters().items()}
    check(launches == want_launches and all(
        launches[k] > 0 for k in ("matmul", "fused_add_rmsnorm",
                                  "flash_attention")),
          f"the partitioned route launched {launches}, the unpartitioned "
          f"{want_launches}")
    held = {part_: same_tree(f"{part_}: ", got[part_], want[part_])
            for part_ in want}
    local = got["prefill"]["logits"].to_local().shape
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "launches": launches, "leaves_held": held,
           "loss": float(_whole(got["step"]["loss"])),
           "grad_norm": float(_whole(got["step"]["grad_norm"])),
           "logits_local": list(local),
           "placements": [str(p) for p in got["prefill"]["logits"]
                          .placements]}
    print(f"  (a) one-rank {out['mesh']} NCCL mesh: prefill {b} x {s}, "
          f"{PART_DECODE_STEPS} decode steps, AdamW step {tb} x {ts} under "
          f"remat full, bit-equal to the unpartitioned kernel route "
          f"(leaves held {held}); loss {out['loss']}, grad_norm "
          f"{out['grad_norm']}; launches {launches} (the unpartitioned "
          f"route's too)")
    return out


def traced_device_ms(fn) -> tuple:
    """``(ms, records)``: the device milliseconds of one call of ``fn``
    from a trace of the card's activity alone (the host's ops, thousands
    on the partitioned route, are not recorded; ms None where the trace
    holds none) and the device records it holds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.device_time_total for e in device)
    return (us / 1e3 if us else None), len(device)


def fake_partitioned(device, card, record_of) -> dict:
    """Phase 24 (b): rank 0's program of each ``PART_CELLS`` cell, the
    last first (``train_4k``'s dry run takes longest), on the ``fake``
    process group at world 256 with the real kernels: the allocator's
    peak against the dry run's ``argument_bytes + temp_bytes``
    (``record_of(name)``), the collectives read on the card against the
    dry run's, and a warm step timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.program import local_program, read_step
    from repro_torch.launch.shapes import SHAPES, adjust_config, cell_rules
    from repro_torch.models.common import with_axis_sizes
    out, launches = {}, {}
    with fake_world(False):
        mesh = make_production_mesh(device_type=device.type)
        for name in reversed(PART_CELLS):
            shape = SHAPES[name]
            cfg = adjust_config(get_config(PART_ARCH), shape)
            rules = with_axis_sizes(cell_rules(shape, False, 16), mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device=device).manual_seed(PART_SEED)
            step, inputs = local_program(cfg, shape.kind, shape.global_batch,
                                         shape.seq, mesh, rules, impl=ops,
                                         device=device, generator=gen)
            torch.cuda.synchronize()
            args = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            t0 = time.perf_counter()
            read = read_step(step, *inputs)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            for k, c in _counters().items():
                launches[k] = launches.get(k, 0) + c.launches
            rec = record_of(name)
            mem, roof = rec["memory"], rec["roofline"]
            dry = mem["argument_bytes"] + mem["temp_bytes"]
            per_device = {k: v // 256 for k, v in
                          roof["collective_by_kind"].items()}
            check(abs(peak - dry) <= PART_PEAK_MARGIN_GB * 1e9,
                  f"{name}: the card's peak {peak} B, the dry run's "
                  f"argument + temp {dry} B")
            check(read["collective_by_kind"] == per_device
                  and read["collective_bytes"]
                  == roof["collective_bytes_per_device"],
                  f"{name}: collectives on the card "
                  f"{read['collective_by_kind']}, the dry run's "
                  f"{per_device}")
            # a warm step by events, then one traced for its device ms
            t0 = time.perf_counter()
            ms = cuda_ms(lambda: step(*inputs), 1, warmup=0)
            device_ms, records = traced_device_ms(lambda: step(*inputs))
            timed_s = time.perf_counter() - t0
            out[name] = {
                "local_batch": list(inputs[-1]["tokens"].to_local().shape
                                    if isinstance(inputs[-1], dict) else
                                    inputs[-1].to_local().shape),
                "argument_bytes": args, "dry_argument_bytes":
                    mem["argument_bytes"], "peak_bytes": peak,
                "dry_bytes": dry, "peak_minus_dry_gb": (peak - dry) / 1e9,
                "temp_bytes": mem["temp_bytes"],
                "alias_bytes": mem["alias_bytes"], "card_read": read,
                "ms": ms, "device_ms": device_ms, "records": records,
                "seconds": {"read": read_s, "timed": timed_s},
                "t_collective_s": roof["t_collective_s"],
                "step_time_s": roof["step_time_s"], "bound": roof["bound"]}
            print(f"  (b) {name} rank 0 of 16 x 16 (fake): local "
                  f"{out[name]['local_batch']}, peak {peak / 1e9:.4f} GB "
                  f"against the dry run's argument + temp {dry / 1e9:.4f} "
                  f"GB ({(peak - dry) / 1e9:+.4f}); collectives "
                  f"{read['collective_by_kind']} B equal to the dry run's; "
                  f"{ms:.2f} ms by events, {device_ms} device ms in "
                  f"{records} records "
                  f"(fake collectives move nothing); dry-run roofline "
                  f"{roof['step_time_s']} s ({roof['bound']}) [{card}]")
            del step, inputs, read
    out["launches"] = launches
    return out


def partitioned_slice(device, card, report) -> dict:
    """Phase 24: (a) the one-rank partitioned route held bit-equal to the
    unpartitioned one, (b) rank 0's program of the 16 x 16 mesh on the
    ``fake`` group held against the dry run.  Returns the main-path
    launches of both."""
    import tempfile
    out, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in PART_CELLS:
            Path(tmp, name).mkdir()
            procs[name] = start_fake_dryrun(PART_ARCH, name,
                                            str(Path(tmp, name)))
        t0 = time.perf_counter()
        with one_rank_mesh(device) as mesh:
            out["one_rank"] = one_rank_partitioned(device, mesh)
        secs["one_rank"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        waited = {}

        def record_of(name):
            t = time.perf_counter()
            rec = fake_dryrun_record(procs[name], PART_ARCH, name,
                                     str(Path(tmp, name)))
            waited[name] = time.perf_counter() - t
            return rec
        t0 = time.perf_counter()
        out["fake"] = fake_partitioned(device, card, record_of)
        secs["fake"] = time.perf_counter() - t0
        secs["dry_run_wait"] = waited
    out["seconds"] = secs
    report["partitioned"] = out
    launches = dict(out["one_rank"]["launches"])
    for k, n in out["fake"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    print(f"partitioned phase: main-path launches {launches}; seconds "
          f"{secs}")
    return {"launches": launches}


def dse_phases(device, card, report) -> dict:
    """Phases 3-9: the DSE main path and the LLM searches, the refine and
    the service on the card; returns ``grid_minmax``'s kernels-line
    entry."""
    with Recorder() as rec:
        results, launches, routes, wall_s, inputs, built_on = \
            drive_main_path(device, rec)
    report["launches"] = launches
    report["routes"] = routes
    report["first_search_s"] = wall_s
    report["reports_built_on"] = built_on
    print(f"main path launches of grid_minmax: {launches}; by route: "
          f"{routes}")
    print(f"energy reports built on: {built_on}")
    for label, s in wall_s.items():
        print(f"  first search {label}: {s} s")
    fused = [lab for lab, _, _, _ in main_path_searches()
             if lab.endswith("/cycles")]
    for label in fused:
        check(launches[label] >= 1,
              f"{label}: the main path never launched grid_minmax")
    for label, by_route in routes.items():
        check(by_route["shared"] == launches[label],
              f"{label}: grid_minmax's main-path launches took the routes "
              f"{by_route}, expected every one on shared")

    report["parity"] = hold_against_numpy(results, device)
    print(f"parity with the numpy engine: {report['parity']['checks']} "
          f"checks passed; training grid max "
          f"{report['parity']['training_grid_max']}; power cap "
          f"{report['parity']['power_cap_w']} W with "
          f"{report['parity']['power_cap_infeasible']} candidates "
          f"infeasible; the custom objective's NaN scores "
          f"{report['parity']['custom_nan_scores']}")

    cases = {name: tuple(torch.from_numpy(a).to(device) for a in arrs)
             for name, arrs in kernel_cases().items()}
    for label, args_ in inputs.items():
        cases[f"main_path/{label}"] = args_
    held = hold_kernel(cases)
    report["kernel_checks"] = held
    print(f"grid_minmax == grid_minmax_ref exactly, and the same bits on a "
          f"second call, on {len(cases)} cases ({', '.join(cases)}); "
          f"routes: " + ", ".join(f"{n} {c['route']}" for n, c in
                                   held["cases"].items()
                                   if c["route"] != ["shared"]))
    del cases
    report["index_past_2_31"] = hold_index_past_2_31(device)
    print(f"grid_minmax == grid_minmax_ref == the placed answer at "
          f"46341 x 46341: {report['index_past_2_31']['kernel']}")

    int32_rate = int32_ops_per_s()
    report["int32_ops_per_s"] = int32_rate
    timing = {label: time_kernel(args_, int32_rate)
              for label, args_ in inputs.items()}
    report["kernel_times"] = timing
    for label, t in timing.items():
        print(f"  grid_minmax {label} {t['shape']}: {t['ms']} ms "
              f"(device {t['device_ms']} ms, profiler {t['profiler_ms']} "
              f"ms from {t['profiler_records']} records; kernels in the "
              f"trace {t['kernels_in_trace']}), plain "
              f"{t['plain_ms']} ms, bound {t['bound_ms']} ms "
              f"({t['bound_by']}), gathered-bytes bound "
              f"{t['gathered_bytes_bound_ms']} ms  [{card}]")
    report["search_ms"] = time_searches(device)
    for label, row in report["search_ms"].items():
        print(f"  warm search {label}: " + ", ".join(
            f"{k} {v}" for k, v in row.items()) + f"  [{card}]")

    with Recorder() as rec:
        llm_launches, llm_cases = llm_slice(device, card, report, rec,
                                            results)

    main_label = "lattice128/training/cycles"
    t = timing[main_label]
    return {
        "name": "grid_minmax", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grid_minmax.cu",
        "replaces": "src/repro/kernels/reduce.py:65",
        "launches": sum(launches.values()) + llm_launches,
        "checks": len(held["cases"]) + 1 + llm_cases,
        "max_abs_err": held["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "device_ms": t["device_ms"], "profiler_ms": t["profiler_ms"],
        "shape": t["shape"], "timed_on": main_label}


# The groups of phases ``--phases`` selects (numbered as in this file's
# docstring; phases 1-2, the card and the build, always run): a group
# runs whole, its first number naming it.  Phases 3-9 are the DSE main
# path and the LLM searches, whose refine holds on the main path's grid.
PHASE_GROUPS = ((3, 9), (10, 12), (13, 15), (16, 16), (17, 17), (18, 18),
                (19, 19), (20, 20), (21, 21), (22, 22), (23, 23),
                (24, 24))


def parse_phases(text: str) -> set:
    """The groups (by first phase) that ``--phases`` names: ``all``, or
    phases and ranges such as ``3-9,19``, each widened to its group."""
    if text == "all":
        return {first for first, _ in PHASE_GROUPS}
    picked = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        if not (lo.isdigit() and (hi.isdigit() or not hi)):
            raise ValueError(f"--phases: {part!r} is not a phase or range")
        lo, hi = int(lo), int(hi or lo)
        if not PHASE_GROUPS[0][0] <= lo <= hi <= PHASE_GROUPS[-1][1]:
            raise ValueError(f"--phases: {part!r} outside phases "
                             f"{PHASE_GROUPS[0][0]}-{PHASE_GROUPS[-1][1]}")
        picked.update(first for first, last in PHASE_GROUPS
                      if first <= hi and lo <= last)
    return picked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    ap.add_argument("--phases", default="all", help="the phases to run: "
                    "all (the default), or phases and ranges such as "
                    "3-9,19 (each runs its whole group, PHASE_GROUPS)")
    args = ap.parse_args(argv)
    run = parse_phases(args.phases)
    # Growable segments, read when the allocator first runs: phase 19's
    # recurrentgemma step holds ~63 GB and AdamW's per-leaf temporaries
    # of its 4.2 GB embedding then found no 3.9 GB block among 15 GB of
    # freed, fragmented cache.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _ext

    # float32 references on the card run in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(CARD)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "phases": sorted(run), "phase_s": {},
              "alloc_conf": os.environ["PYTORCH_CUDA_ALLOC_CONF"]}
    print(f"card: {card}")
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {report['python']}; "
          f"PYTORCH_CUDA_ALLOC_CONF={report['alloc_conf']}")

    t0 = time.perf_counter()
    report["build_s_each"] = _ext.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    print(f"build: {len(report['build_s_each'])} sources in parallel in "
          f"{report['build_s']} s")
    for source, secs in report["build_s_each"].items():
        ptxas = [ln.strip() for ln in _ext.BUILD_LOGS.get(source, "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        report["ptxas"][source] = ptxas
        print(f"  {source}: {secs} s -> "
              f"{_ext.library_path(source).relative_to(ROOT)}")
        for ln in ptxas:
            print(f"    ptxas: {ln}")

    report["sass"] = sass_counts()
    print(f"SASS tensor-core instructions: {report['sass']}")
    check(report["sass"]["matmul.cu"]["HGMMA"] > 0,
          "matmul.cu's library holds no HGMMA")
    f32 = report["f32_gemm_build"] = f32_gemm_build()
    print(f"float32 GEMM: {f32['functions']} mm_f32 instantiations, SASS "
          f"{f32['sass']}, spilled bytes "
          f"{sum(f32['spilled_bytes'].values())}, registers "
          f"{sorted(set(f32['registers'].values()))}")
    check(f32["sass"]["UTMALDG"] > 0 and f32["sass"]["LDGSTS"] > 0,
          f"mm_f32 shows no TMA load or no cp.async: {f32['sass']}")
    if f32["spilled_bytes"]:      # else the library was built earlier
        check(len(f32["spilled_bytes"]) == f32["functions"] and not any(
            f32["spilled_bytes"].values()), f"mm_f32 spills (ptxas): "
            f"{f32['spilled_bytes']}")
    check(report["sass"]["flash_attention.cu"]["HMMA"] +
          report["sass"]["flash_attention.cu"]["HGMMA"] > 0,
          "flash_attention.cu's library holds no tensor-core MMA")

    def timed(first, fn, *args):
        """Phase group ``first``'s ``fn(*args)``, its seconds kept, and its
        float32 GEMM launches by how the ring was filled."""
        t = time.perf_counter()
        loads = _f32_loads()
        out = fn(*args)
        report["phase_s"][first] = time.perf_counter() - t
        loads = {key: n - loads[key] for key, n in _f32_loads().items()}
        report.setdefault("f32_loads", {})[first] = loads
        print(f"phases {first}: {report['phase_s'][first]} s; float32 GEMM "
              f"launches by ring fill {loads}")
        if first == 17:     # SmolLM's every operand is TMA-aligned
            check(loads["cp.async"] == 0 and loads["tma"] > 0,
                  f"SmolLM-360M's float32 GEMMs not all on TMA: {loads}")
        torch.cuda.empty_cache()
        return out

    kernels = {"kernels": []}
    if 3 in run:
        kernels["kernels"].append(timed(3, dse_phases, device, card, report))
    # the launches and checks of phases 13-22, added to the kernels line
    more = []
    if 10 in run:
        kernels["kernels"] += timed(10, kernel_slice, device, card, report)
    if 13 in run:
        bn_back_entry, train_launches_ = timed(13, training_slice, device,
                                               card, report)
        more.append({"launches": train_launches_})
    if 16 in run:
        more.append({"launches": timed(16, serving_slice, device, card,
                                       report)})
    for first, fn in ((17, training_llm_slice), (18, mixers_slice),
                      (19, training_mixers_slice),
                      (20, serving_attention_slice), (21, llama4_slice),
                      (22, dryrun_slice), (23, analysis_slice),
                      (24, partitioned_slice)):
        if first in run:
            more.append(timed(first, fn, device, card, report))
    for entry in kernels["kernels"]:
        name = entry["name"]
        for phase in more:
            entry["launches"] += phase["launches"].get(name, 0)
            if name in phase.get("held", {}):
                checks, err = phase["held"][name]
                entry["checks"] += checks
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if name == "flash_attention" and 18 in run:
            t = report["mixers"]["attention_256"]["times"]
            entry["head_dim_256"] = {
                key: t[key] for key in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "library_device_ms")}
    if 13 in run:       # its launches are the bf16 step's, counted there
        kernels["kernels"].append(bn_back_entry)
    if run != parse_phases("all"):
        # a part of the run: the launches and checks of what ran
        kernels["phases"] = sorted(run)
        kernels["launches"], kernels["held"] = {}, {}
        for phase in more:
            for name, n in phase["launches"].items():
                kernels["launches"][name] = \
                    kernels["launches"].get(name, 0) + n
            for name, (checks, err) in phase.get("held", {}).items():
                c, e = kernels["held"].get(name, (0, 0.0))
                kernels["held"][name] = (c + checks, max(e, err))
    report.update(kernels)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
