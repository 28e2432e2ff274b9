"""Assigned input shapes (4 per architecture = 40 cells) and per-cell
sharding-rule adjustments: the port of the JAX package's
``launch/shapes.py``.

  train_4k     seq=4096    global_batch=256   (training step)
  prefill_32k  seq=32768   global_batch=32    (inference prefill)
  decode_32k   seq=32768   global_batch=128   (one decode token, 32k cache)
  long_500k    seq=524288  global_batch=1     (long-context decode)

``long_500k`` requires sub-quadratic attention: run for the SSM / hybrid /
local-attention archs (mamba2-130m, recurrentgemma-9b, gemma3-27b), skip
for the pure full-attention archs.  ``batch_input_specs`` gives the
port's ``TensorSpec``s where the JAX package gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.common import (ModelConfig, PROD_RULES, Rules, TensorSpec,
                             multipod)
from ..models.frontends import frontend_input_specs


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

LONG_OK = {"mamba2-130m", "recurrentgemma-9b", "gemma3-27b"}


def cell_is_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, "pure full attention — sub-quadratic required (skip)"
    return True, ""


def adjust_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Per-cell config adjustments (documented deviations)."""
    kw = {}
    if cfg.learned_pos:
        # whisper: learned-position table structurally resized to the cell
        kw["learned_pos"] = max(cfg.learned_pos, shape.seq + 8)
    if shape.kind in ("train", "prefill"):
        # always take the chunked (flash-analogue) attention path for full
        # sequences: memory O(S * block) instead of O(S^2) logits
        kw["dense_attn_max_seq"] = 1
        kw["attn_block"] = 512
    if shape.kind == "train":
        kw["ce_chunk"] = 512       # seq-chunked CE: bounds logits memory
    return cfg.replace(**kw) if kw else cfg


def cell_rules(shape: ShapeSpec, multi_pod: bool,
               data_size: int = 16) -> Rules:
    rules = dict(PROD_RULES)
    if multi_pod:
        rules = multipod(rules)
    if shape.kind == "decode" and shape.global_batch < data_size:
        # batch too small to shard: sequence-shard the KV cache instead
        rules["batch"] = None
        rules["cache_seq"] = ("pod", "data") if multi_pod else "data"
    return rules


def batch_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """Abstract (``TensorSpec``) inputs for the cell's step function."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": TensorSpec((b, shape.seq), torch.int32)}
        specs.update(frontend_input_specs(cfg, b))
    else:
        specs = {"tokens": TensorSpec((b, 1), torch.int32)}
    return specs
