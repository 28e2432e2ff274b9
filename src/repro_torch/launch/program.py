"""Rank 0's partitioned step, built and read as the dry run reads it.

``local_program`` builds one cell's step on the partitioned route
(``Model(cfg, impl=kernels.ops.partitioned(impl, mesh, rules))``) with
its state, batch and cache made as ``DTensor``s from this rank's local
shards alone (``models.common.placed_zeros``): on the ``meta`` device
for the dry run (the kernels stood in for by ``kernel_shaped``, which
allocates what each wrapper allocates), or on a card with the real
kernels.  ``read_step`` runs it once under ``StepReader``, a dispatch
mode that sees the ops on the local shards (it hands every op on
``DTensor``s back to ``DTensor``, which runs them as local ops and
collectives) and reads:

* ``temp_bytes``: the most bytes the step's ops hold at once on top of
  its arguments -- every storage an op makes, from its making to its
  free (a storage autograd keeps for the backward stays counted; an
  ``IDENTITY_OPS`` output, a collective's wait, carries its input's
  bytes from then on),
  and the temporaries of ``CUDA_OP_TEMPORARIES`` while their op runs;
* ``alias_bytes``: the bytes of the step's arguments that an op writes
  in place (the decode cache), the counterpart of XLA's donated and
  aliased buffers;
* ``collective_bytes`` and ``collective_by_kind``: the output bytes of
  every ``_c10d_functional`` collective the step issues (all-gather,
  reduce-scatter, all-reduce, all-to-all), what the reference's
  ``launch/roofline.py::collective_bytes`` sums over the per-device HLO.

On the ``fake`` process group (``launch.dryrun.fake_world``) a
collective moves nothing and returns a tensor of its output's shape, so
the step runs at any world size in one process; the values are not
meaningful there.
"""
from __future__ import annotations

import weakref
from types import SimpleNamespace
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import ops
from ..models.common import (ModelConfig, TensorSpec, is_placed,
                             placed_zeros)
from ..models.frontends import frontend_input_specs
from ..models.transformer import Model
from ..optim.optimizers import AdamW, constant_schedule
from .serve import make_prefill_step, make_serve_step, placed_cache
from .train import (batch_shardings, make_state_shardings,
                    make_train_step, trainable)

# Ops whose CUDA kernel holds, beside its output, a temporary as large as
# the output times this, unseen by a dispatch mode: read on an H100 by
# ``scripts/op_temporaries.py`` over Qwen3-0.6B's training step at 2 x
# 4096 (``_softmax_backward_data`` at rows of 4096 float32: 2.147 GB over
# its 2.147 GB output, each of its 28 calls; the step's peak is there).
CUDA_OP_TEMPORARIES = {torch.ops.aten._softmax_backward_data.default: 1}

# the collectives of ``torch.ops._c10d_functional``, by the reference's
# HLO names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}

# ``_c10d_functional`` ops whose output is their input's memory: a card
# allocates nothing for them (``_wrap_tensor_autograd`` wraps its input
# in an ``AsyncCollectiveTensor``), where the meta device gives the
# output a storage of its own, which may outlive the input's
IDENTITY_OPS = ("wait_tensor", "_wrap_tensor_autograd")

# a decode cell's cache is filled this many rows short of its end
DECODE_ROWS_LEFT = 8


def kernel_shaped() -> SimpleNamespace:
    """The kernel route's memory on the meta device: what each wrapper
    allocates.  ``matmul`` its output in A's type and, where the tile
    model splits K, the float32 workspace of the partial sums, freed on
    return; ``fused_add_rmsnorm`` its two outputs; attention its output
    alone (the plain version's S x S scores never exist on the kernel
    route's forward)."""
    from ..core.gpu_model import select_matmul_block

    def matmul(a, b):
        (m, k), n, size = a.shape, b.shape[1], a.element_size()
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        splits = select_matmul_block(m, n, k, bytes_in=size,
                                     bytes_out=size).splits
        if splits > 1:
            torch.empty((splits, m, n), dtype=torch.float32,
                        device=a.device)
        return out
    return SimpleNamespace(
        matmul=matmul,
        fused_add_rmsnorm=lambda x, r, s: (torch.empty_like(x),
                                           torch.empty_like(x)),
        flash_attention=lambda q, k, v, *a, **kw: torch.empty_like(q))


def _group_size(args) -> int:
    """The ranks of a ``_c10d_functional`` collective's process group,
    named by its last string argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class StepReader(TorchDispatchMode):
    """Reads a step's ops on local tensors (module docstring):
    ``peak``, the most bytes held at once by storages the ops made;
    ``written``, the bytes of ``arguments``' storages written in place;
    ``collectives``, output bytes by kind; ``calls``, each collective's
    ``(kind, output shape)`` in order, and ``sizes`` the ranks of its
    process group."""

    def __init__(self, arguments=()):
        super().__init__()
        self.now = self.peak = 0
        self.args = {_storage(t)._cdata: _storage(t).nbytes()
                     for t in arguments}
        self.written = {}
        self.held = {}               # storage -> its finalizer
        self.collectives: Dict[str, int] = {}
        self.calls = []
        self.sizes = []

    def _free(self, n: int) -> None:
        self.now -= n

    def _move(self, inputs: set, res) -> None:
        """An ``IDENTITY_OPS`` output with a storage of its own: the
        input's bytes are no longer counted on the input's storage, but
        on the output's (counted as made), for as long as it lives."""
        outs = {_storage(t)._cdata for t in tree_leaves(res)
                if isinstance(t, torch.Tensor)}
        if outs & inputs:
            return
        for key in inputs:
            fin = self.held.pop(key, None)
            info = fin.detach() if fin is not None else None
            if info is not None:
                self.now -= info[2][0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on its shards
        if (any(issubclass(t, FakeTensor) for t in types)
                or torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None):
            # DTensor's sharding propagation, on fake tensors at the
            # global shapes: not the step's own ops
            return func(*args, **kwargs)
        # under inference mode a composite op (``einsum``) reaches the
        # mode whole: its parts come back through the mode
        with self:
            res = func.decompose(*args, **kwargs)
        if res is not NotImplemented:
            return res
        self._writes(func, args, kwargs)
        res = func(*args, **kwargs)
        collective = func.namespace == "_c10d_functional"
        kind = COLLECTIVE_KINDS.get(func._opname) if collective else None
        seen, made = {_storage(t)._cdata for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)}, 0
        if collective and func._opname in IDENTITY_OPS:
            self._move(seen, res)
        for t in tree_leaves(res):
            if not isinstance(t, torch.Tensor):
                continue
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + t.numel() * t.element_size())
                self.calls.append((kind, tuple(t.shape)))
                self.sizes.append(_group_size(args))
            st = _storage(t)
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            n = st.nbytes()
            made += n
            self.now += n
            self.held[st._cdata] = weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.now + made
                        * CUDA_OP_TEMPORARIES.get(func, 0))
        return res

    def _writes(self, func, args, kwargs) -> None:
        schema = func._schema.arguments
        for i, a in enumerate(schema):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(a.name)
            for x in tree_leaves(t):
                if isinstance(x, torch.Tensor):
                    key = _storage(x)._cdata
                    if key in self.args:
                        self.written[key] = self.args[key]


def _local(tree) -> list:
    return [t._local_tensor if is_placed(t) else t for t in tree_leaves(
        tree) if isinstance(t, torch.Tensor)]


def read_step(step: Callable, *inputs) -> dict:
    """``step(*inputs)`` once under ``StepReader``: ``temp_bytes``,
    ``alias_bytes``, ``collective_bytes`` (this rank's) and
    ``collective_by_kind``."""
    reader = StepReader(_local(inputs))
    with reader:
        out = step(*inputs)
    del out
    return {"temp_bytes": reader.peak,
            "alias_bytes": sum(reader.written.values()),
            "collective_bytes": sum(reader.collectives.values()),
            "collective_by_kind": dict(sorted(reader.collectives.items()))}


def local_program(cfg: ModelConfig, kind: str, batch: int, seq: int, mesh,
                  rules, impl=None, device="meta", mv_dtype=torch.float32,
                  generator=None) -> Tuple[Callable, tuple]:
    """``(step, inputs)``: one step of ``kind`` (``train``, ``prefill``,
    ``decode``) of the global ``batch`` x ``seq`` cell on the
    partitioned route over ``mesh``, its state, batch and cache made
    from this rank's shards on ``device``: a train or prefill batch
    holds the config's front-end inputs beside the tokens (whisper's
    frames, pixtral's patches: ``models.frontends.frontend_input_specs``),
    a decode cache is filled to ``DECODE_ROWS_LEFT`` rows short of its
    end.  ``impl``: the kernels (``kernel_shaped()`` on ``meta`` by
    default, else ``kernels.ops``); ``generator`` draws the parameters,
    tokens and front-end inputs on a real device (``meta`` holds no
    values)."""
    device = torch.device(device)
    if impl is None:
        impl = kernel_shaped() if device.type == "meta" else ops
    model = Model(cfg, impl=ops.partitioned(impl, mesh, rules))
    opt = AdamW(schedule=constant_schedule(1e-4), mv_dtype=mv_dtype)
    shardings = make_state_shardings(model, opt, rules, mesh)

    def draw(shape, dtype):
        if device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
        if dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, shape, device=device,
                                 generator=generator, dtype=dtype)
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    def placed(shape, dtype, pl):
        return placed_zeros(shape, dtype, mesh, pl, device,
                            fill=lambda local: draw(local, dtype))
    params = _map2(lambda s, pair: placed(s.shape, s.dtype, pair[1]),
                   model.abstract(), shardings["params"])
    specs = {"tokens": TensorSpec((batch, 1 if kind == "decode" else seq),
                                  torch.int32)}
    if kind != "decode":
        specs.update(frontend_input_specs(cfg, batch))
    layouts = batch_shardings(mesh, rules, specs)
    batch_in = {k: placed(s.shape, s.dtype, layouts[k][1])
                for k, s in specs.items()}
    if kind == "train":
        p = trainable(params)
        state = {"params": p, "opt": opt.init(p)}
        return make_train_step(model, opt, rules), (state, batch_in)
    if kind == "prefill":
        step = make_prefill_step(model, rules,
                                 max_len=seq + cfg.n_patches + 8)
        return step, (params, batch_in)
    cache = placed_cache(model, batch, seq, mesh, rules, device)
    for part in cache.values():
        # an attention layer's KV position, or the learned positions'
        # offset
        pos = part.get("pos") if isinstance(part, dict) else part
        if pos is not None:
            pos.fill_(seq - DECODE_ROWS_LEFT)
    return make_serve_step(model, rules), (params, cache,
                                           batch_in["tokens"])


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same nested
    dicts."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], other[k]) for k in sorted(tree)}
    return fn(tree, other)

