"""Layer rematerialisation: ``cfg.remat`` and ``cfg.remat_policy`` in the
port's model stack (the JAX package's ``jax.checkpoint`` of each scanned
layer group, ``models/transformer.py::Model._run_stack``).

``checkpointed(fn, policy, impl, routing, *carry)`` runs ``fn(impl,
tape, *carry)`` -- one layer group, or one encoder layer -- through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps none of the tensors the group's backward reads; the backward runs
the group again to make them (stopping, as PyTorch's non-reentrant
checkpoint does, once the last of them is made).  The policies keep
what the reference's keep:

* ``"full"`` (and any name the reference does not know, as its ``elif``
  chain falls through to plain ``jax.checkpoint``): nothing;
* ``"save_dots"`` (``dots_with_no_batch_dims_saveable``): the output of
  every product that has no batch dimension -- each 2-D
  ``impl.matmul`` of a projection, the router, the dense MLP and the
  shared expert.  The products the reference batches are recomputed:
  the experts' (one einsum batched over the experts there, a loop of
  2-D GEMMs here: ``models/moe.py`` runs them on ``unkept(impl)``), the
  attention, the SSD chunk einsums, and the MoE's one-hot einsums.  The
  port draws one line differently: its one-hot dispatch (``nbec,nbd->
  necd``) and combine (``nbec,necd->nbd``) are batched over the token
  blocks, which the reference maps one at a time with no batch
  dimension, so its policy keeps those two and the port recomputes the
  dispatch (the combine is the group's last product and is recomputed by
  neither);
* ``"save_mixer"`` (``save_only_these_names("mixer_out")``): each
  mixer's output (``tape.mixer_out``), so that the mixer's output
  projection is not run again.

Under every policy the group's output ``pending`` (the block's last
residual, ``models/transformer.py``), when it is a product's output, is
kept too: it is the next group's input, so keeping it costs nothing, and
the recompute then skips that product, as the reference's partial
evaluation drops a product nothing in the backward reads.  A MoE
layer computes its aux loss before its dispatch (``models/moe.py``), so
that its combine is its last product and the recompute, stopping once
the backward's tensors are made, does not run it either.  These two
rules and the policies above are what ``chip_smoke.py::
recompute_launches`` counts.

The products no policy keeps run on ``unkept(impl)``: inside a group,
the impl the tape was given, untaped; elsewhere ``impl`` itself.

A product runs as one ``kernels.matmul.MatmulFn`` on the impl's
undifferentiated ``matmul`` (``impl.base`` of ``kernels.ops.
differentiable``, else ``impl`` itself) in the forward and in the
recompute alike, so that both save the same tensors in the same order
(``torch.utils.checkpoint`` pairs them by order); in the recompute a
kept product returns its kept output instead of running.  The kernels
launch through ``ctypes``, which a ``TorchDispatchMode`` (PyTorch's
selective checkpointing) cannot see: this tape keys products by their
place in the group, which does not depend on what computes them.

The group's MoE layers take their top-k choices through the tape
(``Tape.__call__`` is a ``moe.Routing``'s call): the forward asks the
caller's ``routing`` (if any) and keeps what it returns; the recompute
takes those choices again and leaves the caller's record alone.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from ..kernels.matmul import MatmulFn


RECOMPUTE_SPAN = "remat.recompute"


def recompute_span():
    """The context each group's recompute runs in by default
    (``Model.recompute_span``): a profiler span named ``RECOMPUTE_SPAN``,
    whose device time a trace reads."""
    return torch.profiler.record_function(RECOMPUTE_SPAN)


class _Pass:
    """One of the two contexts ``checkpoint``'s ``context_fn`` gives:
    the forward's or the recompute's (re-entered for each backward), the
    latter inside ``span()`` where a span is given."""

    def __init__(self, tape: "Tape", replaying: bool,
                 span: Optional[Callable] = None):
        self.tape, self.replaying = tape, replaying
        self.span = span if replaying else None
        self.inner = None

    def __enter__(self):
        tape = self.tape
        tape.replaying, tape.slot, tape.call = self.replaying, 0, 0
        if self.span is not None:
            self.inner = self.span()
            self.inner.__enter__()
        return tape

    def __exit__(self, *exc):
        self.tape.last = None
        if self.inner is not None:
            inner, self.inner = self.inner, None
            inner.__exit__(*exc)
        return False


class _PassMode(TorchDispatchMode):
    """``_Pass`` as the dispatch mode ``checkpoint`` asks for under a
    proxy trace (``make_fx``: the cost walker's), without the span;
    every op passes through unchanged."""

    def __init__(self, tape: "Tape", replaying: bool):
        super().__init__()
        self.pass_ = _Pass(tape, replaying)

    def __enter__(self):
        self.pass_.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self.pass_.__exit__(*exc)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _tracing() -> bool:
    """Whether a proxy trace is running, the test by which ``checkpoint``
    asks its ``context_fn`` for dispatch modes."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.PROXY) is not None


class Tape:
    """What one group's forward leaves for its recompute: kept product
    outputs by their place among the group's products, and the MoE
    choices by call."""

    def __init__(self, policy: str, routing=None,
                 span: Callable = recompute_span):
        self.policy = policy
        self.outer = routing
        self.span = span
        self.replaying = False
        self.slot = 0               # products so far in this pass
        self.call = 0               # MoE calls so far in this pass
        self.kept = {}              # slot -> output, detached
        self.last = None            # the forward's latest (slot, output)
        self.choices = []

    def contexts(self):
        if _tracing():
            return _PassMode(self, False), _PassMode(self, True)
        return _Pass(self, False), _Pass(self, True, self.span)

    def product(self, impl, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
        slot = self.slot
        self.slot += 1
        if self.replaying:
            return MatmulFn.apply(a, b, impl, self.kept.pop(slot, None))
        out = MatmulFn.apply(a, b, impl)
        if self.policy == "save_dots":
            self.kept[slot] = out.detach()
        else:
            self.last = (slot, out)
        return out

    def keep(self, t: torch.Tensor) -> None:
        """Keeps the forward's latest product if ``t`` is (a view of)
        its output."""
        if self.replaying or self.last is None:
            return
        slot, out = self.last
        if (t if t._base is None else t._base) is out:
            self.kept[slot] = out.detach()

    def mixer_out(self, mix: torch.Tensor) -> None:
        """A block's mixer output, the reference's ``mixer_out``."""
        if self.policy == "save_mixer":
            self.keep(mix)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        if self.replaying:
            idx = self.choices[self.call]
        else:
            if self.outer is not None:
                idx = self.outer(idx)
            self.choices.append(idx)
        self.call += 1
        return idx


class _Taped(SimpleNamespace):
    """An impl whose products go through a tape (``taped``)."""


def taped(impl, tape: Tape) -> _Taped:
    """``impl`` with its products through ``tape``; ``untaped`` is
    ``impl`` itself, for the products no policy keeps."""
    base = getattr(impl, "base", impl)
    return _Taped(
        matmul=lambda a, b: tape.product(base, a, b),
        fused_add_rmsnorm=impl.fused_add_rmsnorm,
        flash_attention=impl.flash_attention, untaped=impl)


def unkept(impl):
    """The impl for the products no policy keeps (the experts'): a
    taped impl's own, else ``impl``."""
    return impl.untaped if isinstance(impl, _Taped) else impl


def checkpointed(fn: Callable, policy: str, impl, routing, *carry,
                 span: Callable = recompute_span):
    """``fn(impl, tape, *carry)`` under ``torch.utils.checkpoint`` with
    ``policy``, its recompute inside ``span()``; returns what ``fn``
    returns (the new carry).  ``fn`` calls ``tape.keep`` on its output
    ``pending`` and passes ``tape`` as its MoE routing and to its
    blocks' mixers."""
    tape = Tape(policy, routing, span)
    timpl = taped(impl, tape)
    # nothing in a layer draws random numbers
    return checkpoint(lambda *c: fn(timpl, tape, *c), *carry,
                      use_reentrant=False, context_fn=tape.contexts,
                      preserve_rng_state=False)


def wanted(cfg, cache: Optional[dict]) -> bool:
    """Whether a stack runs rematerialised: ``cfg.remat`` while autograd
    records (training), and never over a cache (serving updates it in
    place, which a recompute would do twice)."""
    return bool(cfg.remat) and cache is None and torch.is_grad_enabled()
