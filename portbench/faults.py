"""Faults planted in the program under a run, to show that the check
catches them: each is a context manager that patches the port where the
timed path produces its result, and restores it.

* ``unchanged``: a training step that returns its state as it was;
* ``half_batch``: a training step on half the batch, its mean over that
  half; for forward-only cells, half the batch's answers left out (the
  rows zero, the tokens 0);
* ``altered``: one answer altered where it is produced (an image's
  logits rolled by one class; a served token moved to the next id).
"""
from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import torch


@contextmanager
def _patched(target: str, make):
    """``target`` (``module:attribute``) replaced by ``make(original)``."""
    import importlib
    mod_name, attr = target.split(":")
    owner = importlib.import_module(mod_name)
    obj, *path = attr.split(".")
    holder = getattr(owner, obj) if path else owner
    name = path[0] if path else obj
    with mock.patch.object(holder, name, make(getattr(holder, name))):
        yield


def _halved(x):
    return x[: x.shape[0] // 2]


@contextmanager
def unchanged(family: str):
    if family == "resnet":
        def make(orig):
            def step(net, opt, images, labels, decisions=None):
                from repro_torch.kernels.training import loss_and_grads
                return loss_and_grads(net, images, labels)[0]
            return step
        with _patched("repro_torch.kernels.training:train_step", make):
            yield
    else:
        def make(orig):
            def build(model, opt, rules):
                step = orig(model, opt, rules)

                def same(state, batch):
                    return state, step(state, batch)[1]
                return same
            return build
        with _patched("repro_torch.launch.train:make_train_step", make):
            yield


@contextmanager
def half_batch(family: str, kind: str):
    if kind == "train" and family == "resnet":
        def make(orig):
            def step(net, opt, images, labels, decisions=None):
                return orig(net, opt, _halved(images), _halved(labels))
            return step
        with _patched("repro_torch.kernels.training:train_step", make):
            yield
    elif kind == "train":
        def make(orig):
            def build(model, opt, rules):
                step = orig(model, opt, rules)
                return lambda state, batch: step(
                    state, {"tokens": _halved(batch["tokens"])})
            return build
        with _patched("repro_torch.launch.train:make_train_step", make):
            yield
    elif kind == "infer":
        def make(orig):
            def forward(self, images, decisions=None, pin=False):
                out = orig(self, _halved(images))
                return torch.cat([out, torch.zeros_like(out)])
            return forward
        with _patched("repro_torch.kernels.training:Network.forward", make):
            yield
    else:
        def make(orig):
            def greedy(logits):
                tok = orig(logits)
                tok[tok.shape[0] // 2:] = 0
                return tok
            return greedy
        with _patched("repro_torch.models.layers:greedy", make):
            yield


@contextmanager
def altered(kind: str):
    if kind == "infer":
        def make(orig):
            def forward(self, images, decisions=None, pin=False):
                out = orig(self, images, decisions, pin).clone()
                out[0] = out[0].roll(1)
                return out
            return forward
        with _patched("repro_torch.kernels.training:Network.forward", make):
            yield
    else:
        def make(orig):
            def greedy(logits):
                tok = orig(logits).clone()
                tok[0] = (tok[0] + 1) % logits.shape[-1]
                return tok
            return greedy
        with _patched("repro_torch.models.layers:greedy", make):
            yield


def planted(name: str, family: str, kind: str):
    """The fault ``name`` for a cell of ``family`` and ``kind``."""
    if name == "unchanged":
        return unchanged(family)
    if name == "half_batch":
        return half_batch(family, kind)
    return altered(kind)


def faults_of(kind: str):
    """The faults a cell of ``kind`` can have."""
    return ("unchanged", "half_batch") if kind == "train" else \
        ("half_batch", "altered")
