"""GPipe-style pipeline parallelism over ``torch.distributed``: the port of
the JAX package's ``distributed/pipeline.py`` (``bubble_fraction`` :28,
``pipeline_apply`` :32).

Layers are divided into S contiguous stages, one a rank of the mesh's
``stage`` dimension; stage s holds its slice of the stage-stacked
parameters.  The global batch is split into M microbatches, and a
software pipeline of M + S - 1 ticks streams them: at tick t stage s
works on microbatch t - s (if there is one), stage 0 reading it from the
input and every other stage receiving it from stage s - 1 by a
point-to-point ``recv``; the result goes on to stage s + 1 by ``send``.
The last stage banks its results, and a differentiable all-reduce over
the stage group (``torch.distributed.nn.functional``) hands the batch to
every stage, as the reference's masked ``psum`` does.

Where the reference computes every tick on every stage and masks the
results, a stage here skips the ticks it has no microbatch for: the
same values, and the same M + S - 1 ticks of the schedule.

Gradients: ``send`` and ``recv`` are autograd functions, each the
other's transpose (the forward's send is the backward's receive), so
``backward`` through the pipelined forward runs the pipeline in reverse.
The output is replicated over the stages, and each stage's replica
carries 1/S of its cotangent (as ``shard_map`` splits the cotangent of
an output that does not name the axis): when every stage takes the
gradient of the same loss, the parameters' gradients are the sequential
model's.  The point-to-point messages are tagged by microbatch.
"""
from __future__ import annotations

from typing import Callable, List

import torch


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


class _Send(torch.autograd.Function):
    """Sends ``h`` to global rank ``peer``; returns a zero scalar that
    ties the send into the caller's graph.  Backward: receives ``h``'s
    gradient from ``peer``.  ``anchor`` (a scalar that requires grad
    while grad is enabled) makes every stage's graph hold its sends and
    receives, whatever requires grad on that stage."""

    @staticmethod
    def forward(ctx, h, anchor, peer: int, tag: int, group):
        import torch.distributed as dist
        dist.send(h.detach().contiguous(), peer, group=group, tag=tag)
        ctx.meta = (h.shape, h.dtype, h.device, peer, tag, group)
        return torch.zeros((), dtype=h.dtype, device=h.device)

    @staticmethod
    def backward(ctx, _grad):
        import torch.distributed as dist
        shape, dtype, device, peer, tag, group = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, peer, group=group, tag=tag)
        return grad, None, None, None, None


class _Recv(torch.autograd.Function):
    """Receives a tensor like ``like`` from global rank ``peer``.
    Backward: sends the gradient back to ``peer``."""

    @staticmethod
    def forward(ctx, like, anchor, peer: int, tag: int, group):
        import torch.distributed as dist
        out = torch.empty_like(like)
        dist.recv(out, peer, group=group, tag=tag)
        ctx.meta = (peer, tag, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        peer, tag, group = ctx.meta
        dist.send(grad.contiguous(), peer, group=group, tag=tag)
        return None, None, None, None, None


class _Replicated(torch.autograd.Function):
    """The identity; its backward gives 1/``n`` of the gradient, one
    replica's share of an output replicated over ``n`` ranks."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def _stage_slice(leaf, idx: int):
    """This stage's slice of a stage-stacked leaf: a ``DTensor`` sharded
    over the stages gives its local (1, ...) shard, a plain tensor its
    row ``idx``."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[idx]


def _tree_slice(tree, idx: int):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, idx) for k, v in tree.items()}
    return _stage_slice(tree, idx)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   n_micro: int, mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_s, h) -> h`` (h's shape kept) over the S
    stages of ``mesh``'s ``axis`` dimension, on every rank of it.

    stage_params: a tensor or nested dict of them, every leaf with
    leading dim S (stage-stacked; a ``DTensor`` sharded on dim 0 over
    ``axis``, or the whole stack, of which this stage reads its row).
    x: (batch, ...) global input, the same on every stage; batch must
    divide by n_micro.  Returns y: (batch, ...), the final stage's
    output, on every stage.
    """
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_nn
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"pipeline_apply: batch {batch} does not divide "
                         f"into {n_micro} microbatches")
    mb = batch // n_micro
    params = _tree_slice(stage_params, idx)
    x_mb = x.reshape(n_micro, mb, *x.shape[1:])
    prev = None if idx == 0 else dist.get_global_rank(group, idx - 1)
    nxt = None if idx == n_stages - 1 else \
        dist.get_global_rank(group, idx + 1)

    anchor = torch.zeros((), requires_grad=torch.is_grad_enabled())
    outs: List[torch.Tensor] = []
    sent = []
    for t in range(n_micro + n_stages - 1):
        m = t - idx                      # this stage's microbatch at tick t
        if not 0 <= m < n_micro:
            continue
        h = x_mb[m] if prev is None else _Recv.apply(x_mb[m], anchor, prev,
                                                     m, group)
        h = stage_fn(params, h)
        if nxt is None:
            outs.append(h)
        else:
            sent.append(_Send.apply(h, anchor, nxt, m, group))
    if nxt is None:
        banked = torch.stack(outs)
    else:
        # zeros, tied to this stage's sends so that their backward runs
        banked = x_mb.new_zeros(x_mb.shape) + torch.stack(sent).sum()
    out = dist_nn.all_reduce(banked, group=group)
    return _Replicated.apply(out, n_stages).reshape(batch, *x.shape[1:])
