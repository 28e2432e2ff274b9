"""Analytical cost model over traced PyTorch programs: the port of the
JAX package's ``launch/costmodel.py`` (``jaxpr_cost`` there, ``:198``).

``graph_cost(fn, *args)`` traces ``fn`` with
``torch.fx.experimental.proxy_tensor.make_fx`` on ``meta`` tensors (no
memory, no device) and walks the resulting graph of aten ops.  The trace
goes through autograd: a function that calls ``torch.autograd.grad``
gives its forward and backward ops, and a ``torch.utils.checkpoint``
region appears again in the backward as its recompute.  Nothing is
scanned: the port's ``Model`` loops over its layers, so the walker sees
each one (``launch/dryrun.py`` traces two depths and extrapolates, as
the JAX walker multiplies a scan body by its trip count).  The rules are
the reference's, translated to aten names:

  * FLOPs: ``mm``/``bmm``/``addmm``/``baddbmm`` = 2 * output elements *
    K; ``convolution`` = 2 * output elements * the kernel's input
    features * its spatial size; ``convolution_backward`` the dX and dW
    convolutions of its output mask, each counted as the reference counts
    the convolution the JAX transpose builds for it (dX over x's
    positions, padding zeros included; dW over the weight's).  These are
    also ``Cost.gemm_flops``.  Reductions cost one FLOP per input
    element; the ``ZERO_FLOP`` ops (views, copies, compares, index ops)
    nothing; softmax and its backward as the elementwise ops they fuse
    (``COMPOSITE``); every other op one FLOP per output element, times
    ``EXPENSIVE_ELEMWISE``.  Counted on the *global* program: the
    roofline divides by the chip count.
  * HBM bytes: the fusion heuristic.  An op's outputs are counted as
    written (and read again by each consumer) unless the op is a cheap
    elementwise producer (``FUSIBLE``) whose every output has at most one
    consumer (``node.users``, looking through views).  Graph inputs
    (parameters, optimizer state, batch, cache) are counted once per
    consuming op.  Views (``VIEWS``) move nothing: a consumer of a view
    reads the view's bytes, at most its base's (an ``expand`` reads its
    source once), with the base's producer deciding whether it counts.

Where the count differs from the JAX walker's:

  * an in-place update writes what it stores: ``index_copy_`` into a KV
    cache counts the new rows, where the reference's
    ``dynamic_update_slice`` counts the whole buffer as written;
  * under ``cfg.remat`` each layer group's recompute is counted, as the
    reference counts its ``jax.checkpoint`` (and the chunked
    cross-entropy's, as before): a product its ``remat_policy`` keeps
    does not run again (``models/remat.py``), and the recompute stops
    at the group's last saved tensor, where the reference's partial
    evaluation drops what the backward does not read.  The GEMM FLOPs
    agree but for ``save_dots``' one-hot MoE dispatch, which the port
    batches over the token blocks and recomputes, and the reference
    maps block by block with no batch dimension and keeps;
  * the plain route's attention is dense over the whole sequence
    (``kernels/ref.py::flash_attention_ref``), where the reference walks
    its chunked attention: GEMM FLOPs agree, bytes do not.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Dict, List

import torch

# ops assumed fusible into their consumer when single-consumer
FUSIBLE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "log",
    "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "neg", "sign", "floor",
    "ceil", "round", "abs", "reciprocal", "sin", "cos", "erf", "silu",
    "gelu", "relu", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "logical_and", "logical_or", "logical_not", "eq", "ne",
    "ge", "gt", "le", "lt", "where", "clamp", "clamp_min", "clamp_max",
    "masked_fill", "_to_copy", "clone", "arange", "full", "zeros", "ones",
    "empty", "scalar_tensor", "zeros_like", "ones_like", "full_like",
    "empty_like", "new_zeros", "new_ones", "new_full", "new_empty",
    "lift_fresh_copy",
}

ZERO_FLOP = {
    "_to_copy", "clone", "copy", "copy_", "lift_fresh_copy", "cat", "stack",
    "constant_pad_nd", "pad", "gather", "index", "index_select",
    "embedding", "scatter", "index_put", "index_put_", "index_copy",
    "index_copy_", "slice_scatter", "select_scatter", "slice_backward",
    "select_backward", "arange", "full", "zeros", "ones", "empty",
    "scalar_tensor", "zeros_like", "ones_like", "full_like", "empty_like",
    "new_zeros", "new_ones", "new_full", "new_empty", "fill", "fill_",
    "zero_", "where", "masked_fill", "eq", "ne", "ge", "gt", "le", "lt",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "bitwise_and_", "logical_and", "logical_or", "logical_not", "sign",
    "floor", "ceil", "round", "argmax", "argmin", "any", "all",
}

EXPENSIVE_ELEMWISE = {"exp": 1, "log": 1, "tanh": 1, "sigmoid": 1,
                      "rsqrt": 1, "sqrt": 1, "div": 1, "pow": 1, "erf": 1}

REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
              "cumsum", "logsumexp", "var", "std", "var_mean", "norm",
              "linalg_vector_norm"}

# one fused op standing for the reference's elementwise chain: FLOPs an
# element of its output (softmax: max, subtract, exp, sum, divide)
COMPOSITE = {"_softmax": 5, "_log_softmax": 5,
             "_softmax_backward_data": 4, "_log_softmax_backward_data": 4}

GEMMS = {"mm", "bmm", "addmm", "baddbmm"}

# ops whose output aliases (part of) an input: no bytes, no FLOPs
VIEWS = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "alias",
    "detach", "unbind", "split", "split_with_sizes", "chunk",
    "as_strided", "narrow", "diagonal", "unfold", "view_as",
    "_reshape_alias", "movedim",
}

# in-place ops that write a part of ``self`` without reading it
STORES = {"index_copy_", "index_put_", "copy_", "fill_", "zero_",
          "scatter_", "index_fill_", "masked_fill_"}
FILLS = {"fill_", "zero_", "index_fill_", "masked_fill_"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    gemm_flops: float = 0.0       # the GEMM and convolution share of flops

    def __iadd__(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.bytes += other.bytes
        self.gemm_flops += other.gemm_flops
        return self

    def __add__(self, other: "Cost") -> "Cost":
        out = Cost(self.flops, self.bytes, self.gemm_flops)
        out += other
        return out

    def __sub__(self, other: "Cost") -> "Cost":
        return self + other.scaled(-1.0)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k, self.gemm_flops * k)


def _name(node) -> str:
    return node.target.overloadpacket.__name__


def _tensors(value) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_flops(out: torch.Tensor, weight: torch.Tensor) -> float:
    """2 * output elements * the kernel's input features * its spatial
    size (``weight`` is (out features, in features / groups, *k))."""
    return 2.0 * out.numel() * weight.shape[1] * math.prod(weight.shape[2:])


def _conv_backward_flops(node) -> float:
    """dX and dW as the reference counts the convolutions JAX's
    transpose builds: dX over x's elements with the weight's output
    features as inputs (padding zeros included), dW over the weight's
    elements with the batch and the output positions as inputs."""
    grad_out, x, weight = (a.meta["val"] for a in node.args[:3])
    mask = node.args[-1]
    flops = 0.0
    if mask[0]:
        flops += 2.0 * x.numel() * weight.shape[0] * math.prod(
            weight.shape[2:])
    if mask[1]:
        flops += 2.0 * weight.numel() * grad_out.shape[0] * math.prod(
            grad_out.shape[2:])
    return flops


def _gemm_flops(name: str, node, out: torch.Tensor) -> float:
    """2 * output elements * the contracted length."""
    a = node.args[1] if name in ("addmm", "baddbmm") else node.args[0]
    return 2.0 * out.numel() * a.meta["val"].shape[-1]


def _op_flops(name: str, node, outs: List[torch.Tensor]) -> float:
    if name in GEMMS:
        return _gemm_flops(name, node, outs[0])
    if name == "convolution":
        return _conv_flops(outs[0], node.args[1].meta["val"])
    if name == "convolution_backward":
        return _conv_backward_flops(node)
    if name in REDUCTIONS:
        first = _tensors(node.args[0].meta["val"]) if hasattr(
            node.args[0], "meta") else []
        return float(sum(t.numel() for t in first))
    if name in ZERO_FLOP or name.rstrip("_") in ZERO_FLOP:
        return 0.0
    out_elems = float(sum(t.numel() for t in outs))
    if name in COMPOSITE:
        return out_elems * COMPOSITE[name]
    return out_elems * EXPENSIVE_ELEMWISE.get(name.rstrip("_"), 1)


def _is_view(node) -> bool:
    if node.op != "call_function":
        return False
    if node.target is operator.getitem:
        return _is_view(node.args[0])
    return hasattr(node.target, "overloadpacket") and _name(node) in VIEWS


def _consumers(node) -> int:
    """Ops that read ``node``'s value, looking through views; the graph's
    output counts once."""
    n = 0
    for user in node.users:
        if _is_view(user):
            n += _consumers(user)
        elif user.op == "output":
            n += 1
        elif user.target is operator.getitem:
            continue            # selects an output of a multi-output op
        else:
            n += 1
    return n


def walk(graph: torch.fx.Graph) -> Cost:
    """The cost of every op of ``graph`` (one from ``make_fx``, each
    node's value in ``node.meta["val"]``)."""
    total = Cost()
    root: Dict = {}        # node -> the node whose storage it views
    tag: Dict = {}         # producer class of a root: input | fused | materialized

    def read(arg) -> float:
        """Bytes an op reads from the graph value ``arg``."""
        base = root.get(arg, arg)
        kind = tag.get(base, "input")
        if kind == "fused":
            return 0.0
        own = sum(_nbytes(t) for t in _tensors(arg.meta.get("val")))
        whole = sum(_nbytes(t) for t in _tensors(base.meta.get("val")))
        return float(min(own, whole)) if whole else float(own)

    for node in graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            tag[node] = "input"
            continue
        if node.op != "call_function":
            continue
        if _is_view(node):
            parent = node.args[0]
            root[node] = root.get(parent, parent)
            continue
        if node.target is operator.getitem:
            # one output of a multi-output op: its own root, tagged as
            # the op's outputs were
            tag[node] = tag.get(node.args[0], "materialized")
            continue
        name = _name(node)
        value = node.meta.get("val")
        outs = _tensors(value)
        flops = _op_flops(name, node, outs)
        gemm = flops if name in GEMMS or name.startswith("convolution") \
            else 0.0

        args = [a for a in node.all_input_nodes]
        by = 0.0
        if name in STORES:
            # reads what it stores (not ``self``) and writes it: the
            # values, or the whole of ``self`` for a fill
            sources = args[1:]
            by += sum(read(a) for a in sources)
            if name in FILLS or not sources:
                by += sum(_nbytes(t) for t in outs)
            else:
                by += sum(_nbytes(t) for t in _tensors(
                    sources[-1].meta.get("val")))
            tag[node] = "materialized"
        else:
            if isinstance(value, (list, tuple)):
                cons = [_consumers(u) for u in node.users
                        if u.target is operator.getitem]
                consumers_ok = all(c <= 1 for c in cons)
            else:
                consumers_ok = _consumers(node) <= 1
            fused_out = name in FUSIBLE and consumers_ok
            if not fused_out:
                by += sum(_nbytes(t) for t in outs)
            by += sum(read(a) for a in args)
            tag[node] = "fused" if fused_out else "materialized"
        total += Cost(flops, by, gemm)
    return total


def trace(fn, *args) -> torch.fx.GraphModule:
    """``fn`` traced by ``make_fx`` on ``args`` (``meta`` tensors, or
    trees of them in dicts)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn)(*args)


def graph_cost(fn, *args) -> Cost:
    """Trace ``fn`` on ``args`` and walk the graph."""
    return walk(trace(fn, *args).graph)
