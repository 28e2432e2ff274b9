"""Layer/operation specifications for the SimDIT model (paper Table I).

Two families:
  * ``ConvLayer``  -- executed on the systolic array (Conv + FC, both the
    forward op and the two backward ops after the Table V transforms).
  * ``SimdLayer``  -- executed on the SIMD array.  Every non-Conv op is
    expressed through one generic tile template (paper Sec. IV-B): an
    iteration space (h, w, n, c), a set of 4D/1D input/output tensors, and
    per-element arithmetic op lists.  ``BN_back`` is the two-part schedule
    of Algorithm 1: it is represented as two chained generic parts.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Systolic-array layers
# ---------------------------------------------------------------------------

CONV_PHASES = ("fwd", "bwd_dx", "bwd_dw")
GEMM_PHASES = ("fwd", "bwd_dx", "bwd_dw")
SIMD_PHASES = ("fwd", "bwd")


@dataclass(frozen=True)
class ConvLayer:
    """Conv/FC layer (paper Fig. 3 notation).

    FC layers are convs with kh=kw=ih=iw=oh=ow=1, ic=fan_in, oc=fan_out.
    ``phase`` tags forward vs the two backward ops (after Table V mapping
    both backward ops are *plain convolutions* and reuse the same model).
    """
    name: str
    n: int          # batch
    ic: int
    ih: int
    iw: int
    oc: int
    oh: int
    ow: int
    kh: int
    kw: int
    s: int = 1
    has_bias: bool = True
    phase: str = "fwd"          # fwd | bwd_dx | bwd_dw
    kind: str = "conv"          # conv | fc

    @property
    def macs(self) -> int:
        return self.n * self.oh * self.ow * self.oc * self.kh * self.kw * self.ic

    @property
    def weight_elems(self) -> int:
        return self.kh * self.kw * self.ic * self.oc

    @property
    def ofmap_elems(self) -> int:
        return self.n * self.oh * self.ow * self.oc

    @property
    def ifmap_elems(self) -> int:
        return self.n * self.ih * self.iw * self.ic

    @property
    def is_backward(self) -> bool:
        return self.phase != "fwd"


def fc(name: str, n: int, fan_in: int, fan_out: int, has_bias: bool = True,
       phase: str = "fwd") -> ConvLayer:
    return ConvLayer(name=name, n=n, ic=fan_in, ih=1, iw=1, oc=fan_out,
                     oh=1, ow=1, kh=1, kw=1, s=1, has_bias=has_bias,
                     phase=phase, kind="fc")


@dataclass(frozen=True)
class GemmLayer:
    """Plain GEMM out[m, n] = in[m, k] @ w[k, n] (+ bias[n]) on the
    systolic array — attention/MLP projections map onto the weight-
    stationary array without im2col: k along the J rows (the reduction
    dim, like ``ic``), n along the K columns (like ``oc``), m streamed
    (like the batch-spatial dim).  A GEMM m x n x k is cost-equivalent to
    ``fc(n=m, ic=k, oc=n)``; keeping it a first-class type preserves the
    M/N/K vocabulary, the per-head/per-expert ``count`` multiplicity, and
    the ``param`` distinction the training expansion needs.

    ``count`` repeats the identical GEMM (e.g. batch x heads attention
    score GEMMs): every cost quantity scales linearly, the tiling does
    not depend on it.  ``param=False`` marks activation-activation GEMMs
    (attention scores, A·V) whose "weight" operand is itself an
    activation: the training expansion still emits both operand
    gradients but skips the parameter update."""
    name: str
    m: int          # rows of the output (streamed dim)
    n: int          # cols of the output (mapped on the K array columns)
    k: int          # reduction dim (mapped on the J array rows)
    has_bias: bool = False
    phase: str = "fwd"          # fwd | bwd_dx | bwd_dw
    kind: str = "gemm"
    count: int = 1
    param: bool = True

    @property
    def macs(self) -> int:
        return self.m * self.n * self.k * self.count

    @property
    def weight_elems(self) -> int:
        return self.k * self.n

    @property
    def out_elems(self) -> int:
        return self.m * self.n

    @property
    def in_elems(self) -> int:
        return self.m * self.k

    @property
    def is_backward(self) -> bool:
        return self.phase != "fwd"


def gemm(name: str, m: int, n: int, k: int, has_bias: bool = False,
         phase: str = "fwd", count: int = 1, param: bool = True) -> GemmLayer:
    return GemmLayer(name=name, m=m, n=n, k=k, has_bias=has_bias,
                     phase=phase, count=count, param=param)


# ---------------------------------------------------------------------------
# SIMD-array layers: the generic tile template
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TensorRef:
    """A tensor participating in a SIMD op.

    ``rank`` is '4d' (iterates over h,w,n inside each c tile) or '1d'
    (loaded/stored once per c tile, outside the h/w/n loops -- exactly the
    placement of the 1D tensors in Algorithm 1).
    ``io`` in {'in','out'}.
    ``scale`` multiplies the default tile volume -- used e.g. for pool
    input tiles whose spatial extent is (T-1)*s + r per output tile dim.
    """
    rank: str
    io: str
    scale: float = 1.0


@dataclass(frozen=True)
class SimdPart:
    """One generic part: iteration space + tensors + per-element op lists."""
    tensors: Tuple[TensorRef, ...]
    ops4d: Tuple[str, ...] = ()     # arithmetic ops per 4D element
    ops1d: Tuple[str, ...] = ()     # arithmetic ops per 1D (per-channel) element


@dataclass(frozen=True)
class SimdLayer:
    """A non-Conv layer = 1..2 generic parts over an (h,w,n,c) space."""
    name: str
    op: str
    h: int
    w: int
    n: int
    c: int
    parts: Tuple[SimdPart, ...]
    phase: str = "fwd"
    pool_r: int = 0      # pool window / stride metadata (pool ops only)
    pool_s: int = 0

    @property
    def elems(self) -> int:
        return self.h * self.w * self.n * self.c

    @property
    def is_backward(self) -> bool:
        return self.phase != "fwd"


def phase_key(layer) -> str:
    """Namespaced engine:phase tag of a layer ('conv:fwd', 'gemm:bwd_dw',
    'simd:bwd', ...) — the key space shared by the simulator's per-phase
    aggregates and the DSE phase-resolved cost attribution."""
    if isinstance(layer, ConvLayer):
        family = "conv"
    elif isinstance(layer, GemmLayer):
        family = "gemm"
    else:
        family = "simd"
    return f"{family}:{layer.phase}"


# -- constructors for each modeled op (paper Table I) -----------------------

def tensor_add(name: str, h: int, w: int, n: int, c: int,
               phase: str = "fwd") -> SimdLayer:
    """out = in1 + in2 (paper Sec. IV-E). 1 add / element."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("add",))
    return SimdLayer(name, "tensor_add", h, w, n, c, (part,), phase)


def relu(name: str, h: int, w: int, n: int, c: int,
         phase: str = "fwd") -> SimdLayer:
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "out")),
        ops4d=("max",))
    return SimdLayer(name, "relu", h, w, n, c, (part,), phase)


def relu_back(name: str, h: int, w: int, n: int, c: int) -> SimdLayer:
    """dX = dY * (X > 0): reads dY and X, 1 cmp + 1 mul per element."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("cmp", "mul"))
    return SimdLayer(name, "relu_back", h, w, n, c, (part,), "bwd")


def pool(name: str, oh: int, ow: int, n: int, c: int, r: int, s: int,
         mode: str = "max", phase: str = "fwd") -> SimdLayer:
    """Max/avg pool with an r x r window, stride s.

    Iteration space = output tensor. The input tile for a (Th,Tw) output
    tile spans ((Th-1)s + r) x ((Tw-1)s + r); we fold that into a constant
    volume ``scale`` using the layer-level ratio (exact at full-tensor
    granularity, conservative within tiles).
    Per output element: (r*r - 1) max ops, or (r*r - 1) adds + 1 mul (avg,
    multiply by 1/r^2).
    """
    ih = (oh - 1) * s + r
    iw = (ow - 1) * s + r
    scale = (ih * iw) / float(oh * ow)
    if mode == "max":
        ops: Tuple[str, ...] = ("max",) * (r * r - 1)
    else:
        ops = ("add",) * (r * r - 1) + ("mul",)
    part = SimdPart(
        tensors=(TensorRef("4d", "in", scale=scale), TensorRef("4d", "out")),
        ops4d=ops)
    return SimdLayer(name, f"pool_{mode}", oh, ow, n, c, (part,), phase,
                     pool_r=r, pool_s=s)


def global_avg_pool(name: str, ih: int, iw: int, n: int, c: int,
                    phase: str = "fwd") -> SimdLayer:
    """Global average pool: output is 1x1; iterate over the input space and
    accumulate per channel (1 add / input element), then 1 mul per channel."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("1d", "out")),
        ops4d=("add",),
        ops1d=("mul",))
    return SimdLayer(name, "gap", ih, iw, n, c, (part,), phase)


def pool_back(name: str, oh: int, ow: int, n: int, c: int, r: int, s: int,
              mode: str = "max") -> SimdLayer:
    """Backward of pool.

    max: route dY to the argmax -- reads dY and the saved argmax index map,
         writes dX (input-sized): 1 cmp + 1 mul per *input* element.
    avg: dX = broadcast(dY) / r^2 : 1 mul per input element.
    Iteration space = input tensor (the written gradient)."""
    ih = (oh - 1) * s + r
    iw = (ow - 1) * s + r
    scale_out = (oh * ow) / float(ih * iw)
    if mode == "max":
        tensors = (TensorRef("4d", "in", scale=scale_out),   # dY
                   TensorRef("4d", "in", scale=scale_out),   # argmax map
                   TensorRef("4d", "out"))                   # dX
        ops: Tuple[str, ...] = ("cmp", "mul")
    else:
        tensors = (TensorRef("4d", "in", scale=scale_out), TensorRef("4d", "out"))
        ops = ("mul",)
    part = SimdPart(tensors=tensors, ops4d=ops)
    return SimdLayer(name, f"pool_{mode}_back", ih, iw, n, c, (part,), "bwd")


def gap_back(name: str, ih: int, iw: int, n: int, c: int) -> SimdLayer:
    """Backward of global-avg-pool: dX = dY / (ih*iw), broadcast."""
    part = SimdPart(
        tensors=(TensorRef("1d", "in"), TensorRef("4d", "out")),
        ops4d=("mul",))
    return SimdLayer(name, "gap_back", ih, iw, n, c, (part,), "bwd")


def batch_norm(name: str, h: int, w: int, n: int, c: int,
               phase: str = "fwd") -> SimdLayer:
    """BN forward (training): two passes over X.

    Part 1 (statistics): read X, accumulate sum and sum-of-squares per
      channel (1 add + 1 mul + 1 add per element); per channel finalize
      mean/var/psi: mul, sub(mul for E[x]^2), add(eps), rsqrt  -> stored as
      mu, psi for the backward pass (paper Fig. 10).
    Part 2 (normalize): per channel fold a = gamma*psi, b = beta - a*mu
      (mul, mul, sub — the same per-channel hoisting the paper applies to
      the Eq. 28 prefactor), then per element y = a*x + b: mul, add.
    """
    p1 = SimdPart(
        tensors=(TensorRef("4d", "in"),
                 TensorRef("1d", "out"), TensorRef("1d", "out")),
        ops4d=("add", "mul", "add"),
        ops1d=("mul", "mul", "sub", "rsqrt"))
    p2 = SimdPart(
        tensors=(TensorRef("4d", "in"),
                 TensorRef("1d", "in"), TensorRef("1d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("mul", "add"),
        ops1d=("mul", "mul", "sub"))
    return SimdLayer(name, "bn", h, w, n, c, (p1, p2), phase)


def bn_back(name: str, h: int, w: int, n: int, c: int) -> SimdLayer:
    """BN backward -- Algorithm 1 / Appendix A, two parts.

    Part-1 (lines 1-12,24): in: X, dY (4D), mu, psi (1D);
      out: Xhat (4D), dgamma, dbeta (1D).
      ops/4D elem: sub, mul (Xhat) + mul, add (dgamma psum) + add (dbeta) = 5.
    Part-2 (lines 13-23): in: Xhat, dY (4D), gamma (1D; dgamma & dbeta are
      *reused from VMem* inside the same c-tile -- no DRAM traffic, exactly
      the Line-24 placement of Algorithm 1); out: dX (4D).
      ops/1D elem: mul + div (the term outside the parenthesis of Eq. 28);
      ops/4D elem: 3 mul + 2 sub (Eq. 28 inside, matching Eq. 38).
    """
    p1 = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("1d", "in"), TensorRef("1d", "in"),
                 TensorRef("4d", "out"),
                 TensorRef("1d", "out"), TensorRef("1d", "out")),
        ops4d=("sub", "mul", "mul", "add", "add"))
    p2 = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("1d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("mul", "mul", "mul", "sub", "sub"),
        ops1d=("mul", "div"))
    return SimdLayer(name, "bn_back", h, w, n, c, (p1, p2), "bwd")


def param_update(name: str, numel: int, ndim: int, k_align: int = 1) -> SimdLayer:
    """SGD parameter update p <- p - lr * g  (mul + sub per element).

    1D/2D/4D parameter tensors (paper Table I) all flatten onto the SIMD
    lanes; we lay the elements over the c dimension in K-aligned rows.
    """
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("mul", "sub"))
    c = max(1, min(numel, 4096))
    rows = (numel + c - 1) // c
    return SimdLayer(name, f"update_{ndim}d", rows, 1, 1, c, (part,), "bwd")


def bias_grad(name: str, oh: int, ow: int, n: int, oc: int) -> SimdLayer:
    """dL/db = sum over (n, oh, ow) of dY: 1 add per element, 1D output."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("1d", "out")),
        ops4d=("add",))
    return SimdLayer(name, "bias_grad", oh, ow, n, oc, (part,), "bwd")


# -- transformer / LLM non-GEMM ops (same generic tile template) -------------
#
# These route softmax/layernorm/rotary/activation through the SIMD model
# exactly like the paper's non-conv ops.  Iteration spaces put the
# normalized/rotated feature dimension on ``c`` (the SIMD lanes) and the
# token count on the h/n dims, so per-feature 1D tensors (gamma, beta)
# land in the per-c-tile placement the template already models.

def rmsnorm(name: str, tokens: int, d: int, phase: str = "fwd") -> SimdLayer:
    """y = gamma * x / rms(x): a stats pass (sum of squares per token,
    finalized with a reciprocal sqrt) and a scale pass (2 mul/element)."""
    p1 = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("1d", "out")),
        ops4d=("mul", "add"),
        ops1d=("mul", "rsqrt"))
    p2 = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("1d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("mul", "mul"))
    return SimdLayer(name, "rmsnorm", tokens, 1, 1, d, (p1, p2), phase)


def layer_norm(name: str, tokens: int, d: int, phase: str = "fwd") -> SimdLayer:
    """Full LayerNorm: BN-style two-pass schedule (mean/var stats, then
    y = a*x + b with a = gamma*psi, b = beta - a*mu folded per feature)."""
    p1 = SimdPart(
        tensors=(TensorRef("4d", "in"),
                 TensorRef("1d", "out"), TensorRef("1d", "out")),
        ops4d=("add", "mul", "add"),
        ops1d=("mul", "mul", "sub", "rsqrt"))
    p2 = SimdPart(
        tensors=(TensorRef("4d", "in"),
                 TensorRef("1d", "in"), TensorRef("1d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("mul", "add"),
        ops1d=("mul", "mul", "sub"))
    return SimdLayer(name, "layernorm", tokens, 1, 1, d, (p1, p2), phase)


def softmax(name: str, rows: int, cols: int, phase: str = "fwd") -> SimdLayer:
    """Row-wise softmax over ``cols`` entries (attention scores, router
    logits): online max, shifted exp with running sum, then the rescale —
    5 ops per element (max, sub, exp, add, mul)."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "out")),
        ops4d=("max", "sub", "exp", "add", "mul"))
    return SimdLayer(name, "softmax", rows, 1, 1, cols, (part,), phase)


def rotary(name: str, tokens: int, d: int, phase: str = "fwd") -> SimdLayer:
    """Rotary position embedding: y = x*cos +- rot(x)*sin — reads the
    activations plus the (sin, cos) tables, 2 mul + 1 add per element."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("4d", "in"), TensorRef("4d", "out")),
        ops4d=("mul", "mul", "add"))
    return SimdLayer(name, "rotary", tokens, 1, 1, d, (part,), phase)


def conv1d(name: str, tokens: int, d: int, width: int,
           phase: str = "fwd") -> SimdLayer:
    """Depthwise causal short convolution over the sequence (the
    mamba2 / RG-LRU ``conv_width``-tap conv): ``width`` MACs per output
    element, reading the activation window and the per-channel taps."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("mul", "add") * width)
    return SimdLayer(name, "conv1d", tokens, 1, 1, d, (part,), phase)


def elementwise_scan(name: str, tokens: int, d: int, kind: str = "ssm",
                     phase: str = "fwd") -> SimdLayer:
    """Elementwise recurrence update (SSD state blend / RG-LRU gate
    recurrence): per element, the gate nonlinearity plus the decay
    multiply-accumulate into the carried state."""
    part = SimdPart(
        tensors=(TensorRef("4d", "in"), TensorRef("4d", "in"),
                 TensorRef("4d", "out")),
        ops4d=("exp", "mul", "mul", "add", "mul", "add"))
    return SimdLayer(name, f"scan_{kind}", tokens, 1, 1, d, (part,), phase)


def activation(name: str, tokens: int, d: int, act: str = "silu",
               gated: bool = False, phase: str = "fwd") -> SimdLayer:
    """Pointwise activation (silu/gelu both cost a sigmoid-like kernel:
    exp, add, div, then the gating mul).  ``gated=True`` adds the second
    (up-projection) operand and its elementwise product — the fused
    act(gate) * up of gated MLPs."""
    tensors = [TensorRef("4d", "in")]
    ops: Tuple[str, ...] = ("exp", "add", "div", "mul")
    if gated:
        tensors.append(TensorRef("4d", "in"))
        ops = ops + ("mul",)
    tensors.append(TensorRef("4d", "out"))
    part = SimdPart(tensors=tuple(tensors), ops4d=ops)
    return SimdLayer(name, f"act_{act}", tokens, 1, 1, d, (part,), phase)
