"""Tiling generator: outer/inner tile template (paper Sec. IV-B).

Outer tiles must fit the double-buffered on-chip SRAMs (half of each
buffer usable); inner tiles are fixed by the compute array: the systolic
GEMM mapping uses t_ic = J, t_oc = K, every other inner tile parameter = 1
(paper Fig. 4); the SIMD mapping uses t_c = K, t_h = t_w = t_n = 1
(paper Fig. 7).

The generator mirrors the paper's "tiling generator that generates valid
tiling parameters for each type of layer using the configuration of the
hardware" (Sec. VII): it is a deterministic greedy that
  1. keeps the full kernel window (T_kh=Kh, T_kw=Kw) when it fits and
     shrinks kernel dims only when forced (the *training* case the paper
     calls out, with kernels up to 223x223),
  2. maximizes T_ic (J-aligned) to reduce psum spill, then grows T_oc
     (K-aligned) within WBuf — re-offering any capacity an IBuf-forced
     T_ic shrink frees back to T_oc,
  3. fills IBuf/OBuf with spatial/batch tile extent,
  4. finishes every growth axis with an exact, padding-aware remainder
     fill (the extent in [current, largest-that-fits] minimizing the
     ceil-padded extent), so *arbitrary* integer buffer sizes — not just
     powers of two — translate into distinct tilings.  This is what gives
     the off-lattice DSE optimizer (``core/optimize.py``) a
     finer-than-power-of-two design space to search over.

The production derivation is *vectorized over buffer-size candidates*:
``derive_conv_tilings_batch``/``derive_simd_tilings_batch`` run every
greedy phase as masked numpy updates over the whole candidate axis at
once — capacities become per-candidate vectors, the kernel-shrink /
T_ic-maximize / T_oc-grow / spatial-doubling phases become masked array
updates, and the remainder fill becomes a batched distinct-quotient
reduction — so a DSE lattice's worth of tilings (hundreds of size triples
x every layer shape) costs one numpy pass per layer instead of one Python
walk per (triple, layer) pair.  ``make_conv_tiling``/``make_simd_tiling``
are thin memoized scalar wrappers over the same kernel (one code path, no
drift); ``derive_conv_tiling_reference``/``derive_simd_tiling_reference``
retain the original scalar greedy for equivalence tests and benchmarks,
and the batch must stay bit-identical to it (asserted per-field in
``tests/test_tiling_batch.py`` over the full Table VIII lattices).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hardware import HardwareSpec
from .layers import ConvLayer, GemmLayer, SimdLayer


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Tiling caches
#
# Tilings depend on a small subset of the HardwareSpec (buffer sizes, bit
# widths, array dims) and on the layer *shape* — never on layer names,
# phases, or DRAM bandwidths.  Keying the cache on exactly that subset means
# e.g. a bandwidth-only sensitivity sweep, or a DSE bandwidth sweep at fixed
# buffer sizes, hits the cache on every call, and identically-shaped layers
# with different names share one entry.
# ---------------------------------------------------------------------------

_CONV_TILING_CACHE: Dict[tuple, "ConvTiling"] = {}
_SIMD_TILING_CACHE: Dict[tuple, "SimdTiling"] = {}
_GEMM_TILING_CACHE: Dict[tuple, "GemmTiling"] = {}


def clear_tiling_caches() -> None:
    """Drop all memoized tilings (used by benchmarks for fair timing)."""
    _CONV_TILING_CACHE.clear()
    _SIMD_TILING_CACHE.clear()
    _GEMM_TILING_CACHE.clear()


def _conv_hw_key(hw: HardwareSpec) -> tuple:
    return (hw.wbuf, hw.ibuf, hw.obuf, hw.bbuf,
            hw.b_w, hw.b_b, hw.b_i, hw.b_p, hw.J, hw.K)


def _conv_layer_key(layer: ConvLayer) -> tuple:
    return (layer.n, layer.ic, layer.ih, layer.iw, layer.oc, layer.oh,
            layer.ow, layer.kh, layer.kw, layer.s, layer.has_bias)


def _gemm_layer_key(layer: GemmLayer) -> tuple:
    return (layer.m, layer.n, layer.k, layer.has_bias)


def _simd_hw_key(hw: HardwareSpec) -> tuple:
    return (hw.vmem, hw.b_in, hw.K)


def _simd_layer_key(layer: SimdLayer) -> tuple:
    return (layer.h, layer.w, layer.n, layer.c, layer.parts)


def stable_key_repr(key) -> str:
    """Canonical, process-independent serialization of a nested cache key.

    The table/tiling cache keys are nested tuples of ints, bools, floats
    and strings (hardware invariants, layer shapes, phases), plus frozen
    dataclasses of the same (the SIMD layer parts).  The persistent
    table store (``core.store``) content-addresses its entries on this
    serialization, so it must be byte-stable across processes and Python
    versions: every leaf is tagged with its type (``True`` and ``1``
    must not collide) and rendered via ``repr`` (exact for ints and
    round-trip-exact for floats); dataclasses serialize as their class
    name plus fields in definition order.  Unsupported leaf types raise
    ``TypeError`` — an unserializable key must never silently alias."""
    parts: list = []
    _stable_key_parts(key, parts)
    return "".join(parts)


def _stable_key_parts(obj, out: list) -> None:
    if isinstance(obj, tuple):
        out.append("(")
        for item in obj:
            _stable_key_parts(item, out)
            out.append(",")
        out.append(")")
    elif isinstance(obj, bool):            # before int: bool is an int
        out.append(f"b:{obj!r}")
    elif isinstance(obj, int):
        out.append(f"i:{obj!r}")
    elif isinstance(obj, float):
        out.append(f"f:{obj!r}")
    elif isinstance(obj, str):
        out.append(f"s:{len(obj)}:{obj}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out.append(f"d:{type(obj).__name__}(")
        for f in dataclasses.fields(obj):
            _stable_key_parts(getattr(obj, f.name), out)
            out.append(",")
        out.append(")")
    else:
        raise TypeError(
            f"cache keys must be nested tuples/dataclasses of "
            f"int/bool/float/str; got {type(obj).__name__}: {obj!r}")


def _align_down(v: int, a: int) -> int:
    return max(a, (v // a) * a) if v >= a else v


def _max_fit(lo: int, hi: int, fits) -> int:
    """Largest v in [lo, hi] with fits(v), assuming fits is monotone
    decreasing in v and fits(lo) holds (binary search)."""
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


@lru_cache(maxsize=None)
def _distinct_quotients(dim: int) -> Tuple[int, ...]:
    """All distinct values of ``ceil(dim/m)`` over m >= 1, ascending.

    There are only O(sqrt(dim)) of them: for m <= sqrt(dim) each m gives
    one quotient, and every quotient produced by a larger m is itself
    <= sqrt(dim)+1 (t = ceil(dim/t') for t' = ceil(dim/t) — the standard
    divisor-block identity filters the achievable small values)."""
    r = math.isqrt(dim)
    out = {ceil_div(dim, m) for m in range(1, r + 2)}
    out.update(t for t in range(1, r + 2)
               if ceil_div(dim, ceil_div(dim, t)) == t)
    return tuple(sorted(out))


def _fill_dim(cur: int, dim: int, fits) -> int:
    """Exact remainder fill for one tile extent: among the extents in
    [cur, largest-that-fits], pick the one minimizing the ceil-padded
    extent ``ceil(dim/T) * T`` (tile-grid traffic is proportional to it —
    growing 8 -> 13 over a dim of 14 would *double* the padded extent),
    tie-breaking toward the largest T (fewest tiles, least setup
    overhead).  Never shrinks below ``cur``, so it can only improve on
    the doubling pass it follows.

    Only the O(sqrt(dim)) distinct quotients ``t = ceil(dim/m)`` can win
    (for any other extent, the next quotient up has the same tile count
    and a no-worse padded extent is found at a quotient), so the scan
    enumerates exactly those instead of every tile count in
    [1, ceil(dim/cur)] — O(dim) when ``cur`` is 1."""
    if cur >= dim:
        return cur
    hi = _max_fit(cur, dim, fits)
    best_t, best_ext = cur, ceil_div(dim, cur) * cur
    for t in _distinct_quotients(dim):
        if t < cur or t > hi:
            continue
        ext = ceil_div(dim, t) * t
        if ext < best_ext or (ext == best_ext and t > best_t):
            best_t, best_ext = t, ext
    return best_t


# ---------------------------------------------------------------------------
# Vectorized helpers: the same primitives with a candidate axis
# ---------------------------------------------------------------------------

def _max_fit_vec(lo: np.ndarray, hi: np.ndarray, fits) -> np.ndarray:
    """Vector ``_max_fit``: per-lane largest v in [lo, hi] with fits(v),
    where ``fits`` maps an int64 vector to a boolean vector (monotone
    decreasing per lane, fits(lo) assumed)."""
    # saturation fast path: lanes whose whole range fits converge at once
    # (the common case — most tile extents reach the full dim), leaving
    # the log2(dim) bisection to the genuinely capacity-bound lanes
    lo = np.where(fits(hi), hi, lo)
    hi = hi.copy()
    while True:
        open_ = lo < hi
        if not open_.any():
            return lo
        mid = (lo + hi + 1) // 2
        ok = fits(mid) & open_
        lo = np.where(ok, mid, lo)
        hi = np.where(open_ & ~ok, mid - 1, hi)


def _fill_dim_batch(cur: np.ndarray, dim: int, fits=None,
                    hi: "np.ndarray | None" = None) -> np.ndarray:
    """Vector ``_fill_dim``: the padded-extent minimization as one masked
    distinct-quotient reduction over the candidate axis.  The
    largest-that-fits bound comes either from ``hi`` (callers whose
    capacity constraints invert in closed form — the conv path) or from a
    vector bisection of ``fits`` (an int64-extent-vector -> bool-vector
    predicate, monotone decreasing per lane — the SIMD path).  A lane
    whose ``hi`` lands below ``cur`` (its current extent no longer fits)
    keeps ``cur``, exactly like the scalar.  Lanes already at ``dim`` are
    returned unchanged."""
    act = cur < dim
    if not act.any():
        return cur
    if hi is None:
        hi = _max_fit_vec(cur, np.where(act, dim, cur), fits)
    qs = np.asarray(_distinct_quotients(dim), dtype=np.int64)
    # lexicographic (padded extent, -t) packed into one int64 key
    enc = 2 * dim + 2
    key_q = ((dim + qs - 1) // qs) * qs * enc + (dim - qs)
    valid = (qs[None, :] >= cur[:, None]) & (qs[None, :] <= hi[:, None])
    best = np.where(valid, key_q[None, :],
                    np.iinfo(np.int64).max).min(axis=1)
    best = np.minimum(best, ((dim + cur - 1) // cur) * cur * enc
                      + (dim - cur))
    return np.where(act, dim - best % enc, cur)


# ---------------------------------------------------------------------------
# Conv tiling
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvTiling:
    """Outer tile sizes T_phi and inner tile sizes t_phi (paper Fig. 4)."""
    T_oh: int; T_ow: int; T_n: int
    T_kh: int; T_kw: int; T_ic: int; T_oc: int
    t_ic: int; t_oc: int
    # inner tiles for the remaining dims are 1 by construction

    def ih_extent(self, s: int) -> int:
        return (self.T_oh - 1) * s + self.T_kh

    def iw_extent(self, s: int) -> int:
        return (self.T_ow - 1) * s + self.T_kw

    def weight_tile_elems(self) -> int:
        return self.T_kh * self.T_kw * self.T_ic * self.T_oc

    def ifmap_tile_elems(self, s: int) -> int:
        return self.ih_extent(s) * self.iw_extent(s) * self.T_n * self.T_ic

    def psum_tile_elems(self) -> int:
        return self.T_oh * self.T_ow * self.T_n * self.T_oc


def conv_tile_fits(hw: HardwareSpec, layer: ConvLayer, t: ConvTiling) -> bool:
    """Validity: every outer tile fits its (half, double-buffered) SRAM."""
    if t.weight_tile_elems() * hw.b_w // 8 > hw.wbuf // 2:
        return False
    if t.ifmap_tile_elems(layer.s) * hw.b_i // 8 > hw.ibuf // 2:
        return False
    if t.psum_tile_elems() * hw.b_p // 8 > hw.obuf // 2:
        return False
    if layer.has_bias and t.T_oc * hw.b_b // 8 > hw.bbuf // 2:
        return False
    for tv, dim in ((t.T_oh, layer.oh), (t.T_ow, layer.ow), (t.T_n, layer.n),
                    (t.T_kh, layer.kh), (t.T_kw, layer.kw),
                    (t.T_ic, layer.ic), (t.T_oc, layer.oc)):
        if not (1 <= tv <= dim):
            return False
    return True


def make_conv_tiling(hw: HardwareSpec, layer: ConvLayer) -> ConvTiling:
    """Memoized scalar front-end: a one-candidate slice of the batched
    derivation below (single code path with the DSE grid fill)."""
    key = (_conv_hw_key(hw), _conv_layer_key(layer))
    t = _CONV_TILING_CACHE.get(key)
    if t is None:
        t = _CONV_TILING_CACHE[key] = _derive_conv_tiling(hw, layer)
    return t


def _derive_conv_tiling(hw: HardwareSpec, layer: ConvLayer) -> ConvTiling:
    return derive_conv_tilings_batch(
        hw, [(hw.wbuf, hw.ibuf, hw.obuf)], layer)[0]


def derive_conv_tilings_batch(hw: HardwareSpec,
                              size_triples: Sequence[Tuple[int, int, int]],
                              layer: ConvLayer) -> List[ConvTiling]:
    """Derive the greedy conv tiling for *every* (wbuf, ibuf, obuf) byte
    triple at once: one numpy pass over the candidate axis, bit-identical
    per candidate to ``derive_conv_tiling_reference``.

    All other hardware invariants (bit widths, J/K, bbuf) come from
    ``hw``; the triples are byte sizes, exactly as stored on
    ``HardwareSpec``.  Every greedy phase of the scalar walk becomes a
    masked vector update — the loop counts are logarithmic in the layer
    dims, so the pass does O(log) vector operations regardless of how
    many candidates ride the axis."""
    fields = _derive_conv_tiling_arrays(hw, size_triples, layer)
    # .tolist() bulk-converts to Python ints (ConvTiling fields are plain
    # ints, exactly like the scalar path's)
    return [ConvTiling(*vals)
            for vals in zip(*(a.tolist() for a in fields))]


def _derive_conv_tiling_arrays(hw: HardwareSpec,
                               size_triples: Sequence[Tuple[int, int, int]],
                               layer: ConvLayer) -> Tuple[np.ndarray, ...]:
    """The batched greedy kernel, returning the struct-of-arrays form
    ``(T_oh, T_ow, T_n, T_kh, T_kw, T_ic, T_oc, t_ic, t_oc)`` (int64,
    one lane per triple).  ``dse.batch_build_conv_tables`` consumes this
    directly so whole table lattices never materialize per-candidate
    ``ConvTiling`` objects."""
    tri = np.asarray([(t[0], t[1], t[2]) for t in size_triples],
                     dtype=np.int64).reshape(-1, 3)
    n = len(tri)
    wcap = tri[:, 0] // 2 * 8 // hw.b_w      # weight elems per half-buffer
    icap = tri[:, 1] // 2 * 8 // hw.b_i
    ocap = tri[:, 2] // 2 * 8 // hw.b_p
    j0 = min(hw.J, layer.ic)
    k0 = min(hw.K, layer.oc)
    s = layer.s

    # 1) kernel window: keep full, shrink only if a single (J, K) weight
    #    slice with the window would not fit (training-phase huge kernels).
    T_kh = np.full(n, layer.kh, dtype=np.int64)
    T_kw = np.full(n, layer.kw, dtype=np.int64)
    while True:
        m = (T_kh * T_kw * j0 * k0 > wcap) & (T_kw > 1)
        if not m.any():
            break
        T_kw = np.where(m, T_kw // 2, T_kw)
    while True:
        m = (T_kh * T_kw * j0 * k0 > wcap) & (T_kh > 1)
        if not m.any():
            break
        T_kh = np.where(m, T_kh // 2, T_kh)

    # 2) maximize T_ic (J-aligned) with minimal T_oc, then grow T_oc:
    #    doubling first, then an exact remainder fill to the largest
    #    K-aligned value the capacity admits (full oc when it fits).  The
    #    fill is what makes *arbitrary* — non-power-of-two — buffer sizes
    #    meaningful: without it every capacity between two powers of two
    #    collapses onto the lower one's tiling.
    v = wcap // (T_kh * T_kw * k0)
    T_ic = np.where(v >= hw.J, np.maximum(hw.J, v // hw.J * hw.J), v)
    T_ic = np.maximum(1, np.minimum(T_ic, layer.ic))

    def grow_oc(T_oc: np.ndarray) -> np.ndarray:
        while True:
            m = ((T_oc * 2 <= layer.oc)
                 & (T_kh * T_kw * T_ic * T_oc * 2 <= wcap))
            if not m.any():
                break
            T_oc = np.where(m, T_oc * 2, T_oc)
        T_oc = np.minimum(T_oc, layer.oc)
        cap_oc = wcap // (T_kh * T_kw * T_ic)
        fill = np.minimum(layer.oc, np.maximum(k0, cap_oc // k0 * k0))
        return np.where(cap_oc >= layer.oc, layer.oc,
                        np.where(cap_oc >= k0,
                                 np.maximum(T_oc, fill), T_oc))

    T_oc = grow_oc(np.full(n, k0, dtype=np.int64))

    # ifmap cap may also bound T_ic (for 1x1-spatial minimum tiles) ...
    while True:
        m = (T_ic > 1) & (T_kh * T_kw * T_ic > icap)
        if not m.any():
            break
        T_ic = np.where(m, T_ic // 2, T_ic)
    # ... and when it does, the WBuf capacity the shrink freed is
    # re-offered to T_oc (idempotent where no shrink happened, so lanes
    # the guard never touched keep their exact first-pass tiling).
    T_oc = grow_oc(T_oc)

    # 3) spatial/batch tile growth under IBuf and OBuf.  The capacity
    #    constraints are integer products monotone in each extent, so the
    #    exact per-dim maximum ("hi") inverts in closed form — the growth
    #    check is one comparison and the remainder fill needs no
    #    bisection.  When the current tiling does not fit at all (tiny
    #    IBuf/OBuf), hi lands below the current extent, no growth
    #    happens, and the final validity check applies the fallback —
    #    exactly the scalar behavior.
    T_oh = np.ones(n, dtype=np.int64)
    T_ow = np.ones(n, dtype=np.int64)
    T_n = np.ones(n, dtype=np.int64)

    def hi_ow():
        ih = (T_oh - 1) * s + T_kh
        return np.minimum(
            layer.ow,
            np.minimum((icap // (ih * T_n * T_ic) - T_kw) // s + 1,
                       ocap // (T_oh * T_n * T_oc)))

    def hi_oh():
        iw = (T_ow - 1) * s + T_kw
        return np.minimum(
            layer.oh,
            np.minimum((icap // (iw * T_n * T_ic) - T_kh) // s + 1,
                       ocap // (T_ow * T_n * T_oc)))

    def hi_n():
        ih = (T_oh - 1) * s + T_kh
        iw = (T_ow - 1) * s + T_kw
        return np.minimum(
            layer.n,
            np.minimum(icap // (ih * iw * T_ic),
                       ocap // (T_oh * T_ow * T_oc)))

    while True:
        grew = np.zeros(n, dtype=bool)
        cand = np.minimum(T_ow * 2, layer.ow)
        m = (cand > T_ow) & (cand <= hi_ow())
        T_ow = np.where(m, cand, T_ow)
        grew |= m
        cand = np.minimum(T_oh * 2, layer.oh)
        m = (cand > T_oh) & (cand <= hi_oh())
        T_oh = np.where(m, cand, T_oh)
        grew |= m
        cand = np.minimum(T_n * 2, layer.n)
        m = (cand > T_n) & (cand <= hi_n())
        T_n = np.where(m, cand, T_n)
        grew |= m
        if not grew.any():
            break

    # 4) remainder fill: grow each spatial/batch dim to the padding-aware
    #    best extent that still fits (doubling alone strands up to half of
    #    each capacity, and all of any capacity between two powers of two).
    while True:
        grew = np.zeros(n, dtype=bool)
        v = _fill_dim_batch(T_ow, layer.ow, hi=hi_ow())
        grew |= v > T_ow
        T_ow = v
        v = _fill_dim_batch(T_oh, layer.oh, hi=hi_oh())
        grew |= v > T_oh
        T_oh = v
        v = _fill_dim_batch(T_n, layer.n, hi=hi_n())
        grew |= v > T_n
        T_n = v
        if not grew.any():
            break

    t_ic = np.minimum(hw.J, T_ic)
    t_oc = np.minimum(hw.K, T_oc)

    # Validity (the vector ``conv_tile_fits``) with the same last-resort
    # fallback as the scalar: unit tiles along everything but ic/oc lanes.
    ih = (T_oh - 1) * s + T_kh
    iw = (T_ow - 1) * s + T_kw
    ok = ((T_kh * T_kw * T_ic * T_oc * hw.b_w // 8 <= tri[:, 0] // 2)
          & (ih * iw * T_n * T_ic * hw.b_i // 8 <= tri[:, 1] // 2)
          & (T_oh * T_ow * T_n * T_oc * hw.b_p // 8 <= tri[:, 2] // 2))
    if layer.has_bias:
        ok &= T_oc * hw.b_b // 8 <= hw.bbuf // 2
    for tv, dim in ((T_oh, layer.oh), (T_ow, layer.ow), (T_n, layer.n),
                    (T_kh, layer.kh), (T_kw, layer.kw),
                    (T_ic, layer.ic), (T_oc, layer.oc)):
        ok &= (1 <= tv) & (tv <= dim)
    fb_ic = min(hw.J, layer.ic)
    fb_oc = min(hw.K, layer.oc)
    T_oh = np.where(ok, T_oh, 1)
    T_ow = np.where(ok, T_ow, 1)
    T_n = np.where(ok, T_n, 1)
    T_kh = np.where(ok, T_kh, 1)
    T_kw = np.where(ok, T_kw, 1)
    T_ic = np.where(ok, T_ic, fb_ic)
    T_oc = np.where(ok, T_oc, fb_oc)
    t_ic = np.where(ok, t_ic, fb_ic)
    t_oc = np.where(ok, t_oc, fb_oc)

    return (T_oh, T_ow, T_n, T_kh, T_kw, T_ic, T_oc, t_ic, t_oc)


def derive_conv_tiling_reference(hw: HardwareSpec,
                                 layer: ConvLayer) -> ConvTiling:
    """The original scalar greedy walk, retained as the independently
    written reference the batched kernel is pinned against (the tiling
    analogue of ``dse.search_reference``).  Production callers go through
    ``make_conv_tiling`` -> ``derive_conv_tilings_batch``."""
    wcap = hw.wbuf // 2 * 8 // hw.b_w          # weight elems per half-buffer
    icap = hw.ibuf // 2 * 8 // hw.b_i
    ocap = hw.obuf // 2 * 8 // hw.b_p

    # 1) kernel window: keep full, shrink only when forced.
    T_kh, T_kw = layer.kh, layer.kw
    j0 = min(hw.J, layer.ic)
    k0 = min(hw.K, layer.oc)
    while T_kh * T_kw * j0 * k0 > wcap and T_kw > 1:
        T_kw = max(1, T_kw // 2)
    while T_kh * T_kw * j0 * k0 > wcap and T_kh > 1:
        T_kh = max(1, T_kh // 2)

    # 2) maximize T_ic (J-aligned), then grow T_oc within WBuf.
    T_ic = min(layer.ic, _align_down(wcap // (T_kh * T_kw * k0), hw.J))
    T_ic = max(1, min(T_ic, layer.ic))

    def grow_oc(T_oc: int) -> int:
        while T_oc * 2 <= layer.oc and T_kh * T_kw * T_ic * T_oc * 2 <= wcap:
            T_oc *= 2
        T_oc = min(T_oc, layer.oc)
        cap_oc = wcap // (T_kh * T_kw * T_ic)
        if cap_oc >= layer.oc:
            return layer.oc
        if cap_oc >= k0:
            return max(T_oc, min(layer.oc, _align_down(cap_oc, k0)))
        return T_oc

    T_oc = grow_oc(k0)

    # ifmap cap may also bound T_ic (for 1x1-spatial minimum tiles); the
    # WBuf capacity a shrink frees is re-offered to T_oc (grow_oc is
    # idempotent, so an untriggered guard changes nothing).
    while T_ic > 1 and (T_kh * T_kw * T_ic) > icap:
        T_ic = max(1, T_ic // 2)
    T_oc = grow_oc(T_oc)

    # 3) spatial/batch tile growth under IBuf and OBuf.
    T_oh = T_ow = T_n = 1

    def fits(oh: int, ow: int, n: int) -> bool:
        ih = (oh - 1) * layer.s + T_kh
        iw = (ow - 1) * layer.s + T_kw
        return (ih * iw * n * T_ic <= icap) and (oh * ow * n * T_oc <= ocap)

    grew = True
    while grew:
        grew = False
        for dim in ("ow", "oh", "n"):
            oh, ow, n = T_oh, T_ow, T_n
            if dim == "ow" and T_ow < layer.ow and fits(oh, min(ow * 2, layer.ow), n):
                T_ow = min(T_ow * 2, layer.ow); grew = True
            elif dim == "oh" and T_oh < layer.oh and fits(min(oh * 2, layer.oh), ow, n):
                T_oh = min(T_oh * 2, layer.oh); grew = True
            elif dim == "n" and T_n < layer.n and fits(oh, ow, min(n * 2, layer.n)):
                T_n = min(T_n * 2, layer.n); grew = True

    # 4) padding-aware remainder fill on each spatial/batch dim.
    grew = True
    while grew:
        grew = False
        v = _fill_dim(T_ow, layer.ow, lambda x: fits(T_oh, x, T_n))
        if v > T_ow:
            T_ow = v; grew = True
        v = _fill_dim(T_oh, layer.oh, lambda x: fits(x, T_ow, T_n))
        if v > T_oh:
            T_oh = v; grew = True
        v = _fill_dim(T_n, layer.n, lambda x: fits(T_oh, T_ow, x))
        if v > T_n:
            T_n = v; grew = True

    t = ConvTiling(T_oh=T_oh, T_ow=T_ow, T_n=T_n, T_kh=T_kh, T_kw=T_kw,
                   T_ic=T_ic, T_oc=T_oc,
                   t_ic=min(hw.J, T_ic), t_oc=min(hw.K, T_oc))
    if not conv_tile_fits(hw, layer, t):
        # Last-resort fallback: unit tiles along everything but ic/oc lanes.
        t = ConvTiling(1, 1, 1, 1, 1, min(hw.J, layer.ic), min(hw.K, layer.oc),
                       t_ic=min(hw.J, layer.ic), t_oc=min(hw.K, layer.oc))
    return t


def conv_tilings_for_triples(hw: HardwareSpec,
                             size_triples: Sequence[Tuple[int, int, int]],
                             layer: ConvLayer) -> List[ConvTiling]:
    """Cache-aware batch accessor: derive only the triples not already
    memoized — in one vectorized pass — seed the cache, and return the
    tilings for all triples in order.  For callers that want the
    ``ConvTiling`` objects themselves (the table build goes through the
    lighter struct-of-arrays kernel via ``dse.batch_build_conv_tables``
    and never materializes them)."""
    base = _conv_hw_key(hw)
    lk = _conv_layer_key(layer)
    keys = [((int(t[0]), int(t[1]), int(t[2])) + base[3:], lk)
            for t in size_triples]
    miss = [i for i, k in enumerate(keys) if k not in _CONV_TILING_CACHE]
    if miss:
        derived = derive_conv_tilings_batch(
            hw, [size_triples[i] for i in miss], layer)
        for i, t in zip(miss, derived):
            _CONV_TILING_CACHE[keys[i]] = t
    return [_CONV_TILING_CACHE[k] for k in keys]


def prefill_conv_tilings(hw: HardwareSpec,
                         size_triples: Sequence[Tuple[int, int, int]],
                         layers: Sequence[ConvLayer]) -> None:
    """Batch-fill the conv tiling cache for every (size triple x unique
    layer shape) pair not already present (byte triples, like
    ``conv_tilings_for_triples``)."""
    seen = set()
    for layer in layers:
        lk = _conv_layer_key(layer)
        if lk in seen:
            continue
        seen.add(lk)
        conv_tilings_for_triples(hw, size_triples, layer)


# ---------------------------------------------------------------------------
# GEMM tiling
#
# M/N/K blocking of out[m, n] = in[m, k] @ w[k, n] against the same three
# double-buffered SRAMs: the (T_k, T_n) weight block lives in WBuf, the
# (T_m, T_k) input block in IBuf, the (T_m, T_n) psum block in OBuf.  The
# greedy is the exact specialization of the conv walk under the
# fc-equivalence (a GEMM m x n x k prices like ``fc(n=m, ic=k, oc=n)``:
# unit kernel window, unit spatial extents, batch = m) — the kernel-shrink
# phase vanishes, the T_ic/T_oc phases become T_k/T_n, and the three
# spatial growth dims collapse onto the single streamed dim m.  The
# fc-equivalence is pinned bit-identical in tests/test_gemm.py.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GemmTiling:
    """Outer blocks (T_m, T_k, T_n) + inner systolic tiles (t_k, t_n)."""
    T_m: int; T_k: int; T_n: int
    t_k: int; t_n: int

    def weight_tile_elems(self) -> int:
        return self.T_k * self.T_n

    def input_tile_elems(self) -> int:
        return self.T_m * self.T_k

    def psum_tile_elems(self) -> int:
        return self.T_m * self.T_n


def gemm_tile_fits(hw: HardwareSpec, layer: GemmLayer, t: GemmTiling) -> bool:
    """Validity: every outer block fits its (half, double-buffered) SRAM."""
    if t.weight_tile_elems() * hw.b_w // 8 > hw.wbuf // 2:
        return False
    if t.input_tile_elems() * hw.b_i // 8 > hw.ibuf // 2:
        return False
    if t.psum_tile_elems() * hw.b_p // 8 > hw.obuf // 2:
        return False
    if layer.has_bias and t.T_n * hw.b_b // 8 > hw.bbuf // 2:
        return False
    for tv, dim in ((t.T_m, layer.m), (t.T_k, layer.k), (t.T_n, layer.n)):
        if not (1 <= tv <= dim):
            return False
    return True


def make_gemm_tiling(hw: HardwareSpec, layer: GemmLayer) -> GemmTiling:
    """Memoized scalar front-end: a one-candidate slice of the batched
    derivation below (single code path with the DSE grid fill)."""
    key = (_conv_hw_key(hw), _gemm_layer_key(layer))
    t = _GEMM_TILING_CACHE.get(key)
    if t is None:
        t = _GEMM_TILING_CACHE[key] = derive_gemm_tilings_batch(
            hw, [(hw.wbuf, hw.ibuf, hw.obuf)], layer)[0]
    return t


def derive_gemm_tilings_batch(hw: HardwareSpec,
                              size_triples: Sequence[Tuple[int, int, int]],
                              layer: GemmLayer) -> List[GemmTiling]:
    """Derive the greedy GEMM blocking for every (wbuf, ibuf, obuf) byte
    triple at once — the GEMM analogue of ``derive_conv_tilings_batch``,
    bit-identical per candidate to ``derive_gemm_tiling_reference``."""
    fields = _derive_gemm_tiling_arrays(hw, size_triples, layer)
    return [GemmTiling(*vals)
            for vals in zip(*(a.tolist() for a in fields))]


def _derive_gemm_tiling_arrays(hw: HardwareSpec,
                               size_triples: Sequence[Tuple[int, int, int]],
                               layer: GemmLayer) -> Tuple[np.ndarray, ...]:
    """The batched greedy kernel in struct-of-arrays form
    ``(T_m, T_k, T_n, t_k, t_n)`` (int64, one lane per triple)."""
    tri = np.asarray([(t[0], t[1], t[2]) for t in size_triples],
                     dtype=np.int64).reshape(-1, 3)
    n = len(tri)
    wcap = tri[:, 0] // 2 * 8 // hw.b_w
    icap = tri[:, 1] // 2 * 8 // hw.b_i
    ocap = tri[:, 2] // 2 * 8 // hw.b_p
    k0 = min(hw.K, layer.n)

    # 1) maximize T_k (J-aligned) with minimal T_n, then grow T_n within
    #    WBuf — doubling plus the exact K-aligned remainder fill.
    v = wcap // k0
    T_k = np.where(v >= hw.J, np.maximum(hw.J, v // hw.J * hw.J), v)
    T_k = np.maximum(1, np.minimum(T_k, layer.k))

    def grow_n(T_n: np.ndarray) -> np.ndarray:
        while True:
            m = (T_n * 2 <= layer.n) & (T_k * T_n * 2 <= wcap)
            if not m.any():
                break
            T_n = np.where(m, T_n * 2, T_n)
        T_n = np.minimum(T_n, layer.n)
        cap_n = wcap // T_k
        fill = np.minimum(layer.n, np.maximum(k0, cap_n // k0 * k0))
        return np.where(cap_n >= layer.n, layer.n,
                        np.where(cap_n >= k0,
                                 np.maximum(T_n, fill), T_n))

    T_n = grow_n(np.full(n, k0, dtype=np.int64))

    # IBuf may bound T_k (a single m-row of the input block must fit);
    # freed WBuf capacity is re-offered to T_n, like the conv walk.
    while True:
        m = (T_k > 1) & (T_k > icap)
        if not m.any():
            break
        T_k = np.where(m, T_k // 2, T_k)
    T_n = grow_n(T_n)

    # 2) stream dim growth under IBuf and OBuf: doubling, then the exact
    #    padding-aware remainder fill (the capacity bound inverts in
    #    closed form, so no bisection is needed).
    T_m = np.ones(n, dtype=np.int64)

    def hi_m():
        return np.minimum(layer.m,
                          np.minimum(icap // T_k, ocap // T_n))

    while True:
        cand = np.minimum(T_m * 2, layer.m)
        m = (cand > T_m) & (cand <= hi_m())
        if not m.any():
            break
        T_m = np.where(m, cand, T_m)
    T_m = _fill_dim_batch(T_m, layer.m, hi=hi_m())

    t_k = np.minimum(hw.J, T_k)
    t_n = np.minimum(hw.K, T_n)

    # Validity (vector ``gemm_tile_fits``) with the unit-block fallback.
    ok = ((T_k * T_n * hw.b_w // 8 <= tri[:, 0] // 2)
          & (T_m * T_k * hw.b_i // 8 <= tri[:, 1] // 2)
          & (T_m * T_n * hw.b_p // 8 <= tri[:, 2] // 2))
    if layer.has_bias:
        ok &= T_n * hw.b_b // 8 <= hw.bbuf // 2
    for tv, dim in ((T_m, layer.m), (T_k, layer.k), (T_n, layer.n)):
        ok &= (1 <= tv) & (tv <= dim)
    fb_k = min(hw.J, layer.k)
    fb_n = min(hw.K, layer.n)
    T_m = np.where(ok, T_m, 1)
    T_k = np.where(ok, T_k, fb_k)
    T_n = np.where(ok, T_n, fb_n)
    t_k = np.where(ok, t_k, fb_k)
    t_n = np.where(ok, t_n, fb_n)

    return (T_m, T_k, T_n, t_k, t_n)


def derive_gemm_tiling_reference(hw: HardwareSpec,
                                 layer: GemmLayer) -> GemmTiling:
    """The scalar greedy walk, retained as the independently written
    reference the batched kernel is pinned against."""
    wcap = hw.wbuf // 2 * 8 // hw.b_w
    icap = hw.ibuf // 2 * 8 // hw.b_i
    ocap = hw.obuf // 2 * 8 // hw.b_p
    k0 = min(hw.K, layer.n)

    T_k = min(layer.k, _align_down(wcap // k0, hw.J))
    T_k = max(1, min(T_k, layer.k))

    def grow_n(T_n: int) -> int:
        while T_n * 2 <= layer.n and T_k * T_n * 2 <= wcap:
            T_n *= 2
        T_n = min(T_n, layer.n)
        cap_n = wcap // T_k
        if cap_n >= layer.n:
            return layer.n
        if cap_n >= k0:
            return max(T_n, min(layer.n, _align_down(cap_n, k0)))
        return T_n

    T_n = grow_n(k0)
    while T_k > 1 and T_k > icap:
        T_k = max(1, T_k // 2)
    T_n = grow_n(T_n)

    T_m = 1

    def fits(m: int) -> bool:
        return m * T_k <= icap and m * T_n <= ocap

    while T_m < layer.m and fits(min(T_m * 2, layer.m)):
        T_m = min(T_m * 2, layer.m)
    T_m = _fill_dim(T_m, layer.m, fits)

    t = GemmTiling(T_m=T_m, T_k=T_k, T_n=T_n,
                   t_k=min(hw.J, T_k), t_n=min(hw.K, T_n))
    if not gemm_tile_fits(hw, layer, t):
        fb_k, fb_n = min(hw.J, layer.k), min(hw.K, layer.n)
        t = GemmTiling(1, fb_k, fb_n, t_k=fb_k, t_n=fb_n)
    return t


def gemm_tilings_for_triples(hw: HardwareSpec,
                             size_triples: Sequence[Tuple[int, int, int]],
                             layer: GemmLayer) -> List[GemmTiling]:
    """Cache-aware batch accessor (the GEMM twin of
    ``conv_tilings_for_triples``)."""
    base = _conv_hw_key(hw)
    lk = _gemm_layer_key(layer)
    keys = [((int(t[0]), int(t[1]), int(t[2])) + base[3:], lk)
            for t in size_triples]
    miss = [i for i, k in enumerate(keys) if k not in _GEMM_TILING_CACHE]
    if miss:
        derived = derive_gemm_tilings_batch(
            hw, [size_triples[i] for i in miss], layer)
        for i, t in zip(miss, derived):
            _GEMM_TILING_CACHE[keys[i]] = t
    return [_GEMM_TILING_CACHE[k] for k in keys]


# ---------------------------------------------------------------------------
# SIMD tiling
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SimdTiling:
    T_h: int; T_w: int; T_n: int; T_c: int
    t_c: int


def simd_tile_bytes(hw: HardwareSpec, layer: SimdLayer, t: "SimdTiling") -> int:
    """VMem bytes needed by the *largest* part's resident tiles."""
    worst = 0
    v4 = t.T_h * t.T_w * t.T_n * t.T_c
    for part in layer.parts:
        tot = 0
        for ref in part.tensors:
            if ref.rank == "4d":
                tot += int(math.ceil(v4 * ref.scale)) * hw.b_in // 8
            else:
                tot += t.T_c * hw.b_in // 8
        worst = max(worst, tot)
    return worst


def simd_tile_fits(hw: HardwareSpec, layer: SimdLayer, t: "SimdTiling") -> bool:
    if not (1 <= t.T_h <= layer.h and 1 <= t.T_w <= layer.w
            and 1 <= t.T_n <= layer.n and 1 <= t.T_c <= layer.c):
        return False
    return simd_tile_bytes(hw, layer, t) <= hw.vmem   # single-buffered: full VMem


def make_simd_tiling(hw: HardwareSpec, layer: SimdLayer) -> SimdTiling:
    """Memoized scalar front-end: a one-candidate slice of the batched
    derivation below (single code path with the DSE grid fill)."""
    key = (_simd_hw_key(hw), _simd_layer_key(layer))
    t = _SIMD_TILING_CACHE.get(key)
    if t is None:
        t = _SIMD_TILING_CACHE[key] = _derive_simd_tiling(hw, layer)
    return t


def _derive_simd_tiling(hw: HardwareSpec, layer: SimdLayer) -> SimdTiling:
    return derive_simd_tilings_batch(hw, [hw.vmem], layer)[0]


def derive_simd_tilings_batch(hw: HardwareSpec, vmems: Sequence[int],
                              layer: SimdLayer) -> List[SimdTiling]:
    """Derive the greedy SIMD tiling for every VMem byte size at once —
    the non-Conv analogue of ``derive_conv_tilings_batch``, bit-identical
    per candidate to ``derive_simd_tiling_reference``."""
    vm = np.asarray(list(vmems), dtype=np.int64)
    n = len(vm)
    parts = [([ref.scale for ref in part.tensors if ref.rank == "4d"],
              sum(1 for ref in part.tensors if ref.rank != "4d"))
             for part in layer.parts]

    def fits(T_h, T_w, T_n, T_c):
        v4 = (T_h * T_w * T_n * T_c).astype(np.float64)
        worst = np.zeros(n, dtype=np.int64)
        for scales, n_1d in parts:
            tot = np.zeros(n, dtype=np.int64)
            for sc in scales:
                tot = tot + np.ceil(v4 * sc).astype(np.int64) * hw.b_in // 8
            if n_1d:
                tot = tot + n_1d * (T_c * hw.b_in // 8)
            worst = np.maximum(worst, tot)
        return worst <= vm

    one = np.ones(n, dtype=np.int64)
    c0 = min(layer.c, max(hw.K, _align_down(layer.c, hw.K)))
    T_c = np.full(n, c0, dtype=np.int64)
    while True:
        m = ~fits(one, one, one, T_c) & (T_c > 1)
        if not m.any():
            break
        T_c = np.where(m, np.maximum(1, T_c // 2), T_c)

    # exact channel fill: the halving above lands on a power-of-two
    # fraction of the K-aligned start; non-power-of-two VMem sizes admit
    # a larger tile in between.
    T_c = _fill_dim_batch(T_c, layer.c, lambda x: fits(one, one, one, x))

    T_h = one.copy()
    T_w = one.copy()
    T_n = one.copy()
    while True:
        grew = np.zeros(n, dtype=bool)
        cand = np.minimum(T_w * 2, layer.w)
        m = (T_w < layer.w) & fits(T_h, cand, T_n, T_c)
        T_w = np.where(m, cand, T_w)
        grew |= m
        cand = np.minimum(T_h * 2, layer.h)
        m = (T_h < layer.h) & fits(cand, T_w, T_n, T_c)
        T_h = np.where(m, cand, T_h)
        grew |= m
        cand = np.minimum(T_n * 2, layer.n)
        m = (T_n < layer.n) & fits(T_h, T_w, cand, T_c)
        T_n = np.where(m, cand, T_n)
        grew |= m
        if not grew.any():
            break

    # remainder fill on the spatial/batch dims, mirroring the conv path.
    while True:
        grew = np.zeros(n, dtype=bool)
        v = _fill_dim_batch(T_w, layer.w, lambda x: fits(T_h, x, T_n, T_c))
        grew |= v > T_w
        T_w = v
        v = _fill_dim_batch(T_h, layer.h, lambda x: fits(x, T_w, T_n, T_c))
        grew |= v > T_h
        T_h = v
        v = _fill_dim_batch(T_n, layer.n, lambda x: fits(T_h, T_w, x, T_c))
        grew |= v > T_n
        T_n = v
        if not grew.any():
            break

    return [SimdTiling(T_h=h, T_w=w, T_n=nn, T_c=c, t_c=min(hw.K, c))
            for h, w, nn, c in zip(T_h.tolist(), T_w.tolist(),
                                   T_n.tolist(), T_c.tolist())]


def derive_simd_tiling_reference(hw: HardwareSpec,
                                 layer: SimdLayer) -> SimdTiling:
    """The original scalar greedy walk (reference twin of
    ``derive_conv_tiling_reference``)."""
    T_c = min(layer.c, max(hw.K, _align_down(layer.c, hw.K)))
    t = SimdTiling(1, 1, 1, T_c, t_c=min(hw.K, T_c))
    while not simd_tile_fits(hw, layer, t) and t.T_c > 1:
        t = SimdTiling(1, 1, 1, max(1, t.T_c // 2), t_c=min(hw.K, max(1, t.T_c // 2)))

    def with_dims(h: int, w: int, n: int, c: int) -> SimdTiling:
        return SimdTiling(T_h=h, T_w=w, T_n=n, T_c=c, t_c=min(hw.K, c))

    # exact channel fill: the halving loop above lands on a power-of-two
    # fraction of the K-aligned start; any capacity between two such
    # fractions (non-power-of-two VMem sizes) admits a larger tile.
    if t.T_c < layer.c:
        c = _fill_dim(t.T_c, layer.c,
                      lambda x: simd_tile_fits(hw, layer, with_dims(
                          t.T_h, t.T_w, t.T_n, x)))
        t = with_dims(t.T_h, t.T_w, t.T_n, c)

    grew = True
    while grew:
        grew = False
        for dim in ("w", "h", "n"):
            cand = SimdTiling(
                T_h=min(t.T_h * 2, layer.h) if dim == "h" else t.T_h,
                T_w=min(t.T_w * 2, layer.w) if dim == "w" else t.T_w,
                T_n=min(t.T_n * 2, layer.n) if dim == "n" else t.T_n,
                T_c=t.T_c, t_c=t.t_c)
            if cand != t and simd_tile_fits(hw, layer, cand):
                t = cand; grew = True

    # remainder fill on the spatial/batch dims, mirroring the conv path.
    grew = True
    while grew:
        grew = False
        for dim in ("w", "h", "n"):
            cur = getattr(t, f"T_{dim}")
            limit = getattr(layer, dim)
            if cur >= limit:
                continue
            v = _fill_dim(cur, limit,
                          lambda x: simd_tile_fits(hw, layer, with_dims(
                              x if dim == "h" else t.T_h,
                              x if dim == "w" else t.T_w,
                              x if dim == "n" else t.T_n, t.T_c)))
            if v > cur:
                t = with_dims(v if dim == "h" else t.T_h,
                              v if dim == "w" else t.T_w,
                              v if dim == "n" else t.T_n, t.T_c)
                grew = True
    return t


def simd_tilings_for_vmems(hw: HardwareSpec, vmems: Sequence[int],
                           layer: SimdLayer) -> List[SimdTiling]:
    """Cache-aware batch accessor over VMem byte sizes (the SIMD twin of
    ``conv_tilings_for_triples``)."""
    base = _simd_hw_key(hw)
    lk = _simd_layer_key(layer)
    keys = [((int(v),) + base[1:], lk) for v in vmems]
    miss = [i for i, k in enumerate(keys) if k not in _SIMD_TILING_CACHE]
    if miss:
        derived = derive_simd_tilings_batch(
            hw, [vmems[i] for i in miss], layer)
        for i, t in zip(miss, derived):
            _SIMD_TILING_CACHE[keys[i]] = t
    return [_SIMD_TILING_CACHE[k] for k in keys]


def prefill_simd_tilings(hw: HardwareSpec, vmems: Sequence[int],
                         layers: Sequence[SimdLayer]) -> None:
    """Batch-fill the SIMD tiling cache for every (vmem x unique layer
    shape) pair not already present (byte sizes)."""
    seen = set()
    for layer in layers:
        lk = _simd_layer_key(layer)
        if lk in seen:
            continue
        seen.add(lk)
        simd_tilings_for_vmems(hw, vmems, layer)
