"""SimDIT's GEMM tile model instantiated for one NVIDIA H100 (SXM).

The counterpart of the GEMM half of the JAX package's TPU model
(``select_matmul_block`` and its cost, written there for the v5e's VMEM
and MXU): the paper's tile-based DRAM-access and stall model (Secs.
IV-B..D) applied to the loop nest of ``C[m,n] = A[m,k] @ B[k,n]``, here
used to pick the tile, the route and the K split of the port's GEMM
kernel (``repro_torch/kernels/csrc/matmul.cu``).

What changes for the card:

* the on-chip buffer is a thread block's shared memory (232,448 bytes)
  instead of VMEM, and an SM's 233,472 bytes hold as many blocks as fit
  (``resident_blocks``);
* the 132 streaming multiprocessors run blocks in parallel: the model
  counts the blocks of the busiest SM and how many of them run at once;
* a GEMM whose output tiles cannot fill the SMs may split K into
  ``splits`` ranges, one more grid dimension; each block then writes a
  float32 partial tile and a second kernel sums them in split order;
* two routes (``matmul_route``): ``wgmma`` (bf16 only; TMA loads into a
  4-stage ring, ``wgmma`` products) for the tiles of ``WGMMA_TILES`` when
  TMA can read both operands, and ``mma`` for everything else: WMMA for
  bf16, single-buffered; for f32 CUDA-core FMAs on the tiles of
  ``F32_TILES``, fed by a ring of ``f32_stages`` stages that TMA fills
  where ``f32_tma_ok``, else ``cp.async``;
* peak rates: 989 TFLOP/s for bf16 on the tensor cores, 67 TFLOP/s for
  f32 on the CUDA cores (the f32 route uses no TF32).

The same constants give the roofline of a whole step
(``RooflineTerms``, ``model_flops``: the counterparts of the TPU
model's), which the dry run (``launch/dryrun.py``) reports per cell.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# ---- H100 SXM constants (NVIDIA data sheet; dense rates at 700 W) --------
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, CUDA cores, no TF32
HBM_BW = 3.35e12                  # bytes/s
SM_COUNT = 132
SMEM_BYTES = 232_448              # shared memory one block can use
SMEM_PER_SM = 233_472             # shared memory of one SM (228 KB)
REGS_PER_SM = 65_536
THREADS_PER_SM = 2_048
# NVLink 4 between the cards of one node: 18 links x 25 GB/s a direction,
# 450 GB/s a card a direction (NVIDIA H100 SXM data sheet: 900 GB/s both
# ways).  A mesh that spans nodes is bounded lower, by each card's NIC
# (InfiniBand NDR: 50 GB/s a direction); ``RooflineTerms`` does not split
# that case.
NVLINK_BW = 450e9                 # bytes/s a card, one direction

# The (bm, bn, bk) tiles matmul.cu compiles its `mma` route for, f32 and
# bf16 alike: the tiles the JAX package's kernel tests name (64^3, and bm
# 32/64/128 x bn 64 x bk 32/128), 128 x 128 x 32, and the three `wgmma`
# tiles, so that an explicit tile runs on either route.
# ``tests/test_torch_matmul.py`` holds both lists equal to the source's.
MATMUL_TILES: Tuple[Tuple[int, int, int], ...] = (
    (32, 64, 32), (32, 64, 128), (64, 64, 32), (64, 64, 64), (64, 64, 128),
    (128, 64, 32), (128, 64, 128), (128, 128, 32), (128, 64, 64),
    (128, 128, 64), (128, 256, 64))
# The tiles of the `wgmma` route (bf16): two consumer warpgroups of 64
# rows each, bk 64 (one 128-byte swizzle row of bf16).
WGMMA_TILES: Tuple[Tuple[int, int, int], ...] = (
    (128, 64, 64), (128, 128, 64), (128, 256, 64))

# The tiles of the f32 kernel (``mm_f32``): every `mma` tile, so that an
# explicit tile runs in either type, and its own 128 x 256 x 32 (8 x 16
# outputs a thread, four stages).
F32_TILES: Tuple[Tuple[int, int, int], ...] = MATMUL_TILES + (
    (128, 256, 32),)

# Kernel facts the model counts with (matmul.cu):
WGMMA_STAGES = 4                  # TMA ring depth
WGMMA_THREADS = 288               # two consumer warpgroups + a producer warp
MMA_THREADS = 256
# Registers a thread: every route holds bm * bn / 256 float32
# accumulators a thread, and about 32 more registers besides (ptxas reads
# 58, 90 and 154 for the three `wgmma` tiles).
EXTRA_REGS = 32
# The f32 kernel's ring: as many stages (2 to F32_MAX_STAGES) as fit
# beside the transposed A rows and 128 bytes of alignment slack in
# F32_SMEM_BUDGET bytes, half of a block's shared memory, for a tile with
# up to 8 x 8 outputs a thread, bounded to 128 registers so that two
# blocks share an SM (``__launch_bounds__(256, 2)``); in twice that for a
# larger one.
F32_MAX_STAGES = 4
F32_SMEM_BUDGET = 116_224
F32_KC = 32                       # k rows of A transposed at a time
F32_TWO_BLOCK_OUTPUTS = 64
MAX_SPLITS = 256
# the split-K reduction is a second launch; a fixed cost assumed for it
REDUCE_LAUNCH_S = 4e-6


@dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline for one step on ``chips`` cards:
        compute    = FLOPs            / (chips * 989e12 FLOP/s, bf16)
        memory     = HBM bytes        / (chips * 3.35e12 B/s)
        collective = collective bytes / (chips * 450e9 B/s, NVLink 4)
    The bf16 peak stands for every cell, float32 ones too, as the TPU
    model's does.  ``collective_bytes`` None (the port has no partitioned
    program to read them from, ``launch/dryrun.py``) leaves the
    collective term out: ``t_collective`` is None and the bound and step
    time are taken over compute and memory alone."""
    flops: float
    hbm_bytes: float
    collective_bytes: Optional[float]
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / (self.chips * NVLINK_BW)

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.t_collective is not None:
            terms["collective"] = self.t_collective
        return terms

    @property
    def bound(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Paper-style segment time: max over the parallel engines (Eq.
        18 generalized to compute, HBM and the interconnect)."""
        return max(self._terms().values())

    @property
    def roofline_fraction(self) -> float:
        """``t_compute / step_time``: the share of the dominant
        resource's time that is useful compute."""
        st = self.step_time
        return self.t_compute / st if st > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bound": self.bound,
            "step_time_s": self.step_time,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(n_active_params: int, tokens: int, training: bool) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for a forward/serve step."""
    return (6.0 if training else 2.0) * n_active_params * tokens


@dataclass(frozen=True)
class MatmulBlock:
    bm: int
    bn: int
    bk: int
    splits: int                # K ranges, one grid dimension (1: no split)
    route: str                 # "wgmma" or "mma"
    est_s: float               # model-estimated time of the GEMM (Eq. 18)
    hbm_bytes: float           # model-estimated device-memory traffic


def smem_bytes(bm: int, bn: int, bk: int, bytes_in: int) -> int:
    """Shared memory of one A and one B tile (Eq. 1's inner tiles; the
    kernel holds ``kernel_smem`` of them with padding and staging)."""
    return (bm * bk + bk * bn) * bytes_in


def f32_stage_floats(bm: int, bn: int, bk: int) -> int:
    """Floats of one stage of the f32 kernel's ring: A as [bm][bk], B as
    [bk][bn] (``F32Tile::STAGE``)."""
    return bm * bk + bk * bn


def f32_two_blocks(bm: int, bn: int) -> bool:
    """Whether the f32 kernel asks for two blocks an SM at this tile
    (``F32Tile::MIN_BLOCKS``): up to 8 x 8 outputs a thread."""
    return (bm // 16) * (bn // 16) <= F32_TWO_BLOCK_OUTPUTS


def f32_stages(bm: int, bn: int, bk: int) -> int:
    """The f32 kernel's ring depth for a tile (``F32Tile::STAGES``): what
    fits beside the transposed A rows, [F32_KC][bm], and the slack."""
    budget = F32_SMEM_BUDGET * (1 if f32_two_blocks(bm, bn) else 2)
    fit = (budget - 4 * F32_KC * bm - 128) // (
        4 * f32_stage_floats(bm, bn, bk))
    return max(2, min(F32_MAX_STAGES, fit))


def f32_regs(bm: int, bn: int, tma: bool = True) -> int:
    """Registers a thread of the f32 kernel: its (bm/16) x (bn/16)
    accumulators, the A and B values of two k steps (one in use, one
    loaded ahead) and ``EXTRA_REGS``; at most 128 where two blocks an SM
    are asked for (``F32Tile::MIN_BLOCKS``, on the TMA path only)."""
    tm, tn = bm // 16, bn // 16
    cap = 128 if tma and f32_two_blocks(bm, bn) else 255
    return min(cap, tm * tn + 2 * (tm + tn) + EXTRA_REGS)


def f32_fma_share(bm: int, bn: int) -> float:
    """The share of the CUDA cores' peak the f32 kernel's products can
    reach at a tile, from a k step of one warp on each of an SM's four
    schedulers: each issues tm tn FMAs and tm / va + tn / 4 shared loads
    (va = min(tm, 4) floats of A, 4 of B), one instruction a cycle; the
    SM's shared memory delivers 128 bytes a cycle and a warp's load
    fills all 32 lanes, so the four take 4 (tm + tn) cycles of it.  The
    longer of the two bounds the step (8 x 8 outputs: 0.94; 8 x 4: 0.67;
    8 x 16: 0.96)."""
    tm, tn = bm // 16, bn // 16
    issue = tm * tn + tm // min(tm, 4) + tn // 4
    return tm * tn / max(issue, 4 * (tm + tn))


def f32_vector_copies(n: int, k: int, a_ptr: int = 0,
                      b_ptr: int = 0) -> Tuple[bool, bool]:
    """Whether A (m, k) and B (k, n) can be read 16 bytes at a time
    (``launch_f32``): a row a multiple of 4 floats and a 16-byte aligned
    base."""
    return (k % 4 == 0 and a_ptr % 16 == 0, n % 4 == 0 and b_ptr % 16 == 0)


def f32_tma_ok(n: int, k: int, a_ptr: int = 0, b_ptr: int = 0) -> bool:
    """Whether the f32 kernel fills its ring by TMA (both operands read
    16 bytes at a time); else by cp.async, 16 bytes a copy for the
    operand that allows it and one float for the other."""
    return all(f32_vector_copies(n, k, a_ptr, b_ptr))


def kernel_smem(route: str, bm: int, bn: int, bk: int,
                bytes_in: int) -> int:
    """Dynamic shared memory one block of the kernel asks for, as
    matmul.cu computes it."""
    if route == "wgmma":
        # the ring, plus 1024 bytes to align it for the 128-byte swizzle
        return WGMMA_STAGES * smem_bytes(bm, bn, bk, 2) + 1024
    if bytes_in == 2:    # padded A and B tiles, a 16 x 16 f32 buffer a warp
        return 2 * (bm * (bk + 8) + bk * (bn + 8)) + 4 * 8 * 256
    return 4 * (f32_stages(bm, bn, bk) * f32_stage_floats(bm, bn, bk)
                + F32_KC * bm) + 128


def resident_blocks(route: str, bm: int, bn: int, bk: int,
                    bytes_in: int, tma: bool = True) -> int:
    """Blocks of this kernel one SM holds at once: the least of what its
    shared memory, its threads and its registers allow (``tma``: the f32
    kernel's ring is filled by TMA, ``f32_tma_ok``)."""
    threads = WGMMA_THREADS if route == "wgmma" else MMA_THREADS
    if route == "mma" and bytes_in == 4:
        regs = f32_regs(bm, bn, tma)
    else:
        regs = min(255, bm * bn // 256 + EXTRA_REGS)
    return max(0, min(SMEM_PER_SM // kernel_smem(route, bm, bn, bk,
                                                 bytes_in),
                      THREADS_PER_SM // threads,
                      REGS_PER_SM // (threads * regs)))


def compiled_tiles(bytes_in: int) -> Tuple[Tuple[int, int, int], ...]:
    """The tiles matmul.cu compiles for this element size: ``F32_TILES``
    for float32, ``MATMUL_TILES`` for bf16."""
    return F32_TILES if bytes_in == 4 else MATMUL_TILES


def tma_ok(n: int, k: int, bytes_in: int, a_ptr: int = 0,
           b_ptr: int = 0) -> bool:
    """Whether TMA can read A (m, k) and B (k, n), both row-major: bf16,
    each row stride a multiple of 16 bytes and each base 16-byte
    aligned."""
    return (bytes_in == 2 and k % 8 == 0 and n % 8 == 0
            and a_ptr % 16 == 0 and b_ptr % 16 == 0)


def matmul_route(n: int, k: int, bytes_in: int, tile: Tuple[int, int, int],
                 a_ptr: int = 0, b_ptr: int = 0) -> str:
    """The route matmul.cu runs a GEMM on, from its shape, type, pointers
    and tile alone: ``wgmma`` for a ``WGMMA_TILES`` tile that TMA can
    feed, else ``mma``."""
    if tuple(tile) in WGMMA_TILES and tma_ok(n, k, bytes_in, a_ptr, b_ptr):
        return "wgmma"
    return "mma"


def split_bounds(k: int, bk: int, splits: int) -> List[Tuple[int, int]]:
    """``[k_lo, k_hi)`` of each split, as matmul.cu computes them: the
    ``ceil(k / bk)`` k tiles are dealt out evenly, split ``s`` taking
    tiles ``[s*kt//splits, (s+1)*kt//splits)``; so every bound but the
    last is a multiple of ``bk`` and no tile is read by two splits."""
    kt = -(-k // bk)
    return [(s * kt // splits * bk, min((s + 1) * kt // splits * bk, k))
            for s in range(splits)]


def matmul_cost(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                bytes_in: int = 2, bytes_out: int = 2,
                smem: int = SMEM_BYTES, splits: int = 1,
                route: Optional[str] = None, tma: Optional[bool] = None
                ) -> Optional[Tuple[float, float]]:
    """``(seconds, hbm_bytes)`` of ``C[m,n] = A[m,k] @ B[k,n]`` tiled
    ``(bm, bn, bk)`` with ``splits`` K ranges on ``route`` (by default
    the route an aligned operand pair gets; ``tma``: the f32 kernel's
    ring filled by TMA, by default where an aligned pair allows it), or
    None if the kernel's shared memory exceeds ``smem`` or a split would
    be empty.

      outer multipliers m_m = ceil(m/bm), m_n, m_k               (Eq. 1)
      B traffic: each B tile once per k step and output column    (Eq. 4)
      A traffic: each A tile for every (m, n, k) tile             (Eq. 7)
      C traffic: the psums stay in registers across a block's k
        range; with splits, each block writes a float32 partial
        tile and the reduction reads them all and writes C        (Eq. 9)
      per k step, one SM: the compute and the load of a tile at its
        share of the card, overlapped by the ring on `wgmma` and on
        f32 `mma` (its stages less one, times the resident blocks)
        and only across resident blocks on bf16 `mma`; f32 compute
        at ``f32_fma_share`` of the CUDA cores' peak; the busiest SM
        runs ceil(blocks / 132) blocks                            (Eq. 18)
    """
    if route is None:
        route = matmul_route(n, k, bytes_in, (bm, bn, bk))
    need = kernel_smem(route, bm, bn, bk, bytes_in)
    if tma is None:
        tma = f32_tma_ok(n, k)
    res = resident_blocks(route, bm, bn, bk, bytes_in, tma)
    m_m, m_n, m_k = -(-m // bm), -(-n // bn), -(-k // bk)
    if need > smem or res < 1 or splits > m_k:
        return None
    kt_split = -(-m_k // splits)
    a_bytes = bm * bk * bytes_in * m_m * m_k * m_n
    b_bytes = bk * bn * bytes_in * m_k * m_n
    c_bytes = m * n * bytes_out
    part_bytes = 2 * splits * m * n * 4 if splits > 1 else 0
    hbm = a_bytes + b_bytes + c_bytes + part_bytes
    peak = PEAK_FLOPS_BF16 if bytes_in == 2 else PEAK_FLOPS_F32
    sm_bw = HBM_BW / SM_COUNT
    compute = 2.0 * bm * bn * bk / (peak / SM_COUNT)
    load = smem_bytes(bm, bn, bk, bytes_in) / sm_bw
    blocks = m_m * m_n * splits
    per_sm = -(-blocks // SM_COUNT)
    if route == "wgmma":
        stages = WGMMA_STAGES - 1
    elif bytes_in == 4:
        stages = f32_stages(bm, bn, bk) - 1
        compute /= f32_fma_share(bm, bn)
    else:
        stages = 1
    depth = stages * min(res, per_sm)
    step = max(compute, load, (compute + load) / depth)
    store = bm * bn * (4 if splits > 1 else bytes_out) / sm_bw
    est = per_sm * (kt_split * step + store)
    if splits > 1:
        est += (splits * m * n * 4 + c_bytes) / HBM_BW + REDUCE_LAUNCH_S
    return est, float(hbm)


@functools.lru_cache(maxsize=4096)
def select_matmul_block(m: int, n: int, k: int, bytes_in: int = 2,
                        bytes_out: int = 2, smem: int = SMEM_BYTES,
                        aligned: bool = True,
                        tile: Optional[Tuple[int, int, int]] = None
                        ) -> MatmulBlock:
    """The tile, route and split count the model finds fastest for this
    GEMM (ties go to less traffic, then to the earlier tile and fewer
    splits).  ``aligned``: both operands' bases are 16-byte aligned.  The
    candidates are the ``WGMMA_TILES`` where TMA can feed the GEMM (every
    such GEMM runs on `wgmma`), else ``compiled_tiles(bytes_in)``;
    ``tile`` fixes the tile and leaves the split count to the model."""
    if min(m, n, k) <= 0:
        raise ValueError(f"no tile for a degenerate GEMM ({m}, {n}, {k})")
    tma = tma_ok(n, k, bytes_in) and aligned
    if tile is not None:
        tiles = (tuple(tile),)
    else:
        tiles = WGMMA_TILES if tma else compiled_tiles(bytes_in)
    f32_tma = aligned and f32_tma_ok(n, k)
    best: Optional[MatmulBlock] = None
    for bm, bn, bk in tiles:
        route = "wgmma" if tma and (bm, bn, bk) in WGMMA_TILES else "mma"
        for splits in range(1, min(-(-k // bk), MAX_SPLITS) + 1):
            res = matmul_cost(m, n, k, bm, bn, bk, bytes_in, bytes_out,
                              smem, splits, route, f32_tma)
            if res is None:
                continue
            est, hbm = res
            if best is None or est < best.est_s or (
                    est == best.est_s and hbm < best.hbm_bytes):
                best = MatmulBlock(bm, bn, bk, splits, route, est, hbm)
    if best is None:
        raise ValueError(f"no compiled tile fits {smem} bytes of shared "
                         f"memory at {bytes_in} bytes an element")
    return best


# ---- batch norm (bn_forward.cu, bn_backward.cu) --------------------------
# One persistent launch a call: one block of BN_THREADS threads an SM, all
# resident at once (a cooperative launch), each keeping up to
# BN_SMEM_BUDGET bytes of its rows on chip between the reduction and the
# elementwise pass.
BN_THREADS = 512
BN_BLOCKS_PER_SM = 1
BN_SMEM_BUDGET = 200 * 1024


@dataclass(frozen=True)
class BnLayout:
    route: str                 # "vector" (16-byte accesses) or "scalar"
    vec: int                   # elements a thread loads at once
    threads: int               # threads a block
    row_groups: int            # blocks along rows
    channel_groups: int        # blocks along channels
    group_c: int               # channels of a group (a multiple of vec)
    lanes: int                 # rows a block reads at once
    rows: int                  # rows of the longest row group
    rows_kept: int             # rows a block keeps in shared memory
    rows_streamed: int         # rows of the longest group read twice
    smem: int                  # dynamic shared memory a block

    @property
    def blocks(self) -> int:
        return self.row_groups * self.channel_groups

    def row_bounds(self, n: int) -> List[Tuple[int, int]]:
        """``[r0, r1)`` of each row group, as the kernels compute them:
        ``n * g // row_groups``, so group sizes differ by at most one."""
        g = self.row_groups
        return [(n * i // g, n * (i + 1) // g) for i in range(g)]


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def bn_smem(group_c: int, lanes: int, rows_kept: int, bytes_per_el: int,
            tensors: int) -> int:
    """Dynamic shared memory of a BN block, as the kernels lay it out: a
    tile of ``rows_kept`` rows of ``group_c`` channels for each tensor
    kept on chip, then the per-lane sums of the reduction (two float32
    values a lane and channel)."""
    tile = _round16(rows_kept * group_c * bytes_per_el)
    return tensors * tile + 2 * 4 * lanes * group_c


def bn_layout(n: int, c: int, bytes_per_el: int, tensors: int,
              aligned: bool = True) -> BnLayout:
    """How ``bn_forward.cu`` (``tensors`` 1: x) and ``bn_backward.cu``
    (``tensors`` 2: x and dy) lay out an (n, c) call on the card, from
    the shape and the module's constants alone.

    * route: 16-byte accesses (``vec`` 4 float32 or 8 bfloat16 values)
      when ``c`` is a multiple of ``vec`` and the tensors are 16-byte
      aligned, else one element a thread ("scalar");
    * channel groups: as few as let one block's threads span a group's
      row (``group_c / vec`` threads along channels, ``lanes`` rows at
      once); the groups are of equal width, rounded up to ``vec``;
    * row groups: the blocks of one SM each (``BN_BLOCKS_PER_SM`` x
      ``SM_COUNT``) shared among the channel groups, but no more than
      ``n``; rows are dealt out evenly (``BnLayout.row_bounds``);
    * rows kept: as many of a group's rows as fit the shared-memory
      budget beside the reduction's buffers; the rest are read again."""
    if n < 1 or c < 1:
        raise ValueError(f"bn_layout: nothing to lay out in {(n, c)}")
    if bytes_per_el not in (2, 4) or tensors not in (1, 2):
        raise ValueError(f"bn_layout: {bytes_per_el} bytes an element, "
                         f"{tensors} tensors")
    width = 16 // bytes_per_el
    vec = width if aligned and c % width == 0 else 1
    groups = -(-c // (BN_THREADS * vec))
    group_c = -(-(-(-c // groups)) // vec) * vec
    groups = -(-c // group_c)
    lanes = BN_THREADS // (group_c // vec)
    row_groups = max(1, min(n, BN_BLOCKS_PER_SM * SM_COUNT // groups))
    rows = -(-n // row_groups)
    fixed = bn_smem(group_c, lanes, 0, bytes_per_el, tensors)
    row_bytes = group_c * bytes_per_el
    kept = min(rows, (BN_SMEM_BUDGET - fixed) // (tensors * row_bytes))
    while bn_smem(group_c, lanes, kept, bytes_per_el, tensors) \
            > BN_SMEM_BUDGET:     # a tile's rounding up to 16 bytes
        kept -= 1
    return BnLayout(
        route="vector" if vec > 1 else "scalar", vec=vec,
        threads=BN_THREADS, row_groups=row_groups, channel_groups=groups,
        group_c=group_c, lanes=lanes, rows=rows, rows_kept=kept,
        rows_streamed=rows - kept,
        smem=bn_smem(group_c, lanes, kept, bytes_per_el, tensors))
