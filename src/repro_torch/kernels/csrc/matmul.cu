// C[m,n] = A[m,k] @ B[k,n] with float32 accumulation; C takes A's type.
//
// Replaces the JAX package's Pallas GEMM `matmul_pallas`
// (src/repro/kernels/matmul.py:30), the MXU twin of the paper's Conv/FC-as-
// GEMM mapping (Sec. IV-B).  Row-major operands, as there.
//
// Bound on the H100: at the shapes the port drives (Qwen3-0.6B projections
// and LM head at 4096 tokens, ResNet-50's convolutions as GEMMs, forward
// and backward) the work is well above 295 FLOP a byte, so the tensor
// cores bound bf16 (989 TFLOP/s) and the CUDA cores bound f32 (67 TFLOP/s,
// no TF32).  What keeps a kernel from that bound is feeding the tensor
// cores (loads that overlap the products) and filling 132 SMs.
//
// Two routes, chosen by the caller from shape, type, pointers and tile
// (repro_torch/core/gpu_model.py::matmul_route); this file refuses a route
// that cannot take the GEMM:
// * `wgmma` (bf16; the tiles of WGMMA_TILES, 128 x bn x 64): one producer
//   warp keeps a 4-stage ring of shared-memory tiles full with TMA loads
//   (128-byte swizzle, mbarriers mark each stage full and empty); two
//   consumer warpgroups, 64 rows each, run wgmma.m64n{bn}k16 on the
//   stages with float32 accumulators in registers.  TMA zero-fills what
//   lies outside the matrix, so ragged m, n and k need no mask in the main
//   loop.  B is row-major (k, n), N-major for wgmma: read through the
//   descriptor's transpose bit, in 64-column boxes.  The epilogue rounds to
//   bf16 and stages the tile in shared memory so that each thread stores
//   16 bytes, masked at the ragged edge.  TMA needs 16-byte row strides
//   and bases, so K or N not a multiple of 8, or an offset view, take:
// * `mma`: one block of 256 threads for each (bm x bn) output tile.
//   bf16: the first kernel, kept: single-buffered A and B tiles in shared
//   memory, 16x16x16 WMMA (mma.sync) through a per-warp staging buffer;
//   the ragged edge masked in the loads and stores.
//   f32 (`mm_f32`, the tiles of F32_TILES; IEEE products, no TF32): a ring
//   of 2 to 4 shared-memory stages filled ahead of the CUDA cores, so that
//   the next tiles' loads are in flight while a tile is multiplied.  Where
//   both operands' rows are multiples of 4 floats and both bases 16-byte
//   aligned, one thread fills a stage with two TMA loads that complete the
//   stage's mbarrier (zero outside the matrix); else every thread issues
//   cp.async copies, 16 bytes for an operand that allows it and one float
//   for the other (K = 147, offset views), zero-filled past the matrix and
//   the split.  Either way the main loop has no mask.  A lands
//   k-contiguous, as in memory, and is transposed 32 k rows at a time into
//   a swizzled [32][bm] tile (16-byte loads and stores); B stays [bk][bn].
//   Each thread owns (bm/16) x (bn/16) outputs (8 x 16 at 128 x 256) and
//   reads, a k step, one 16-byte load of A per 4 rows and one of B per 4
//   columns: 6 shared loads for 128 FMAs at 8 x 16.  No access to shared
//   memory meets a bank conflict.  Each output keeps the first kernel's
//   sum order (increasing k, one fmaf a product, from 0), so its bits do
//   not depend on the tile.
// Split-K, both routes and types: where the output tiles cannot fill the
// SMs, grid dimension z cuts the ceil(k / bk) k tiles into `splits` even
// ranges (split s: tiles [s*kt/splits, (s+1)*kt/splits), so no tile is
// read twice).  Each block writes a float32 partial tile to the caller's
// workspace (splits, m, n); `splitk_sum` then adds the partials in split
// order and casts: no atomics, the same bits on every run.
// Offsets are 64-bit: the LM head's output at 4096 x 151936 has 622M
// elements.  The tensor maps are encoded here, from the pointers and
// sizes, with cuTensorMapEncodeTiled fetched by
// cudaGetDriverEntryPoint(ByVersion), so the library links no libcuda.
#include <cuda.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;

// Split s of the ceil(k / bk) k tiles: [k_lo, k_hi), bounds in elements.
// The Python mirror is gpu_model.split_bounds.
__device__ __forceinline__ void split_range(long long k, int bk, int splits,
                                            long long* k_lo,
                                            long long* k_hi) {
  const long long kt = (k + bk - 1) / bk, s = blockIdx.z;
  *k_lo = s * kt / splits * bk;
  *k_hi = min((s + 1) * kt / splits * bk, k);
}

// ---- mma route, f32: CUDA-core FMAs fed by a TMA or cp.async ring -------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers and TMA loads (the f32 ring and the `wgmma` route)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` of `bar` has completed.  No
// wait of these kernels lasts a second: one that outlasts about ten (2e10
// cycles) traps, so a fault in the pipeline ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  }
}

// TMA: the box at (c0, c1) (innermost first) of `map` into `dst`; its
// bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// cp.async of `bytes` (16, or 0: zero-fill) from global `src` to shared
// `dst`, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
// The same for one float (`bytes` 4 or 0).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring's depth: as many stages (2 to F32_MAX_STAGES) as fit beside the
// transposed A rows and 128 bytes of alignment slack in F32_SMEM_BUDGET
// bytes, half of a block's shared memory, where two blocks are to share an
// SM, else in twice that.  gpu_model.py mirrors these constants and
// formulas.
constexpr int F32_MAX_STAGES = 4;
constexpr int F32_SMEM_BUDGET = 116224;

// A block of 256 threads computes a (BM x BN) tile; its threads form a
// 16 x 16 grid (a warp: 4 ty by 8 tx), each TM x TN = (BM / 16) x (BN / 16)
// outputs: rows VA ty + 16 VA g + {0..VA-1} (VA = 4, or 2 at BM 32) and
// columns 4 tx + 64 j + {0..3}.  A ring stage holds A as it was loaded,
// [BM][BK] (k contiguous, as in memory), and B as [BK][BN]; before the
// products each KC k rows of a stage's A are transposed into `At`,
// [KC][BM], whose 16-byte chunks are swizzled (chunk q of k row kk at
// q ^ (kk / 4)), so that a thread reads its A values of a k step as one
// 16-byte load.
constexpr int KC = 32;

template <int BM, int BN, int BK>
struct F32Tile {
  static constexpr int TM = BM / 16, TN = BN / 16, VA = TM < 4 ? TM : 4;
  static constexpr int STAGE = BM * BK + BK * BN;            // floats
  static constexpr int AT = KC * BM;                         // floats
  // two blocks an SM (at most 128 registers a thread) up to 8 x 8 outputs
  // where TMA fills the ring; the cp.async path's address arithmetic
  // would spill there, so it is not bounded (one block an SM)
  static constexpr int MIN_BLOCKS = TM * TN <= 64 ? 2 : 1;
  static constexpr int BUDGET =
      MIN_BLOCKS == 2 ? F32_SMEM_BUDGET : 2 * F32_SMEM_BUDGET;
  static constexpr int FIT = (BUDGET - 4 * AT - 128) / (4 * STAGE);
  static constexpr int STAGES =
      FIT < 2 ? 2 : (FIT > F32_MAX_STAGES ? F32_MAX_STAGES : FIT);
  static constexpr size_t SMEM = sizeof(float) * (STAGES * STAGE + AT) + 128;
  static_assert(BM % 32 == 0 && BN % 64 == 0 && BK % 32 == 0,
                "f32 tile: bm a multiple of 32, bn of 64, bk of 32");
  static_assert((BM * BK / 4) % kThreads == 0 &&
                    (BK * BN / 4) % kThreads == 0,
                "f32 tile: whole 16-byte chunks for every thread");
};

// The cp.async path: issues the copies of k tile [k0, k0 + BK) into the
// stage at `As`, 16 bytes a copy where `vec_a` / `vec_b` (row length a
// multiple of 4, base 16-byte aligned), else one float a copy; whatever
// lies at or past row m, column n or k_hi (the split's end) is
// zero-filled.  Eight neighbouring threads fill 128 contiguous bytes of
// one row.
template <int BM, int BN, int BK>
__device__ __forceinline__ void f32_load_stage(
    float* As, const float* __restrict__ A, const float* __restrict__ B,
    long long m, long long n, long long k, long long k_hi, long long row0,
    long long col0, long long k0, bool vec_a, bool vec_b) {
  float* Bs = As + BM * BK;
  constexpr int CA = BK / 4, CB = BN / 4;
#pragma unroll
  for (int it = 0; it < BM * CA / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / CA, c = (e % CA) * 4;
    const long long gr = row0 + r, gc = k0 + c;
    float* d = As + r * BK + c;
    if (vec_a) {
      const bool in = gr < m && gc < k_hi;
      cp_async16(d, in ? A + gr * k + gc : A, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = gr < m && gc + i < k_hi;
        cp_async4(d + i, in ? A + gr * k + gc + i : A, in ? 4 : 0);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < BK * CB / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / CB, c = (e % CB) * 4;
    const long long gr = k0 + r, gc = col0 + c;
    float* d = Bs + r * BN + c;
    if (vec_b) {
      const bool in = gr < k_hi && gc < n;
      cp_async16(d, in ? B + gr * n + gc : B, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = gr < k_hi && gc + i < n;
        cp_async4(d + i, in ? B + gr * n + gc + i : B, in ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ float part_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// k rows [kc, kc + KC) of the stage's A, [BM][BK], into At, [KC][BM]
// swizzled: a thread takes 4 rows by 4 k values (four 16-byte loads, the
// neighbouring threads along k: one row's 128 bytes), and stores them as
// 4 k rows of 4 rows (four 16-byte stores, the 8 neighbours' chunks on 8
// bank groups by the swizzle).
template <int BM, int BK>
__device__ __forceinline__ void f32_transpose_a(float* __restrict__ At,
                                                const float* __restrict__ As,
                                                int kc) {
  constexpr int CK = KC / 4, BLOCKS = (BM / 4) * CK;
#pragma unroll
  for (int it = 0; it < (BLOCKS + kThreads - 1) / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e < BLOCKS) {
      const int b = e % CK, a = e / CK;
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const float4*>(As + (4 * a + j) * BK +
                                                kc + 4 * b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(At + (4 * b + i) * BM + 4 * (a ^ b)) =
            make_float4(part_of(v[0], i), part_of(v[1], i), part_of(v[2], i),
                        part_of(v[3], i));
    }
  }
}

// The A and B values of k step kk of At's KC rows: TM / VA loads of A and
// TN / 4 of B, each 16 bytes (8 at BM 32).
template <int BM, int BN>
__device__ __forceinline__ void f32_frag(float* a, float4* b,
                                         const float* At, const float* Bs,
                                         int kk, int tx, int ty) {
  constexpr int TM = BM / 16, TN = BN / 16, VA = TM < 4 ? TM : 4;
  const int f = kk / 4;
#pragma unroll
  for (int g = 0; g < TM / VA; ++g) {
    const float* p = At + kk * BM + 4 * (((VA * ty + 16 * VA * g) / 4) ^ f) +
                     (VA * ty) % 4;
    if constexpr (VA == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
      a[4 * g + 3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      a[2 * g] = v.x, a[2 * g + 1] = v.y;
    }
  }
#pragma unroll
  for (int j = 0; j < TN / 4; ++j)
    b[j] = *reinterpret_cast<const float4*>(Bs + kk * BN + 4 * tx + 64 * j);
}

// acc[r][c] += a[r] * b[c], one fmaf each.
template <int TM, int TN>
__device__ __forceinline__ void f32_fma(float (&acc)[TM][TN], const float* a,
                                        const float4* b) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      acc[r][4 * j] = fmaf(a[r], b[j].x, acc[r][4 * j]);
      acc[r][4 * j + 1] = fmaf(a[r], b[j].y, acc[r][4 * j + 1]);
      acc[r][4 * j + 2] = fmaf(a[r], b[j].z, acc[r][4 * j + 2]);
      acc[r][4 * j + 3] = fmaf(a[r], b[j].w, acc[r][4 * j + 3]);
    }
}

// ws == nullptr: C gets the sum; else ws[blockIdx.z] gets a float32 partial.
// Each output is one accumulator that takes one fmaf a product, in
// increasing k over the split's range, from 0: the first kernel's order, so
// the same bits for the same split bounds whatever the tile (and zero-filled
// products add +0 to a sum that is never -0).  kTma: thread 0 fills each
// stage with two TMA loads (`ta`, `tb`: A's and B's tensor maps, boxes of
// BK x BM and BN x BK, zero outside the matrix) whose bytes complete the
// stage's mbarrier; else every thread issues cp.async copies.
template <int BM, int BN, int BK, bool kTma>
__global__ void __launch_bounds__(kThreads,
                                  kTma ? F32Tile<BM, BN, BK>::MIN_BLOCKS : 1)
    mm_f32(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb,
           const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C, float* __restrict__ ws, long long m,
           long long n, long long k, int splits, bool vec_a, bool vec_b) {
  using T = F32Tile<BM, BN, BK>;
  constexpr int TM = T::TM, TN = T::TN, VA = T::VA, S = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S];
  // TMA writes 128-byte aligned boxes: align the ring (SMEM has the slack)
  float* ring = reinterpret_cast<float*>(
      smem + ((128 - (smem_u32(smem) & 127)) & 127));
  float* At = ring + S * T::STAGE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const long long col0 = static_cast<long long>(blockIdx.y) * BN;
  long long k_lo, k_hi;
  split_range(k, BK, splits, &k_lo, &k_hi);
  const int tiles = static_cast<int>((k_hi - k_lo + BK - 1) / BK);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // k tile t of the split into stage t % S
  auto issue = [&](int t) {
    float* st = ring + (t % S) * T::STAGE;
    const long long k0 = k_lo + static_cast<long long>(t) * BK;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[t % S], T::STAGE * 4);
        tma_load_2d(st, &ta, static_cast<int>(k0), static_cast<int>(row0),
                    &full[t % S]);
        tma_load_2d(st + BM * BK, &tb, static_cast<int>(col0),
                    static_cast<int>(k0), &full[t % S]);
      }
    } else {
      f32_load_stage<BM, BN, BK>(st, A, B, m, n, k, k_hi, row0, col0, k0,
                                 vec_a, vec_b);
    }
  };
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // S - 1 tiles in flight before the first product; on the cp.async path
  // one commit group a tile (empty past the last), so that wait_group
  // S - 2 means "tile i has landed"
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < tiles) issue(t);
    if constexpr (!kTma) cp_async_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    if constexpr (kTma)
      mbar_wait(&full[i % S], (i / S) & 1);
    else
      cp_async_wait<S - 2>();
    __syncthreads();    // tile i landed; every thread is past tile i - 1
    if (i + S - 1 < tiles) issue(i + S - 1);   // the stage tile i - 1 left
    if constexpr (!kTma) cp_async_commit();
    const float* As = ring + (i % S) * T::STAGE;
    const float* Bs = As + BM * BK;
#pragma unroll 1
    for (int kc = 0; kc < BK; kc += KC) {
      if (kc > 0) __syncthreads();    // every thread is past At's last rows
      f32_transpose_a<BM, BK>(At, As, kc);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[TM];
        float4 b[TN / 4];
        f32_frag<BM, BN>(a, b, At, Bs + kc * BN, kk, tx, ty);
        f32_fma<TM, TN>(acc, a, b);
      }
    }
  }

  float* out = ws == nullptr ? C : ws + blockIdx.z * m * n;
  const bool vec_c = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long gr = row0 + VA * ty + 16 * VA * (r / VA) + r % VA;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const long long gc = col0 + 4 * tx + 64 * j;
      float* o = out + gr * n + gc;
      if (vec_c && gc < n) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                        acc[r][4 * j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < n) o[e] = acc[r][4 * j + e];
      }
    }
  }
}

// ---- mma route, bf16: WMMA (mma.sync) with f32 accumulators ---------------
// Copies the (ROWS x COLS) tile at (r0, c0) of a row-major matrix with
// leading dimension `ld` into shared memory with leading dimension LD, zero
// at or past (rows, cols); 8 elements (16 bytes) a step, one vector load
// where `vec` allows.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile_bf16(
    bf16* __restrict__ dst, const bf16* __restrict__ src, long long rows,
    long long cols, long long ld, long long r0, long long c0, bool vec) {
  constexpr int CHUNKS = COLS / 8;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += kThreads) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const long long gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * LD + c;
    if (vec && gr < rows && gc + 8 <= cols) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + gr * ld + gc);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (gr < rows && gc + i < cols) ? src[gr * ld + gc + i] : zero;
    }
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    mm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
            bf16* __restrict__ C, float* __restrict__ ws, long long m,
            long long n, long long k, int splits, bool vec_a, bool vec_b) {
  constexpr int WM = 2, WN = 4;                  // 8 warps
  constexpr int FM = BM / (16 * WM), FN = BN / (16 * WN);
  constexpr int LDA = BK + 8, LDB = BN + 8;      // multiples of 8, as WMMA needs
  static_assert(FM >= 1 && FN >= 1 && BK % 16 == 0, "tile too small");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);      // [BM][LDA]
  bf16* Bs = As + BM * LDA;                      // [BK][LDB]
  float* stage = reinterpret_cast<float*>(Bs + BK * LDB);  // [8][16 * 16]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const long long col0 = static_cast<long long>(blockIdx.y) * BN;
  long long k_lo, k_hi;
  split_range(k, BK, splits, &k_lo, &k_hi);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long k0 = k_lo; k0 < k_hi; k0 += BK) {
    load_tile_bf16<BM, BK, LDA>(As, A, m, k_hi, k, row0, k0, vec_a);
    load_tile_bf16<BK, BN, LDB>(Bs, B, k_hi, n, n, k0, col0, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * FM * 16 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * FN * 16 + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage + warp * 256;
  float* part = ws == nullptr ? nullptr : ws + blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long r0 = row0 + wm * FM * 16 + i * 16;
      const long long c0 = col0 + wn * FN * 16 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const long long r = r0 + e / 16, c = c0 + e % 16;
        if (r < m && c < n) {
          if (part != nullptr)
            part[r * n + c] = st[e];
          else
            C[r * n + c] = __float2bfloat16_rn(st[e]);
        }
      }
      __syncwarp();
    }
  }
}

// ---- wgmma route: PTX helpers ---------------------------------------------
// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `p`:
// leading and stride byte offsets in 16-byte units, layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, f32, the warpgroup's fragment) += A (64 x 16, K-major) @
// B (16 x N, N-major: transpose bit set); scale_d 0 ignores d.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving accumulator registers while a wgmma that
// writes them is in flight.
template <int R>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- wgmma route: the kernel ----------------------------------------------
constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 288;      // two consumer warpgroups + one producer
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;   // 128 rows of 128 bytes
constexpr int WG_B_BOX = WG_BK * 64 * 2;        // 64 k rows x 64 columns

template <int BN>
constexpr size_t wgmma_smem() {
  return WG_STAGES * (WG_A_BYTES + (BN / 64) * WG_B_BOX) + 1024;
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mm_wgmma(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, bf16* __restrict__ C,
             float* __restrict__ ws, int m, int n, int k, int splits) {
  constexpr int STAGE = WG_A_BYTES + (BN / 64) * WG_B_BOX;
  constexpr int LDS = BN + 8;                  // epilogue staging, bf16
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int kt = (k + WG_BK - 1) / WG_BK;
  const int t_lo = static_cast<long long>(blockIdx.z) * kt / splits;
  const int t_hi = static_cast<long long>(blockIdx.z + 1) * kt / splits;
  const int row0 = blockIdx.x * WG_BM, col0 = blockIdx.y * BN;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);       // the producer's expect_tx, then bytes
      mbar_init(&empty[s], 2);      // one arrival from each warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {                 // the producer warp; one lane copies
    if (tid == 256) {
      int s = 0, phase = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        mbar_wait(&empty[s], phase ^ 1);
        unsigned char* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(st, &ta, t * WG_BK, row0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(st + WG_A_BYTES + j * WG_B_BOX, &tb, col0 + 64 * j,
                      t * WG_BK, &full[s]);
        if (++s == WG_STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = tid / 128;         // rows 64 wg .. 64 wg + 63 of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0, phase = 0, prev = -1;
  for (int t = t_lo; t < t_hi; ++t) {
    mbar_wait(&full[s], phase);
    const unsigned char* st = ring + s * STAGE;
    wgmma_fence();
    fence_operands<BN / 2>(acc);
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: K-major, 8-row groups 1024 bytes apart, k16 steps 32 bytes in
      // the swizzled row; B: N-major, 64-column boxes WG_B_BOX apart, k
      // groups of 8 rows 1024 bytes apart, k16 steps 2048 bytes
      const uint64_t da = sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(st + WG_A_BYTES + kk * 2048, WG_B_BOX,
                                     1024);
      wgmma_bf16<BN>(acc, da, db, 1);
    }
    wgmma_commit();
    fence_operands<BN / 2>(acc);
    wgmma_wait<1>();                // the previous stage's products are done
    if (prev >= 0 && tid % 128 == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == WG_STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands<BN / 2>(acc);

  // accumulator fragment: register 4j + 2h + e holds row 16w + lane/4 + 8h
  // and column 8j + 2(lane % 4) + e of the warpgroup's 64 rows
  const int lane = tid % 32, r_loc = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int c_loc = 2 * (lane % 4);
  if (ws != nullptr) {              // a float32 partial of split z
    float* part = ws + static_cast<long long>(blockIdx.z) * m * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + r_loc + 8 * h, c = col0 + c_loc + 8 * j;
        if (r < m && c < n)         // n is even: c + 1 < n too
          *reinterpret_cast<float2*>(part + r * n + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    return;
  }
  // bf16: stage the tile in the ring (both warpgroups are past it), then
  // store 16 bytes a thread; n % 8 == 0, so a chunk is all in or all out
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* stage = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (r_loc + 8 * h) * LDS + c_loc + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  constexpr int CH = BN / 8;
  for (int e = tid; e < WG_BM * CH; e += 256) {
    const int r = e / CH, c = (e % CH) * 8;
    const long long gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < n)
      *reinterpret_cast<uint4*>(C + gr * n + gc) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + c);
  }
}

// ---- split-K: the partials summed in split order --------------------------
template <typename T>
__global__ void splitk_sum(const float* __restrict__ ws, T* __restrict__ c,
                           long long mn, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    c[i] = repro::from_f32<T>(s);
  }
}

// ---- launchers --------------------------------------------------------------
template <int BM, int BN, int BK>
int launch_bf16(const void* a, const void* b, void* c, float* ws, long long m,
                long long n, long long k, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (BM * (BK + 8) + BK * (BN + 8)) +
                      sizeof(float) * 8 * 256;
  cudaError_t err = repro::allow_smem(mm_bf16<BM, BN, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_a = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, splits);
  mm_bf16<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(c), ws, m, n, k, splits, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled's signature (cuda.h), fetched at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (outer x inner) matrix at `base`, bf16 (read in boxes of
// box_outer x box_inner with the 128-byte swizzle) or f32 (unswizzled),
// zero outside.
bool encode_2d(CUtensorMap* map, int dtype, const void* base,
               long long inner, long long outer, unsigned box_inner,
               unsigned box_outer) {
  const bool f32 = dtype == REPRO_F32;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) *
                                 (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map,
                        f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        f32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                            : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32: TMA where both operands allow it, else cp.async
// (gpu_model.py::f32_tma_ok and f32_vector_copies mirror the rule).
template <int BM, int BN, int BK>
int launch_f32(const void* a, const void* b, void* c, float* ws, long long m,
               long long n, long long k, int splits, cudaStream_t stream) {
  using T = F32Tile<BM, BN, BK>;
  const bool vec_a = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool tma = vec_a && vec_b;
  CUtensorMap ta{}, tb{};
  if (tma) {
    const long long limit = 0x7fffffffLL;
    if (encode_tiled() == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    if (m > limit || n > limit || k > limit ||
        !encode_2d(&ta, REPRO_F32, a, k, m, BK, BM) ||
        !encode_2d(&tb, REPRO_F32, b, n, k, BN, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tma ? mm_f32<BM, BN, BK, true> : mm_f32<BM, BN, BK, false>;
  cudaError_t err = repro::allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, splits);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(
      ta, tb, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), ws, m, n, k, splits, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wgmma(const void* a, const void* b, void* c, float* ws,
                 long long m, long long n, long long k, int splits,
                 cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb;
  if (!encode_2d(&ta, REPRO_BF16, a, k, m, WG_BK, WG_BM) ||
      !encode_2d(&tb, REPRO_BF16, b, n, k, 64, WG_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wgmma_smem<BN>();
  cudaError_t err = repro::allow_smem(mm_wgmma<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + WG_BM - 1) / WG_BM, (n + BN - 1) / BN, splits);
  mm_wgmma<BN><<<grid, WG_THREADS, smem, stream>>>(
      ta, tb, static_cast<bf16*>(c), ws, static_cast<int>(m),
      static_cast<int>(n), static_cast<int>(k), splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_sum(int dtype, const float* ws, void* c, long long mn, int splits,
               cudaStream_t stream) {
  const long long blocks = std::min<long long>((mn + 255) / 256, 132 * 16);
  if (dtype == REPRO_F32)
    splitk_sum<float><<<blocks, 256, 0, stream>>>(ws, static_cast<float*>(c),
                                                   mn, splits);
  else
    splitk_sum<bf16><<<blocks, 256, 0, stream>>>(ws, static_cast<bf16*>(c),
                                                  mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tiles (bm, bn, bk) of the `mma` route, the same for both types: those
// the JAX package's kernel tests name (64^3; bm 32/64/128 x bn 64 x bk
// 32/128), 128 x 128 x 32, and the `wgmma` tiles, so that an explicit tile
// runs on either route.  Keep equal to gpu_model.py::MATMUL_TILES.
#define MATMUL_TILES(X)                                                     \
  X(32, 64, 32) X(32, 64, 128) X(64, 64, 32) X(64, 64, 64) X(64, 64, 128)  \
  X(128, 64, 32) X(128, 64, 128) X(128, 128, 32) X(128, 64, 64)            \
  X(128, 128, 64) X(128, 256, 64)

// The tiles of the `wgmma` route (bf16; bm 128, bk 64).  Keep equal to
// gpu_model.py::WGMMA_TILES.
#define WGMMA_TILES(X) X(128, 64, 64) X(128, 128, 64) X(128, 256, 64)

// The tiles of the f32 kernel: every `mma` tile, so that an explicit tile
// runs in either type, and its own.  Keep equal to gpu_model.py::F32_TILES.
#define F32_TILES(X) MATMUL_TILES(X) X(128, 256, 32)

enum { ROUTE_MMA = 0, ROUTE_WGMMA = 1 };

// Launches C = A @ B for m, n, k > 0 on `stream` with tile (bm, bn, bk) on
// `route`, in `splits` K ranges (for splits > 1, `ws` holds splits * m * n
// floats); returns a cudaError_t code: cudaErrorInvalidValue for an unknown
// type, route or tile, a split count outside [1, ceil(k / bk)], or a GEMM
// the `wgmma` route cannot take (not bf16, K or N not a multiple of 8, a
// base not 16-byte aligned).
extern "C" int matmul_launch(int dtype, int route, const void* a,
                             const void* b, void* c, void* ws, long long m,
                             long long n, long long k, int bm, int bn, int bk,
                             int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      splits < 1 || splits > (k + bk - 1) / bk || splits > 65535 ||
      (n + bn - 1) / bn > 65535 || (splits > 1 && ws == nullptr) ||
      (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return bad;
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  int err = bad;
  bool found = false;
  if (route == ROUTE_WGMMA) {
    const long long limit = 0x7fffffffLL;
    if (dtype != REPRO_BF16 || k % 8 != 0 || n % 8 != 0 ||
        reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(b) % 16 != 0 || m > limit ||
        n > limit || k > limit)
      return bad;
#define WGMMA_DISPATCH(BM, BN, BK)                                         \
  if (!found && bm == BM && bn == BN && bk == BK) {                        \
    static_assert(BM == WG_BM && BK == WG_BK, "wgmma tile is 128 x bn x 64"); \
    found = true;                                                          \
    err = launch_wgmma<BN>(a, b, c, part, m, n, k, splits, s);             \
  }
    WGMMA_TILES(WGMMA_DISPATCH)
#undef WGMMA_DISPATCH
  } else if (route == ROUTE_MMA && dtype == REPRO_F32) {
#define F32_DISPATCH(BM, BN, BK)                                           \
  if (!found && bm == BM && bn == BN && bk == BK) {                        \
    found = true;                                                          \
    err = launch_f32<BM, BN, BK>(a, b, c, part, m, n, k, splits, s);       \
  }
    F32_TILES(F32_DISPATCH)
#undef F32_DISPATCH
  } else if (route == ROUTE_MMA) {
#define MATMUL_DISPATCH(BM, BN, BK)                                        \
  if (!found && bm == BM && bn == BN && bk == BK) {                        \
    found = true;                                                          \
    err = launch_bf16<BM, BN, BK>(a, b, c, part, m, n, k, splits, s);      \
  }
    MATMUL_TILES(MATMUL_DISPATCH)
#undef MATMUL_DISPATCH
  }
  if (!found) return bad;
  if (err != 0 || splits == 1) return err;
  return launch_sum(dtype, part, c, m * n, splits, s);
}

REPRO_EXPORT_ERROR_STRING(matmul)
