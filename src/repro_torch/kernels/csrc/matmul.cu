// C[m,n] = A[m,k] @ B[k,n] with float32 accumulation; C takes A's type.
//
// Replaces the JAX package's Pallas GEMM `matmul_pallas`
// (src/repro/kernels/matmul.py:30), the MXU twin of the paper's Conv/FC-as-
// GEMM mapping (Sec. IV-B).  Row-major operands, as there.
//
// Bound on the H100: at the shapes the port drives (Qwen3-0.6B projections
// and LM head at 4096 tokens, ResNet-50's convolutions as GEMMs) the work
// is well above 295 FLOP a byte, so the tensor cores bound bf16 (989
// TFLOP/s) and the CUDA cores bound f32 (67 TFLOP/s, no TF32).
//
// Design, simple first:
// * One block of 256 threads for each (bm x bn) output tile, looping over k
//   in steps of bk.  The A and B tiles sit in shared memory, single-
//   buffered; the f32 accumulators sit in registers for the whole k sweep,
//   so every output is written once (the Pallas kernel revisits its f32
//   output block in VMEM instead).
// * bf16: eight warps, each a (bm/2 x bn/4) sub-tile of 16x16x16 WMMA
//   products (mma.sync on the tensor cores); the accumulator fragments go
//   through a per-warp 16x16 buffer in shared memory to the masked store.
// * f32: CUDA-core FMAs only, each thread a (bm/16 x bn/16) strided sub-
//   tile, so no TF32 rounding enters (the f32 tolerance is 2e-4).
// * The ragged edge is masked in the kernel (zero-filled loads, guarded
//   stores) instead of padding copies of the operands as `jnp.pad` does.
//   Loads move 16 bytes a thread where the rows allow it.
// * Offsets are 64-bit (row * stride in int64): the LM head's output at
//   4096 x 151936 has 622M elements.
// The tiles are the template instantiations in MATMUL_TILES below; the
// port's tile model (repro_torch/core/gpu_model.py) chooses among them.
// Later work: TMA loads, a multi-stage pipeline and wgmma.
#include <mma.h>

#include <cstdint>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;

// ---- f32: CUDA-core FMAs -------------------------------------------------
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    mm_f32(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C, long long m, long long n, long long k) {
  constexpr int TM = BM / 16, TN = BN / 16, LDA = BM + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [BK][BM + 1], A transposed
  float* Bs = As + BK * LDA;                   // [BK][BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const long long col0 = static_cast<long long>(blockIdx.y) * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const long long gr = row0 + r, gc = k0 + c;
      As[c * LDA + r] = (gr < m && gc < k) ? A[gr * k + gc] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const long long gr = k0 + r, gc = col0 + c;
      Bs[r * BN + c] = (gr < k && gc < n) ? B[gr * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = col0 + tx + 16 * j;
      if (r < m && c < n) C[r * n + c] = acc[i][j];
    }
  }
}

// ---- bf16: WMMA (mma.sync) with f32 accumulators --------------------------
// Copies a (ROWS x COLS) tile of a row-major (rows x cols) matrix at
// (r0, c0) into shared memory with leading dimension LD, zero outside the
// matrix; 8 elements (16 bytes) a step, one vector load where `vec` allows.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile_bf16(
    bf16* __restrict__ dst, const bf16* __restrict__ src, long long rows,
    long long cols, long long r0, long long c0, bool vec) {
  constexpr int CHUNKS = COLS / 8;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += kThreads) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const long long gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * LD + c;
    if (vec && gr < rows && gc + 8 <= cols) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + gr * cols + gc);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (gr < rows && gc + i < cols) ? src[gr * cols + gc + i] : zero;
    }
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    mm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
            bf16* __restrict__ C, long long m, long long n, long long k,
            bool vec_a, bool vec_b) {
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long k0 = 0; k0 < k; k0 += BK) {
    load_tile_bf16<BM, BK, LDA>(As, A, m, k, row0, k0, vec_a);
    load_tile_bf16<BK, BN, LDB>(Bs, B, k, n, k0, col0, vec_b);
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
        if (r < m && c < n) C[r * n + c] = __float2bfloat16_rn(st[e]);
      }
      __syncwarp();
    }
  }
}

template <int BM, int BN, int BK>
int launch_f32(const void* a, const void* b, void* c, long long m,
               long long n, long long k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BK * (BM + 1) + BK * BN);
  cudaError_t err = repro::allow_smem(mm_f32<BM, BN, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  mm_f32<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK>
int launch_bf16(const void* a, const void* b, void* c, long long m,
                long long n, long long k, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (BM * (BK + 8) + BK * (BN + 8)) +
                      sizeof(float) * 8 * 256;
  cudaError_t err = repro::allow_smem(mm_bf16<BM, BN, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_a = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  mm_bf16<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(c), m, n, k, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled tiles (bm, bn, bk), the same for both types: those the JAX
// package's kernel tests name (64^3; bm 32/64/128 x bn 64 x bk 32/128) and
// 128 x 128 x 32, the tile model's pick for the large GEMMs.  Keep equal to
// repro_torch/core/gpu_model.py::MATMUL_TILES.
#define MATMUL_TILES(X)                                                     \
  X(32, 64, 32) X(32, 64, 128) X(64, 64, 32) X(64, 64, 64) X(64, 64, 128)  \
  X(128, 64, 32) X(128, 64, 128) X(128, 128, 32)

// Launches C = A @ B for m, n, k > 0 on `stream` with tile (bm, bn, bk);
// returns a cudaError_t code (cudaErrorInvalidValue for an unknown type or
// a tile that is not compiled).
extern "C" int matmul_launch(int dtype, const void* a, const void* b, void* c,
                             long long m, long long n, long long k, int bm,
                             int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MATMUL_DISPATCH(BM, BN, BK)                                  \
  if (bm == BM && bn == BN && bk == BK) {                            \
    if (dtype == REPRO_F32) return launch_f32<BM, BN, BK>(a, b, c, m, n, k, s); \
    if (dtype == REPRO_BF16) return launch_bf16<BM, BN, BK>(a, b, c, m, n, k, s); \
    return static_cast<int>(cudaErrorInvalidValue);                  \
  }
  MATMUL_TILES(MATMUL_DISPATCH)
#undef MATMUL_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(matmul)
