// Fused DSE grid reduction: outer-add + first-occurrence min/argmin and
// max/argmax over the virtual int64 cost grid
//
//     grid[r, c] = conv_rows[s3_of[r], c] + simd_rows[v_of[r], c]
//
// without materialising it.  Returns [min, argmin, max, argmax] with flat
// row-major indices (r * nb + c).
//
// Replaces the JAX package's Pallas kernel kernels/reduce.py::
// grid_minmax_pallas (body _minmax_kernel).  The Pallas grid walks the rows
// in order on one core and resolves ties to the first occurrence through
// its strict running update.  A CUDA grid has no order, so every merge
// here is lexicographic on (value, flat index): the minimum keeps the
// smaller value, and on equal values the smaller index; the maximum
// mirrors it.  Any merge order then gives the same answer, with no
// atomics, so results are deterministic.
//
// Bound on an H100: memory.  Each candidate costs one int64 add and two
// compares against 16 bytes of gathered operands, far below the card's
// ratio of operations to bytes.  The design streams each gathered row pair
// once, with neighbouring threads on neighbouring columns (coalesced),
// keeps the four running scalars in registers, and reduces them with warp
// shuffles and one shared-memory pass per block.
//
// Stage 1: block b takes rows [b * rows_per_block, ...) and writes one
// partial (min_v, min_i, max_v, max_i).  Stage 2: one block merges the
// partials.  Everything that indexes or accumulates is 64-bit: Table VIII
// training grids hold cycle counts past 2^31, and a flat index of a large
// grid can pass 2^31 too.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/reduce.py); both launches go on the caller's stream.

#include <climits>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct MinMax {
  i64 min_v, min_i, max_v, max_i;
};

__device__ __forceinline__ void init(MinMax& s) {
  s.min_v = LLONG_MAX;
  s.min_i = LLONG_MAX;
  s.max_v = LLONG_MIN;
  s.max_i = LLONG_MAX;
}

// Lexicographic merges: a real candidate always has an index below the
// LLONG_MAX sentinel, so it wins against an empty state even when its
// value equals the sentinel value.
__device__ __forceinline__ void take(MinMax& s, i64 v, i64 i) {
  if (v < s.min_v || (v == s.min_v && i < s.min_i)) {
    s.min_v = v;
    s.min_i = i;
  }
  if (v > s.max_v || (v == s.max_v && i < s.max_i)) {
    s.max_v = v;
    s.max_i = i;
  }
}

__device__ __forceinline__ void merge(MinMax& s, const MinMax& o) {
  if (o.min_v < s.min_v || (o.min_v == s.min_v && o.min_i < s.min_i)) {
    s.min_v = o.min_v;
    s.min_i = o.min_i;
  }
  if (o.max_v > s.max_v || (o.max_v == s.max_v && o.max_i < s.max_i)) {
    s.max_v = o.max_v;
    s.max_i = o.max_i;
  }
}

__device__ __forceinline__ void warp_merge(MinMax& s) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MinMax o;
    o.min_v = __shfl_down_sync(full, s.min_v, off);
    o.min_i = __shfl_down_sync(full, s.min_i, off);
    o.max_v = __shfl_down_sync(full, s.max_v, off);
    o.max_i = __shfl_down_sync(full, s.max_i, off);
    merge(s, o);
  }
}

// Block-wide merge; the result is valid in thread 0.  Every thread of the
// block must call it.
__device__ MinMax block_merge(MinMax s) {
  __shared__ MinMax warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_merge(s);
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) {
      s = warp_part[lane];
    } else {
      init(s);
    }
    warp_merge(s);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
grid_minmax_partial(const i64* __restrict__ conv_rows,
                    const i64* __restrict__ simd_rows,
                    const i64* __restrict__ s3_of,
                    const i64* __restrict__ v_of, i64 n_rows, i64 nb,
                    i64 rows_per_block, MinMax* __restrict__ partials) {
  MinMax s;
  init(s);
  const i64 r0 = (i64)blockIdx.x * rows_per_block;
  const i64 r1 = r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;
  for (i64 r = r0; r < r1; ++r) {
    const i64* crow = conv_rows + __ldg(s3_of + r) * nb;
    const i64* srow = simd_rows + __ldg(v_of + r) * nb;
    const i64 base = r * nb;
    for (i64 c = threadIdx.x; c < nb; c += kThreads) {
      // wrap-around add, as numpy's int64 add
      const i64 v = (i64)((u64)__ldg(crow + c) + (u64)__ldg(srow + c));
      take(s, v, base + c);
    }
  }
  s = block_merge(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
grid_minmax_final(const MinMax* __restrict__ partials, int n_parts,
                  i64* __restrict__ out) {
  MinMax s;
  init(s);
  for (int k = threadIdx.x; k < n_parts; k += kThreads) merge(s, partials[k]);
  s = block_merge(s);
  if (threadIdx.x == 0) {
    out[0] = s.min_v;
    out[1] = s.min_i;
    out[2] = s.max_v;
    out[3] = s.max_i;
  }
}

}  // namespace

extern "C" {

// Bytes of one stage-1 partial; the caller allocates n_blocks of them.
int grid_minmax_partial_bytes() { return (int)sizeof(MinMax); }

const char* grid_minmax_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches both stages on `stream`; returns the cudaError_t of the launches
// (0 on success).  The caller guarantees n_rows, nb, rows_per_block and
// n_blocks > 0, n_blocks * rows_per_block >= n_rows, and every s3_of/v_of
// entry a valid row of its operand.
int grid_minmax_launch(const i64* conv_rows, const i64* simd_rows,
                       const i64* s3_of, const i64* v_of, i64 n_rows, i64 nb,
                       i64 rows_per_block, int n_blocks, void* partials,
                       i64* out, void* stream) {
  if (n_rows <= 0 || nb <= 0 || rows_per_block <= 0 || n_blocks <= 0 ||
      (i64)n_blocks * rows_per_block < n_rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  MinMax* parts = (MinMax*)partials;
  grid_minmax_partial<<<n_blocks, kThreads, 0, st>>>(
      conv_rows, simd_rows, s3_of, v_of, n_rows, nb, rows_per_block, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grid_minmax_final<<<1, kThreads, 0, st>>>(parts, n_blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
