// What the two batch-norm kernels (bn_forward.cu, bn_backward.cu) share:
// the layout core/gpu_model.py::bn_layout picks, 16-byte packs of x's
// type, the grid-wide barrier, and the shared-memory carve-up.
//
// Both kernels are one persistent cooperative launch: one block an SM,
// all resident at once.  Block b owns channel group b % cgroups and row
// group b / cgroups, rows [n*g/rgroups, n*(g+1)/rgroups); its threads
// stand group_c / V along the channels (neighbouring threads on
// neighbouring 16-byte packs) and `lanes` along the rows, and lane l
// walks rows l, l + lanes, ...  The first `kept` rows of the group stay
// in shared memory from the reduction to the elementwise pass.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace bn {

constexpr int kThreads = 512;  // core/gpu_model.py::BN_THREADS
// Rows a thread has in flight (of x, and of dy in the backward): 32 KB
// an SM in the forward, 64 KB in the backward; 8 rows measured no faster
// in the forward (PERF.md).
constexpr int kUnroll = 4;

struct Layout {
  long long n;     // rows
  int c;           // channels
  int group_c;     // channels of a group, a multiple of the pack width
  int cgroups;     // channel groups
  int rgroups;     // row groups; rgroups * cgroups blocks
  int kept;        // rows a block keeps in shared memory
};

// V elements of T as one access: 16 bytes on the vector route, one
// element on the scalar route.
template <typename T, int V> struct Pack;
template <> struct Pack<float, 4> { using S = float4; };
template <> struct Pack<bf16, 8> { using S = uint4; };
template <> struct Pack<float, 1> { using S = float; };
template <> struct Pack<bf16, 1> { using S = bf16; };

__device__ __forceinline__ void unpack(const float4& s, float (&f)[4]) {
  f[0] = s.x; f[1] = s.y; f[2] = s.z; f[3] = s.w;
}
__device__ __forceinline__ void unpack(const uint4& s, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const float& s, float (&f)[1]) {
  f[0] = s;
}
__device__ __forceinline__ void unpack(const bf16& s, float (&f)[1]) {
  f[0] = __bfloat162float(s);
}

// Streaming stores (evict first): the outputs are not read again here,
// and L2 is kept for the rows the elementwise pass reads a second time.
__device__ __forceinline__ void store(float4* p, const float (&f)[4]) {
  __stcs(p, make_float4(f[0], f[1], f[2], f[3]));
}
__device__ __forceinline__ void store(uint4* p, const float (&f)[8]) {
  uint4 s;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  __stcs(p, s);
}
__device__ __forceinline__ void store(float* p, const float (&f)[1]) {
  __stcs(p, f[0]);
}
__device__ __forceinline__ void store(bf16* p, const float (&f)[1]) {
  *p = __float2bfloat16_rn(f[0]);
}

// First row of row group g.
__device__ __forceinline__ long long row_bound(const Layout& L, int g) {
  return L.n * g / L.rgroups;
}

// Every block of the cooperative launch waits here until all have
// arrived; writes before it are visible to every block after it.
__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

// Bytes of one tensor's tile, and of the whole carve-up:
// [tensors][kept][group_c] T, then [2][lanes][group_c] float sums;
// core/gpu_model.py::bn_smem computes the same.
__host__ __device__ inline size_t tile_bytes(const Layout& L, int bytes) {
  return (static_cast<size_t>(L.kept) * L.group_c * bytes + 15) / 16 * 16;
}
inline size_t smem_bytes(const Layout& L, int bytes, int vec, int tensors) {
  const int lanes = kThreads / (L.group_c / vec);
  return tensors * tile_bytes(L, bytes) +
         sizeof(float) * 2 * static_cast<size_t>(lanes) * L.group_c;
}

// The checks both launches make of a layout before they launch; false
// means cudaErrorInvalidValue.
inline bool valid(const Layout& L, int vec) {
  return L.n > 0 && L.c > 0 && L.group_c > 0 && L.group_c % vec == 0 &&
         L.group_c / vec <= kThreads && L.c % vec == 0 &&
         static_cast<long long>(L.cgroups) * L.group_c >= L.c &&
         static_cast<long long>(L.cgroups - 1) * L.group_c < L.c &&
         L.rgroups > 0 && L.rgroups <= L.n && L.kept >= 0;
}

// Launches `kernel` cooperatively with rgroups * cgroups blocks of
// kThreads threads after allowing its shared memory; a grid that cannot
// be resident at once is refused by the runtime, and that error returns.
template <typename Kernel>
cudaError_t launch(Kernel kernel, const Layout& L, size_t smem, void** args,
                   cudaStream_t stream) {
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(
      (const void*)kernel,
      dim3(static_cast<unsigned>(L.rgroups) * L.cgroups), dim3(kThreads),
      args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks of `kernel` with `smem` bytes one SM holds at once.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t smem, int* blocks) {
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kThreads, smem);
}

}  // namespace bn
