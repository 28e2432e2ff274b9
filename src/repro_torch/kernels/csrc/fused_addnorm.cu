// Fused residual add + RMSNorm: s = x + resid in float32, res = s rounded
// to x's type, y = s * rsqrt(mean(s^2) + eps) * scale from the unrounded s.
//
// Replaces the JAX package's Pallas kernel `fused_add_rmsnorm_pallas`
// (src/repro/kernels/fused_addnorm.py:27), the VPU twin of the paper's
// Tensor-add fused with the normalisation that follows it (Sec. IV-E).
//
// Bound on the H100: bytes.  Each element costs a handful of operations
// against 2 reads and 2 writes (16 bytes in f32, 8 in bf16), far below the
// card's ~20 FLOP a byte for CUDA-core f32, so 3.35 TB/s bounds it.
//
// Design: one block of 256 threads for each row, so the row statistic is a
// block reduction and nothing crosses blocks.  Every element is read once
// from device memory: s is kept in shared memory (d floats) between the sum
// of squares and the normalisation, and res and y are each written once.
// The reduction runs in a fixed order (warp shuffles, then warp partials in
// order), so the result does not change from run to run.  Row offsets are
// 64-bit.  Later work: vector loads and several rows a block for short rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    addnorm(const T* __restrict__ x, const T* __restrict__ r,
            const float* __restrict__ scale, T* __restrict__ y,
            T* __restrict__ res, int d, float eps) {
  extern __shared__ float s[];                 // [d]
  __shared__ float warp_sum[kThreads / 32];
  __shared__ float total;
  const long long off = static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_f32(x[off + i]) + repro::to_f32(r[off + i]);
    s[i] = v;
    res[off + i] = repro::from_f32<T>(v);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sum[w];
    total = t;
  }
  __syncthreads();
  const float inv = rsqrtf(total / d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    y[off + i] = repro::from_f32<T>(s[i] * inv * scale[i]);
}

template <typename T>
int launch(const void* x, const void* r, const float* scale, void* y,
           void* res, long long rows, int d, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d;
  cudaError_t err = repro::allow_smem(addnorm<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  addnorm<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale,
      static_cast<T*>(y), static_cast<T*>(res), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (y, res) of rows x d inputs x and r of one type, float32 scale[d];
// rows, d > 0.  Returns a cudaError_t code.
extern "C" int fused_addnorm_launch(int dtype, const void* x, const void* r,
                                    const void* scale, void* y, void* res,
                                    long long rows, int d, float eps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == REPRO_F32)
    return launch<float>(x, r, sc, y, res, rows, d, eps, s);
  if (dtype == REPRO_BF16)
    return launch<bf16>(x, r, sc, y, res, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(fused_addnorm)
