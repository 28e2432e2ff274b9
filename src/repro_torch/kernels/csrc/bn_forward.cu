// Training batch-norm forward over x (N_eff, C): per-channel mean mu and
// psi = rsqrt(E[x^2] - mu^2 + eps), then y = (x - mu) * psi * gamma + beta.
// Returns (y, mu, psi), mu and psi in float32.
//
// Replaces the JAX package's Pallas kernel `bn_forward_pallas`
// (src/repro/kernels/bn.py:50): Sec. V-A's two passes (statistics, then
// normalise) over the (h*w*n, c) rows the paper reduces the h/w/n loops to.
// It keeps that kernel's one-pass variance E[x^2] - mu^2 (bn.py:69-71), not
// the oracle's two-pass form.
//
// Bound on the H100: bytes.  Two reads of x and one write of y against a
// few operations an element; at ResNet-50's 53 BN layers (batch 32) x is
// 1.42 GB in f32, so 3.35 TB/s bounds them.
//
// Design: the Pallas grid walks the row blocks in order and carries the
// sums in its output block; CUDA blocks run in no order, so the statistics
// are a two-stage reduction without atomics, and the same in every run:
//   1. stats: one block per (row chunk of block_rows rows, channel tile of
//      block_c channels), threads along C (contiguous, so loads coalesce)
//      and a few row lanes; float32 partial sum and sum of squares of the
//      chunk, combined over the lanes in a fixed order;
//   2. finalize: per channel, the chunks' partials summed in a fixed order
//      (lanes over chunks, then lanes in order), then mu, var and psi;
//   3. normalise: elementwise, on the same tiling as stage 1.
// With block_rows = 256 the stem's (401408, 64) gives 1568 blocks, which
// fill the 132 SMs although its 64 channels are one tile.  Offsets are
// 64-bit.  Later work: fold the normalise into fewer passes over x.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // threads a stage-1 or normalise block aims at
constexpr int kMaxThreads = 1024; // block_c up to 1024 channels, one row lane
constexpr int kLanes2 = 8;       // chunk lanes of a finalize block

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bn_stats(const T* __restrict__ x, float* __restrict__ psum,
             float* __restrict__ psq, long long n, int c, int br) {
  extern __shared__ float red[];             // [2][lanes][bc]
  const int bc = blockDim.x, lanes = blockDim.y;
  const int ch = blockIdx.y * bc + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * br;
  const long long r1 = min(r0 + br, n);
  float sum = 0.f, sq = 0.f;
  if (ch < c) {
    for (long long row = r0 + threadIdx.y; row < r1; row += lanes) {
      const float v = repro::to_f32(x[row * c + ch]);
      sum += v;
      sq = fmaf(v, v, sq);
    }
  }
  red[threadIdx.y * bc + threadIdx.x] = sum;
  red[(lanes + threadIdx.y) * bc + threadIdx.x] = sq;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.f, q = 0.f;
    for (int l = 0; l < lanes; ++l) {
      s += red[l * bc + threadIdx.x];
      q += red[(lanes + l) * bc + threadIdx.x];
    }
    psum[static_cast<long long>(blockIdx.x) * c + ch] = s;
    psq[static_cast<long long>(blockIdx.x) * c + ch] = q;
  }
}

__global__ void __launch_bounds__(32 * kLanes2)
    bn_finalize(const float* __restrict__ psum, const float* __restrict__ psq,
                float* __restrict__ mu, float* __restrict__ psi,
                long long n, int c, int chunks, float eps) {
  __shared__ float red[2][kLanes2][32];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, q = 0.f;
  if (ch < c) {
    for (int k = threadIdx.y; k < chunks; k += kLanes2) {
      s += psum[static_cast<long long>(k) * c + ch];
      q += psq[static_cast<long long>(k) * c + ch];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    s = 0.f;
    q = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes2; ++l) {
      s += red[0][l][threadIdx.x];
      q += red[1][l][threadIdx.x];
    }
    const float m = s / static_cast<float>(n);
    const float var = q / static_cast<float>(n) - m * m;
    mu[ch] = m;
    psi[ch] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bn_normalise(const T* __restrict__ x, const float* __restrict__ mu,
                 const float* __restrict__ psi,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ y,
                 long long n, int c, int br) {
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float m = mu[ch], p = psi[ch], g = gamma[ch], b = beta[ch];
  const long long r0 = static_cast<long long>(blockIdx.x) * br;
  const long long r1 = min(r0 + br, n);
  for (long long row = r0 + threadIdx.y; row < r1; row += blockDim.y) {
    const float v = repro::to_f32(x[row * c + ch]);
    y[row * c + ch] = repro::from_f32<T>((v - m) * p * g + b);
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, void* y,
           float* mu, float* psi, float* psum, float* psq, long long n, int c,
           int br, int bc, float eps, cudaStream_t stream) {
  const long long chunks = (n + br - 1) / br;
  const int lanes = bc >= kThreads ? 1 : kThreads / bc;
  const dim3 block(bc, lanes);
  const dim3 grid(static_cast<unsigned>(chunks), (c + bc - 1) / bc);
  const size_t smem = sizeof(float) * 2 * lanes * bc;
  cudaError_t err = repro::allow_smem(bn_stats<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_stats<T><<<grid, block, smem, stream>>>(static_cast<const T*>(x), psum,
                                             psq, n, c, br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_finalize<<<(c + 31) / 32, dim3(32, kLanes2), 0, stream>>>(
      psum, psq, mu, psi, n, c, static_cast<int>(chunks), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_normalise<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), mu, psi, gamma, beta, static_cast<T*>(y), n,
      c, br);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (N_eff x C, x's type), mu[C] and psi[C] (float32) of x; gamma, beta
// float32 [C]; psum and psq are float32 scratch of ceil(n / br) x C.
// n, c > 0; 0 < br; 0 < bc <= 1024.  Returns a cudaError_t code.
extern "C" int bn_forward_launch(int dtype, const void* x, const void* gamma,
                                 const void* beta, void* y, void* mu,
                                 void* psi, void* psum, void* psq,
                                 long long n, int c, int br, int bc,
                                 float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mu);
  float* p = static_cast<float*>(psi);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  if (dtype == REPRO_F32)
    return launch<float>(x, g, b, y, m, p, ps, pq, n, c, br, bc, eps, s);
  if (dtype == REPRO_BF16)
    return launch<bf16>(x, g, b, y, m, p, ps, pq, n, c, br, bc, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(bn_forward)
