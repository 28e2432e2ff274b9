// Training batch-norm backward over x, dy (N_eff, C), the paper's
// Algorithm 1 (Eqs. 25-28), given the forward's per-channel mu and
// psi = rsqrt(var + eps):
//   part 1: x^ = (x - mu) * psi, dgamma = sum dy * x^, dbeta = sum dy;
//   part 2: dx = (gamma * psi / N) * (N * dy - dgamma * x^ - dbeta).
// Returns dx in x's type and dgamma, dbeta in float32.
//
// Replaces the JAX package's Pallas kernel `bn_backward_pallas`
// (src/repro/kernels/bn.py:121, with `_part1_kernel` :95 and
// `_part2_kernel` :112).
//
// Bound on the H100: bytes.  x and dy are read and dx written at least
// once, against about a dozen operations an element; at the ResNet-50 stem
// (401408 x 64, f32) that is 308 MB, 0.092 ms at 3.35 TB/s.  This kernel
// reads x and dy twice (once a part), so it moves 5 N*C elements and cannot
// go below 0.153 ms there.
//
// Design: the Pallas part 1 walks the row blocks in order and carries
// dgamma and dbeta in its revisited output block; CUDA blocks run in no
// order, so part 1 is the same two-stage reduction as bn_forward.cu's
// statistics, without atomics and the same bits in every run:
//   1. partials: one block per (row chunk of block_rows rows, channel tile
//      of block_c channels), threads along C (contiguous, so loads
//      coalesce) and a few row lanes; float32 partial sums of dy * x^ and
//      dy over the chunk, combined over the lanes in a fixed order;
//   2. finalize: per channel, the chunks' partials summed in a fixed order
//      (lanes over chunks, then lanes in order) into dgamma and dbeta;
//   3. dx: elementwise, on the same tiling as stage 1.
// Pallas writes x^ in x's type in part 1 and reads it back in part 2
// (Algorithm 1's buffer reuse, bn.py:107,142).  Here part 2 recomputes x^
// from x in float32 instead: one pass fewer over N*C (5, not 6), and the
// unrounded x^ of the oracle (kernels/ref.py) also for bfloat16, where
// Pallas would round x^ to bfloat16.  The ragged edge is masked (Pallas
// pads with zeros); N is the unpadded row count.  Offsets are 64-bit.
// Later work: fold part 2 into fewer reads of x and dy.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // threads a stage-1 or dx block aims at
constexpr int kMaxThreads = 1024; // block_c up to 1024 channels, one lane
constexpr int kLanes2 = 8;        // chunk lanes of a finalize block

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bn_back_partials(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mu,
                     const float* __restrict__ psi, float* __restrict__ pdg,
                     float* __restrict__ pdb, long long n, int c, int br) {
  extern __shared__ float red[];             // [2][lanes][bc]
  const int bc = blockDim.x, lanes = blockDim.y;
  const int ch = blockIdx.y * bc + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * br;
  const long long r1 = min(r0 + br, n);
  float sg = 0.f, sb = 0.f;
  if (ch < c) {
    const float m = mu[ch], p = psi[ch];
    for (long long row = r0 + threadIdx.y; row < r1; row += lanes) {
      const long long i = row * c + ch;
      const float g = repro::to_f32(dy[i]);
      const float xh = (repro::to_f32(x[i]) - m) * p;     // Eq. 25
      sg = fmaf(g, xh, sg);                               // Eq. 26
      sb += g;                                            // Eq. 27
    }
  }
  red[threadIdx.y * bc + threadIdx.x] = sg;
  red[(lanes + threadIdx.y) * bc + threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float s = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {
      s += red[l * bc + threadIdx.x];
      b += red[(lanes + l) * bc + threadIdx.x];
    }
    pdg[static_cast<long long>(blockIdx.x) * c + ch] = s;
    pdb[static_cast<long long>(blockIdx.x) * c + ch] = b;
  }
}

__global__ void __launch_bounds__(32 * kLanes2)
    bn_back_finalize(const float* __restrict__ pdg,
                     const float* __restrict__ pdb, float* __restrict__ dg,
                     float* __restrict__ db, int c, int chunks) {
  __shared__ float red[2][kLanes2][32];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, b = 0.f;
  if (ch < c) {
    for (int k = threadIdx.y; k < chunks; k += kLanes2) {
      s += pdg[static_cast<long long>(k) * c + ch];
      b += pdb[static_cast<long long>(k) * c + ch];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s;
  red[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    s = 0.f;
    b = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes2; ++l) {
      s += red[0][l][threadIdx.x];
      b += red[1][l][threadIdx.x];
    }
    dg[ch] = s;
    db[ch] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bn_back_dx(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ mu, const float* __restrict__ psi,
               const float* __restrict__ gamma,
               const float* __restrict__ dg, const float* __restrict__ db,
               T* __restrict__ dx, long long n, int c, int br) {
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float nf = static_cast<float>(n);
  const float m = mu[ch], p = psi[ch], g = dg[ch], b = db[ch];
  const float pref = gamma[ch] * p / nf;        // Algorithm 1, line 14
  const long long r0 = static_cast<long long>(blockIdx.x) * br;
  const long long r1 = min(r0 + br, n);
  for (long long row = r0 + threadIdx.y; row < r1; row += blockDim.y) {
    const long long i = row * c + ch;
    const float xh = (repro::to_f32(x[i]) - m) * p;
    const float d = repro::to_f32(dy[i]);
    dx[i] = repro::from_f32<T>(pref * (nf * d - g * xh - b));  // Eq. 28
  }
}

template <typename T>
int launch(const void* x, const void* dy, const float* gamma,
           const float* mu, const float* psi, void* dx, float* dg, float* db,
           float* pdg, float* pdb, long long n, int c, int br, int bc,
           cudaStream_t stream) {
  const long long chunks = (n + br - 1) / br;
  const int lanes = bc >= kThreads ? 1 : kThreads / bc;
  const dim3 block(bc, lanes);
  const dim3 grid(static_cast<unsigned>(chunks), (c + bc - 1) / bc);
  const size_t smem = sizeof(float) * 2 * lanes * bc;
  cudaError_t err = repro::allow_smem(bn_back_partials<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_back_partials<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mu, psi, pdg, pdb,
      n, c, br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_back_finalize<<<(c + 31) / 32, dim3(32, kLanes2), 0, stream>>>(
      pdg, pdb, dg, db, c, static_cast<int>(chunks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_back_dx<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mu, psi, gamma,
      dg, db, static_cast<T*>(dx), n, c, br);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx (N_eff x C, x's type), dgamma[C] and dbeta[C] (float32) of x and dy
// (both N_eff x C, one type); gamma, mu, psi float32 [C]; pdg and pdb are
// float32 scratch of ceil(n / br) x C.  n, c > 0; 0 < br; 0 < bc <= 1024.
// Returns a cudaError_t code.
extern "C" int bn_backward_launch(int dtype, const void* x, const void* dy,
                                  const void* gamma, const void* mu,
                                  const void* psi, void* dx, void* dgamma,
                                  void* dbeta, void* pdg, void* pdb,
                                  long long n, int c, int br, int bc,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mu);
  const float* p = static_cast<const float*>(psi);
  float* dgp = static_cast<float*>(dgamma);
  float* dbp = static_cast<float*>(dbeta);
  float* pg = static_cast<float*>(pdg);
  float* pb = static_cast<float*>(pdb);
  if (br <= 0 || bc <= 0 || bc > kMaxThreads || n <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == REPRO_F32)
    return launch<float>(x, dy, g, m, p, dx, dgp, dbp, pg, pb, n, c, br, bc,
                         s);
  if (dtype == REPRO_BF16)
    return launch<bf16>(x, dy, g, m, p, dx, dgp, dbp, pg, pb, n, c, br, bc,
                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(bn_backward)
