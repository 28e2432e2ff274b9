// Training batch-norm forward over x (N_eff, C): per-channel batch mean mu
// and psi = rsqrt(var + eps) with the biased variance, then
// y = (x - mu) * psi * gamma + beta.  Returns (y, mu, psi), mu and psi in
// float32.
//
// Replaces the JAX package's Pallas kernel `bn_forward_pallas`
// (src/repro/kernels/bn.py:50, its `pl.pallas_call`s at :59 and :76):
// Sec. V-A's two passes (statistics, then normalise) over the (h*w*n, c)
// rows the paper reduces the h/w/n loops to.
//
// Bound on the H100: bytes.  x read once and y written once, 2 N*C
// elements, against a few operations an element; at the ResNet-50 stem
// (401408 x 64, f32) that is 205.5 MB, 0.0613 ms at 3.35 TB/s.
//
// Design: one persistent cooperative launch (bn_common.cuh), laid out by
// core/gpu_model.py::bn_layout.  What it does about what held the
// three-kernel form back:
//   * too few blocks: the grid is one block of 512 threads on each of the
//     132 SMs, whatever the shape (or one a row when N_eff < 132);
//   * narrow accesses: 16-byte loads and stores (4 float32 or 8 bfloat16
//     values) on neighbouring channel packs, and each thread keeps four
//     rows in flight; a channel count that is no multiple of the pack
//     width, or a base not 16-byte aligned, takes the scalar route;
//   * three launches: the statistics and the normalisation are one
//     kernel; grid-wide barriers separate the blocks' partial sums, their
//     merge and the normalisation;
//   * two reads of x: a block keeps as many of its rows in shared memory
//     as its ~200 KB allow and normalises them from there; only the rest
//     is read again, last row first, so that the rows read last come
//     from L2;
//   * the one-pass variance E[x^2] - mu^2 of the Pallas kernel (bn.py:
//     69-71), which loses every digit at a large mean shift: each block
//     shifts each channel by its value in the block's first row, K, and
//     sums (x - K) and (x - K)^2 in float32, its lanes combined in a fixed
//     order, into (K, mean - K, M2); the blocks' partials are merged by
//     Chan's formula, offsets taken against the left operand's K, in a
//     fixed order: lane l of a warp takes blocks l, l + 32, ..., then a
//     tree over the lanes.  The mean stays a pair K + s until y is
//     formed, ((x - K) - s) * psi * gamma + beta; mu = K + s is rounded
//     once.  No atomics decide an order, so the same inputs give the
//     same bits in every run.
// The merge of a channel is one warp's, the channels spread over all
// warps of the grid, and its result reaches every block through device
// memory behind a second barrier: every block merging its own channels
// behind one barrier was measured 1.08x-42x slower at ResNet-50's 12 BN
// shapes, forward and backward (PERF.md).  Offsets are 64-bit.
#include "bn_common.cuh"

namespace {

using bn::Layout;
using bn::kUnroll;

// (count, shift K, mean offset s = mean - K, M2) of a run of rows.
struct Moments {
  float n, k, s, m2;
};

// a := a merged with b (Chan et al.), offsets against a's shift.
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.f) return;
  if (a.n == 0.f) {
    a = b;
    return;
  }
  const float n = a.n + b.n;
  const float d = ((b.k - a.k) + b.s) - a.s;
  const float w = b.n / n;
  a.s = fmaf(d, w, a.s);
  a.m2 = a.m2 + b.m2 + d * d * (a.n * w);
  a.n = n;
}

// The moments of channel ch over all row groups, merged in a fixed order
// by one warp; valid in lane 0.  part: [3][rgroups][c] float (K, s, M2).
__device__ Moments combine(const float* part, const Layout& L, int ch) {
  const int lane = threadIdx.x & 31;
  const long long plane = static_cast<long long>(L.rgroups) * L.c;
  Moments a{0.f, 0.f, 0.f, 0.f};
  for (int g = lane; g < L.rgroups; g += 32) {
    const long long i = static_cast<long long>(g) * L.c + ch;
    const Moments b{
        static_cast<float>(bn::row_bound(L, g + 1) - bn::row_bound(L, g)),
        __ldcg(part + i), __ldcg(part + plane + i),
        __ldcg(part + 2 * plane + i)};
    merge(a, b);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Moments b{__shfl_down_sync(0xffffffffu, a.n, off),
                    __shfl_down_sync(0xffffffffu, a.k, off),
                    __shfl_down_sync(0xffffffffu, a.s, off),
                    __shfl_down_sync(0xffffffffu, a.m2, off)};
    if (lane < off) merge(a, b);
  }
  return a;
}

template <int V, typename S>
__device__ __forceinline__ void accumulate(const S& v, const float (&k)[V],
                                           float (&s1)[V], float (&s2)[V]) {
  float f[V];
  bn::unpack(v, f);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = f[j] - k[j];
    s1[j] += d;
    s2[j] = fmaf(d, d, s2[j]);
  }
}

template <int V, typename S, typename P>
__device__ __forceinline__ void normalise(const S& v, P* out,
                                          const float (&k)[V],
                                          const float (&s)[V],
                                          const float (&pg)[V],
                                          const float (&b)[V]) {
  float f[V];
  bn::unpack(v, f);
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = fmaf((f[j] - k[j]) - s[j], pg[j], b[j]);
  bn::store(out, f);
}

template <typename T, int V>
__global__ void __launch_bounds__(bn::kThreads, 1)
    bn_forward_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* mu, float* psi, float* part, Layout L,
                      float eps) {
  using S = typename bn::Pack<T, V>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc = L.group_c / V;              // threads along the channels
  const int lanes = bn::kThreads / tc;
  const int tx = threadIdx.x % tc, lane = threadIdx.x / tc;
  const int cg = blockIdx.x % L.cgroups, rg = blockIdx.x / L.cgroups;
  const int ch = cg * L.group_c + tx * V;    // this thread's first channel
  const bool active = lane < lanes && ch < L.c;
  const long long r0 = bn::row_bound(L, rg);
  const long long rows = bn::row_bound(L, rg + 1) - r0;
  const long long kept = min(static_cast<long long>(L.kept), rows);
  S* tile = reinterpret_cast<S*>(smem);                      // [kept][tc]
  float* red = reinterpret_cast<float*>(smem + bn::tile_bytes(L, sizeof(T)));
  const long long cv = L.c / V;              // packs a row
  const S* xs = reinterpret_cast<const S*>(x) + r0 * cv + ch / V;
  S* ys = reinterpret_cast<S*>(y) + r0 * cv + ch / V;
  const long long plane = static_cast<long long>(L.rgroups) * L.c;
  float* pk = part + 3 * plane;              // [c] merged K, then s

  // 1. the block's shifted sums, its first kept rows copied on chip
  float k[V], s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = s1[j] = s2[j] = 0.f;
  if (active) {
    bn::unpack(xs[0], k);
    long long q = lane;
    for (; q + (kUnroll - 1) * lanes < rows; q += kUnroll * lanes) {
      S v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = xs[(q + u * lanes) * cv];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q + u * lanes < kept) tile[(q + u * lanes) * tc + tx] = v[u];
        accumulate<V>(v[u], k, s1, s2);
      }
    }
    for (; q < rows; q += lanes) {
      const S v = xs[q * cv];
      if (q < kept) tile[q * tc + tx] = v;
      accumulate<V>(v, k, s1, s2);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[lane * L.group_c + tx * V + j] = s1[j];
      red[(lanes + lane) * L.group_c + tx * V + j] = s2[j];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L.group_c; j += bn::kThreads) {
    const int c = cg * L.group_c + j;
    if (c >= L.c) break;
    float a = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {         // lanes in order
      a += red[l * L.group_c + j];
      b += red[(lanes + l) * L.group_c + j];
    }
    const float s = a / static_cast<float>(rows);
    const long long i = static_cast<long long>(rg) * L.c + c;
    part[i] = repro::to_f32(x[r0 * L.c + c]);
    part[plane + i] = s;
    part[2 * plane + i] = fmaxf(fmaf(-a, s, b), 0.f);
  }
  bn::grid_sync();

  // 2. the merge, each channel by one warp of the grid, published behind
  // a second barrier: (K, s) in part's last 2 x c, mu and psi
  const int warp = threadIdx.x / 32, warps = bn::kThreads / 32;
  for (int c = blockIdx.x * warps + warp; c < L.c; c += gridDim.x * warps) {
    const Moments m = combine(part, L, c);
    if ((threadIdx.x & 31) == 0) {
      pk[c] = m.k;
      pk[L.c + c] = m.s;
      mu[c] = m.k + m.s;
      psi[c] = rsqrtf(m.m2 / m.n + eps);
    }
  }
  bn::grid_sync();

  // 3. y, from the rows read again (last first), then from the tile
  if (!active) return;
  float s[V], pg[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    k[j] = __ldcg(pk + ch + j);
    s[j] = __ldcg(pk + L.c + ch + j);
    pg[j] = __ldcg(psi + ch + j) * gamma[ch + j];
    b[j] = beta[ch + j];
  }
  if (lane < rows) {
    long long q = lane + (rows - 1 - lane) / lanes * lanes;
    for (; q - (kUnroll - 1) * lanes >= kept; q -= kUnroll * lanes) {
      S v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = xs[(q - u * lanes) * cv];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        normalise<V>(v[u], ys + (q - u * lanes) * cv, k, s, pg, b);
    }
    for (; q >= kept; q -= lanes)
      normalise<V>(xs[q * cv], ys + q * cv, k, s, pg, b);
  }
#pragma unroll 4
  for (long long q = lane; q < kept; q += lanes)
    normalise<V>(tile[q * tc + tx], ys + q * cv, k, s, pg, b);
}

template <typename T, int V>
int launch(const void* x, const float* gamma, const float* beta, void* y,
           float* mu, float* psi, float* part, Layout L, int smem,
           float eps, cudaStream_t stream) {
  if (!bn::valid(L, V) ||
      bn::smem_bytes(L, sizeof(T), V, 1) != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  void* args[] = {&xp, &gamma, &beta, &yp, &mu, &psi, &part, &L, &eps};
  return static_cast<int>(
      bn::launch(bn_forward_kernel<T, V>, L, smem, args, stream));
}

template <typename T, int V>
int occupancy(int smem, int* blocks) {
  return static_cast<int>(
      bn::occupancy(bn_forward_kernel<T, V>, smem, blocks));
}

}  // namespace

// y (N_eff x C, x's type), mu[C] and psi[C] (float32) of x; gamma, beta
// float32 [C]; part float32 scratch of (3 rgroups + 2) x C.  The layout
// (vec, group_c, cgroups, rgroups, kept) and smem are
// core/gpu_model.py::bn_layout's; vec 4 (f32) or 8 (bf16) is the vector
// route, 1 the scalar route.  Returns a cudaError_t code.
extern "C" int bn_forward_launch(int dtype, const void* x, const void* gamma,
                                 const void* beta, void* y, void* mu,
                                 void* psi, void* part, long long n, int c,
                                 int vec, int group_c, int cgroups,
                                 int rgroups, int kept, int smem, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{n, c, group_c, cgroups, rgroups, kept};
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mu);
  float* p = static_cast<float*>(psi);
  float* w = static_cast<float*>(part);
  if (dtype == REPRO_F32 && vec == 4)
    return launch<float, 4>(x, g, b, y, m, p, w, L, smem, eps, s);
  if (dtype == REPRO_F32 && vec == 1)
    return launch<float, 1>(x, g, b, y, m, p, w, L, smem, eps, s);
  if (dtype == REPRO_BF16 && vec == 8)
    return launch<bf16, 8>(x, g, b, y, m, p, w, L, smem, eps, s);
  if (dtype == REPRO_BF16 && vec == 1)
    return launch<bf16, 1>(x, g, b, y, m, p, w, L, smem, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel for (dtype, vec) with `smem` bytes that one SM
// holds at once, into *blocks.  Returns a cudaError_t code.
extern "C" int bn_forward_occupancy(int dtype, int vec, int smem,
                                    int* blocks) {
  if (dtype == REPRO_F32 && vec == 4) return occupancy<float, 4>(smem, blocks);
  if (dtype == REPRO_F32 && vec == 1) return occupancy<float, 1>(smem, blocks);
  if (dtype == REPRO_BF16 && vec == 8) return occupancy<bf16, 8>(smem, blocks);
  if (dtype == REPRO_BF16 && vec == 1) return occupancy<bf16, 1>(smem, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(bn_forward)
