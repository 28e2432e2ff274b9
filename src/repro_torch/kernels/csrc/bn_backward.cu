// Training batch-norm backward over x, dy (N_eff, C), the paper's
// Algorithm 1 (Eqs. 25-28), given the forward's per-channel mu and
// psi = rsqrt(var + eps):
//   part 1: x^ = (x - mu) * psi, dgamma = sum dy * x^, dbeta = sum dy;
//   part 2: dx = (gamma * psi / N) * (N * dy - dgamma * x^ - dbeta).
// Returns dx in x's type and dgamma, dbeta in float32.
//
// Replaces the JAX package's Pallas kernel `bn_backward_pallas`
// (src/repro/kernels/bn.py:121, its `pl.pallas_call`s at :137 and :149,
// with `_part1_kernel` :95 and `_part2_kernel` :112).
//
// Bound on the H100: bytes.  x and dy read once and dx written once,
// 3 N*C elements, against about a dozen operations an element; at the
// ResNet-50 stem (401408 x 64, f32) that is 308 MB, 0.092 ms at
// 3.35 TB/s.
//
// Design: one persistent cooperative launch (bn_common.cuh), laid out by
// core/gpu_model.py::bn_layout, like bn_forward.cu.  What it does about
// what held the three-kernel form back:
//   * too few blocks: one block of 512 threads on each of the 132 SMs;
//   * narrow accesses: 16-byte loads and stores of neighbouring channel
//     packs, four rows of x and of dy in flight a thread; the scalar route
//     for a channel count no multiple of the pack width or an unaligned
//     base;
//   * three launches: part 1's sums, their combination and part 2 are one
//     kernel, with grid-wide barriers between them;
//   * five passes over N*C: a block keeps as many of its rows of x and dy
//     as its ~200 KB allow in shared memory (x and dy share the budget)
//     and computes part 2 on them there; only the rest is read again,
//     last row first, so that the rows read last come from L2.
// Part 1's float32 sums of dy * x^ and dy are combined over a block's
// lanes in a fixed order, then over the blocks in a fixed order (lane l
// of a warp takes blocks l, l + 32, ..., then a tree over the lanes):
// no atomics decide an order, so the same inputs give the same bits in
// every run.  A channel's combination is one warp's, the channels spread
// over all warps of the grid, published behind a second barrier (see
// bn_forward.cu for why not in every block).  Pallas writes x^
// in x's type in part 1 and reads it back in part 2 (Algorithm 1's
// buffer reuse, bn.py:107,142); here x^ is recomputed from x in float32
// and never stored, the oracle's unrounded x^ also for bfloat16.  N is
// the row count.  Offsets are 64-bit.
#include "bn_common.cuh"

namespace {

using bn::Layout;
using bn::kUnroll;

// dgamma and dbeta of channel ch over all row groups, summed in a fixed
// order by one warp; valid in lane 0.  part: [2][rgroups][c] float.
__device__ float2 combine(const float* part, const Layout& L, int ch) {
  const int lane = threadIdx.x & 31;
  const long long plane = static_cast<long long>(L.rgroups) * L.c;
  float g = 0.f, b = 0.f;
  for (int r = lane; r < L.rgroups; r += 32) {
    const long long i = static_cast<long long>(r) * L.c + ch;
    g += __ldcg(part + i);
    b += __ldcg(part + plane + i);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float g2 = __shfl_down_sync(0xffffffffu, g, off);
    const float b2 = __shfl_down_sync(0xffffffffu, b, off);
    if (lane < off) {
      g += g2;
      b += b2;
    }
  }
  return make_float2(g, b);
}

template <int V, typename S>
__device__ __forceinline__ void accumulate(const S& xv, const S& dv,
                                           const float (&m)[V],
                                           const float (&p)[V],
                                           float (&sg)[V], float (&sb)[V]) {
  float xf[V], df[V];
  bn::unpack(xv, xf);
  bn::unpack(dv, df);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xh = (xf[j] - m[j]) * p[j];   // Eq. 25
    sg[j] = fmaf(df[j], xh, sg[j]);           // Eq. 26
    sb[j] += df[j];                           // Eq. 27
  }
}

template <int V, typename S, typename P>
__device__ __forceinline__ void dx_of(const S& xv, const S& dv, P* out,
                                      const float (&m)[V],
                                      const float (&p)[V],
                                      const float (&pref)[V],
                                      const float (&g)[V],
                                      const float (&b)[V], float nf) {
  float xf[V], df[V];
  bn::unpack(xv, xf);
  bn::unpack(dv, df);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xh = (xf[j] - m[j]) * p[j];
    xf[j] = pref[j] * (nf * df[j] - g[j] * xh - b[j]);   // Eq. 28
  }
  bn::store(out, xf);
}

template <typename T, int V>
__global__ void __launch_bounds__(bn::kThreads, 1)
    bn_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma,
                       const float* __restrict__ mu,
                       const float* __restrict__ psi, T* __restrict__ dx,
                       float* dgamma, float* dbeta, float* part, Layout L) {
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
  const size_t tb = bn::tile_bytes(L, sizeof(T));
  S* xt = reinterpret_cast<S*>(smem);                        // [kept][tc]
  S* dt = reinterpret_cast<S*>(smem + tb);                   // [kept][tc]
  float* red = reinterpret_cast<float*>(smem + 2 * tb);  // [2][lanes][group_c]
  const long long cv = L.c / V;              // packs a row
  const long long off = r0 * cv + ch / V;
  const S* xs = reinterpret_cast<const S*>(x) + off;
  const S* ds = reinterpret_cast<const S*>(dy) + off;
  S* out = reinterpret_cast<S*>(dx) + off;
  const long long plane = static_cast<long long>(L.rgroups) * L.c;

  // part 1: the block's sums of dy * x^ and dy, its first kept rows of x
  // and dy copied on chip
  float m[V], p[V], sg[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = active ? mu[ch + j] : 0.f;
    p[j] = active ? psi[ch + j] : 0.f;
    sg[j] = sb[j] = 0.f;
  }
  if (active) {
    long long q = lane;
    for (; q + (kUnroll - 1) * lanes < rows; q += kUnroll * lanes) {
      S xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = xs[(q + u * lanes) * cv];
        dv[u] = ds[(q + u * lanes) * cv];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q + u * lanes < kept) {
          xt[(q + u * lanes) * tc + tx] = xv[u];
          dt[(q + u * lanes) * tc + tx] = dv[u];
        }
        accumulate<V>(xv[u], dv[u], m, p, sg, sb);
      }
    }
    for (; q < rows; q += lanes) {
      const S xv = xs[q * cv], dv = ds[q * cv];
      if (q < kept) {
        xt[q * tc + tx] = xv;
        dt[q * tc + tx] = dv;
      }
      accumulate<V>(xv, dv, m, p, sg, sb);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[lane * L.group_c + tx * V + j] = sg[j];
      red[(lanes + lane) * L.group_c + tx * V + j] = sb[j];
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
    const long long i = static_cast<long long>(rg) * L.c + c;
    part[i] = a;
    part[plane + i] = b;
  }
  bn::grid_sync();

  // the combination, each channel by one warp of the grid, published
  // behind a second barrier in dgamma and dbeta
  const int warp = threadIdx.x / 32, warps = bn::kThreads / 32;
  for (int c = blockIdx.x * warps + warp; c < L.c; c += gridDim.x * warps) {
    const float2 s = combine(part, L, c);
    if ((threadIdx.x & 31) == 0) {
      dgamma[c] = s.x;
      dbeta[c] = s.y;
    }
  }
  bn::grid_sync();

  // part 2: dx, from the rows read again (last first), then from the tiles
  if (!active) return;
  const float nf = static_cast<float>(L.n);
  float pref[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    g[j] = __ldcg(dgamma + ch + j);
    b[j] = __ldcg(dbeta + ch + j);
    pref[j] = gamma[ch + j] * p[j] / nf;       // Algorithm 1, line 14
  }
  if (lane < rows) {
    long long q = lane + (rows - 1 - lane) / lanes * lanes;
    for (; q - (kUnroll - 1) * lanes >= kept; q -= kUnroll * lanes) {
      S xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = xs[(q - u * lanes) * cv];
        dv[u] = ds[(q - u * lanes) * cv];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        dx_of<V>(xv[u], dv[u], out + (q - u * lanes) * cv, m, p, pref, g, b,
                 nf);
    }
    for (; q >= kept; q -= lanes)
      dx_of<V>(xs[q * cv], ds[q * cv], out + q * cv, m, p, pref, g, b, nf);
  }
#pragma unroll 4
  for (long long q = lane; q < kept; q += lanes)
    dx_of<V>(xt[q * tc + tx], dt[q * tc + tx], out + q * cv, m, p, pref, g, b,
             nf);
}

template <typename T, int V>
int launch(const void* x, const void* dy, const float* gamma,
           const float* mu, const float* psi, void* dx, float* dg, float* db,
           float* part, Layout L, int smem, cudaStream_t stream) {
  if (!bn::valid(L, V) ||
      bn::smem_bytes(L, sizeof(T), V, 2) != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  void* args[] = {&xp, &dp, &gamma, &mu, &psi, &op, &dg, &db, &part, &L};
  return static_cast<int>(
      bn::launch(bn_backward_kernel<T, V>, L, smem, args, stream));
}

template <typename T, int V>
int occupancy(int smem, int* blocks) {
  return static_cast<int>(
      bn::occupancy(bn_backward_kernel<T, V>, smem, blocks));
}

}  // namespace

// dx (N_eff x C, x's type), dgamma[C] and dbeta[C] (float32) of x and dy
// (both N_eff x C, one type); gamma, mu, psi float32 [C]; part float32
// scratch of 2 rgroups x C.  The layout (vec, group_c, cgroups, rgroups,
// kept) and smem are core/gpu_model.py::bn_layout's for two
// tensors.  Returns a cudaError_t code.
extern "C" int bn_backward_launch(int dtype, const void* x, const void* dy,
                                  const void* gamma, const void* mu,
                                  const void* psi, void* dx, void* dgamma,
                                  void* dbeta, void* part, long long n, int c,
                                  int vec, int group_c, int cgroups,
                                  int rgroups, int kept, int smem,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{n, c, group_c, cgroups, rgroups, kept};
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mu);
  const float* p = static_cast<const float*>(psi);
  float* dgp = static_cast<float*>(dgamma);
  float* dbp = static_cast<float*>(dbeta);
  float* w = static_cast<float*>(part);
  if (dtype == REPRO_F32 && vec == 4)
    return launch<float, 4>(x, dy, g, m, p, dx, dgp, dbp, w, L, smem, s);
  if (dtype == REPRO_F32 && vec == 1)
    return launch<float, 1>(x, dy, g, m, p, dx, dgp, dbp, w, L, smem, s);
  if (dtype == REPRO_BF16 && vec == 8)
    return launch<bf16, 8>(x, dy, g, m, p, dx, dgp, dbp, w, L, smem, s);
  if (dtype == REPRO_BF16 && vec == 1)
    return launch<bf16, 1>(x, dy, g, m, p, dx, dgp, dbp, w, L, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel for (dtype, vec) with `smem` bytes that one SM
// holds at once, into *blocks.  Returns a cudaError_t code.
extern "C" int bn_backward_occupancy(int dtype, int vec, int smem,
                                     int* blocks) {
  if (dtype == REPRO_F32 && vec == 4) return occupancy<float, 4>(smem, blocks);
  if (dtype == REPRO_F32 && vec == 1) return occupancy<float, 1>(smem, blocks);
  if (dtype == REPRO_BF16 && vec == 8) return occupancy<bf16, 8>(smem, blocks);
  if (dtype == REPRO_BF16 && vec == 1) return occupancy<bf16, 1>(smem, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(bn_backward)
