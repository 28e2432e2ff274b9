// Forward attention with an online softmax: causal and sliding-window masks,
// grouped-query heads.  q (B*H, S, D); k, v (B*KV, S, D); out (B*H, S, D)
// in q's type.
//
// Replaces the JAX package's Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:66) and keeps its arithmetic: logits
// q.k * (1/sqrt(D)) in float32, the running max, denominator and accumulator
// in float32, masked logits at -1e30 and masked probabilities zeroed, p
// rounded to v's type before P.V, and acc / max(l, 1e-30) at the end.  It
// always masks keys at or past S; the Pallas kernel pads K and V with zeros
// to its key tile and, without `causal`, lets the padded keys into the
// softmax (the oracle does not, and this kernel follows the oracle).
//
// Bound on the H100: operations.  At Qwen3-0.6B's prefill (32 query heads,
// 2048 tokens, head_dim 128, causal) the two products are 34.4 GFLOP
// against 67 MB of q, k, v and out, far above the card's 295 FLOP a byte.
//
// Design, simple first: one block of 256 threads for each (b*h, 64-query
// tile), looping over 64-key tiles.  Q stays in shared memory for the whole
// loop; each K and V tile is read into shared memory once for the block
// and shared by its 64 queries.  The KV head is read through
// b*n_kv + h/group, so K and V are never expanded.  Thread (ty, tx) owns
// query rows 4ty..4ty+3: it computes their logits against keys tx + 16j,
// reduces row max and row sum over the 16 lanes of its half-warp with
// shuffles, and accumulates the output columns tx + 16j of those rows in
// registers; so the running max, denominator and correction never leave
// the thread.  Key tiles that the causal mask or the window masks out for
// the whole query tile are skipped, which leaves the result unchanged.
// Both products use CUDA-core float32 FMAs (bf16 inputs are widened; their
// products are exact in float32).  Offsets are 64-bit.  Later work: the
// products on the tensor cores (wgmma), TMA loads, a deeper pipeline.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64, BKV = 64;
constexpr int LDQ = BQ + 4;      // Qs[d][row]: rows 16-byte aligned for float4
constexpr int LDK = BKV + 1;     // Ks[d][key]: conflict-free transposed stores
constexpr int LDP = BQ + 4;      // Ps[key][row]
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  return D * LDQ + D * LDK + BKV * D + BKV * LDP;
}

template <typename T>
__device__ __forceinline__ float round_like(float p) {
  return repro::to_f32(repro::from_f32<T>(p));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S,
              int n_heads, int n_kv, bool causal, int window, float scale) {
  constexpr int ND = D / 16;     // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // [D][LDQ]
  float* Ks = Qs + D * LDQ;                // [D][LDK]
  float* Vs = Ks + D * LDK;                // [BKV][D]
  float* Ps = Vs + BKV * D;                // [BKV][LDP]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int group = n_heads / n_kv;
  const long long kvh = static_cast<long long>(bh / n_heads) * n_kv +
                        (bh % n_heads) / group;
  const T* qb = q + static_cast<long long>(bh) * S * D;
  const T* kb = k + kvh * S * D;
  const T* vb = v + kvh * S * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[d * LDQ + r] = q0 + r < S ? repro::to_f32(qb[static_cast<long long>(
                                       q0 + r) * D + d])
                                 : 0.f;
  }

  float m[4], l[4], o[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[i][j] = 0.f;
  }

  // key range that can be unmasked for some query of this tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / BKV) * BKV; k0 < k_end; k0 += BKV) {
    __syncthreads();             // the last tile's Ks, Vs, Ps are consumed
    for (int e = tid; e < BKV * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < S;
      const long long g = static_cast<long long>(k0 + r) * D + d;
      Ks[d * LDK + r] = in ? repro::to_f32(kb[g]) : 0.f;
      Vs[r * D + d] = in ? repro::to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * LDQ + 4 * ty]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Ks[d * LDK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qa[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(tx + 16 * j) * LDP + 4 * ty + i] = round_like<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) o[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BKV; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[key * LDP + 4 * ty]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = Vs[key * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pa[i], vv, o[i][j]);
      }
    }
  }

  T* ob = out + static_cast<long long>(bh) * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[static_cast<long long>(qpos) * D + tx + 16 * j] =
          repro::from_f32<T>(o[i][j] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int S, int n_heads, int n_kv, bool causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = repro::allow_smem(flash_fwd<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, bh);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, n_heads, n_kv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int bh, int S, int n_heads, int n_kv, bool causal, int window,
             float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, bh, S, n_heads, n_kv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, bh, S, n_heads, n_kv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, bh, S, n_heads, n_kv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, bh, S, n_heads, n_kv, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out = attention(q, k, v) for bh = B*H query heads of S positions and
// head_dim d in {16, 32, 64, 128}; S, bh > 0.  Returns a cudaError_t code.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int bh, int S,
                                      int d, int n_heads, int n_kv,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_d<float>(d, q, k, v, out, bh, S, n_heads, n_kv, causal != 0,
                           window, scale, s);
  if (dtype == REPRO_BF16)
    return launch_d<bf16>(d, q, k, v, out, bh, S, n_heads, n_kv, causal != 0,
                          window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(flash_attention)
