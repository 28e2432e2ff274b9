// Forward attention with an online softmax: causal and sliding-window masks,
// grouped-query heads.  q (B*H, S, D); k, v (B*KV, S, D); out (B*H, S, D)
// in q's type.
//
// Replaces the JAX package's Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:66) and keeps its arithmetic: logits
// q.k * (1/sqrt(D)) in float32, the running max, denominator and accumulator
// in float32, masked logits at -1e30 and masked probabilities zeroed, the
// denominator summed from the unrounded p, p rounded to v's type before
// P.V, and acc / max(l, 1e-30) at the end.  It always masks keys at or past
// S; the Pallas kernel pads K and V with zeros to its key tile and, without
// `causal`, lets the padded keys into the softmax (the oracle does not, and
// this kernel follows the oracle).  The KV head is read through
// b*n_kv + h/group, so K and V are never expanded; key tiles that the
// causal mask or the window masks out for a whole query tile are skipped,
// which leaves the result unchanged.  Offsets are 64-bit.
//
// Bound on the H100: operations.  At Qwen3-0.6B's prefill (32 query heads,
// 2048 tokens, head_dim 128, causal) the two products are 34.4 GFLOP
// against 67 MB of q, k, v and out, far above the card's 295 FLOP a byte.
//
// Two routes, chosen by the element type:
// * bf16, `flash_fwd_tc`, on the tensor cores (FlashAttention-2's layout):
//   one block of four warps for each (b*h, 64-query tile), each warp 16
//   query rows.  The query tiles are walked longest first (the causal
//   tail last), so the short tiles fill the card's last wave.  Q's
//   fragments are read once with ldmatrix and stay in registers; K and V
//   tiles of 64 keys sit in bf16 shared memory with rows padded by 16
//   bytes (ldmatrix reads them without bank conflicts), double-buffered
//   with cp.async so the next tile loads while this one computes.
//   S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with
//   float32 accumulators; the softmax runs on the S fragments, its row max
//   and sum across the four lanes that share a row (quad shuffles); P goes
//   from S's accumulator fragment to PV's A fragment in registers, rounded
//   to bf16, and never touches shared memory; V is read with ldmatrix.trans.
//   exp(x) is taken as exp2(x log2 e), one MUFU.EX2, and a key tile that no
//   mask touches for the whole block skips the mask: at 64-key tiles the
//   softmax's ALU work is of the order of the tile's mma.sync time.
//   Bases must be 16-byte aligned (cp.async moves 16 bytes).
//   At head_dim 256 (RecurrentGemma's local attention) a warp's output
//   fragments alone take 128 registers a thread, and Q's 64 more would
//   spill: there Q stays in shared memory (it does anyway) and each 16-wide
//   slice of it is read with ldmatrix when S = Q K^T needs it, once a key
//   tile.  The block's shared memory is 165 KB (Q, two K and two V tiles),
//   so one block runs on an SM.
// * float32, `flash_fwd`, on the CUDA cores: TF32 would break the float32
//   tolerance of 2e-5.  One block of 256 threads for each (b*h, 64-query
//   tile); Q, K and V tiles in shared memory; thread (ty, tx) owns query
//   rows 4ty..4ty+3 against keys tx + 16j and output columns tx + 16j, so
//   the running max, denominator and correction never leave the thread.
//   At head_dim 256 the tiles take 214 KB of shared memory, one block an SM.
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64, BKV = 64;
constexpr int LDQ = BQ + 4;      // Qs[d][row]: rows 16-byte aligned for float4
constexpr int LDK = BKV + 1;     // Ks[d][key]: conflict-free transposed stores
constexpr int LDP = BQ + 4;      // Ps[key][row]
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t smem_floats() {
  return D * LDQ + D * LDK + BKV * D + BKV * LDP;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
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
  const float* qb = q + static_cast<long long>(bh) * S * D;
  const float* kb = k + kvh * S * D;
  const float* vb = v + kvh * S * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[d * LDQ + r] = q0 + r < S ? qb[static_cast<long long>(q0 + r) * D + d]
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
      Ks[d * LDK + r] = in ? kb[g] : 0.f;
      Vs[r * D + d] = in ? vb[g] : 0.f;
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
        Ps[(tx + 16 * j) * LDP + 4 * ty + i] = p;
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

  float* ob = out + static_cast<long long>(bh) * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[static_cast<long long>(qpos) * D + tx + 16 * j] =
          o[i][j] * inv_l;
  }
}

// ---- bf16: tensor cores ---------------------------------------------------
constexpr int TC_THREADS = 128;  // four warps, 16 query rows each

template <int D>
constexpr size_t tc_smem() {     // Q, two K and two V tiles, rows padded
  return sizeof(bf16) * (BQ + 4 * BKV) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zeros where `in` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of D bf16 from row `row0` of a (S, D) matrix into [64][D + 8]
// shared memory, rows at or past S zero-filled; 16 bytes a copy.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int S) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int e = threadIdx.x; e < 64 * CH; e += TC_THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool in = row0 + r < S;
    cp_async16(dst + r * LD + c,
               src + static_cast<long long>(in ? row0 + r : 0) * D + c, in);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int n_heads, int n_kv, bool causal, int window,
                 float scale) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NK = BKV / 8;
  // Q's fragments in registers for the whole block, or read from shared
  // memory a key tile (head_dim 256: the registers hold O)
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                   // [2][BKV][LD]
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int group = n_heads / n_kv;
  const long long kvh = static_cast<long long>(bh / n_heads) * n_kv +
                        (bh % n_heads) / group;
  const bf16* qb = q + static_cast<long long>(bh) * S * D;
  const bf16* kb = k + kvh * S * D;
  const bf16* vb = v + kvh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // key tiles that can be unmasked for some query of this tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_begin / BKV, t_end = (k_end + BKV - 1) / BKV;

  load_rows<D>(Qs, qb, q0, S);
  load_rows<D>(Ks, kb, t_first * BKV, S);
  load_rows<D>(Vs, vb, t_first * BKV, S);
  cp_async_commit();

  uint32_t qf[kQRegs ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = t_first; t < t_end; ++t) {
    const int buf = (t - t_first) & 1;
    if (t + 1 < t_end) {       // the next tile loads while this one computes
      load_rows<D>(Ks + (buf ^ 1) * BKV * LD, kb, (t + 1) * BKV, S);
      load_rows<D>(Vs + (buf ^ 1) * BKV * LD, vb, (t + 1) * BKV, S);
    }
    cp_async_commit();
    cp_async_wait<1>();        // all but the newest group: this tile is in
    __syncthreads();
    // this lane's row and column offset in the warp's 16 rows of Q
    const bf16* q_lane =
        Qs + (warp * 16 + (lane / 8 % 2) * 8 + lane % 8) * LD + lane / 16 * 8;
    if constexpr (kQRegs) {
      if (t == t_first) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 16);
      }
    }
    const bf16* Kt = Ks + buf * BKV * LD;
    const bf16* Vt = Vs + buf * BKV * LD;
    const int k0 = t * BKV;

    // S = Q K^T: 16 rows x 64 keys a warp, eight n8 fragments
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, q_lane + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (jp * 16 + lane / 16 * 8 + lane % 8) * LD +
                           kk * 16 + (lane / 8 % 2) * 8);
        mma_16816(sc[2 * jp], qa, b[0], b[1]);
        mma_16816(sc[2 * jp + 1], qa, b[2], b[3]);
      }
    }

    // online softmax on the fragments: element e of fragment j is row
    // row[e / 2], key k0 + 8j + 2(lane % 4) + e % 2.  A tile that no mask
    // touches for any row of the block skips the mask.
    const bool whole = k0 + BKV <= S && (!causal || k0 + BKV - 1 <= q0) &&
                       (window <= 0 || k0 > q_last - window);
    uint32_t ok = 0xffffffffu;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (whole) {
          sc[j][e] *= scale;
        } else {
          const int kpos = k0 + 8 * j + 2 * (lane % 4) + e % 2;
          const int qpos = row[e / 2];
          const bool in = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          ok &= ~(static_cast<uint32_t>(!in) << (4 * j + e));
          sc[j][e] = in ? sc[j][e] * scale : kNegInf;
        }
        mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // exp(x) as 2^(x log2 e): one MUFU.EX2 a probability
        const float p = (ok >> (4 * j + e)) & 1u
                            ? exp2f((sc[j][e] - m_run[e / 2]) * kLog2e) : 0.f;
        rs[e / 2] += p;        // the denominator from the unrounded p
        sc[j][e] = p;
      }
    // this thread's share of each row's denominator; the quad sums them
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + rs[h];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V: P's accumulator fragments are PV's A fragments, in bf16
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
          pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
          pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
          pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_t(b, Vt + (kc * 16 + (lane / 8 % 2) * 8 + lane % 8) * LD +
                             dp * 16 + lane / 16 * 8);
        mma_16816(o[2 * dp], pa, b[0], b[1]);
        mma_16816(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();           // this buffer is free for the tile after next
  }

  bf16* ob = out + static_cast<long long>(bh) * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    if (row[h] >= S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<long long>(row[h]) * D + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int bh,
              int S, int n_heads, int n_kv, bool causal, int window,
              float scale, cudaStream_t stream) {
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_qt = (S + BQ - 1) / BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tc_smem<D>();
  cudaError_t err = repro::allow_smem(flash_fwd_tc<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_tc<D><<<dim3(bh, n_qt), TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, n_heads, n_kv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- launchers ---------------------------------------------------------------
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int S, int n_heads, int n_kv, bool causal, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = repro::allow_smem(flash_fwd<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, bh);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, n_heads,
      n_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Runs LAUNCH<D> (launch_f32<D> or launch_tc<D>) for head_dim d.
#define FLASH_DISPATCH_D(LAUNCH)                                            \
  switch (d) {                                                              \
    case 16: return LAUNCH<16>(q, k, v, out, bh, S, n_heads, n_kv, c, window, scale, s); \
    case 32: return LAUNCH<32>(q, k, v, out, bh, S, n_heads, n_kv, c, window, scale, s); \
    case 64: return LAUNCH<64>(q, k, v, out, bh, S, n_heads, n_kv, c, window, scale, s); \
    case 128: return LAUNCH<128>(q, k, v, out, bh, S, n_heads, n_kv, c, window, scale, s); \
    case 256: return LAUNCH<256>(q, k, v, out, bh, S, n_heads, n_kv, c, window, scale, s); \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

}  // namespace

// out = attention(q, k, v) for bh = B*H query heads of S positions and
// head_dim d in {16, 32, 64, 128, 256}; S, bh > 0: float32 on the CUDA cores,
// bf16 on the tensor cores (16-byte aligned bases, else
// cudaErrorMisalignedAddress).  Returns a cudaError_t code.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int bh, int S,
                                      int d, int n_heads, int n_kv,
                                      int causal, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == REPRO_F32) FLASH_DISPATCH_D(launch_f32)
  if (dtype == REPRO_BF16) FLASH_DISPATCH_D(launch_tc)
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING(flash_attention)
