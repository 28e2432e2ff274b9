// Fused DSE grid reduction: outer-add + first-occurrence min/argmin and
// max/argmax over the virtual int64 cost grid
//
//     grid[r, c] = conv_rows[s3_of[r], c] + simd_rows[v_of[r], c]
//
// without materialising it.  Returns [min, argmin, max, argmax] with flat
// row-major indices (r * nb + c), ties to the first occurrence.
//
// Replaces the JAX package's Pallas kernel kernels/reduce.py::
// grid_minmax_pallas (body _minmax_kernel).  The Pallas grid walks the rows
// in order on one core and resolves ties to the first occurrence through
// its strict running update.  A CUDA grid has no order, so every merge
// between threads, warps and blocks here is lexicographic on (value, flat
// index): the minimum keeps the smaller value, and on equal values the
// smaller index; the maximum mirrors it.  Any merge order then gives the
// same answer, with no atomics on values, so results are deterministic.
//
// Bound on an H100: memory.  The unique input is the conv panel (one int64
// per (distinct conv row, column)), the SIMD panel and the two projections;
// each candidate costs one int64 add and two int64 compares, six 32-bit
// integer instructions, well under the bytes' time on the INT32 pipes.
//
// Design (one launch a call):
// * Work items.  The grid is cut into items of one 64-column tile x at most
//   kMaxItemRows rows; block b walks items b, b + gridDim.x, ... (the
//   planner, kernels/reduce.py::launch_plan, keeps the grid to one wave).
// * Loads in two bursts an item, so that a block waits about two memory
//   round trips, not one a run: cp.async copies the item's s3_of/v_of rows
//   and, on the "shared" route, the tile's columns of every SIMD row into
//   shared memory; then, once the runs of equal s3_of are numbered (warp
//   ballots), one more burst copies the conv row of each run, 64 columns,
//   into a slot of its own (16 bytes a copy where the row is aligned, else
//   8), in two commit groups, so that the walk starts on the first half of
//   the runs while the second is in flight.  Each conv element is read
//   once per run of equal s3_of (the main path's s3_of is sorted: runs of
//   3.45 rows on the 128-step lattice).  An item with more runs than slots
//   takes them a window at a time.  When the SIMD rows do not fit beside
//   the staged rows and eight slots (n_simd above about 430), the "global"
//   route reads them through the read-only cache instead.
// * The walk reads shared memory only.  Each warp takes a contiguous slice
//   of a window's rows; lane l owns columns 2l and 2l + 1 of the tile and
//   holds its conv pair in registers while the run stays the same.
// * Strict compares.  Within one lane the flat index only grows, so a
//   strict compare on the value keeps the first occurrence; the lane
//   records a 32-bit row code on an update and forms the 64-bit flat index
//   once, at the item's end (a code never set means every value equalled
//   the sentinel, and the lane's first candidate is the first occurrence).
//   Lane states merge lexicographically across items, then by warp
//   shuffles and one shared-memory pass per block.
// * Last block merges.  Each block writes its partial and takes a ticket
//   (an acq_rel atomic); the block that takes the last ticket merges all
//   partials (read from L2) and writes the answer, then resets the ticket
//   for the next call on the same workspace.  The caller keeps one workspace per
//   (device, stream): calls on one stream run in order.
//
// Everything that indexes or accumulates is 64-bit: Table VIII training
// grids hold cycle counts past 2^31, and a flat index of a large grid can
// pass 2^31 too.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/reduce.py); the launch goes on the caller's stream.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned long long u64;

// What kernels/reduce.py::launch_plan decides; passed by pointer (outside
// the anonymous namespace: the C entry point takes it).
struct Plan {
  i64 n_rows, nb, n_simd;
  i64 rows_per_item, col_tiles, n_items;
  int route;      // 0: SIMD tile in shared memory, 1: SIMD from global
  int run_slots;  // runs a window holds
  int blocks;     // grid size, at most the workspace's partials
  int smem;       // dynamic shared memory bytes
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // columns of an item: 2 a lane
constexpr int kMaxItemRows = 256;    // rows of an item: a warp's ballot each

struct MinMax {
  i64 min_v, min_i, max_v, max_i;
};

#ifdef GRID_MINMAX_TRACE
// Built with -DGRID_MINMAX_TRACE (scripts/kernel_probe.py): the global
// timer (ns, columns 0-6) and the SM's clock (cycles, columns 8-14) of
// each block at its start, at the end of its first item's phases (rows
// and SIMD tile staged, runs numbered, first half of the runs landed,
// walked) and after its partial is merged; the last block also when the
// answer is written.  Nothing of it is compiled otherwise.
constexpr int kTraceBlocks = 2048;
__device__ long long grid_minmax_trace[kTraceBlocks][16];
__device__ __forceinline__ void mark(int point, bool on = true) {
  if (on && threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    grid_minmax_trace[blockIdx.x][point] = t;
    grid_minmax_trace[blockIdx.x][8 + point] = clock64();
  }
}
#else
__device__ __forceinline__ void mark(int, bool = true) {}
#endif

__device__ __forceinline__ void init(MinMax& s) {
  s.min_v = LLONG_MAX;
  s.min_i = LLONG_MAX;
  s.max_v = LLONG_MIN;
  s.max_i = LLONG_MAX;
}

// Lexicographic merge: a real candidate always has an index below the
// LLONG_MAX sentinel, so it wins against an empty state even when its
// value equals the sentinel value.
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

// Columns c and c + 1 of the row at p (c + 1 past the edge: c twice).
__device__ __forceinline__ void load_pair(const i64* p, bool two, i64& a,
                                          i64& b) {
  if (!two) {
    a = b = __ldg(p);
  } else if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const longlong2 q = __ldg(reinterpret_cast<const longlong2*>(p));
    a = q.x;
    b = q.y;
  } else {
    a = __ldg(p);
    b = __ldg(p + 1);
  }
}

// Asynchronous copies from global to shared memory (sm_80 and later), in
// commit groups.
__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's groups are in flight.
template <int pending>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// The conv pairs of runs [q0, q1) into `slots` (32 lanes a run): 16 bytes
// a copy where the row is aligned, else 8; a lane whose second column is
// past the edge gets its first column twice.
__device__ __forceinline__ void copy_runs(longlong2* slots,
                                          const i64* conv_rows,
                                          const i64* s3_sh,
                                          const int* run_row, int q0,
                                          int q1, i64 c0, i64 nb) {
  for (int idx = threadIdx.x; idx < (q1 - q0) * 32; idx += kThreads) {
    const i64 col = c0 + 2 * (idx & 31);
    if (col >= nb) continue;
    const i64* src = conv_rows + s3_sh[run_row[q0 + (idx >> 5)]] * nb + col;
    i64* dst = reinterpret_cast<i64*>(slots + idx);
    if (col + 1 < nb && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      copy16(dst, src);
    } else {
      copy8(dst, src);
      copy8(dst + 1, col + 1 < nb ? src + 1 : src);
    }
  }
  commit();
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
grid_minmax_kernel(const i64* __restrict__ conv_rows,
                   const i64* __restrict__ simd_rows,
                   const i64* __restrict__ s3_of,
                   const i64* __restrict__ v_of, Plan plan,
                   MinMax* __restrict__ partials,
                   unsigned* __restrict__ ticket, i64* __restrict__ out) {
  // [run_slots x 32 lanes] conv pairs, [n_simd][kTile] SIMD (shared
  // route), then the item's s3_of, v_of, (run slot, SIMD row) of each row
  // and the first row of each run
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int seg[kWarps];
  const i64 nb = plan.nb;
  const int R = (int)plan.rows_per_item;
  const int S = plan.run_slots;
  longlong2* slots = reinterpret_cast<longlong2*>(smem_raw);
  i64* simd_sh = reinterpret_cast<i64*>(slots + S * 32);
  i64* s3_sh = simd_sh + (kShared ? plan.n_simd * kTile : 0);
  i64* v_sh = s3_sh + R;
  int2* meta = reinterpret_cast<int2*>(v_sh + R);
  int* run_row = reinterpret_cast<int*>(meta + R);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  MinMax total;
  init(total);
  mark(0);
  for (i64 item = blockIdx.x; item < plan.n_items; item += gridDim.x) {
    const i64 r0 = (item / plan.col_tiles) * R;
    const i64 c0 = (item % plan.col_tiles) * kTile;
    const int nrow = (int)(r0 + R < plan.n_rows ? R : plan.n_rows - r0);
    __syncthreads();                  // the last item's readers are done
    // burst 1: the rows' projections; then the SIMD tile (the column past
    // an odd edge repeats the last one, as the conv slots do)
    for (int k = threadIdx.x; k < nrow; k += kThreads) {
      copy8(s3_sh + k, s3_of + r0 + k);
      copy8(v_sh + k, v_of + r0 + k);
    }
    commit();
    if (kShared) {
      for (int k = threadIdx.x; k < plan.n_simd * kTile; k += kThreads) {
        const i64 c = c0 + (k % kTile);
        const i64* row = simd_rows + (k / kTile) * nb;
        if (c < nb) {
          copy8(simd_sh + k, row + c);
        } else if (c == nb && (k & 1)) {
          copy8(simd_sh + k, row + c - 1);
        } else {
          simd_sh[k] = 0;
        }
      }
    }
    commit();
    wait_groups<1>();
    __syncthreads();
    mark(1, item == blockIdx.x);

    // number the runs of equal s3_of: warp w's ballot over rows 32w..
    const int k = warp * 32 + lane;
    const bool start = k < nrow && (k == 0 || s3_sh[k] != s3_sh[k - 1]);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    if (lane == 0) seg[warp] = __popc(starts);
    __syncthreads();
    int n_runs = 0, before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? seg[w] : 0;
      n_runs += seg[w];
    }
    if (k < nrow) {
      const int rid = before + __popc(starts & (0xffffffffu >> (31 - lane)))
                      - 1;
      // the run's slot and the SIMD row, in 16-byte units where shared
      meta[k] = make_int2(rid * 32, kShared ? (int)v_sh[k] * (kTile / 2)
                                            : (int)v_sh[k]);
      if (start) run_row[rid] = k;
    }
    __syncthreads();
    mark(2, item == blockIdx.x);

    // windows of up to S runs, each copied in two halves (two commit
    // groups): the walk takes the first half once it has landed, while the
    // second is still in flight
    const i64 c = c0 + 2 * lane;
    const bool live = c < nb;
    const longlong2* simd2 = reinterpret_cast<const longlong2*>(simd_sh) +
                             lane;
    int first = -1;                   // this warp's first row of the item
    i64 mn = LLONG_MAX, mx = LLONG_MIN, ca = 0, cb = 0;
    int mn_code = -1, mx_code = -1, cur = -1;
    for (int q0 = 0; q0 < n_runs; q0 += S) {
      const int q2 = q0 + S < n_runs ? q0 + S : n_runs;
      const int q1 = q0 + (q2 - q0 + 1) / 2;
      copy_runs(slots, conv_rows, s3_sh, run_row, q0, q1, c0, nb);
      copy_runs(slots + (q1 - q0) * 32, conv_rows, s3_sh, run_row, q1, q2,
                c0, nb);
      const longlong2* buf = slots + lane - q0 * 32;
      for (int half = 0; half < 2; ++half) {
        if (half == 0) {
          wait_groups<1>();
        } else {
          wait_groups<0>();
        }
        __syncthreads();
        mark(3, item == blockIdx.x && q0 == 0 && half == 0);
        const int qa = half == 0 ? q0 : q1, qb = half == 0 ? q1 : q2;
        const int ws = qa < n_runs ? run_row[qa] : nrow;
        const int we = qb < n_runs ? run_row[qb] : nrow;
        const int per = (we - ws + kWarps - 1) / kWarps;
        const int ra = ws + warp * per < we ? ws + warp * per : we;
        const int rb = ra + per < we ? ra + per : we;
        if (!live || ra >= rb) continue;
        if (first < 0) first = ra;
        for (int r = ra; r < rb; ++r) {
          const int2 m = meta[r];
          if (m.x != cur) {           // a new run: its conv pair
            const longlong2 q = buf[m.x];
            ca = q.x;
            cb = q.y;
            cur = m.x;
          }
          i64 sa, sb;
          if (kShared) {
            const longlong2 q = simd2[m.y];
            sa = q.x;
            sb = q.y;
          } else {
            load_pair(simd_rows + (i64)m.y * nb + c, c + 1 < nb, sa, sb);
          }
          const i64 g0 = (i64)((u64)ca + (u64)sa);   // wrap-around
          const i64 g1 = (i64)((u64)cb + (u64)sb);
          if (g0 < mn) { mn = g0; mn_code = 2 * r; }
          if (g0 > mx) { mx = g0; mx_code = 2 * r; }
          if (g1 < mn) { mn = g1; mn_code = 2 * r + 1; }
          if (g1 > mx) { mx = g1; mx_code = 2 * r + 1; }
        }
      }
      __syncthreads();                // the slots are free again
    }
    mark(4, item == blockIdx.x);
    if (first >= 0) {
      // a code still unset: every value equalled the sentinel, so the
      // lane's first candidate is the first occurrence
      if (mn_code < 0) mn_code = 2 * first;
      if (mx_code < 0) mx_code = 2 * first;
      MinMax s;
      s.min_v = mn;
      s.min_i = (r0 + (mn_code >> 1)) * nb + c + (mn_code & 1);
      s.max_v = mx;
      s.max_i = (r0 + (mx_code >> 1)) * nb + c + (mx_code & 1);
      merge(total, s);
    }
  }

  // this block's partial, then the last block to finish merges them all;
  // the ticket's acq_rel orders the partials before it for the last block
  __shared__ bool am_last;
  total = block_merge(total);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    unsigned t;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(ticket) : "memory");
    am_last = t == gridDim.x - 1;
  }
  __syncthreads();
  mark(5);
  if (!am_last) return;
  MinMax m;
  init(m);
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    MinMax o;
    o.min_v = __ldcg(&partials[k].min_v);   // from L2: written by others
    o.min_i = __ldcg(&partials[k].min_i);
    o.max_v = __ldcg(&partials[k].max_v);
    o.max_i = __ldcg(&partials[k].max_i);
    merge(m, o);
  }
  m = block_merge(m);
  if (threadIdx.x == 0) {
    out[0] = m.min_v;
    out[1] = m.min_i;
    out[2] = m.max_v;
    out[3] = m.max_i;
    *ticket = 0;                      // ready for the next call
  }
  mark(6);
}

}  // namespace

extern "C" {

// Bytes of one block's partial; the workspace holds one per block of the
// largest grid, then the ticket.
int grid_minmax_partial_bytes() { return (int)sizeof(MinMax); }

// Bytes of the plan the launch takes.
int grid_minmax_plan_bytes() { return (int)sizeof(Plan); }

#ifdef GRID_MINMAX_TRACE
// Copies the trace (kTraceBlocks x 16 int64) to `host`.
int grid_minmax_trace_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, grid_minmax_trace,
                                   sizeof(grid_minmax_trace));
}
#endif

const char* grid_minmax_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches the kernel on `stream` of `device`; returns the cudaError_t of
// the launch (0 on success).  The caller guarantees a plan from
// launch_plan, every s3_of/v_of entry a valid row of its operand, and a
// workspace of plan->blocks partials followed by a zeroed ticket.
int grid_minmax_launch(const Plan* plan, const i64* conv_rows,
                       const i64* simd_rows, const i64* s3_of,
                       const i64* v_of, void* partials, void* ticket,
                       i64* out, void* stream, int device) {
  if (plan->n_rows <= 0 || plan->nb <= 0 || plan->n_simd <= 0 ||
      plan->rows_per_item <= 0 || plan->rows_per_item > kMaxItemRows ||
      plan->run_slots <= 0 || plan->run_slots > plan->rows_per_item ||
      plan->blocks <= 0 || plan->n_items < plan->blocks ||
      (plan->route != 0 && plan->route != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = plan->route == 0 ? grid_minmax_kernel<true>
                                 : grid_minmax_kernel<false>;
  if (plan->smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan->smem);
  }
  if (err == cudaSuccess) {
    kernel<<<plan->blocks, kThreads, plan->smem, (cudaStream_t)stream>>>(
        conv_rows, simd_rows, s3_of, v_of, *plan, (MinMax*)partials,
        (unsigned*)ticket, out);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
