// K5 startree_agg: residual aggregation over the pre-aggregated star-tree
// records that the host traversal selected, over stacked segment blocks
// [S, D] of pre-agg rows, packed as [S, 1 + sum(w)] (flat: the selected
// record count, then each slot) or [S, G, 1 + sum(w)] (grouped by the
// mixed-radix key sum_d stid[d] * stride[d]: the group's record count,
// then each slot).
//
// Replaces pinot_tpu/ops/startree_device.py:99 `make_startree_kernel` and
// :81 `_grouped_usum`, and, with its member axis, :152
// `make_batched_startree_kernel` (K5 under vmap over B coalesced queries).
//
// The member axis, as K1-K4 carry it (csrc/interp.cuh): one launch computes
// B members of one plan over U column sets, member m reading set set_of[m]
// (its pre-agg rows and record counts) and its own selection mask sel[m],
// and writing its own [S, ...] output. Broadcast is U = 1, stacked U = B,
// dedup a member-to-set map; no [B, S, D] stack is copied. The grid's z
// axis is the member, and the block partition of a segment depends on D
// and its record count only, so a member's flat result is bit for bit its
// single launch's. The kernels are templates on BATCH: the single launch
// (B = 1) compiles its own body with the member and its set fixed at 0, so
// it spends no registers on the member axis.
//
// Slots: usum (an exact sum of a non-negative integral pair below 2^48,
// staged as two 24-bit digit rows; each digit is cut into 4 planes of 7
// bits whose int sums stay exact: 127 * 2^24 < 2^31; each plane sum s is
// written as the halves (s >> 12, s & 4095)), sum (a float pair, added in
// double and rounded once to the value dtype), min and max (in the value
// dtype; NaN sticks). A record counts where sel[s, r] and r < num_docs[s].
//
// Bound on an H100: bytes. A record reads its 1-byte mask and, where
// selected, 4-8 bytes per staged column, against a few integer operations
// per plane: far below the card's compute rate. At the star-tree leg's
// own shapes (8 segments of at most 128-2048 pre-agg records) those bytes
// take nanoseconds, and what a call costs is its launches: the first
// design ran two kernels flat and three grouped (an init, the pass, a
// finalize) for a few blocks of work, and the host's wrapper paces the
// calls (PERF.md §6, K5's findings).
//
// Design: grid (blocks per segment, S), 256 threads, each block over one
// contiguous record range of one segment. Where a segment takes one block
// (nb = 1, the leg's shapes) and the launch is flat or its [G, A] table
// fits shared memory (`one_pass`), the call is one kernel: the block
// initialises its table, aggregates its segment and writes its packed
// rows in the value dtype itself, with no init kernel, finalize kernel,
// memset or scratch. Several blocks a segment (phase 3's S = 16, D = 2^20
// cases) or a table past shared memory (G = 2^14) keep a second pass:
// flat, the blocks' partials and a finalize kernel; grouped, an init
// kernel, the pass and a finalize kernel. The wrapper builds StArgs' plan
// constants (slot ops, strides, the accumulator map) once a plan and sets
// only the pointers a call (ops/_cuda.py `_st_layout`).
// - Flat: one pass per slot over the block's records, the lanes stepping
//   together and a rejected record contributing the slot's identity (no
//   `continue`); accumulators in registers (int planes, double sums,
//   min / max), then a block reduction in a fixed order (warp shuffles,
//   then the warps in order) into a per-block row of a [S, nb, A] partial
//   buffer. A finalize pass combines the nb rows of each accumulator column
//   in block order: counts, planes and min / max are bit for bit the plain
//   version's, float sums are the same every run.
// - Grouped: a [G, A] table of double accumulators in shared memory while
//   it fits (96 KB); selected records update it with shared-memory atomics
//   (a rejected record reads nothing beyond its mask and updates nothing,
//   but its lane steps with the warp: no `continue`) and the block merges
//   the entries it touched into a [S, G, A] float64 table with global
//   atomics, as K2 does. Beyond 96 KB the records update the global table
//   directly. Counts and planes are integers below 2^53 in
//   double, so their atomic sums are exact in any order; min / max are
//   order-free; float sums take the order of the atomics (a tolerance). A
//   finalize pass (or, in one pass, the block) writes the value dtype,
//   empty groups keeping the identities (0, +inf for min, -inf for max),
//   as the plain version's fill.
#include <cuda_runtime.h>
#include <math.h>

#include "smem_limit.cuh"

#define ST_THREADS 256
#define ST_MAX_SLOTS 16
#define ST_MAX_DIMS 8
#define ST_USUM_PLANES 4
#define ST_USUM_BITS 7
#define ST_MAX_ACC (1 + 2 * ST_USUM_PLANES * ST_MAX_SLOTS)
#define ST_MAX_SETS 16     // column sets per launch (ops/_cuda.py MAX_SETS)
#define ST_MAX_MEMBERS 16  // members per launch (ops/_cuda.py MAX_MEMBERS)
#define ST_SMEM_TABLE_BYTES (96 * 1024)

enum { OP_USUM = 0, OP_SUM = 1, OP_MIN = 2, OP_MAX = 3 };

// ops/_cuda.py `_StArgs`, passed by value: 6,448 bytes, inside the
// 32,764 bytes of kernel parameters that CUDA 12.1 and later allow on sm_70
// and later. Per column set u: a[u] / b[u] / gid[u]; per member m: sel[m]
// and set_of[m]. acc_op / acc_out: per accumulator column, how it combines
// (count and float sums OP_SUM, exact-sum planes OP_USUM) and the output
// column it is written to (a plane writes two).
struct StArgs {
  const void* a[ST_MAX_SETS][ST_MAX_SLOTS];  // usum: hi digit rows (int32);
                                             // else values
  const int* b[ST_MAX_SETS][ST_MAX_SLOTS];   // usum: lo digit rows (int32)
  const int* gid[ST_MAX_SETS][ST_MAX_DIMS];  // group dimension codes (int32)
  const unsigned char* sel[ST_MAX_MEMBERS];  // [S, D] selection masks
  int set_of[ST_MAX_MEMBERS];
  int op[ST_MAX_SLOTS];
  int stride[ST_MAX_DIMS];
  int acc_op[ST_MAX_ACC];
  int acc_out[ST_MAX_ACC];
  int nslot, ndim;
};

__device__ __forceinline__ double identity_of(int op) {
  return op == OP_MIN ? INFINITY : op == OP_MAX ? -INFINITY : 0.0;
}

// A double's bits as a signed integer in their total order (-0.0 below
// +0.0), as interp.cuh `order_key`.
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFll);
}
#define ST_QNAN __longlong_as_double(0x7FF8000000000000ll)

// min / max as XLA takes them (ops/kernels.py `minmax_combine`): NaN
// sticks as the quiet NaN, and -0.0 ranks below +0.0 in either order.
__device__ __forceinline__ double combine(int op, double x, double v) {
  if (op == OP_MIN || op == OP_MAX) {
    if (x != x || v != v) return ST_QNAN;
    const bool pick = op == OP_MIN ? order_key(v) < order_key(x)
                                   : order_key(v) > order_key(x);
    return pick ? v : x;
  }
  return x + v;
}

// The same through compare-and-swap on a table entry: a NaN entry is
// final; a value replaces the entry only when it ranks past it.
__device__ __forceinline__ void atomic_minmax(int op, double* addr, double v) {
  unsigned long long* p = (unsigned long long*)addr;
  unsigned long long old = *(volatile unsigned long long*)p;
  if (v != v) v = ST_QNAN;
  while (true) {
    const double cur = __longlong_as_double(old);
    if (cur != cur) return;
    if (v == v && !(op == OP_MIN ? order_key(v) < order_key(cur)
                                 : order_key(v) > order_key(cur)))
      return;
    const unsigned long long seen = atomicCAS(p, old, __double_as_longlong(v));
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_combine(int op, double* addr, double v) {
  if (op == OP_MIN || op == OP_MAX) atomic_minmax(op, addr, v);
  else atomicAdd(addr, v);
}

// Combines v over the block in a fixed order (warp shuffles, then the
// warps' results in warp order) and stores the result at *dst.
__device__ void block_store(int op, double v, double* wbuf, double* dst) {
  for (int o = 16; o > 0; o >>= 1)
    v = combine(op, v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) wbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double r = wbuf[0];
    for (int w = 1; w < ST_THREADS / 32; ++w) r = combine(op, r, wbuf[w]);
    *dst = r;
  }
  __syncthreads();
}

// Writes accumulator value r of column c into an output row.
template <typename T>
__device__ __forceinline__ void put(const StArgs& a, int c, double r, T* o) {
  const int col = a.acc_out[c];
  if (a.acc_op[c] == OP_USUM) {
    const int v = (int)r;
    o[col] = (T)(v >> 12);
    o[col + 1] = (T)(v & 4095);
  } else {
    o[col] = (T)r;
  }
}

// nrec: [U, S] record counts. ONE (a block a segment): the block writes
// its row of out [B, S, W] itself; else its row of partial [B, S, nb, A].
template <typename T, bool BATCH, bool ONE>
__global__ void __launch_bounds__(ST_THREADS)
startree_flat(const __grid_constant__ StArgs a,
              const int* __restrict__ nrec, int D, int A, int W,
              double* __restrict__ partial, T* __restrict__ out) {
  __shared__ double wbuf[ST_THREADS / 32];
  __shared__ double res[ST_MAX_ACC];
  const int s = blockIdx.y, b = blockIdx.x, nb = gridDim.x, S = gridDim.y;
  const int m = BATCH ? (int)blockIdx.z : 0;
  const int u = BATCH ? a.set_of[m] : 0;
  const int n = max(0, min(nrec[(long long)u * S + s], D));
  const int per = (n + nb - 1) / nb;
  const int start = min(n, b * per), end = min(n, start + per);
  const long long base = (long long)s * D;
  const unsigned char* srow = a.sel[m] + base;
  double* prow =
      ONE ? res : partial + (((long long)m * S + s) * nb + b) * A;

  int cnt = 0;
  for (int d = start + threadIdx.x; d < end; d += ST_THREADS)
    cnt += srow[d] != 0;
  block_store(OP_SUM, (double)cnt, wbuf, prow);
  int off = 1;
  for (int j = 0; j < a.nslot; ++j) {
    const int op = a.op[j];
    if (op == OP_USUM) {
      const int* hi = (const int*)a.a[u][j] + base;
      const int* lo = a.b[u][j] + base;
      int ph[ST_USUM_PLANES] = {0, 0, 0, 0}, pl[ST_USUM_PLANES] = {0, 0, 0, 0};
      for (int d = start + threadIdx.x; d < end; d += ST_THREADS) {
        const bool m = srow[d] != 0;
        const int vh = m ? hi[d] : 0, vl = m ? lo[d] : 0;
#pragma unroll
        for (int k = 0; k < ST_USUM_PLANES; ++k) {
          ph[k] += (vh >> (ST_USUM_BITS * k)) & 127;
          pl[k] += (vl >> (ST_USUM_BITS * k)) & 127;
        }
      }
      for (int k = 0; k < ST_USUM_PLANES; ++k)
        block_store(OP_SUM, (double)ph[k], wbuf, prow + off + k);
      for (int k = 0; k < ST_USUM_PLANES; ++k)
        block_store(OP_SUM, (double)pl[k], wbuf,
                    prow + off + ST_USUM_PLANES + k);
      off += 2 * ST_USUM_PLANES;
    } else {
      const T* v = (const T*)a.a[u][j] + base;
      const double id = identity_of(op);
      double acc = id;
      for (int d = start + threadIdx.x; d < end; d += ST_THREADS) {
        const bool m = srow[d] != 0;
        acc = combine(op, acc, m ? (double)v[d] : id);
      }
      block_store(op, acc, wbuf, prow + off);
      off += 1;
    }
  }
  if (ONE) {  // block_store's last barrier published res
    T* o = out + ((long long)m * S + s) * W;
    for (int c = threadIdx.x; c < A; c += ST_THREADS)
      put<T>(a, c, res[c], o);
  }
}

// grid (S, B): row (m, s) of the [B, S, nb, A] partials into out[m, s].
template <typename T>
__global__ void startree_flat_finalize(const __grid_constant__ StArgs a,
                                       const double* __restrict__ partial,
                                       int nb, int A, int W,
                                       T* __restrict__ out) {
  const long long s = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const double* p = partial + s * nb * A;
  for (int c = threadIdx.x; c < A; c += blockDim.x) {
    const int op = a.acc_op[c] == OP_USUM ? OP_SUM : a.acc_op[c];
    double r = p[c];
    for (int b = 1; b < nb; ++b) r = combine(op, r, p[(long long)b * A + c]);
    put<T>(a, c, r, out + s * W);
  }
}

__global__ void startree_group_init(const __grid_constant__ StArgs a,
                                    long long n, int A,
                                    double* __restrict__ table) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    table[e] = identity_of(a.acc_op[e % A]);
}

// nrec: [U, S]; table: [B, S, G, A]. ONE (a block a segment, its table
// in shared memory): the block writes its rows of out [B, S, G, W] itself,
// and `table` is not read.
template <typename T, bool BATCH, bool ONE>
__global__ void __launch_bounds__(ST_THREADS)
startree_group(const __grid_constant__ StArgs a,
               const int* __restrict__ nrec, int D, int G, int A, int W,
               int use_smem, double* __restrict__ table,
               T* __restrict__ out) {
  extern __shared__ double tab[];
  const int s = blockIdx.y, b = blockIdx.x, nb = gridDim.x, S = gridDim.y;
  const int m = BATCH ? (int)blockIdx.z : 0;
  const int u = BATCH ? a.set_of[m] : 0;
  const long long entries = (long long)G * A;
  double* seg_table =
      ONE ? nullptr : table + ((long long)m * S + s) * entries;
  double* my = use_smem ? tab : seg_table;
  if (use_smem) {
    for (int e = threadIdx.x; e < entries; e += blockDim.x)
      tab[e] = identity_of(a.acc_op[e % A]);
    __syncthreads();
  }

  const int n = max(0, min(nrec[(long long)u * S + s], D));
  const int per = (n + nb - 1) / nb;
  const int start = min(n, b * per), end = min(n, start + per);
  const long long base = (long long)s * D;
  const unsigned char* sel = a.sel[m];
  // Every lane of a warp takes the same steps and the warp reconverges at
  // the end of each, as in K3: a rejected record (or one whose key XLA
  // would drop) updates nothing, but its lane does not run ahead.
  for (int d0 = start; d0 < end; d0 += ST_THREADS) {
    const int d = d0 + threadIdx.x;
    const long long i = base + d;
    int key = -1;
    if (d < end && sel[i] != 0) {
      key = 0;
      for (int g = 0; g < a.ndim; ++g) key += a.gid[u][g][i] * a.stride[g];
    }
    if (key >= 0 && key < G) {
      double* row = my + (long long)key * A;
      atomicAdd(row, 1.0);
      int off = 1;
      for (int j = 0; j < a.nslot; ++j) {
        const int op = a.op[j];
        if (op == OP_USUM) {
          const int vh = ((const int*)a.a[u][j])[i], vl = a.b[u][j][i];
          for (int k = 0; k < ST_USUM_PLANES; ++k) {
            atomicAdd(row + off + k,
                      (double)((vh >> (ST_USUM_BITS * k)) & 127));
            atomicAdd(row + off + ST_USUM_PLANES + k,
                      (double)((vl >> (ST_USUM_BITS * k)) & 127));
          }
          off += 2 * ST_USUM_PLANES;
        } else {
          atomic_combine(op, row + off, (double)((const T*)a.a[u][j])[i]);
          off += 1;
        }
      }
    }
    __syncwarp();
  }

  if (ONE) {  // the whole segment's table: the packed rows, identities kept
    __syncthreads();
    T* o = out + ((long long)m * S + s) * G * W;
    for (int e = threadIdx.x; e < entries; e += blockDim.x)
      put<T>(a, e % A, tab[e], o + (e / A) * W);
  } else if (use_smem) {
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += blockDim.x) {
      const int c = e % A;
      const int op = a.acc_op[c] == OP_USUM ? OP_SUM : a.acc_op[c];
      const double x = tab[e];
      if (!(x == identity_of(op))) atomic_combine(op, seg_table + e, x);
    }
  }
}

template <typename T>
__global__ void startree_group_finalize(const __grid_constant__ StArgs a,
                                        long long n, int A, int W,
                                        const double* __restrict__ table,
                                        T* __restrict__ out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    put<T>(a, (int)(e % A), table[e], out + (e / A) * W);
}

// Whether a launch runs in one pass (one kernel, no scratch): a block a
// segment, flat or with its [G, A] table in shared memory. The wrapper
// asks it through `pt_startree_one_pass` before it sizes the scratch.
static bool one_pass(int G, int nb, int A) {
  return nb == 1 && (size_t)G * A * sizeof(double) <= ST_SMEM_TABLE_BYTES;
}

extern "C" int pt_startree_one_pass(int G, int nb, int A) {
  return one_pass(G, nb, A) ? 1 : 0;
}

template <typename T, bool BATCH>
static int launch(const StArgs* a, const int* nrec, int S, int D, int G,
                  int nb, int A, int W, int B, double* scratch, T* out,
                  cudaStream_t st) {
  const dim3 grid(nb, S, B);
  const bool one = one_pass(G, nb, A);
  if (!one && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (G == 0) {
    if (one) {
      startree_flat<T, BATCH, true><<<grid, ST_THREADS, 0, st>>>(
          *a, nrec, D, A, W, scratch, out);
      return (int)cudaGetLastError();
    }
    startree_flat<T, BATCH, false><<<grid, ST_THREADS, 0, st>>>(
        *a, nrec, D, A, W, scratch, out);
    startree_flat_finalize<T><<<dim3(S, B), 128, 0, st>>>(*a, scratch, nb, A,
                                                         W, out);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)G * A * sizeof(double);
  const int use_smem = smem <= ST_SMEM_TABLE_BYTES;
  if (use_smem) {  // each function's own flag: a limit is a function's
    static std::atomic<unsigned> one_set{0}, two_set{0};
    const cudaError_t e =
        one ? pt_smem_limit_max(startree_group<T, BATCH, true>, &one_set)
            : pt_smem_limit_max(startree_group<T, BATCH, false>, &two_set);
    if (e != cudaSuccess) return (int)e;
  }
  if (one) {
    startree_group<T, BATCH, true><<<grid, ST_THREADS, smem, st>>>(
        *a, nrec, D, G, A, W, use_smem, scratch, out);
    return (int)cudaGetLastError();
  }
  const long long n = (long long)B * S * G * A;
  const long long tb = (n + ST_THREADS - 1) / ST_THREADS;
  const int flat = (int)(tb < 4096 ? (tb > 0 ? tb : 1) : 4096);
  startree_group_init<<<flat, ST_THREADS, 0, st>>>(*a, n, A, scratch);
  startree_group<T, BATCH, false>
      <<<grid, ST_THREADS, use_smem ? smem : 0, st>>>(*a, nrec, D, G, A, W,
                                                      use_smem, scratch, out);
  startree_group_finalize<T><<<flat, ST_THREADS, 0, st>>>(*a, n, A, W,
                                                          scratch, out);
  return (int)cudaGetLastError();
}

// The floor of one call: an empty kernel, launched as K5's entry point
// launches (device set, the caller's stream). Not a port of anything:
// measurement scripts time it beside K5.
__global__ void pt_empty_kernel() {}

extern "C" int pt_empty_launch(int dev, void* stream) {
  cudaSetDevice(dev);
  pt_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The size of StArgs as this compiler lays it out, for the wrapper's check
// of its ctypes mirror.
extern "C" int pt_startree_args_bytes() { return (int)sizeof(StArgs); }

// Launches K5 on `stream` for B members (B = 1: the single launch, on its
// own body). nrec: [U, S] int32 record counts; G: group count (0: flat);
// nb: blocks per segment; A / W: accumulator / output columns; scratch:
// [B, S, nb, A] (flat) or [B, S, G, A] (grouped) float64, null for a
// launch in one pass (`one_pass`); out: [B, S, W] or
// [B, S, G, W] in the value dtype (f64 != 0: float64, else float32); dev:
// the tensors' device. Returns cudaGetLastError().
extern "C" int pt_startree_agg(const StArgs* a, const int* nrec, int S, int D,
                               int G, int nb, int A, int W, int B, int f64,
                               double* scratch, void* out, int dev,
                               void* stream) {
  cudaSetDevice(dev);
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return B > 1 ? launch<double, true>(a, nrec, S, D, G, nb, A, W, B,
                                        scratch, (double*)out, st)
                 : launch<double, false>(a, nrec, S, D, G, nb, A, W, B,
                                         scratch, (double*)out, st);
  return B > 1 ? launch<float, true>(a, nrec, S, D, G, nb, A, W, B, scratch,
                                     (float*)out, st)
               : launch<float, false>(a, nrec, S, D, G, nb, A, W, B, scratch,
                                      (float*)out, st);
}
