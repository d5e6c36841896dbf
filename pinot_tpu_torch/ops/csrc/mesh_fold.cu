// K9 mesh_fold: the combine of a mesh's per-slot partials, in one launch:
// the doc-axis fold of the sharded kernels, and the collective merge's
// fold over every slot and segment through a group-key remap.
//
// Replaces the collectives of pinot_tpu/ops/kernels.py:685
// `_shard_combine_pack` (psum / pmin / pmax of each slot over `docs`, in
// `make_sharded_kernel` :710 and `make_batched_sharded_kernel` :893), of
// pinot_tpu/ops/collective.py (`_member_fn` :84's local fold over
// segments, `_collect_pack` :131's psum / pmin / pmax over every mesh
// axis, `_matched_tail` :167, in `make_merged_kernel` :187 and
// `make_batched_merged_kernel` :234; `_global_keys` :68's remap, applied
// here to the per-segment group partials instead of to every doc), and
// the two psums of pinot_tpu/parallel/distributed_query.py:30.
//
// Input: P partials (one per mesh slot, in mesh order), each [B, rows_in,
// win] in the value dtype. Output: [B, R * W + nt] in the value dtype.
// Op 0 adds, 1 takes the minimum and 2 the maximum (NaN propagating, -0.0
// below +0.0, as XLA's min / max; the plain version's `minmax_combine`);
// a fold starts from the identity (0, +inf, -inf), accumulates in double
// and rounds once to the value dtype. Two shapes of fold (ops/kernels.py
// `MeshFold`):
//
// Strided (the doc fold, n_doc > 0): output row (i, r) of every column c
// folds row r of slots i * n_doc .. i * n_doc + n_doc - 1, in slot order,
// with ops[c]. No source lists: the kernel computes the sources. Each
// thread streams 16 bytes (a float4 or a double2) of one partial row from
// each slot, the op codes of a block's columns staged once in shared
// memory; index math in 32 bits where the sizes allow.
//
// Listed (the merges and the step): output row o, column w folds column
// col0 + w of the partial rows src[off[o]:off[o + 1]] (each (slot << 32)
// | row) by ops[w]; the nt tail elements add column tail_col of their
// rows tsrc[toff[t]:toff[t + 1]] (the merge's per-segment matched
// counts). A main row folds in list order: its entries are loaded once,
// by the lanes of its sub-warp, and shuffled to the lanes of its W
// columns. A tail of at most MF_LONG_LIST entries adds in list order
// too (its values loaded by the sub-warp's lanes and added in order by
// shuffles). A longer tail (a grouped merge's: n_doc x G_local entries,
// 131,072 at G_local = 2^16) goes to a block of MF_LIST_THREADS lanes:
// lane l adds entries l, l + MF_LIST_THREADS, ... in order from +0.0,
// then a fixed tree joins the lane sums, adjacent pairs first (lanes (0,
// 1), (2, 3), ..., then pairs of those): xor shuffles inside a warp,
// then the warps' sums in shared memory. ops/kernels.py `_add_lists`
// takes the same order, so K9 equals its plain version bit for bit on
// every input. One block of 1024 lanes a tail, past 64 entries, is the
// fastest split timed on an H100 (PERF.md §6, K9's redesign: a warp, 256
// lanes, 1024; thresholds from 63 to 4095).
//
// The host builds the lists in one fixed order (slot, then segment, then
// local group), so reruns give the same bits. No atomics.
//
// Bound on an H100: bytes (each partial row the fold reads read once, the
// output written once; an add or a compare per element). Design: the
// strided fold is a vectorized stream over a grid of a few blocks an SM;
// the listed fold's long tails spread over a block's lanes, its main rows
// read their lists once per row instead of once per column.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MF_STREAM_THREADS 256
// the lanes of a long tail (ops/kernels.py MeshFold.LANES)
#define MF_LIST_THREADS 1024
// tails longer than this go to MF_LIST_THREADS lanes (MeshFold.LONG_LIST)
#define MF_LONG_LIST 64
#define MF_MAX_PARTS 64
#define MF_OPS_SMEM 8192
#define MF_UNROLL 4

// ops/_cuda.py `_FoldArgs`, passed by value: the partials' pointers.
struct FoldArgs {
  const void* part[MF_MAX_PARTS];
};

// A double's bits as a signed integer in their total order (-0.0 below
// +0.0), as interp.cuh `order_key`.
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFll);
}

__device__ __forceinline__ double combine(int op, double acc, double v) {
  if (op == 0) return acc + v;
  if (acc != acc || v != v)  // NaN sticks, as the quiet NaN
    return __longlong_as_double(0x7FF8000000000000ll);
  if (op == 1) return order_key(v) < order_key(acc) ? v : acc;
  return order_key(v) > order_key(acc) ? v : acc;
}

__device__ __forceinline__ double identity_of(int op) {
  return op == 0 ? 0.0 : (op == 1 ? INFINITY : -INFINITY);
}

// 16 bytes of T: four floats or two doubles, loaded and stored at once.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, double* v) {
    const float4 x = __ldg((const float4*)p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const double* v) {
    *(float4*)p = make_float4((float)v[0], (float)v[1], (float)v[2],
                              (float)v[3]);
  }
};
template <>
struct Vec16<double> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void load(const double* p, double* v) {
    const double2 x = __ldg((const double2*)p);
    v[0] = x.x, v[1] = x.y;
  }
  static __device__ __forceinline__ void store(double* p, const double* v) {
    *(double2*)p = make_double2(v[0], v[1]);
  }
};

// The strided fold. Rows (b, i) of M values each (B' = 1 and M = B *
// rows_in * win when n_seg is 1: member rows are then contiguous in the
// partials and the output alike); unit u takes values [e0, e0 + V) of
// one row. `aligned`: every partial and the output start on 16 bytes.
template <typename T, typename I>
__global__ void __launch_bounds__(MF_STREAM_THREADS)
mesh_fold_strided(const __grid_constant__ FoldArgs a,
                  const signed char* __restrict__ ops, int n_seg, int n_doc,
                  I M, I win, I rows, int aligned, T* __restrict__ out) {
  constexpr int V = Vec16<T>::N;
  __shared__ signed char sops[MF_OPS_SMEM];
  const signed char* op_of = ops;
  if (win <= MF_OPS_SMEM) {
    for (I c = threadIdx.x; c < win; c += blockDim.x) sops[c] = ops[c];
    __syncthreads();
    op_of = sops;
  }
  const I per_row = (M + V - 1) / V;
  const I units = rows * per_row;
  for (I u = (I)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (I)gridDim.x * blockDim.x) {
    const I row = u / per_row;
    const I e0 = (u - row * per_row) * V;
    const I b = row / n_seg;
    const int slot0 = (int)(row - b * n_seg) * n_doc;
    const I in0 = b * M + e0, out0 = row * M + e0;
    int op[V];
    double acc[V];
    I c = e0 % win;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      op[q] = op_of[c];
      acc[q] = identity_of(op[q]);
      if (++c == win) c = 0;
    }
    if (aligned && e0 + V <= M && in0 % V == 0 && out0 % V == 0) {
#pragma unroll 4
      for (int d = 0; d < n_doc; ++d) {
        double v[V];
        Vec16<T>::load((const T*)a.part[slot0 + d] + in0, v);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = combine(op[q], acc[q], v[q]);
      }
      Vec16<T>::store(out + out0, acc);
    } else {
      for (int q = 0; q < V && e0 + q < M; ++q) {
        for (int d = 0; d < n_doc; ++d)
          acc[q] = combine(op[q], acc[q],
                           (double)__ldg((const T*)a.part[slot0 + d] + in0 +
                                         q));
        out[out0 + q] = (T)acc[q];
      }
    }
  }
}

// The listed fold. Block u below n_long adds long tail ltail[u % n_ltail]
// of member u / n_ltail over its MF_LIST_THREADS lanes. The blocks past
// them walk the B x (R + nt) output rows, a sub-warp of `wp` lanes a row;
// there are only as many as one wave holds beside the long blocks, so
// that no row waits for a second wave.
template <typename T>
__global__ void __launch_bounds__(MF_LIST_THREADS)
mesh_fold_listed(const __grid_constant__ FoldArgs a,
                 const signed char* __restrict__ ops,
                 const long long* __restrict__ off,
                 const long long* __restrict__ src,
                 const long long* __restrict__ toff,
                 const long long* __restrict__ tsrc,
                 const int* __restrict__ ltail, int n_ltail, int R, int W,
                 int nt, int col0, int tail_col, int rows_in, int win, int B,
                 int n_long, int wp, T* __restrict__ out) {
  const long long L = (long long)R * W + nt;
  if ((int)blockIdx.x < n_long) {
    __shared__ double wsum[MF_LIST_THREADS / 32];
    const int b = (int)blockIdx.x / n_ltail;
    const int t = ltail[blockIdx.x - b * n_ltail];
    const long long beg = toff[t], end = toff[t + 1];
    const long long base = (long long)b * rows_in;
    double acc = 0.0;
    // MF_UNROLL entries of the lane at a time, the next ones' list
    // entries loaded while this round's values are
    const long long stride = (long long)MF_UNROLL * MF_LIST_THREADS;
    long long s[MF_UNROLL];
#pragma unroll
    for (int q = 0; q < MF_UNROLL; ++q) {
      const long long j = beg + threadIdx.x + (long long)q * MF_LIST_THREADS;
      s[q] = j < end ? __ldg(tsrc + j) : -1;
    }
    for (long long i = beg + threadIdx.x; i < end; i += stride) {
      const T* p[MF_UNROLL];
#pragma unroll
      for (int q = 0; q < MF_UNROLL; ++q) {
        p[q] = s[q] < 0 ? nullptr
                        : (const T*)a.part[s[q] >> 32] +
                              (base + (s[q] & 0xffffffffLL)) * win + tail_col;
        const long long j = i + stride + (long long)q * MF_LIST_THREADS;
        s[q] = j < end ? __ldg(tsrc + j) : -1;
      }
      double v[MF_UNROLL];
#pragma unroll
      for (int q = 0; q < MF_UNROLL; ++q)
        v[q] = p[q] ? (double)__ldg(p[q]) : 0.0;
#pragma unroll
      for (int q = 0; q < MF_UNROLL; ++q)
        if (p[q]) acc += v[q];
    }
    // the tree, adjacent pairs first: inside the warp (an add is exact
    // whichever side it takes) ...
    for (int o = 1; o < 32; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    // ... then over the block's warps
    if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int n = MF_LIST_THREADS / 32; n > 1; n >>= 1)
        for (int k = 0; k < n / 2; ++k)
          wsum[k] = wsum[2 * k] + wsum[2 * k + 1];
      out[b * L + (long long)R * W + t] = (T)wsum[0];
    }
    return;
  }
  // short lists, in list order: sub-warps of wp lanes, one output row each
  const int sl = threadIdx.x & (wp - 1);
  const unsigned mask =
      wp == 32 ? 0xffffffffu
               : ((1u << wp) - 1) << ((threadIdx.x & 31) & ~(wp - 1));
  const int per_block = MF_LIST_THREADS / wp;
  const long long rows = (long long)B * (R + nt);
  const long long step = (long long)(gridDim.x - n_long) * per_block;
  for (long long r = (long long)(blockIdx.x - n_long) * per_block +
                     threadIdx.x / wp;
       r < rows; r += step) {
    const long long b = r / (R + nt);
    const int o = (int)(r - b * (R + nt));
    const long long base = b * rows_in;
    if (o < R) {
      const long long beg = off[o], end = off[o + 1];
      for (int c0 = 0; c0 < W; c0 += wp) {
        const int w = c0 + sl;
        const bool on = w < W;
        const int op = on ? ops[w] : 0;
        double acc = identity_of(op);
        for (long long c = beg; c < end; c += wp) {
          long long p = 0;  // the entry's row, as an address
          if (c + sl < end) {
            const long long s = __ldg(src + c + sl);
            p = (long long)((const T*)a.part[s >> 32] +
                            (base + (s & 0xffffffffLL)) * win + col0);
          }
          const int n = (int)(end - c < wp ? end - c : wp);
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            const T* q = (const T*)__shfl_sync(mask, p, j, wp);
            if (on) acc = combine(op, acc, (double)__ldg(q + w));
          }
        }
        if (on) out[b * L + (long long)o * W + w] = (T)acc;
      }
    } else {
      const int t = o - R;
      const long long beg = toff[t], end = toff[t + 1];
      if (end - beg > MF_LONG_LIST) continue;
      double acc = 0.0;
      for (long long c = beg; c < end; c += wp) {
        double v = 0.0;
        if (c + sl < end) {
          const long long s = __ldg(tsrc + c + sl);
          v = (double)__ldg((const T*)a.part[s >> 32] +
                            (base + (s & 0xffffffffLL)) * win + tail_col);
        }
        const int n = (int)(end - c < wp ? end - c : wp);
        for (int j = 0; j < n; ++j) acc += __shfl_sync(mask, v, j, wp);
      }
      if (sl == 0) out[b * L + (long long)R * W + t] = (T)acc;
    }
  }
}

// The size of FoldArgs as this compiler lays it out, for the wrapper's
// check of its ctypes mirror.
extern "C" int pt_mesh_fold_args_bytes() { return (int)sizeof(FoldArgs); }

template <typename T>
static cudaError_t launch_strided(const FoldArgs* a, const signed char* ops,
                                  int n_seg, int n_doc, long long M,
                                  long long win, long long rows, int aligned,
                                  int sms, cudaStream_t st, T* out) {
  constexpr int V = Vec16<T>::N;
  const long long units = rows * ((M + V - 1) / V);
  long long blocks = (units + MF_STREAM_THREADS - 1) / MF_STREAM_THREADS;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  if (blocks < 1) blocks = 1;
  if (rows * M + V < (1LL << 31))
    mesh_fold_strided<T, int><<<(unsigned)blocks, MF_STREAM_THREADS, 0, st>>>(
        *a, ops, n_seg, n_doc, (int)M, (int)win, (int)rows, aligned, out);
  else
    mesh_fold_strided<T, long long>
        <<<(unsigned)blocks, MF_STREAM_THREADS, 0, st>>>(
            *a, ops, n_seg, n_doc, M, win, rows, aligned, out);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_listed(const FoldArgs* a, const signed char* ops,
                                 const long long* off, const long long* src,
                                 const long long* toff, const long long* tsrc,
                                 const int* ltail, int n_ltail, int R, int W,
                                 int nt, int col0, int tail_col, int rows_in,
                                 int win, int B, int sms, cudaStream_t st,
                                 T* out) {
  const long long n_long = (long long)B * n_ltail;
  int wp = 4;
  while (wp < W && wp < 32) wp <<= 1;
  // the short rows' blocks fill what the long ones leave of one wave
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, mesh_fold_listed<T>, MF_LIST_THREADS, 0);
  if (e != cudaSuccess) return e;
  const long long wave = (long long)(occ > 0 ? occ : 1) * sms;
  const long long rows = (long long)B * (R + nt);
  const long long per_short = MF_LIST_THREADS / wp;
  long long n_short = (rows + per_short - 1) / per_short;
  const long long room = n_long < wave ? wave - n_long : wave;
  if (n_short > room) n_short = room;
  if (n_long + n_short > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mesh_fold_listed<T>
      <<<(unsigned)(n_long + n_short), MF_LIST_THREADS, 0, st>>>(
          *a, ops, off, src, toff, tsrc, ltail, n_ltail, R, W, nt, col0,
          tail_col, rows_in, win, B, (int)n_long, wp, out);
  return cudaGetLastError();
}

// Launches K9 on `stream`. ops: [W] int8. Strided (n_doc > 0): n_seg =
// R / rows_in segment slices of n_doc slots, the lists unused. Listed:
// off: [R + 1], src: [off[R]]; toff: [nt + 1], tsrc: [toff[nt]] (both
// null when nt is 0), all int64; ltail: [n_ltail] int32, the tails longer
// than MF_LONG_LIST entries. out: [B, R * W + nt] of the value dtype (f64
// != 0: float64, else float32); aligned: the partials and out start on 16
// bytes; dev: the tensors' device. Returns the launch's cudaError.
extern "C" int pt_mesh_fold(const FoldArgs* a, const signed char* ops,
                            const long long* off, const long long* src,
                            const long long* toff, const long long* tsrc,
                            const int* ltail, int n_ltail, int R, int W,
                            int nt, int col0, int tail_col, int rows_in,
                            int win, int B, int n_doc, int aligned, int f64,
                            void* out, int dev, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  int sms = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_doc > 0) {
    const int n_seg = R / rows_in;
    const long long M = (long long)rows_in * win;
    const long long rows = n_seg == 1 ? 1 : (long long)B * n_seg;
    const long long Mr = n_seg == 1 ? M * B : M;
    e = f64 ? launch_strided<double>(a, ops, n_seg, n_doc, Mr, win, rows,
                                     aligned, sms, st, (double*)out)
            : launch_strided<float>(a, ops, n_seg, n_doc, Mr, win, rows,
                                    aligned, sms, st, (float*)out);
  } else {
    e = f64 ? launch_listed<double>(a, ops, off, src, toff, tsrc, ltail,
                                    n_ltail, R, W, nt, col0, tail_col,
                                    rows_in, win, B, sms, st, (double*)out)
            : launch_listed<float>(a, ops, off, src, toff, tsrc, ltail,
                                   n_ltail, R, W, nt, col0, tail_col, rows_in,
                                   win, B, sms, st, (float*)out);
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}
