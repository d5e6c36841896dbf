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
// win] in the value dtype. Output: [B, R * W + nt] in the value dtype. For
// member b, output row o, column w (w < W):
//
//   out[b, o * W + w] = fold over k in [off[o], off[o + 1]) of
//                       part[p_k][b, r_k, col0 + w]    with op[w]
//
// where src[k] = (p_k << 32) | r_k, op 0 adds, 1 takes the minimum and 2
// the maximum (NaN propagating, -0.0 below +0.0, as XLA's min / max; the
// plain version's `minmax_combine`); an empty list gives
// the identity (0, +inf, -inf). The nt tail elements add column tail_col
// of their own source lists (toff, tsrc) the same way: the collective
// merge's per-segment matched counts.
//
// Order: each output element walks its list in order, accumulating in
// double, and rounds once to the value dtype. The host builds the lists in
// one fixed order (slot, then segment, then local group), so reruns give
// the same bits, and ops/kernels.py `mesh_fold_plain`, which folds the
// same lists in the same order in float64, gives them too. No atomics: a
// remapped fold gathers through the host-built inverse lists.
//
// Bound on an H100: bytes (each partial read once, the output written
// once; an add, a compare per element). Design: one thread per output
// element, grid-stride; adjacent threads take adjacent columns of one
// output row, so each step of a list reads one partial row coalesced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MF_THREADS 256
#define MF_MAX_PARTS 64

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

template <typename T>
__global__ void __launch_bounds__(MF_THREADS)
mesh_fold(const __grid_constant__ FoldArgs a, const signed char* __restrict__ ops,
          const long long* __restrict__ off, const long long* __restrict__ src,
          const long long* __restrict__ toff,
          const long long* __restrict__ tsrc, int R, int W, int nt, int col0,
          int tail_col, int rows_in, int win, int B, T* __restrict__ out) {
  const long long L = (long long)R * W + nt;
  const long long n = L * B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / L, k = e % L;
    const long long base = b * rows_in;
    double acc;
    if (k < (long long)R * W) {
      const int o = (int)(k / W), w = (int)(k % W);
      const int op = ops[w];
      acc = identity_of(op);
      for (long long i = off[o]; i < off[o + 1]; ++i) {
        const long long s = src[i];
        const T* p = (const T*)a.part[s >> 32];
        acc = combine(op, acc,
                      (double)p[(base + (s & 0xffffffffLL)) * win + col0 + w]);
      }
    } else {
      const long long t = k - (long long)R * W;
      acc = 0.0;
      for (long long i = toff[t]; i < toff[t + 1]; ++i) {
        const long long s = tsrc[i];
        const T* p = (const T*)a.part[s >> 32];
        acc += (double)p[(base + (s & 0xffffffffLL)) * win + tail_col];
      }
    }
    out[e] = (T)acc;
  }
}

// The size of FoldArgs as this compiler lays it out, for the wrapper's
// check of its ctypes mirror.
extern "C" int pt_mesh_fold_args_bytes() { return (int)sizeof(FoldArgs); }

// Launches K9 on `stream`. ops: [W] int8; off: [R + 1], src: [off[R]];
// toff: [nt + 1], tsrc: [toff[nt]] (both null when the tail's length nt
// is 0), all int64 on the device; out: [B, R * W + nt] of the value dtype
// (f64 != 0: float64, else float32); dev: the tensors' device. Returns
// cudaGetLastError().
extern "C" int pt_mesh_fold(const FoldArgs* a, const signed char* ops,
                            const long long* off, const long long* src,
                            const long long* toff, const long long* tsrc,
                            int R, int W, int nt, int col0, int tail_col,
                            int rows_in, int win, int B, int f64, void* out,
                            int dev, void* stream) {
  cudaSetDevice(dev);
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = ((long long)R * W + nt) * B;
  long long blocks = (n + MF_THREADS - 1) / MF_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 8192) blocks = 8192;
  if (f64)
    mesh_fold<double><<<(unsigned)blocks, MF_THREADS, 0, st>>>(
        *a, ops, off, src, toff, tsrc, R, W, nt, col0, tail_col, rows_in, win,
        B, (double*)out);
  else
    mesh_fold<float><<<(unsigned)blocks, MF_THREADS, 0, st>>>(
        *a, ops, off, src, toff, tsrc, R, W, nt, col0, tail_col, rows_in, win,
        B, (float*)out);
  return (int)cudaGetLastError();
}
