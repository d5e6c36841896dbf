// K2 group_agg: fused filter + value expressions + per-group reductions over
// stacked segment blocks [S, D] with dense mixed-radix keys or compact
// per-segment key codes, packed as [S, G, n_slots].
//
// Replaces the grouped branch of pinot_tpu/ops/kernels.py:537
// `make_kernel`: keys from `_compute_slots` :490-495, `_grouped_reduce`
// :252, `_scatter_sum` :287, `_vmap_scatter` :316. The JAX kernel's one-hot
// matmul for small key spaces (:299-311) was a device for the TPU's matrix
// unit; the function is a scatter-sum, and here it is one.
//
// Also replaces the compact-key branch, kernels.py:488-491: where the
// dense key space exceeds 2^20 the engine stages an int32 [S, D] `gkey`
// block of per-segment codes over the key tuples present, and the program
// names it as the key's only digit at stride 1, so each kept doc's key is
// one load of its code. G (8 to 2^20) comes with the launch; past the
// 40 KB shared table (G x n_slots x 8 bytes) docs update the float64
// table in global memory directly, the common case for compact keys.
//
// Also replaces pinot_tpu/ops/timeseries_device.py:166 `bucket_ids` (the
// fused time bucket, kernels.py:496-506): where the plan carries one, each
// doc's floor((t - start) / step) from the timestamp's (hi, lo) i32 planes
// and the member's tb:* parameter cells is the key's lowest digit, and a
// doc outside the window is gated out (interp.cuh ts_bucket). The upsert
// validity mask skips superseded docs before the filter (doc_valid).
//
// Bound on an H100: bytes, as for K1 — each staged element is read once;
// the output [S, G, n_slots] is small beside the columns (a time bucket
// reads two i32 planes more per kept doc and does a handful of integer
// operations: still bytes). At compact G the float64 table's init write
// and finalize read (B x S x G x n_slots entries) are no longer small
// beside the columns; they are this design's scratch, not the function's
// traffic, so the bound leaves them out and chip_smoke.py reports them
// beside it.
//
// Design: grid (B members x blocks per segment, S), a single launch being
// the B = 1 case (interp.cuh: the member axis), each
// block over one contiguous doc range of one segment for one member. When
// the G x n_slots accumulators of a segment fit in 40 KB they live in
// shared memory: docs update them with shared-memory atomics (atomicAdd on
// doubles for counts and sums, compare-and-swap loops for NaN-propagating
// min / max), and the block then merges the entries it touched into a
// float64 table [B, S, G, n_slots] with global atomics.
// Otherwise docs update the global table directly. A last pass converts
// the table to the value dtype. Sums accumulate in double, so a float32
// result is the correctly rounded sum of float32 contributions up to the
// double rounding of the adds; the order of atomics varies run to run.
#include "interp.cuh"

#define PT_SMEM_TABLE_BYTES (40 * 1024)

__device__ __forceinline__ void atomic_min_nan(double* addr, double v) {
  unsigned long long* p = (unsigned long long*)addr;
  unsigned long long old = *(volatile unsigned long long*)p;
  while (true) {
    const double cur = __longlong_as_double(old);
    if (cur != cur) return;              // NaN is sticky
    if (v == v && !(v < cur)) return;    // not smaller
    const unsigned long long seen = atomicCAS(p, old, __double_as_longlong(v));
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_max_nan(double* addr, double v) {
  unsigned long long* p = (unsigned long long*)addr;
  unsigned long long old = *(volatile unsigned long long*)p;
  while (true) {
    const double cur = __longlong_as_double(old);
    if (cur != cur) return;
    if (v == v && !(v > cur)) return;
    const unsigned long long seen = atomicCAS(p, old, __double_as_longlong(v));
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_combine(int r, double* addr, double v) {
  if (r == R_ADD) atomicAdd(addr, v);
  else if (r == R_MIN) atomic_min_nan(addr, v);
  else atomic_max_nan(addr, v);
}

__global__ void group_init(const __grid_constant__ Args a, long long n,
                           double* __restrict__ table) {
  const int nslot = a.code[H_NSLOT];
  const int* slots = a.code + a.code[H_SLOT];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    table[e] = identity_of(slot_red(slots[(e % nslot) * SLOT_W]));
}

template <typename T, typename M, bool kMask>
__global__ void __launch_bounds__(PT_THREADS)
group_agg_kernel(const __grid_constant__ Args a, const double* __restrict__ params,
                 const int* __restrict__ num_docs, int S, int D, int P,
                 int G, int nmem, int use_smem,
                 double* __restrict__ table) {
  __shared__ Shared sh;
  extern __shared__ double tab[];
  const int s = blockIdx.y;
  int b, nb;
  const M mb = Grid<M>::at(a, S, nmem, b, nb);
  stage_block(a, params, mb.row(), P, sh);
  const int* code = sh.code;
  const int nslot = code[H_NSLOT], ngcol = code[H_NGCOL], mainf = code[H_MAIN];
  const int tbhi = code[H_TBHI], tbpad = code[H_TBPAD];
  const int* slots = code + code[H_SLOT];
  const int* gcols = code + code[H_GCOL];
  const int entries = G * nslot;
  double* seg_table = table + mb.row() * entries;
  double* my = use_smem ? tab : seg_table;
  if (use_smem) {
    for (int e = threadIdx.x; e < entries; e += blockDim.x)
      tab[e] = identity_of(slot_red(slots[(e % nslot) * SLOT_W]));
    __syncthreads();
  }

  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  const int per = (n + nb - 1) / nb;
  const int start = b * per, end = min(n, start + per);
  const long long base = (long long)s * D;
  for (int d = start + threadIdx.x; d < end; d += blockDim.x) {
    const long long i = base + d;
    if (!doc_valid(a, mb, i)) continue;  // superseded by an upsert
    if (mainf >= 0 && !eval_filter<kMask>(a, sh, mainf, mb, i)) continue;
    int key = 0;
    for (int g = 0; g < ngcol; ++g)
      key += (int)load_col(a, code, mb.u(), gcols[2 * g], i) * gcols[2 * g + 1];
    if (tbhi >= 0) {  // the fused time bucket: the key's lowest digit
      const double* tp = sh.prm + code[H_TBPRM];
      int bk;
      if (!ts_bucket(((const int*)a.cols[mb.u()][tbhi])[i],
                     ((const int*)a.cols[mb.u()][code[H_TBLO]])[i], (int)tp[0],
                     (int)tp[1], (int)tp[2], (int)tp[3], tbpad, bk))
        continue;
      key += bk;
    }
    if (key < 0 || key >= G) continue;  // as XLA drops out-of-range scatters
    double* row = my + (long long)key * nslot;
    DocCache c = {0u, 0u, 0u};
    T vc[PT_MAX_VALUES];
    for (int j = 0; j < nslot; ++j) {
      const int* sl = slots + j * SLOT_W;
      const int op = sl[0], v = sl[1];
      if (!slot_passes<kMask>(a, sh, sl[2], mb, i, c)) continue;
      if (op == S_COUNT) {
        atomicAdd(row + j, 1.0);
        continue;
      }
      if (!(c.vdone & (1u << v))) {
        vc[v] = eval_value<T>(a, sh, v, mb, i);
        c.vdone |= 1u << v;
      }
      atomic_combine(slot_red(op), row + j, slot_contrib<T>(op, vc[v]));
    }
  }

  if (use_smem) {
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += blockDim.x) {
      const int r = slot_red(slots[(e % nslot) * SLOT_W]);
      const double x = tab[e];
      if (!(x == identity_of(r))) atomic_combine(r, seg_table + e, x);
    }
  }
}

template <typename T>
__global__ void group_finalize(long long n, const double* __restrict__ table,
                               T* __restrict__ out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = (T)table[e];
}

// Launches the table init, K2 and the finalize pass on `stream` for B
// members. params: [B, S, P] float64; num_docs: [U, S] int32; table:
// [B, S, G, n_slots] float64 scratch; out: the same shape in the value
// dtype (f64 != 0: float64, else float32); dev: the tensors' device.
// Returns cudaGetLastError().
extern "C" int pt_group_agg(const Args* a, const double* params,
                            const int* num_docs, int S, int D, int P, int G,
                            int nb, int B, int f64, double* table, void* out,
                            int dev, void* stream) {
  cudaSetDevice(dev);
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * S * G * a->code[H_NSLOT];
  const long long tb = (n + PT_THREADS - 1) / PT_THREADS;
  const int flat = (int)(tb < 4096 ? (tb > 0 ? tb : 1) : 4096);
  const size_t smem = (size_t)G * a->code[H_NSLOT] * sizeof(double);
  const int use_smem = smem <= PT_SMEM_TABLE_BYTES;
  const dim3 grid(nb * B, S);
  const size_t dyn = use_smem ? smem : 0;
  const bool mask = has_mask_leaf(a->code);
  group_init<<<flat, PT_THREADS, 0, st>>>(*a, n, table);
  if (f64 && mask)
    group_agg_kernel<double, Mem, true><<<grid, PT_THREADS, dyn, st>>>(
        *a, params, num_docs, S, D, P, G, B, use_smem, table);
  else if (f64)
    group_agg_kernel<double, Mem, false><<<grid, PT_THREADS, dyn, st>>>(
        *a, params, num_docs, S, D, P, G, B, use_smem, table);
  else if (mask)
    group_agg_kernel<float, Mem, true><<<grid, PT_THREADS, dyn, st>>>(
        *a, params, num_docs, S, D, P, G, B, use_smem, table);
  else
    group_agg_kernel<float, Mem, false><<<grid, PT_THREADS, dyn, st>>>(
        *a, params, num_docs, S, D, P, G, B, use_smem, table);
  if (f64)
    group_finalize<double><<<flat, PT_THREADS, 0, st>>>(n, table, (double*)out);
  else
    group_finalize<float><<<flat, PT_THREADS, 0, st>>>(n, table, (float*)out);
  return (int)cudaGetLastError();
}
