// K1 scan_agg: fused filter + value expressions + masked reductions over
// stacked segment blocks [S, D], packed as [S, 1 + sum(w)].
//
// Replaces the ungrouped branch of pinot_tpu/ops/kernels.py:537
// `make_kernel` (`_compute_slots` :468 with `_eval_filter` :128,
// `_eval_value` :197, `_masked_reduce` :228, `_isum_slot` :377,
// `_isum_u_slot` :404, `_pack_flat` :574).
//
// Bound on an H100: bytes. Each staged column element is read once
// (1-8 bytes per doc per column) against a handful of compares and adds, far
// below the ~20 operations per byte where the card's compute would limit,
// so the floor is the staged bytes over 3.35 TB/s.
//
// Design: grid (blocks per segment, S) for a single launch, (B members x
// blocks per segment, S) for a batch (interp.cuh: the member axis). A
// block covers one contiguous doc range of one segment for one member, so
// the program and the member's parameter row load into shared memory
// once; threads stride by the block size, so each column read is
// coalesced at its own width. The block partition depends on D only, not
// on B, so a member's bits equal its single launch's. Docs at or past num_docs[s] are never
// read (padding costs nothing); a doc whose byte in the set's upsert
// validity mask is 0 is skipped before the filter (interp.cuh doc_valid). Every accumulator word is a double per
// thread: counts and isum planes stay exact integers (< 2^53), float sums
// gain precision over the JAX float32 sum, min/max are exact. Blocks write
// per-word partials to scratch [B, S, nb, n_acc]; a second kernel reduces
// them in a fixed order, so reruns give the same bits, and writes the
// packed output in the value dtype, splitting isum planes into (hi, lo)
// 12-bit halves. Sketch slots (HLL, histogram) are K3's (sketch_agg.cu):
// K1 skips them and leaves their output columns to K3.
#include "interp.cuh"

template <typename T, typename M, bool kMask>
__global__ void __launch_bounds__(PT_THREADS)
scan_agg_kernel(const __grid_constant__ Args a, const double* __restrict__ params,
                const int* __restrict__ num_docs, int S, int D, int P,
                int nmem, double* __restrict__ partial) {
  __shared__ Shared sh;
  __shared__ double red[PT_THREADS / 32][PT_MAX_ACC];
  const int s = blockIdx.y;
  int b, nb;
  const M mb = Grid<M>::at(a, S, nmem, b, nb);
  stage_block(a, params, mb.row(), P, sh);
  const int* code = sh.code;
  const int nacc = code[H_NACC], nslot = code[H_NSLOT], mainf = code[H_MAIN];
  const int* slots = code + code[H_SLOT];
  const int* accs = code + code[H_ACC];

  double acc[PT_MAX_ACC];
  for (int w = 0; w < nacc; ++w) acc[w] = identity_of(accs[w * ACC_W]);

  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  const int per = (n + nb - 1) / nb;
  const int start = b * per, end = min(n, start + per);
  const long long base = (long long)s * D;
  for (int d = start + threadIdx.x; d < end; d += blockDim.x) {
    const long long i = base + d;
    if (!doc_valid(a, mb, i)) continue;  // superseded by an upsert
    if (mainf >= 0 && !eval_filter<kMask>(a, sh, mainf, mb, i)) continue;
    acc[0] += 1.0;  // matched count
    DocCache c = {0u, 0u, 0u};
    T vc[PT_MAX_VALUES];
    for (int j = 0; j < nslot; ++j) {
      const int* sl = slots + j * SLOT_W;
      const int op = sl[0], v = sl[1], w = sl[3];
      if (is_sketch(op)) continue;  // K3's slots
      if (!slot_passes<kMask>(a, sh, sl[2], mb, i, c)) continue;
      if (op == S_COUNT) {
        acc[w] += 1.0;
      } else if (op == S_ISUM) {
        const int vi = eval_value<int>(a, sh, v, mb, i);
        for (int k = 0; k < 5; ++k) acc[w + k] += (double)((vi >> (6 * k)) & 63);
        acc[w + 5] += (double)(vi >> 30);  // signed top digit
      } else if (op == S_ISUM_U) {
        const int vi = eval_value<int>(a, sh, v, mb, i);
        for (int k = 0; k < sl[4]; ++k) acc[w + k] += (double)((vi >> (7 * k)) & 127);
      } else {
        if (!(c.vdone & (1u << v))) {
          vc[v] = eval_value<T>(a, sh, v, mb, i);
          c.vdone |= 1u << v;
        }
        const double x = slot_contrib<T>(op, vc[v]);
        acc[w] = op == S_MIN ? nan_min(acc[w], x)
               : op == S_MAX ? nan_max(acc[w], x) : acc[w] + x;
      }
    }
  }

  // block reduction in a fixed order: warp shuffles, then warp 0's lanes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = 0; w < nacc; ++w) {
    const int r = accs[w * ACC_W];
    double x = acc[w];
    for (int o = 16; o > 0; o >>= 1)
      x = combine(r, x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) red[warp][w] = x;
  }
  __syncthreads();
  if (threadIdx.x < nacc) {
    const int w = threadIdx.x, r = accs[w * ACC_W];
    double x = red[0][w];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) x = combine(r, x, red[k][w]);
    partial[(mb.row() * nb + b) * nacc + w] = x;
  }
}

// One block per (accumulator word, segment, member): reduce the nb block
// partials in a fixed tree order and write the packed output.
template <typename T>
__global__ void __launch_bounds__(PT_THREADS)
scan_finalize(const __grid_constant__ Args a, const double* __restrict__ partial,
              int nb, T* __restrict__ out) {
  __shared__ double buf[PT_THREADS];
  const int w = blockIdx.x;
  // the (member, segment) row of partial and out
  const long long s = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int nacc = a.code[H_NACC], outw = a.code[H_OUTW];
  const int* A = a.code + a.code[H_ACC] + w * ACC_W;
  const int r = A[0];
  double x = identity_of(r);
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    x = combine(r, x, partial[((long long)s * nb + b) * nacc + w]);
  buf[threadIdx.x] = x;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) buf[threadIdx.x] = combine(r, buf[threadIdx.x], buf[threadIdx.x + o]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    T* row = out + (long long)s * outw;
    if (A[1] == O_SCALAR) {
      row[A[2]] = (T)buf[0];
    } else {  // isum plane: exact int sum split into 12-bit halves
      const long long v = (long long)buf[0];
      row[A[2]] = (T)(v >> 12);
      row[A[2] + 1] = (T)(v & 4095);
    }
  }
}

template <typename T, typename M>
static void launch(const Args* a, const double* params, const int* num_docs,
                   int S, int D, int P, int nb, int B, double* partial,
                   T* out, cudaStream_t st) {
  if (has_mask_leaf(a->code))
    scan_agg_kernel<T, M, true><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *a, params, num_docs, S, D, P, B, partial);
  else
    scan_agg_kernel<T, M, false><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *a, params, num_docs, S, D, P, B, partial);
  scan_finalize<T><<<dim3(a->code[H_NACC], S, B), PT_THREADS, 0, st>>>(
      *a, partial, nb, out);
}

// Launches K1 and its finalize pass on `stream` for B members. params:
// [B, S, P] float64; num_docs: [U, S] int32; partial: [B, S, nb, n_acc]
// float64 scratch; out: [B, S, out_width] of the value dtype (f64 != 0:
// float64, else float32); dev: the tensors' device. Returns
// cudaGetLastError().
extern "C" int pt_scan_agg(const Args* a, const double* params,
                           const int* num_docs, int S, int D, int P, int nb,
                           int B, int f64, double* partial, void* out,
                           int dev, void* stream) {
  cudaSetDevice(dev);
  cudaStream_t st = (cudaStream_t)stream;
  const bool one = B == 1 && a->set_of[0] == 0;
  if (f64 && one)
    launch<double, Single>(a, params, num_docs, S, D, P, nb, B, partial, (double*)out, st);
  else if (f64)
    launch<double, Mem>(a, params, num_docs, S, D, P, nb, B, partial, (double*)out, st);
  else if (one)
    launch<float, Single>(a, params, num_docs, S, D, P, nb, B, partial, (float*)out, st);
  else
    launch<float, Mem>(a, params, num_docs, S, D, P, nb, B, partial, (float*)out, st);
  return (int)cudaGetLastError();
}
