// K3 sketch_agg: fused filter + HLL registers + fixed-bucket histograms over
// stacked segment blocks [S, D], written into the packed [S, 1 + sum(w)]
// layout (matched count in column 0, each sketch slot's registers or
// buckets at its `out` column).
//
// Replaces pinot_tpu/ops/kernels.py:429 `_hll_slot` (with `_fmix32` :419)
// and :451 `_hist_slot`, as `_compute_slots` :515-523 calls them, and
// `_pack_flat` :574 for their columns.
//
// Bound on an H100: bytes. Per kept doc an HLL slot reads two i32 planes
// and a histogram slot one value: 8-12 bytes against some 20 integer
// operations (two murmur3 finalizers each way) and one shared-memory
// atomic, far below the rate where the card's compute would limit.
//
// Design: grid (blocks per segment, S) for a single launch, (B members x
// blocks per segment, S) for a batch, 256 threads, each block over one
// contiguous doc range of one segment for one member, as K1 (interp.cuh:
// the member axis). The upsert validity mask, the filter and the value IR
// run through interp.cuh. Each sketch slot whose table fits under
// SKETCH_SMEM_WORDS (program.py places it: the slot row's `acc` field) keeps
// a per-block uint32 table in dynamic shared memory: registers take
// atomicMax of the rank, buckets atomicAdd of 1. At the end the block
// writes its whole table (zeros too) to its own row of a partial buffer
// [B, S, nb, smem_words], coalesced and without atomics. A slot that does
// not fit (log2m 16, or several sketches) updates a per-segment global
// table [B, S, out_width] with atomics instead. A finalize pass reduces the nb
// partials of each column (max or sum) in a fixed order, or reads the
// global table, and writes the value dtype. Integer tables and integer
// atomics make every result bit-exact whatever the block order.
//
// Numerics, as the JAX kernel: the hash is uint32 arithmetic on the planes'
// bit patterns; rank = clz(h2) + 1, which is 33 when h2 is 0. The bucket is
// (v - lo) * scale in the value dtype, one rounding per operation (the build
// passes --fmad=false), clipped to [0, B - 1] and truncated; NaN goes to
// bucket 0, where XLA's float to int32 conversion puts it.
#include "interp.cuh"

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Bucket of value x: clip((x - lo) * scale, 0, B - 1), truncated.
template <typename T>
__device__ __forceinline__ int hist_bucket(T x, T lo, T scale, int B) {
  T t = (x - lo) * scale;
  if (t != t) return 0;
  t = t < (T)0 ? (T)0 : t;
  t = t > (T)(B - 1) ? (T)(B - 1) : t;
  return (int)t;
}

__device__ __forceinline__ int sketch_width(const int* sl) {
  return sl[0] == S_HLL ? (1 << sl[4]) : sl[4];
}

template <typename T, typename M, bool kMask>
__global__ void __launch_bounds__(PT_THREADS)
sketch_agg_kernel(const __grid_constant__ Args a,
                  const double* __restrict__ params,
                  const int* __restrict__ num_docs, int S, int D, int P,
                  int nmem, int smem_words, unsigned* __restrict__ partial,
                  unsigned* __restrict__ gtab) {
  __shared__ Shared sh;
  __shared__ unsigned warp_cnt[PT_THREADS / 32];
  extern __shared__ unsigned tab[];
  const int s = blockIdx.y;
  int b, nb;
  const M mb = Grid<M>::at(a, S, nmem, b, nb);
  stage_block(a, params, mb.row(), P, sh);
  const int* code = sh.code;
  const int nslot = code[H_NSLOT], mainf = code[H_MAIN];
  const int outw = code[H_OUTW];
  const int* slots = code + code[H_SLOT];
  for (int k = threadIdx.x; k < smem_words; k += blockDim.x) tab[k] = 0u;
  __syncthreads();

  unsigned* grow = gtab + mb.row() * outw;
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  const int per = (n + nb - 1) / nb;
  const int start = b * per, end = min(n, start + per);
  const long long base = (long long)s * D;
  unsigned matched = 0;
  // Every lane of a warp takes the same number of steps and the warp
  // reconverges at the end of each: with a `continue` on a rejected doc,
  // lanes drift apart by whole steps, the loads stop coalescing and the
  // sketch updates run a few lanes at a time (on an H100 that made K3
  // four times slower under chip_smoke.py's filtered config-#4 queries).
  for (int d0 = start; d0 < end; d0 += blockDim.x) {
    const int d = d0 + threadIdx.x;
    const long long i = base + d;
    if (d < end && doc_valid(a, mb, i) &&
        (mainf < 0 || eval_filter<kMask>(a, sh, mainf, mb, i))) {
      ++matched;
      DocCache c = {0u, 0u, 0u};
      T vc[PT_MAX_VALUES];
      for (int j = 0; j < nslot; ++j) {
        const int* sl = slots + j * SLOT_W;
        const int op = sl[0];
        if (!is_sketch(op)) continue;  // K1's slots
        if (!slot_passes<kMask>(a, sh, sl[2], mb, i, c)) continue;
        const int sm = sl[3];
        if (op == S_HLL) {
          const unsigned hi = (unsigned)((const int*)a.cols[mb.u()][sl[6]])[i];
          const unsigned lo = (unsigned)((const int*)a.cols[mb.u()][sl[7]])[i];
          const unsigned h1 = fmix32(fmix32(lo ^ 0x9E3779B9u) ^ hi);
          const unsigned h2 = fmix32(fmix32(hi ^ 0x85EBCA77u) ^ lo);
          const int reg = (int)(h1 & ((1u << sl[4]) - 1u));
          const unsigned rank = (unsigned)__clz((int)h2) + 1u;  // 33 at 0
          if (sm >= 0) atomicMax(tab + sm + reg, rank);
          else atomicMax(grow + sl[5] + reg, rank);
        } else {
          const int v = sl[1];
          if (!(c.vdone & (1u << v))) {
            vc[v] = eval_value<T>(a, sh, v, mb, i);
            c.vdone |= 1u << v;
          }
          const int bk = hist_bucket<T>(vc[v], (T)sh.prm[sl[6]],
                                        (T)sh.prm[sl[7]], sl[4]);
          if (sm >= 0) atomicAdd(tab + sm + bk, 1u);
          else atomicAdd(grow + sl[5] + bk, 1u);
        }
      }
    }
    __syncwarp();
  }

  // matched count: warp sums, then one global atomic per block
  for (int o = 16; o > 0; o >>= 1)
    matched += __shfl_down_sync(0xffffffffu, matched, o);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = matched;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_cnt[w];
    if (total) atomicAdd(grow, total);
  }
  // this block's shared tables, whole, to its row of the partial buffer
  unsigned* prow = partial + (mb.row() * nb + b) * smem_words;
  for (int k = threadIdx.x; k < smem_words; k += blockDim.x) prow[k] = tab[k];
}

// One thread per (output column, segment, member): the matched count, and every
// sketch column, reduced over the nb block partials (max for registers,
// sum for buckets) in block order or read from the global table. Scalar
// slots' columns are K1's and are left as they are.
template <typename T>
__global__ void __launch_bounds__(PT_THREADS)
sketch_finalize(const __grid_constant__ Args a,
                const unsigned* __restrict__ partial,
                const unsigned* __restrict__ gtab, int nb, int smem_words,
                T* __restrict__ out) {
  // the (member, segment) row of partial, gtab and out
  const long long s = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int outw = a.code[H_OUTW];
  if (col >= outw) return;
  const unsigned* grow = gtab + (long long)s * outw;
  T* row = out + (long long)s * outw;
  if (col == 0) {
    row[0] = (T)grow[0];
    return;
  }
  const int nslot = a.code[H_NSLOT];
  const int* slots = a.code + a.code[H_SLOT];
  for (int j = 0; j < nslot; ++j) {
    const int* sl = slots + j * SLOT_W;
    if (!is_sketch(sl[0])) continue;
    const int k = col - sl[5];
    if (k < 0 || k >= sketch_width(sl)) continue;
    const int sm = sl[3];
    if (sm < 0) {
      row[col] = (T)grow[col];
      return;
    }
    unsigned x = 0;
    const unsigned* p = partial + (long long)s * nb * smem_words + sm + k;
    for (int q = 0; q < nb; ++q) {
      const unsigned y = p[(long long)q * smem_words];
      x = sl[0] == S_HLL ? (y > x ? y : x) : x + y;
    }
    row[col] = (T)x;
    return;
  }
}

template <typename T, typename M, bool kMask>
static int launch(const Args* a, const double* params, const int* num_docs,
                  int S, int D, int P, int nb, int B, int smem_words,
                  unsigned* partial, unsigned* gtab, T* out,
                  cudaStream_t st) {
  const size_t dyn = (size_t)smem_words * sizeof(unsigned);
  static std::atomic<unsigned> limit_set{0};
  cudaError_t e =
      pt_smem_limit_max(sketch_agg_kernel<T, M, kMask>, &limit_set);
  if (e != cudaSuccess) return (int)e;
  const int outw = a->code[H_OUTW];
  e = cudaMemsetAsync(gtab, 0, (size_t)B * S * outw * sizeof(unsigned),
                      st);
  if (e != cudaSuccess) return (int)e;
  sketch_agg_kernel<T, M, kMask><<<dim3(nb * B, S), PT_THREADS, dyn, st>>>(
      *a, params, num_docs, S, D, P, B, smem_words, partial, gtab);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sketch_finalize<T><<<dim3((outw + PT_THREADS - 1) / PT_THREADS, S, B),
                       PT_THREADS, 0, st>>>(*a, partial, gtab, nb,
                                            smem_words, out);
  return (int)cudaGetLastError();
}

// K3 in the instantiation the program needs (a CLP mask leaf or not).
template <typename T, typename M>
static int launch_for(const Args* a, const double* params,
                      const int* num_docs, int S, int D, int P, int nb, int B,
                      int smem_words, unsigned* partial, unsigned* gtab,
                      T* out, cudaStream_t st) {
  return has_mask_leaf(a->code)
             ? launch<T, M, true>(a, params, num_docs, S, D, P, nb, B,
                                  smem_words, partial, gtab, out, st)
             : launch<T, M, false>(a, params, num_docs, S, D, P, nb, B,
                                   smem_words, partial, gtab, out, st);
}

// Launches K3 and its finalize pass on `stream` for B members. params:
// [B, S, P] float64; num_docs: [U, S] int32; partial: [B, S, nb,
// smem_words] uint32 scratch (written whole, no zeroing needed); gtab:
// [B, S, out_width] uint32 scratch, zeroed here; out: [B, S, out_width] of
// the value dtype (f64 != 0: float64, else float32), of which K3 writes
// column 0 and its sketch slots' columns. dev: the tensors' device.
// Returns the first CUDA error, or 0.
extern "C" int pt_sketch_agg(const Args* a, const double* params,
                             const int* num_docs, int S, int D, int P,
                             int nb, int B, int smem_words, int f64,
                             unsigned* partial, unsigned* gtab, void* out,
                             int dev, void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const bool one = B == 1 && a->set_of[0] == 0;
  if (f64)
    return one ? launch_for<double, Single>(a, params, num_docs, S, D, P, nb,
                                            B, smem_words, partial, gtab,
                                            (double*)out, st)
               : launch_for<double, Mem>(a, params, num_docs, S, D, P, nb, B,
                                         smem_words, partial, gtab,
                                         (double*)out, st);
  return one ? launch_for<float, Single>(a, params, num_docs, S, D, P, nb, B,
                                         smem_words, partial, gtab,
                                         (float*)out, st)
             : launch_for<float, Mem>(a, params, num_docs, S, D, P, nb, B,
                                      smem_words, partial, gtab, (float*)out,
                                      st);
}
