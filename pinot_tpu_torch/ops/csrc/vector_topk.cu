// K8 vector_topk: per segment of stacked vector blocks, the top-k docs by
// cosine similarity to the query, then the residual filter on the winners,
// packed as [S, 1 + 2 kk] float32: the count of kept winners, kk doc ids
// (-1 where a winner is not kept) and their scores (-inf there).
//
// Replaces pinot_tpu/ops/vector_device.py:104 `make_vector_kernel` and :163
// `make_batched_vector_kernel` (scores :127-128, the IVF probe mask
// :132-137, `lax.top_k` :138-139, the residual filter and validity mask
// :143-148, the keep rule :149-152). A doc competes when it is a real doc
// (d < num_docs[s]) and, with IVF, when the member's probe mask holds its
// cell (clipped into [0, cells_pad)); its score is V[s, d, :] . q[s, :],
// every other doc's -inf. The top kk = min(k_pad, D) come in lax.top_k's
// order: score descending under the total order of the float's bits (+0.0
// above -0.0), ties toward the lower doc; a NaN score ranks above +inf
// (the order of the positive NaN XLA computes), all NaNs alike. Winners
// are chosen before the filter: winner j is kept when j < k[s], its score
// is above -inf and the residual filter and the validity mask hold at its
// doc, so a dropped winner is never replaced by a loser.
//
// Bound on an H100: bytes. Exact search reads every real doc's row,
// dim_pad x 4 bytes; with IVF each doc's 4-byte cell id, then the row of
// the docs in a probed cell only (about nprobe / n_cells of them). The
// product and the selection are a few operations per byte.
//
// Design (simple and right first; ROADMAP names a faster one). B members
// (interp.cuh: the member axis) make B x S rows, row m * S + s.
//   1. keys: grid (B members x blocks per segment, S), the member fastest.
//      A warp takes 32 docs at a time: each lane reads its doc's cell id
//      and probe bit (IVF), the candidates' ranks come from a ballot, and
//      the warp computes the candidates' dot products, min(32, dim_pad / 4)
//      lanes to a row, each lane loading 16 bytes of the row at a time
//      (coalesced), so a doc outside the probed cells costs no vector read.
//      The sum has one fixed order, which the plain version
//      (ops/vector_device.py `dot_scores`) repeats: lane l adds the
//      products of its 4-float chunks l, l + L, l + 2L, ... in order onto
//      -0.0 (the exact identity of IEEE addition, so a sum of -0.0
//      products stays -0.0), then a shuffle tree halves the lanes, lane i
//      adding lane i + L/2, ..., i + 1. The build passes --fmad=false, so
//      every product and sum rounds once. Each doc's total-order u32 key
//      (-inf's for a non-candidate) goes to scratch [B, S, D]. Offsets are
//      64-bit: S x D x dim_pad passes 2^31 at the vector leg's block.
//   2. threshold and candidates: csrc/topk_select.cuh, K4's passes.
//   3. finish: one block per row sorts its kk candidates by (key desc, doc
//      asc) in shared memory, then each thread takes a winner, evaluates
//      the residual filter and the validity mask at that doc alone through
//      interp.cuh, applies the k[s] cut and the -inf test, and writes the
//      packed row.
#include "topk_select.cuh"

#define VT_FULL 0xFFFFFFFFu

// Passed by value (__grid_constant__): the residual filter's launch
// arguments (interp.cuh `Args`: column sets, validity masks, LUTs, the
// program, the member-to-set map), then per column set the vector block
// [S, D * dim_pad] float32 and the IVF cell block [S, D] int32 (null
// without cells). Its size is checked against the ctypes mirror
// (ops/_cuda.py `_VecArgs`) when the library loads.
struct VecArgs {
  Args a;
  const float* vec[PT_MAX_SETS];
  const int* cell[PT_MAX_SETS];
};

extern "C" int pt_vec_args_bytes() { return (int)sizeof(VecArgs); }

// A score's total-order key; every NaN takes the key of the canonical
// positive NaN, above +inf.
__device__ __forceinline__ unsigned score_key(float x) {
  return x != x ? 0xFFFFFFFFu : KeyOf<float>::of(x);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__global__ void __launch_bounds__(PT_THREADS)
vec_keys(const __grid_constant__ VecArgs va, const int* __restrict__ num_docs,
         const float* __restrict__ q, const unsigned char* __restrict__ cells,
         int S, int D, int dim_pad, int cells_pad, int nmem,
         unsigned* __restrict__ keys) {
  __shared__ int slot_doc[PT_WARPS][32];
  __shared__ float sc[PT_WARPS][32];
  const int s = blockIdx.y;
  int b, nb;
  const Mem mb = Grid<Mem>::at(va.a, S, nmem, b, nb);
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  int start, end;
  block_range(D, b, nb, start, end);
  const float* V = va.vec[mb.u()] + (long long)s * D * dim_pad;
  const int* cell = cells == nullptr ? nullptr
                                     : va.cell[mb.u()] + (long long)s * D;
  const unsigned char* probe =
      cells == nullptr ? nullptr : cells + mb.row() * cells_pad;
  const float4* q4 = (const float4*)(q + mb.row() * dim_pad);
  unsigned* row_keys = keys + mb.row() * D;
  const unsigned none = KeyOf<float>::of(-INFINITY);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nch = dim_pad >> 2;    // 4-float chunks of a row
  const int L = min(32, nch);      // lanes to a row
  const int G = 32 / L;            // rows a warp computes at once
  const int g = lane / L, li = lane % L;
  for (int t0 = start + w * 32; t0 < end; t0 += PT_WARPS * 32) {
    const int d = t0 + lane;
    bool cand = d < end && d < n;
    if (cand && cell != nullptr) {
      const int c = min(max(cell[d], 0), cells_pad - 1);
      cand = probe[c] != 0;
    }
    const unsigned bal = __ballot_sync(VT_FULL, cand);
    if (cand) slot_doc[w][__popc(bal & ((1u << lane) - 1u))] = lane;
    __syncwarp();
    const int nc = __popc(bal);
    for (int base = 0; base < nc; base += G) {
      const int r = base + g;
      int j = 0;
      float acc = -0.0f;
      if (r < nc) {
        j = slot_doc[w][r];
        const float4* row = (const float4*)(V + (long long)(t0 + j) *
                                                    dim_pad);
        for (int c = li; c < nch; c += L) {
          const float4 x = row[c];
          const float4 y = q4[c];
          acc = __fadd_rn(acc, __fmul_rn(x.x, y.x));
          acc = __fadd_rn(acc, __fmul_rn(x.y, y.y));
          acc = __fadd_rn(acc, __fmul_rn(x.z, y.z));
          acc = __fadd_rn(acc, __fmul_rn(x.w, y.w));
        }
      }
      for (int off = L >> 1; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_down_sync(VT_FULL, acc, off, L));
      if (r < nc && li == 0) sc[w][j] = acc;
    }
    __syncwarp();
    if (d < end) row_keys[d] = cand ? score_key(sc[w][lane]) : none;
    __syncwarp();
  }
}

template <bool kMask>
__global__ void __launch_bounds__(PT_SORT_THREADS)
vec_finish(const __grid_constant__ VecArgs va,
           const double* __restrict__ params,
           const int* __restrict__ num_docs, const int* __restrict__ kq,
           int S, int D, int P, int kk, int n2,
           const unsigned* __restrict__ cand_key,
           const int* __restrict__ cand_doc, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  __shared__ Shared sh;
  unsigned* sk = (unsigned*)smem;
  int* sd = (int*)(sk + n2);
  const int r = blockIdx.x;  // row m * S + s
  const int s = r % S;
  Mem mb;
  mb.u_ = va.a.set_of[r / S];
  mb.row_ = r;
  stage_block(va.a, params, r, P, sh);
  load_candidates(cand_key, cand_doc, kk, n2, r, sk, sd);
  bitonic_sort(sk, sd, n2);
  const int mainf = sh.code[H_MAIN];
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  const int kr = kq[r];
  float* row = out + (long long)r * (1 + 2 * kk);
  int kept = 0;
  for (int i0 = 0; i0 < kk; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool keep = false;
    if (i < kk) {
      const int d = sd[i];
      const float score = key_score(sk[i]);
      const long long doc = (long long)s * D + d;
      keep = i < kr && score > -INFINITY && d < n &&
             doc_valid(va.a, mb, doc) &&
             (mainf < 0 || eval_filter<kMask>(va.a, sh, mainf, mb, doc));
      row[1 + i] = keep ? (float)d : -1.0f;
      row[1 + kk + i] = keep ? score : -INFINITY;
    }
    kept += __syncthreads_count(keep);
  }
  if (threadIdx.x == 0) row[0] = (float)kept;
}

// Launches K8's passes on `stream` for B members (R = B x S rows).
// params: [B, S, P] float64 (the residual filter's); num_docs: [U, S]
// int32; q: [B, S, dim_pad] float32; kq: [B, S] int32; cells: [B, S,
// cells_pad] bool probe masks (null: exact search); keys: [B, S, D] u32
// scratch; state: [R, ST_WORDS] int64; hist: [R, 256] int32; ties: [R, nb]
// int32; cand_key / cand_doc: [R, kk]; out: [B, S, 1 + 2 kk] float32.
// 1 <= kk <= min(D, 8192), dim_pad a power of two >= 8, R <= 65535. Returns
// the first nonzero cudaGetLastError().
extern "C" int pt_vector_topk(const VecArgs* va, const double* params,
                              const int* num_docs, const float* q,
                              const int* kq, const unsigned char* cells,
                              int S, int D, int P, int dim_pad, int cells_pad,
                              int nb, int B, int kk, unsigned* keys,
                              long long* state, int* hist, int* ties,
                              unsigned* cand_key, int* cand_doc, float* out,
                              int dev, void* stream) {
  cudaSetDevice(dev);
  if (kk < 1 || kk > PT_TOPN_MAX_K || kk > D || (long long)B * S > 65535 ||
      dim_pad < 8 || (dim_pad & (dim_pad - 1)) != 0 ||
      (cells != nullptr && cells_pad < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define PT_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  const int R = B * S;
  topn_init<<<(R + 127) / 128, 128, 0, st>>>(state, R, kk);
  PT_CHECK();
  cudaMemsetAsync(hist, 0, sizeof(int) * 256 * (size_t)R, st);
  PT_CHECK();
  vec_keys<<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
      *va, num_docs, q, cells, S, D, dim_pad, cells_pad, B, keys);
  PT_CHECK();
  const int rc = select_candidates<unsigned>(keys, R, D, nb, kk, state, hist,
                                             ties, cand_key, cand_doc, st);
  if (rc) return rc;
  const int n2 = sort_width(kk);
  const size_t smem = (size_t)n2 * (sizeof(unsigned) + sizeof(int));
  if (has_mask_leaf(va->a.code)) {
    cudaFuncSetAttribute(vec_finish<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    PT_CHECK();
    vec_finish<true><<<R, PT_SORT_THREADS, smem, st>>>(
        *va, params, num_docs, kq, S, D, P, kk, n2, cand_key, cand_doc, out);
  } else {
    cudaFuncSetAttribute(vec_finish<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    PT_CHECK();
    vec_finish<false><<<R, PT_SORT_THREADS, smem, st>>>(
        *va, params, num_docs, kq, S, D, P, kk, n2, cand_key, cand_doc, out);
  }
  PT_CHECK();
#undef PT_CHECK
  return 0;
}
