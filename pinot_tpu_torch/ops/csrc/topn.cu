// K4 topn: per segment of stacked blocks [S, D], the top-k doc ids by an
// order value (or the first k matched docs), packed as [S, 1 + k] int32:
// the matched count, then the winners, -1 where a winner is unmatched.
//
// Replaces pinot_tpu/ops/kernels.py:583 `make_topn_kernel` (mask
// :599-603, the upsert validity mask :604, score :604-623, `lax.top_k` :625-627). The order is that of
// lax.top_k: score descending under the total order of the float's bits
// (+0.0 above -0.0; a float compare holds them equal), ties toward the
// lower doc. The score is the order value, negated for ASC, or -doc when
// unordered; NaN becomes the finite minimum, matched scores are clipped to
// the finite range and unmatched ones are -inf. So a doc is unmatched
// exactly when its key is the key of -inf.
//
// Bound on an H100: bytes. The function reads the filter's columns for
// every doc and the order value for the kept ones and writes k + 1 ints
// per segment; selecting needs a handful of integer operations per doc.
//
// Design (simple and deterministic; see ROADMAP for a faster one). B
// members (interp.cuh: the member axis) make B x S rows; every pass after
// the first works on rows alone, so member m's segment s is row m * S + s.
//   1. keys: grid (B members x blocks per segment, S), the member fastest
//      (a single launch is the B = 1 case). Each doc runs the filter and
//      the order value through interp.cuh and writes its ordered integer
//      key (the float's bits with the sign flip: u32 for float32, u64 for
//      float64) to scratch [B, S, D]; blocks add their matched counts.
//   2-3. threshold and candidates: csrc/topk_select.cuh (shared with K8).
//   4. sort: one block per row sorts its k candidates by (key desc,
//      doc asc) with a bitonic sort in dynamic shared memory (k <= 8192:
//      64 KB for u32 keys, 96 KB for u64) and writes the row.
// Every pass is deterministic, so the output is the same bits every run.
#include "topk_select.cuh"

template <typename T, typename M, bool kMask>
__global__ void __launch_bounds__(PT_THREADS)
topn_keys(const __grid_constant__ Args a, const double* __restrict__ params,
          const int* __restrict__ num_docs, int S, int D, int P, int nmem,
          int asc, typename KeyOf<T>::K* __restrict__ keys,
          long long* __restrict__ state) {
  typedef typename KeyOf<T>::K K;
  __shared__ Shared sh;
  const int s = blockIdx.y;
  int b, nb;
  const M mb = Grid<M>::at(a, S, nmem, b, nb);
  stage_block(a, params, mb.row(), P, sh);
  const int mainf = sh.code[H_MAIN];
  const bool has_value = sh.code[H_NVAL] > 0;
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  int start, end;
  block_range(D, b, nb, start, end);
  const long long base = (long long)s * D;
  K* row_keys = keys + mb.row() * D;
  const K unmatched = KeyOf<T>::of((T)-INFINITY);
  int matched = 0;
  for (int t0 = start; t0 < end; t0 += blockDim.x) {
    const int d = t0 + threadIdx.x;
    bool hit = false;
    if (d < end) {
      const long long i = base + d;
      hit = d < n && doc_valid(a, mb, i) &&
            (mainf < 0 || eval_filter<kMask>(a, sh, mainf, mb, i));
      K key = unmatched;
      if (hit) {
        T sc;
        if (has_value) {
          const T v = eval_value<T, true>(a, sh, 0, mb, i);
          sc = asc ? -v : v;
        } else {
          sc = -(T)d;
        }
        if (sc != sc) sc = KeyOf<T>::lowest();
        sc = sc < KeyOf<T>::lowest() ? KeyOf<T>::lowest()
           : (sc > KeyOf<T>::highest() ? KeyOf<T>::highest() : sc);
        key = KeyOf<T>::of(sc);
      }
      row_keys[d] = key;
    }
    matched += __syncthreads_count(hit);
  }
  if (threadIdx.x == 0 && matched)
    atomicAdd((unsigned long long*)(state + mb.row() * ST_WORDS +
                                    ST_MATCHED),
              (unsigned long long)matched);
}

template <typename K>
__global__ void __launch_bounds__(PT_SORT_THREADS)
topn_sort(const K* __restrict__ cand_key, const int* __restrict__ cand_doc,
          int k, int n2, K unmatched, const long long* __restrict__ state,
          int* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  K* sk = (K*)smem;
  int* sd = (int*)(sk + n2);
  const int s = blockIdx.x;
  load_candidates(cand_key, cand_doc, k, n2, s, sk, sd);
  bitonic_sort(sk, sd, n2);
  int* row = out + (long long)s * (1 + k);
  if (threadIdx.x == 0)
    row[0] = (int)state[(long long)s * ST_WORDS + ST_MATCHED];
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    row[1 + i] = sk[i] == unmatched ? -1 : sd[i];
}

template <typename T>
static int launch(const Args* a, const double* params, const int* num_docs,
                  int S, int D, int P, int nb, int B, int k, int asc,
                  void* keys_v, long long* state, int* hist, int* ties,
                  void* cand_key_v, int* cand_doc, int* out,
                  cudaStream_t st) {
  typedef typename KeyOf<T>::K K;
  K* keys = (K*)keys_v;
  K* cand_key = (K*)cand_key_v;
  cudaError_t err;
#define PT_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  const int R = B * S;  // (member, segment) rows
  topn_init<<<(R + 127) / 128, 128, 0, st>>>(state, R, k);
  PT_CHECK();
  cudaMemsetAsync(hist, 0, sizeof(int) * 256 * (size_t)R, st);
  PT_CHECK();
  if (has_mask_leaf(a->code))
    topn_keys<T, Mem, true><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *a, params, num_docs, S, D, P, B, asc, keys, state);
  else
    topn_keys<T, Mem, false><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *a, params, num_docs, S, D, P, B, asc, keys, state);
  PT_CHECK();
  const int rc = select_candidates<K>(keys, R, D, nb, k, state, hist, ties,
                                      cand_key, cand_doc, st);
  if (rc) return rc;
  const int n2 = sort_width(k);
  const size_t smem = (size_t)n2 * (sizeof(K) + sizeof(int));
  cudaFuncSetAttribute(topn_sort<K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  PT_CHECK();
  const K unmatched = (K)(sizeof(K) == 4 ? 0x007FFFFFull
                                         : 0x000FFFFFFFFFFFFFull);
  topn_sort<K><<<R, PT_SORT_THREADS, smem, st>>>(cand_key, cand_doc, k, n2,
                                                 unmatched, state, out);
  PT_CHECK();
#undef PT_CHECK
  return 0;
}

// Launches K4's passes on `stream` for B members (R = B x S rows).
// params: [B, S, P] float64; num_docs: [U, S] int32; keys: [B, S, D]
// scratch (u32 keys for float32 values, u64 for float64); state:
// [R, ST_WORDS] int64; hist: [R, 256] int32; ties: [R, nb] int32;
// cand_key / cand_doc: [R, k]; out: [B, S, 1 + k] int32. 1 <= k <=
// min(D, 8192), R <= 65535. Returns the first nonzero cudaGetLastError().
extern "C" int pt_topn(const Args* a, const double* params,
                       const int* num_docs, int S, int D, int P, int nb,
                       int B, int f64, int k, int asc, void* keys,
                       long long* state, int* hist, int* ties,
                       void* cand_key, int* cand_doc, int* out, int dev,
                       void* stream) {
  cudaSetDevice(dev);
  if (k < 1 || k > PT_TOPN_MAX_K || k > D || (long long)B * S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch<double>(a, params, num_docs, S, D, P, nb, B, k, asc,
                              keys, state, hist, ties, cand_key, cand_doc,
                              out, st)
             : launch<float>(a, params, num_docs, S, D, P, nb, B, k, asc,
                             keys, state, hist, ties, cand_key, cand_doc,
                             out, st);
}
