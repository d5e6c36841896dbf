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
// the finite range and unmatched ones are -inf. So every matched doc ranks
// above every unmatched one, and the winners past the matched docs are
// the -1 entries: an unmatched doc is never a candidate here.
//
// Bound on an H100: bytes. The function reads the filter's columns for
// every doc and the order value for the kept ones and writes k + 1 ints
// per segment; selecting needs a handful of integer operations per doc.
//
// Design. B members (interp.cuh: the member axis) make B x S rows; every
// pass after the first works on rows alone, so member m's segment s is row
// m * S + s. The select is csrc/topk_select.cuh's compacting radix select
// (K8 shares it) on the composite (key, ~doc): the ordered integer key
// (u32 for float32, u64 for float64) and then the complemented doc id.
//   0. compact: grid (B members x blocks per segment, S), the member
//      fastest (a single launch is the B = 1 case). Each doc runs the
//      filter and the order value through interp.cuh; a kept doc appends
//      its (key, doc) pair to its row's list and counts the key's first
//      digit (`stage_append`, `count_bin`). An unkept doc writes nothing.
//      The list's length is the matched count.
//   1. pick and sift (`sift_passes`), for each of the composite's 8 (u32
//      keys) or 12 (u64) digits: after the compact pass K4 reads only the
//      candidates still in the running, never a [B, S, D] block.
//   2. sort: one block per row sorts its winners by (key desc, doc asc)
//      with a bitonic sort in dynamic shared memory (k <= 8192: 64 KB for
//      u32 keys, 96 KB for u64) and writes the row, -1 past the matched
//      docs.
// Every pass gives the same winners whatever the order of its atomics,
// and the sort orders them, so the output is the same bits every run.
// Scratch: the two lists hold every doc at worst ([2, B, S, D] keys and
// doc ids: 16 bytes a doc for float32, 24 for float64).
#include "topk_select.cuh"

template <typename T, typename M, bool kMask>
__global__ void __launch_bounds__(PT_THREADS)
topn_compact(const __grid_constant__ Args a, const double* __restrict__ params,
             const int* __restrict__ num_docs, int S, int D, int P, int nmem,
             int asc, typename KeyOf<T>::K* __restrict__ lkey,
             int* __restrict__ ldoc, long long* __restrict__ state,
             int* __restrict__ hist) {
  typedef typename KeyOf<T>::K K;
  __shared__ Shared sh;
  __shared__ int wh[PT_WARPS][256];
  __shared__ K wk[PT_WARPS][PT_WSTAGE];
  __shared__ int wd[PT_WARPS][PT_WSTAGE];
  for (int e = threadIdx.x; e < PT_WARPS * 256; e += blockDim.x)
    (&wh[0][0])[e] = 0;
  const int s = blockIdx.y;
  int b, nb;
  const M mb = Grid<M>::at(a, S, nmem, b, nb);
  stage_block(a, params, mb.row(), P, sh);
  const int mainf = sh.code[H_MAIN];
  const bool has_value = sh.code[H_NVAL] > 0;
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  int start, end;
  block_range(n, b, nb, start, end);
  const long long base = (long long)s * D;
  const long long row = mb.row();
  long long* cnt = state + row * TS_WORDS + TS_N0;
  K* lk = lkey + row * D;
  int* ld = ldoc + row * D;
  const int w = threadIdx.x >> 5;
  int fill = 0;
  for (int t0 = start; t0 < end; t0 += blockDim.x) {
    const int d = t0 + threadIdx.x;
    const long long i = base + d;
    const bool hit = d < end && doc_valid(a, mb, i) &&
                     (mainf < 0 || eval_filter<kMask>(a, sh, mainf, mb, i));
    K key = 0;
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
    stage_append<K>(hit, key, d, wk[w], wd[w], fill, cnt, lk, ld, D,
                    false);
    count_bin(hit ? digit_of<K>(key, d, 0) : -1, wh[w]);
  }
  stage_append<K>(false, (K)0, 0, wk[w], wd[w], fill, cnt, lk, ld, D, true);
  flush_hist(wh, hist + row * 256);
}

template <typename K>
__global__ void __launch_bounds__(PT_SORT_THREADS)
topn_sort(const K* __restrict__ cand_key, const int* __restrict__ cand_doc,
          int k, int n2, const long long* __restrict__ state,
          int* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  K* sk = (K*)smem;
  int* sd = (int*)(sk + n2);
  const long long s = blockIdx.x;
  const long long* st = state + s * TS_WORDS;
  const int won = (int)min(st[TS_SLOT], (long long)k);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    sk[i] = i < won ? cand_key[s * k + i] : (K)0;
    sd[i] = i < won ? cand_doc[s * k + i] : 0x7FFFFFFF;
  }
  __syncthreads();
  bitonic_sort(sk, sd, n2);
  int* row = out + s * (1 + k);
  if (threadIdx.x == 0) row[0] = (int)st[TS_MATCHED];
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    row[1 + i] = i < won ? sd[i] : -1;
}

template <typename T>
static int launch(const Args* a, const double* params, const int* num_docs,
                  int S, int D, int P, int nb, int B, int k, int asc,
                  void* keys_v, int* docs, long long* state, int* hist,
                  void* cand_key_v, int* cand_doc, int* out,
                  cudaStream_t st) {
  typedef typename KeyOf<T>::K K;
  K* keys = (K*)keys_v;
  K* cand_key = (K*)cand_key_v;
  cudaError_t err;
#define PT_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  const int R = B * S;  // (member, segment) rows
  topn_start<<<(R + 127) / 128, 128, 0, st>>>(state, R, k);
  PT_CHECK();
  cudaMemsetAsync(hist, 0, sizeof(int) * 256 * (size_t)R, st);
  PT_CHECK();
  if (has_mask_leaf(a->code))
    topn_compact<T, Mem, true><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *a, params, num_docs, S, D, P, B, asc, keys, docs, state, hist);
  else
    topn_compact<T, Mem, false><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *a, params, num_docs, S, D, P, B, asc, keys, docs, state, hist);
  PT_CHECK();
  // the sifts' grid: about 2048 blocks over the rows, at most nb a row
  int nbl = (2048 + R - 1) / R;
  nbl = nbl < 1 ? 1 : (nbl > nb ? nb : nbl);
  const int rc = sift_passes<K>(keys, docs, R, D, nbl, k, -1, state, hist,
                                cand_key, cand_doc, st);
  if (rc) return rc;
  const int n2 = sort_width(k);
  const size_t smem = (size_t)n2 * (sizeof(K) + sizeof(int));
  static std::atomic<unsigned> limit_set{0};
  if ((err = pt_smem_limit_max(topn_sort<K>, &limit_set)) != cudaSuccess)
    return (int)err;
  topn_sort<K><<<R, PT_SORT_THREADS, smem, st>>>(cand_key, cand_doc, k, n2,
                                                 state, out);
  PT_CHECK();
#undef PT_CHECK
  return 0;
}

// Launches K4's passes on `stream` for B members (R = B x S rows).
// params: [B, S, P] float64; num_docs: [U, S] int32; keys: [2, B, S, D]
// candidate keys (u32 for float32 values, u64 for float64); docs: [2, B,
// S, D] int32 candidate doc ids; state: [R, TS_WORDS] int64; hist: [R,
// 256] int32; cand_key / cand_doc: [R, k]; out: [B, S, 1 + k] int32.
// 1 <= k <= min(D, 8192), R <= 65535. Returns the first nonzero
// cudaGetLastError().
extern "C" int pt_topn(const Args* a, const double* params,
                       const int* num_docs, int S, int D, int P, int nb,
                       int B, int f64, int k, int asc, void* keys, int* docs,
                       long long* state, int* hist, void* cand_key,
                       int* cand_doc, int* out, int dev, void* stream) {
  cudaSetDevice(dev);
  if (k < 1 || k > PT_TOPN_MAX_K || k > D || (long long)B * S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch<double>(a, params, num_docs, S, D, P, nb, B, k, asc,
                              keys, docs, state, hist, cand_key, cand_doc,
                              out, st)
             : launch<float>(a, params, num_docs, S, D, P, nb, B, k, asc,
                             keys, docs, state, hist, cand_key, cand_doc,
                             out, st);
}
