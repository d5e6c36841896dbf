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
//   2. threshold: an MSB-first radix select over the keys, 8-bit digits.
//      Per digit a histogram pass counts the digits of the keys that share
//      the higher digits found so far (per-warp shared histograms,
//      warp-aggregated with __match_any_sync), and a one-block pass per
//      segment picks the digit holding the k-th key. At the end T is the
//      k-th largest key, c_gt the count of keys above it and k_eq = k - c_gt
//      the ties at T that make the cut.
//   3. candidates: a count pass records each block's ties at T; a collect
//      pass writes every key above T (at a slot from an atomic counter: the
//      final sort fixes their order) and the first k_eq ties in doc order
//      (a tie's rank = the ties of earlier blocks + its rank in its block,
//      from warp ballots, tile by tile in doc order).
//   4. sort: one block per row sorts its k candidates by (key desc,
//      doc asc) with a bitonic sort in dynamic shared memory (k <= 8192:
//      64 KB for u32 keys, 96 KB for u64) and writes the row.
// Every pass is deterministic, so the output is the same bits every run.
#include "interp.cuh"

#include <float.h>
#include <stdint.h>

#define PT_TOPN_MAX_K 8192
#define PT_SORT_THREADS 1024
#define PT_WARPS (PT_THREADS / 32)
// per-segment state words (ops/_cuda.py TOPN_STATE_WORDS)
enum { ST_PREFIX, ST_KREM, ST_CGT, ST_MATCHED, ST_SLOT, ST_WORDS };

template <typename T> struct KeyOf;
template <> struct KeyOf<float> {
  typedef uint32_t K;
  static __device__ __forceinline__ K of(float x) {
    const uint32_t b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  static __device__ __forceinline__ float lowest() { return -FLT_MAX; }
  static __device__ __forceinline__ float highest() { return FLT_MAX; }
};
template <> struct KeyOf<double> {
  typedef unsigned long long K;
  static __device__ __forceinline__ K of(double x) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(x);
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
  static __device__ __forceinline__ double lowest() { return -DBL_MAX; }
  static __device__ __forceinline__ double highest() { return DBL_MAX; }
};

// The contiguous doc range [start, end) of block b of nb over D docs.
__device__ __forceinline__ void block_range(int D, int b, int nb, int& start,
                                            int& end) {
  const int per = (D + nb - 1) / nb;
  start = min(D, b * per);
  end = min(D, start + per);
}

__global__ void topn_init(long long* __restrict__ state, int R, int k) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= R) return;
  long long* st = state + (long long)s * ST_WORDS;
  st[ST_PREFIX] = 0;
  st[ST_KREM] = k;
  st[ST_CGT] = 0;
  st[ST_MATCHED] = 0;
  st[ST_SLOT] = 0;
}

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

// The digit at `shift` of every key that shares the digits above it with
// the prefix found so far, counted into hist [R, 256].
template <typename K>
__global__ void __launch_bounds__(PT_THREADS)
topn_hist(const K* __restrict__ keys, int D, int shift,
          const long long* __restrict__ state, int* __restrict__ hist) {
  __shared__ int wh[PT_WARPS][256];
  const int s = blockIdx.y;
  for (int e = threadIdx.x; e < PT_WARPS * 256; e += blockDim.x)
    (&wh[0][0])[e] = 0;
  __syncthreads();
  const int hi = shift + 8;
  const K prefix = (K)state[(long long)s * ST_WORDS + ST_PREFIX];
  const bool all = hi >= (int)(8 * sizeof(K));
  const K want = all ? (K)0 : (prefix >> hi);
  int start, end;
  block_range(D, blockIdx.x, gridDim.x, start, end);
  const long long base = (long long)s * D;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t0 = start; t0 < end; t0 += blockDim.x) {
    const int d = t0 + threadIdx.x;
    int bin = -1;
    if (d < end) {
      const K key = keys[base + d];
      if (all || (key >> hi) == want) bin = (int)((key >> shift) & 0xFF);
    }
    // one shared-memory add per distinct bin of the warp
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      wh[w][bin] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int bin = threadIdx.x; bin < 256; bin += blockDim.x) {
    int c = 0;
    for (int j = 0; j < PT_WARPS; ++j) c += wh[j][bin];
    if (c) atomicAdd(hist + (long long)s * 256 + bin, c);
  }
}

// One block per row: the digit holding the k-th key; clears hist.
__global__ void topn_pick(int* __restrict__ hist,
                          long long* __restrict__ state, int shift) {
  __shared__ int h[256];
  const int s = blockIdx.x;
  int* row = hist + (long long)s * 256;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    h[b] = row[b];
    row[b] = 0;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long* st = state + (long long)s * ST_WORDS;
  const long long krem = st[ST_KREM];
  long long cum = 0;
  for (int b = 255; b >= 0; --b) {
    if (cum + h[b] >= krem) {
      st[ST_PREFIX] = (long long)((unsigned long long)st[ST_PREFIX] |
                                  ((unsigned long long)b << shift));
      st[ST_KREM] = krem - cum;
      st[ST_CGT] += cum;
      return;
    }
    cum += h[b];
  }
}

// Each block's count of keys equal to T, into ties [R, nb].
template <typename K>
__global__ void __launch_bounds__(PT_THREADS)
topn_count(const K* __restrict__ keys, int D,
           const long long* __restrict__ state, int* __restrict__ ties) {
  const int s = blockIdx.y;
  const K T = (K)state[(long long)s * ST_WORDS + ST_PREFIX];
  int start, end;
  block_range(D, blockIdx.x, gridDim.x, start, end);
  const long long base = (long long)s * D;
  int c = 0;
  for (int t0 = start; t0 < end; t0 += blockDim.x) {
    const int d = t0 + threadIdx.x;
    c += __syncthreads_count(d < end && keys[base + d] == T);
  }
  if (threadIdx.x == 0) ties[(long long)s * gridDim.x + blockIdx.x] = c;
}

template <typename K>
__global__ void __launch_bounds__(PT_THREADS)
topn_collect(const K* __restrict__ keys, int D, int k,
             long long* __restrict__ state, const int* __restrict__ ties,
             K* __restrict__ cand_key, int* __restrict__ cand_doc) {
  __shared__ int wsum[PT_WARPS];
  __shared__ int before_sh;
  const int s = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  long long* st = state + (long long)s * ST_WORDS;
  const K T = (K)st[ST_PREFIX];
  const int keq = (int)st[ST_KREM], cgt = (int)st[ST_CGT];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // ties in the blocks before this one, in block order
  int c = 0;
  for (int j = threadIdx.x; j < b; j += blockDim.x)
    c += ties[(long long)s * nb + j];
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, o);
  if (threadIdx.x == 0) before_sh = 0;
  __syncthreads();
  if (lane == 0) atomicAdd(&before_sh, c);
  __syncthreads();
  int run = before_sh;
  int start, end;
  block_range(D, b, nb, start, end);
  const long long base = (long long)s * D;
  K* ck = cand_key + (long long)s * k;
  int* cd = cand_doc + (long long)s * k;
  for (int t0 = start; t0 < end; t0 += blockDim.x) {
    const int d = t0 + threadIdx.x;
    K key = 0;
    if (d < end) key = keys[base + d];
    const bool gt = d < end && key > T;
    const bool eq = d < end && key == T;
    if (gt) {
      const int slot = (int)atomicAdd(
          (unsigned long long*)(st + ST_SLOT), 1ull);
      ck[slot] = key;
      cd[slot] = d;
    }
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, eq);
    if (lane == 0) wsum[w] = __popc(bal);
    __syncthreads();
    int off = run, total = 0;
    for (int j = 0; j < PT_WARPS; ++j) {
      if (j < w) off += wsum[j];
      total += wsum[j];
    }
    if (eq) {
      const int rank = off + __popc(bal & ((1u << lane) - 1u));
      if (rank < keq) {
        ck[cgt + rank] = key;
        cd[cgt + rank] = d;
      }
    }
    run += total;
    __syncthreads();
  }
}

// x before y in the output: key descending, then doc ascending.
template <typename K>
__device__ __forceinline__ bool before(K kx, int dx, K ky, int dy) {
  return kx > ky || (kx == ky && dx < dy);
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
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    if (i < k) {
      sk[i] = cand_key[(long long)s * k + i];
      sd[i] = cand_doc[(long long)s * k + i];
    } else {  // below every real key (0 is the key of a negative NaN)
      sk[i] = 0;
      sd[i] = 0x7FFFFFFF;
    }
  }
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        const int j = i ^ stride;
        if (j <= i) continue;
        const bool first = (i & size) == 0;
        const bool swap = first ? before(sk[j], sd[j], sk[i], sd[i])
                                : before(sk[i], sd[i], sk[j], sd[j]);
        if (swap) {
          const K tk = sk[i]; sk[i] = sk[j]; sk[j] = tk;
          const int td = sd[i]; sd[i] = sd[j]; sd[j] = td;
        }
      }
      __syncthreads();
    }
  }
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
  const dim3 grid(nb, R);
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
  for (int shift = 8 * (int)sizeof(K) - 8; shift >= 0; shift -= 8) {
    topn_hist<K><<<grid, PT_THREADS, 0, st>>>(keys, D, shift, state, hist);
    PT_CHECK();
    topn_pick<<<R, 256, 0, st>>>(hist, state, shift);
    PT_CHECK();
  }
  topn_count<K><<<grid, PT_THREADS, 0, st>>>(keys, D, state, ties);
  PT_CHECK();
  topn_collect<K><<<grid, PT_THREADS, 0, st>>>(keys, D, k, state, ties,
                                               cand_key, cand_doc);
  PT_CHECK();
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
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
