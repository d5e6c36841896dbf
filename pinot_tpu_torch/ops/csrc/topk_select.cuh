// K8 (vector_topk.cu): the exact top-k of each row of a [R, D] block of
// ordered integer keys (a float's bits with the sign flip), in (key
// descending, doc ascending) order, the order XLA's top_k gives floats. R
// rows are (member, segment) pairs. K4 (topn.cu) selects with its own
// compacting passes and takes from here the key map (KeyOf), the block
// range and the final sort (bitonic_sort, sort_width).
//
//   threshold: an MSB-first radix select over the keys, 8-bit digits. Per
//      digit a histogram pass counts the digits of the keys that share the
//      higher digits found so far (per-warp shared histograms,
//      warp-aggregated with __match_any_sync), and a one-block pass per row
//      picks the digit holding the k-th key. At the end T is the k-th
//      largest key, c_gt the count of keys above it and k_eq = k - c_gt the
//      ties at T that make the cut.
//   candidates: a count pass records each block's ties at T; a collect pass
//      writes every key above T (at a slot from an atomic counter: the final
//      sort fixes their order) and the first k_eq ties in doc order (a tie's
//      rank = the ties of earlier blocks + its rank in its block, from warp
//      ballots, tile by tile in doc order).
//   sort: `bitonic_sort` orders one row's k candidates in dynamic shared
//      memory with the block's threads; the caller's kernel loads them
//      (`load_candidates`) and writes its own output row.
// Every pass is deterministic, so a row's result is the same bits every run.
#pragma once

#include "interp.cuh"

#include <float.h>
#include <stdint.h>

#define PT_TOPN_MAX_K 8192
#define PT_SORT_THREADS 1024
#define PT_WARPS (PT_THREADS / 32)
// per-row state words (ops/_cuda.py TOPN_STATE_WORDS)
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


// Row s's k candidates into shared memory, padded to n2 (a power of two)
// with entries below every real key (0 is the key of a negative NaN).
template <typename K>
__device__ __forceinline__ void load_candidates(
    const K* __restrict__ cand_key, const int* __restrict__ cand_doc, int k,
    int n2, long long s, K* sk, int* sd) {
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    if (i < k) {
      sk[i] = cand_key[s * k + i];
      sd[i] = cand_doc[s * k + i];
    } else {
      sk[i] = 0;
      sd[i] = 0x7FFFFFFF;
    }
  }
  __syncthreads();
}

// Sorts n2 (key, doc) pairs in shared memory by before(), with every
// thread of the block; returns after a barrier.
template <typename K>
__device__ void bitonic_sort(K* sk, int* sd, int n2) {
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
}

// The power of two that holds k candidates.
static inline int sort_width(int k) {
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
  return n2;
}

// The threshold and candidate passes over keys [R, D] on `st`, after
// topn_init and a zeroed hist: cand_key / cand_doc [R, k] then hold each
// row's k winners in no order. Returns the first nonzero
// cudaGetLastError().
template <typename K>
static int select_candidates(const K* keys, int R, int D, int nb, int k,
                             long long* state, int* hist, int* ties,
                             K* cand_key, int* cand_doc, cudaStream_t st) {
  cudaError_t err;
  const dim3 grid(nb, R);
  for (int shift = 8 * (int)sizeof(K) - 8; shift >= 0; shift -= 8) {
    topn_hist<K><<<grid, PT_THREADS, 0, st>>>(keys, D, shift, state, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    topn_pick<<<R, 256, 0, st>>>(hist, state, shift);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  topn_count<K><<<grid, PT_THREADS, 0, st>>>(keys, D, state, ties);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topn_collect<K><<<grid, PT_THREADS, 0, st>>>(keys, D, k, state, ties,
                                               cand_key, cand_doc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
