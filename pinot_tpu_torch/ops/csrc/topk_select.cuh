// The compacting top-k select that K4 (topn.cu) and K8 (vector_topk.cu)
// share: the exact k largest of each row's (key, doc) candidates in (key
// descending, doc ascending) order, the order XLA's top_k gives floats. R
// rows are (member, segment) pairs; keys are ordered integers (a float's
// bits with the sign flip: KeyOf).
//
// The select is an MSB-first radix select, 8 bits a digit, on the
// composite (key, ~doc): the key and then the complemented doc id, so no
// two candidates tie, and the k largest composites are the k winners in
// top_k's order whatever order the candidates were compacted in.
//   compact (the caller's kernel): each candidate appends its (key, doc)
//      pair to its row's list (`stage_append`: a slot from a warp ballot
//      into the warp's shared stage of PT_WSTAGE pairs, the stage appended
//      with one atomic when full) and counts the key's first digit into
//      per-warp shared histograms (`count_bin`), merged per block into the
//      row's [256] histogram (`flush_hist`). The list's length is the
//      row's candidate count (TS_N0).
//   pick (`topn_pick_digit`, one block per row): the digit holding the
//      k-th largest composite among the row's candidates, and how many of
//      that bucket's candidates still make the cut. Where every candidate
//      makes it (k or fewer left, or the bucket exactly fills the cut) the
//      row is settled: no candidate passes on. A row whose list holds at
//      most `local` pairs is left to the caller (TS_LOCAL: K8 selects it
//      in one block's shared memory).
//   sift (`topn_sift`): each candidate of the row's list above the picked
//      digit is a winner (appended to the row's k winners); one in the
//      picked bucket passes on to the next list (two lists, ping-pong) and
//      counts its next digit; the rest drop. Then pick again, for each of
//      the composite's 8 (u32 keys) or 12 (u64) digits (`sift_passes`);
//      the last sift takes the picked bucket's one candidate as the k-th
//      winner. After the compact pass only the candidates still in the
//      running are read.
//   sort (`bitonic_sort`): one block orders a row's winners in dynamic
//      shared memory; the caller's kernel writes its own output row.
// Every pass gives the same winners whatever the order of its atomics, and
// the sort orders them, so a row's result is the same bits every run.
#pragma once

#include "interp.cuh"

#include <float.h>
#include <stdint.h>

#define PT_TOPN_MAX_K 8192
#define PT_SORT_THREADS 1024
#define PT_WARPS (PT_THREADS / 32)
// pairs a warp stages in shared memory before it appends them to its row's
// list (8 KB a block for u32 keys, 12 KB for u64)
#define PT_WSTAGE 128
// per-row state words (ops/_cuda.py TOPN_ROW_WORDS)
enum { TS_DIGIT, TS_KREM, TS_MATCHED, TS_SLOT, TS_N0, TS_N1, TS_SETTLED,
       TS_WORDS };
// TS_SETTLED: 0 running, 1 settled, TS_LOCAL left to the caller's select
#define TS_LOCAL 2

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

// Digit p (0 = the most significant) of the composite (key, ~doc).
template <typename K>
__device__ __forceinline__ int digit_of(K key, int doc, int p) {
  constexpr int KB = (int)sizeof(K);
  if (p < KB) return (int)((key >> (8 * (KB - 1 - p))) & 0xFF);
  return (int)(((unsigned)~doc >> (8 * (3 - (p - KB)))) & 0xFFu);
}

__global__ void topn_start(long long* __restrict__ state, int R, int k) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= R) return;
  long long* st = state + (long long)s * TS_WORDS;
  st[TS_DIGIT] = 0;
  st[TS_KREM] = k;
  st[TS_MATCHED] = 0;
  st[TS_SLOT] = 0;
  st[TS_N0] = 0;
  st[TS_N1] = 0;
  st[TS_SETTLED] = 0;
}

// Appends a warp's flagged (key, doc) pairs to list `lk` / `ld` at slots
// from the counter `*n` (one atomic per warp); returns after the warp's
// writes are issued.
template <typename K>
__device__ __forceinline__ void append(bool put, K key, int doc,
                                       long long* n, K* lk, int* ld,
                                       int* wslot) {
  const unsigned bal = __ballot_sync(0xFFFFFFFFu, put);
  const int lane = threadIdx.x & 31;
  if (bal) {
    if (lane == __ffs(bal) - 1)
      *wslot = (int)atomicAdd((unsigned long long*)n,
                              (unsigned long long)__popc(bal));
    __syncwarp();
    if (put) {
      const int at = *wslot + __popc(bal & ((1u << lane) - 1u));
      lk[at] = key;
      ld[at] = doc;
    }
    __syncwarp();
  }
}

// A warp's flagged (key, doc) pairs into its shared stage (wk, wd:
// PT_WSTAGE pairs; `fill` of them held, the same in every lane), and, once
// the stage has less than a warp's room left (or at `flush`), the stage
// onto the row's list at a slot from one atomic on *n: one atomic per
// stage-full where one per warp step would serialize on the row's counter
// when most docs are kept. With kCap the list holds `cap` pairs: *n still
// counts the pairs past it, which are not written (K8's lists, sized by
// the host's bound); without, the caller's list has room for them all.
// Every lane of the warp calls it.
template <typename K, bool kCap = false>
__device__ __forceinline__ void stage_append(bool put, K key, int doc, K* wk,
                                             int* wd, int& fill,
                                             long long* n, K* lk, int* ld,
                                             long long cap, bool flush) {
  const unsigned bal = __ballot_sync(0xFFFFFFFFu, put);
  const int lane = threadIdx.x & 31;
  if (put) {
    const int at = fill + __popc(bal & ((1u << lane) - 1u));
    wk[at] = key;
    wd[at] = doc;
  }
  fill += __popc(bal);
  if (flush ? fill > 0 : fill > PT_WSTAGE - 32) {
    __syncwarp();
    unsigned long long b0 = 0;
    if (lane == 0)
      b0 = atomicAdd((unsigned long long*)n, (unsigned long long)fill);
    b0 = __shfl_sync(0xFFFFFFFFu, b0, 0);
    for (int i = lane; i < fill; i += 32) {
      if (!kCap || (long long)b0 + i < cap) {
        lk[b0 + i] = wk[i];
        ld[b0 + i] = wd[i];
      }
    }
    __syncwarp();
    fill = 0;
  }
}

// Adds bin (or nothing, for -1) to the warp's shared histogram: one add per
// distinct bin of the warp.
__device__ __forceinline__ void count_bin(int bin, int* wh) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    wh[bin] += __popc(peers);
  __syncwarp();
}

// The block's per-warp histograms into the row's.
__device__ __forceinline__ void flush_hist(int (*wh)[256], int* row) {
  __syncthreads();
  for (int bin = threadIdx.x; bin < 256; bin += blockDim.x) {
    int c = 0;
    for (int j = 0; j < PT_WARPS; ++j) c += wh[j][bin];
    if (c) atomicAdd(row + bin, c);
  }
}

// One block per row, after the pass that counted digit p: picks the digit
// of the k-th largest composite left, settles the row where every
// candidate left makes the cut, clears the histogram and the counter of
// the list the next sift writes. At p = 0 it records the row's candidate
// count (TS_MATCHED) and leaves a row of at most `local` candidates to the
// caller (TS_LOCAL; -1: none).
__global__ void topn_pick_digit(int* __restrict__ hist,
                                long long* __restrict__ state, int p,
                                long long local) {
  __shared__ int h[256];
  const int s = blockIdx.x;
  int* row = hist + (long long)s * 256;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    h[b] = row[b];
    row[b] = 0;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long* st = state + (long long)s * TS_WORDS;
  if (p == 0) {
    st[TS_MATCHED] = st[TS_N0];
    if (st[TS_N0] <= local) st[TS_SETTLED] = TS_LOCAL;
  }
  st[TS_N0 + ((p + 1) & 1)] = 0;
  if (st[TS_SETTLED]) return;
  const long long krem = st[TS_KREM];
  long long cum = 0;
  for (int b = 255; b >= 0; --b) {
    if (cum + h[b] >= krem) {
      st[TS_DIGIT] = b;
      st[TS_KREM] = krem - cum;
      if (h[b] == krem - cum) st[TS_SETTLED] = 1;  // the bucket fills the cut
      return;
    }
    cum += h[b];
  }
  st[TS_DIGIT] = -1;  // k or fewer left: every one wins
  st[TS_KREM] = krem - cum;
  st[TS_SETTLED] = 1;
}

// Sift p (1 <= p <= npass): the row's list from the sift before (or the
// compact pass), classified by digit p - 1 against the picked digit. Lists
// hold `stride` pairs a row.
template <typename K>
__global__ void __launch_bounds__(PT_THREADS)
topn_sift(const K* __restrict__ inkey, const int* __restrict__ indoc,
          K* __restrict__ outkey, int* __restrict__ outdoc, int stride,
          int k, int p, int npass, long long* __restrict__ state,
          int* __restrict__ hist, K* __restrict__ cand_key,
          int* __restrict__ cand_doc) {
  __shared__ int wh[PT_WARPS][256];
  __shared__ int wslot[PT_WARPS];
  __shared__ K wk[PT_WARPS][PT_WSTAGE];
  __shared__ int wd[PT_WARPS][PT_WSTAGE];
  const long long s = blockIdx.y;
  long long* st = state + s * TS_WORDS;
  if (st[TS_SETTLED] == TS_LOCAL) return;
  for (int e = threadIdx.x; e < PT_WARPS * 256; e += blockDim.x)
    (&wh[0][0])[e] = 0;
  __syncthreads();
  const long long n = min(st[TS_N0 + ((p - 1) & 1)], (long long)stride);
  const int dig = (int)st[TS_DIGIT];
  const bool settled = st[TS_SETTLED] != 0, last = p == npass;
  const K* ik = inkey + s * stride;
  const int* id = indoc + s * stride;
  const int w = threadIdx.x >> 5;
  int fill = 0;
  for (long long i0 = (long long)blockIdx.x * blockDim.x; i0 < n;
       i0 += (long long)gridDim.x * blockDim.x) {
    const long long i = i0 + threadIdx.x;
    const bool in = i < n;
    K key = 0;
    int doc = 0, g = -1;
    if (in) {
      key = ik[i];
      doc = id[i];
      g = digit_of<K>(key, doc, p - 1);
    }
    const bool win = in && (g > dig || (g == dig && (settled || last)));
    const bool keep = in && !win && g == dig;
    append<K>(win, key, doc, st + TS_SLOT, cand_key + s * k,
              cand_doc + s * k, &wslot[w]);
    if (!last) {
      stage_append<K>(keep, key, doc, wk[w], wd[w], fill,
                      st + TS_N0 + (p & 1), outkey + s * stride,
                      outdoc + s * stride, stride, false);
      count_bin(keep ? digit_of<K>(key, doc, p) : -1, wh[w]);
    }
  }
  if (!last) {
    stage_append<K>(false, (K)0, 0, wk[w], wd[w], fill,
                    st + TS_N0 + (p & 1), outkey + s * stride,
                    outdoc + s * stride, stride, true);
    flush_hist(wh, hist + s * 256);
  }
}

// The pick and sift passes over R rows' two lists (keys / docs [2, R,
// stride], list 0 filled by the compact pass, its first digit counted in
// hist) on `st`, nbl blocks a row per sift: cand_key / cand_doc [R, k]
// then hold each row's winners in no order, TS_SLOT of them. Rows of at
// most `local` candidates are left to the caller (-1: none). Returns the
// first nonzero cudaGetLastError().
template <typename K>
static int sift_passes(K* keys, int* docs, int R, int stride, int nbl,
                       int k, long long local, long long* state, int* hist,
                       K* cand_key, int* cand_doc, cudaStream_t st) {
  cudaError_t err;
  const long long RD = (long long)R * stride;
  const int npass = (int)sizeof(K) + 4;  // the composite's digits
  for (int p = 1; p <= npass; ++p) {
    topn_pick_digit<<<R, 256, 0, st>>>(hist, state, p - 1, local);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long in = ((p - 1) & 1) * RD, outo = (p & 1) * RD;
    topn_sift<K><<<dim3(nbl, R), PT_THREADS, 0, st>>>(
        keys + in, docs + in, keys + outo, docs + outo, stride, k, p, npass,
        state, hist, cand_key, cand_doc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// x before y in the output: key descending, then doc ascending.
template <typename K>
__device__ __forceinline__ bool before(K kx, int dx, K ky, int dy) {
  return kx > ky || (kx == ky && dx < dy);
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
