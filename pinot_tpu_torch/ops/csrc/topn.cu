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
// m * S + s. The select is an MSB-first radix select, 8 bits a digit, on
// the composite (key, ~doc): the ordered integer key (the float's bits with
// the sign flip: u32 for float32, u64 for float64) and then the
// complemented doc id, so no two docs tie, and the k largest composites
// are the k winners in lax.top_k's order whatever order the docs were
// compacted in.
//   0. compact: grid (B members x blocks per segment, S), the member
//      fastest (a single launch is the B = 1 case). Each doc runs the
//      filter and the order value through interp.cuh; a kept doc appends
//      its (key, doc) pair to its row's list (a slot from a warp ballot
//      into the warp's shared stage of PT_WSTAGE pairs, the stage
//      appended with one atomic when full), and adds the key's first
//      digit to per-warp shared histograms, merged per block into the
//      row's [256] histogram. An unkept doc writes nothing. The list's
//      length is the matched count.
//   1. pick (one block per row): the digit holding the k-th largest
//      composite among the row's candidates, and how many of that
//      bucket's candidates still make the cut. Where every candidate
//      makes it (k or fewer left, or the bucket exactly fills the cut)
//      the row is settled: no candidate passes on.
//   2. sift: each candidate of the row's list above the picked digit is a
//      winner (appended to the row's k winners); one in the picked
//      bucket passes on to the next list (two lists, ping-pong) and adds
//      its next digit to the histogram; the rest drop. Then 1 again, for
//      each of the composite's 8 (u32 keys) or 12 (u64) digits; the last
//      sift takes the picked bucket's one candidate as the k-th winner.
//      After the compact pass K4 reads only the candidates still in the
//      running, never a [B, S, D] block.
//   3. sort: one block per row sorts its winners by (key desc, doc asc)
//      with a bitonic sort in dynamic shared memory (k <= 8192: 64 KB for
//      u32 keys, 96 KB for u64) and writes the row, -1 past the matched
//      docs.
// Every pass gives the same winners whatever the order of its atomics,
// and the sort orders them, so the output is the same bits every run.
// Scratch: the two lists hold every doc at worst ([2, B, S, D] keys and
// doc ids: 16 bytes a doc for float32, 24 for float64).
#include "topk_select.cuh"

// pairs a warp stages in shared memory before it appends them to its row's
// list (8 KB a block for u32 keys, 12 KB for u64)
#define PT_WSTAGE 128
// per-row state words (ops/_cuda.py TOPN_ROW_WORDS)
enum { TS_DIGIT, TS_KREM, TS_MATCHED, TS_SLOT, TS_N0, TS_N1, TS_SETTLED,
       TS_WORDS };

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
// when most docs are kept. Every lane of the warp calls it.
template <typename K>
__device__ __forceinline__ void stage_append(bool put, K key, int doc, K* wk,
                                             int* wd, int& fill,
                                             long long* n, K* lk, int* ld,
                                             bool flush) {
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
      lk[b0 + i] = wk[i];
      ld[b0 + i] = wd[i];
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
    stage_append<K>(hit, key, d, wk[w], wd[w], fill, cnt, lk, ld, false);
    count_bin(hit ? digit_of<K>(key, d, 0) : -1, wh[w]);
  }
  stage_append<K>(false, (K)0, 0, wk[w], wd[w], fill, cnt, lk, ld, true);
  flush_hist(wh, hist + row * 256);
}

// One block per row, after the pass that counted digit p: picks the digit
// of the k-th largest composite left, settles the row where every
// candidate left makes the cut, clears the histogram and the counter of
// the list the next sift writes.
__global__ void topn_pick_digit(int* __restrict__ hist,
                                long long* __restrict__ state, int p) {
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
  if (p == 0) st[TS_MATCHED] = st[TS_N0];
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
// compact pass), classified by digit p - 1 against the picked digit.
template <typename K>
__global__ void __launch_bounds__(PT_THREADS)
topn_sift(const K* __restrict__ inkey, const int* __restrict__ indoc,
          K* __restrict__ outkey, int* __restrict__ outdoc, int D, int k,
          int p, int npass, long long* __restrict__ state,
          int* __restrict__ hist, K* __restrict__ cand_key,
          int* __restrict__ cand_doc) {
  __shared__ int wh[PT_WARPS][256];
  __shared__ int wslot[PT_WARPS];
  __shared__ K wk[PT_WARPS][PT_WSTAGE];
  __shared__ int wd[PT_WARPS][PT_WSTAGE];
  for (int e = threadIdx.x; e < PT_WARPS * 256; e += blockDim.x)
    (&wh[0][0])[e] = 0;
  __syncthreads();
  const long long s = blockIdx.y;
  long long* st = state + s * TS_WORDS;
  const long long n = st[TS_N0 + ((p - 1) & 1)];
  const int dig = (int)st[TS_DIGIT];
  const bool settled = st[TS_SETTLED] != 0, last = p == npass;
  const K* ik = inkey + s * D;
  const int* id = indoc + s * D;
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
                      st + TS_N0 + (p & 1), outkey + s * D, outdoc + s * D,
                      false);
      count_bin(keep ? digit_of<K>(key, doc, p) : -1, wh[w]);
    }
  }
  if (!last) {
    stage_append<K>(false, (K)0, 0, wk[w], wd[w], fill,
                    st + TS_N0 + (p & 1), outkey + s * D, outdoc + s * D,
                    true);
    flush_hist(wh, hist + s * 256);
  }
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
  const long long RD = (long long)R * D;
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
  const int npass = (int)sizeof(K) + 4;  // the composite's digits
  for (int p = 1; p <= npass; ++p) {
    topn_pick_digit<<<R, 256, 0, st>>>(hist, state, p - 1);
    PT_CHECK();
    const long long in = ((p - 1) & 1) * RD, outo = (p & 1) * RD;
    topn_sift<K><<<dim3(nbl, R), PT_THREADS, 0, st>>>(
        keys + in, docs + in, keys + outo, docs + outo, D, k, p, npass, state,
        hist, cand_key, cand_doc);
    PT_CHECK();
  }
  const int n2 = sort_width(k);
  const size_t smem = (size_t)n2 * (sizeof(K) + sizeof(int));
  cudaFuncSetAttribute(topn_sort<K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  PT_CHECK();
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
