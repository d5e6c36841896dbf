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
// Design. B members (interp.cuh: the member axis) make B x S rows, row
// m * S + s. A row's candidates are compacted as they are scored, and the
// select reads only them (csrc/topk_select.cuh, the select K4 shares),
// never a [B, S, D] block. The host gives `cap`, a bound on any row's
// candidates that it knows without reading the card (ops/vector_device.py
// `candidate_counts`: the probed cells' doc counts with IVF, num_docs
// without, the largest over the rows). Where cap is at most `local` (the
// pairs one block's shared memory holds beside kk winners: pt_vec_local_cap)
// a launch is three passes:
//   0. a memset of the rows' state words (the list counters).
//   1. score + compact: grid (B members x blocks per segment, S), the
//      member fastest, over the real docs (d < num_docs[s]) only, so a
//      padded row costs nothing; short segments get more blocks, so the
//      launch fills the card (ops/_cuda.py VECTOR_BLOCKS). A block first copies its row's probe
//      mask into shared memory as bits (masks of up to VT_PROBE_BITS cells;
//      a wider one is read from global memory). A warp takes a tile of
//      VT_TILE docs: each lane reads VT_DOCS docs' cell ids at once (their
//      loads in flight together) and their probe bits (IVF), the
//      candidates' ranks come from ballots, and the warp computes the
//      candidates' dot products, min(32, dim_pad / 4) lanes to a row and
//      VT_DOCS rows at a time (their loads in flight together), each lane
//      loading 16 bytes of a row at a time (coalesced), so a doc outside
//      the probed cells costs no vector read and a tile with no candidate
//      ends there. The sum has one fixed
//      order, which the plain version (ops/vector_device.py `dot_scores`)
//      repeats: lane l adds the products of its 4-float chunks l, l + L,
//      l + 2L, ... in order onto -0.0 (the exact identity of IEEE addition,
//      so a sum of -0.0 products stays -0.0), then a shuffle tree halves
//      the lanes, lane i adding lane i + L/2, ..., i + 1. The build passes
//      --fmad=false, so every product and sum rounds once. Each candidate's
//      (score key, doc) pair goes onto its row's list (`stage_append`); a
//      non-candidate writes nothing. Offsets are 64-bit: S x D x dim_pad
//      passes 2^31 at the vector leg's block.
//   2. select + finish: one block of 1024 threads per row loads its list
//      into dynamic shared memory as 64-bit composites (key << 32 | ~doc:
//      no two equal, the larger first in top_k's order) and finds the kk-th
//      largest by an MSB-first radix select, 8 bits a digit, there: a
//      warp-aggregated shared histogram of the composites that share the
//      digits found so far, one warp's scan to pick the digit holding the
//      kk-th, stopping where the picked bucket exactly fills the cut. The
//      composites at or above it are the winners (min(n, kk) of them),
//      sorted by (key desc, doc asc) in shared memory. Each thread then
//      takes a winner, evaluates the residual filter and the validity mask
//      at that doc alone through interp.cuh, applies the k[s] cut and the
//      -inf test, and writes the packed row; past the row's candidates it
//      writes -1 and -inf (the docs the JAX kernel ranks there score -inf
//      and are never kept).
// Where cap is above `local` (exact search at the leg's sizes), pass 1 also
// counts each key's first digit into its row's histogram and K4's pick and
// sift passes (`sift_passes`) run between 1 and 2 on the rows whose list
// outgrew `local`; the first pick leaves the other rows to pass 2's
// shared-memory select, so both kinds of row share one launch.
// Scratch: lists [L, B x S, cap] of u32 keys and i32 docs (L = 1, or 2
// with the sift passes), the state [B x S, TS_WORDS] int64, and with the
// sift passes a histogram [B x S, 256] and the winners [B x S, kk]. A list
// that outgrows cap (a bound that undercounts) is not written past it, and
// its row's count is written as -1, on which the host's reading of the row
// (ops/vector_device.py `unpack`) raises.
#include "topk_select.cuh"

#define VT_FULL 0xFFFFFFFFu
// docs a lane of pass 1 takes a tile (their cell ids, and up to as many
// candidate rows, loaded together), and a warp's tile; 2 was faster than 1
// and 4 on an H100 (PERF.md §6, K8's design points)
#define VT_DOCS 2
#define VT_TILE (32 * VT_DOCS)
// probe-mask cells a block holds in shared memory as bits (4 KB)
#define VT_PROBE_BITS 32768
// dynamic shared memory of pass 2: the composites and the sort's kk
// winners (the static Shared block and histogram fit the rest of the
// card's 227 KB)
#define VT_SMEM_BYTES (220 * 1024)

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

// The pairs pass 2 selects from in one block's shared memory, at kk.
extern "C" int pt_vec_local_cap(int kk) {
  int n2 = 1;
  while (n2 < kk) n2 <<= 1;
  return (VT_SMEM_BYTES - n2 * (int)(sizeof(unsigned) + sizeof(int))) /
         (int)sizeof(unsigned long long);
}

// A score's total-order key; every NaN takes the key of the canonical
// positive NaN, above +inf.
__device__ __forceinline__ unsigned score_key(float x) {
  return x != x ? 0xFFFFFFFFu : KeyOf<float>::of(x);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

template <bool kHist>
__global__ void __launch_bounds__(PT_THREADS)
vec_compact(const __grid_constant__ VecArgs va,
            const int* __restrict__ num_docs, const float* __restrict__ q,
            const unsigned char* __restrict__ cells, int S, int D,
            int dim_pad, int cells_pad, int nmem, long long cap,
            unsigned* __restrict__ lkey, int* __restrict__ ldoc,
            long long* __restrict__ state, int* __restrict__ hist) {
  __shared__ int slot_doc[PT_WARPS][VT_TILE];
  __shared__ float sc[PT_WARPS][VT_TILE];
  __shared__ unsigned pbits[VT_PROBE_BITS / 32];
  __shared__ unsigned wk[PT_WARPS][PT_WSTAGE];
  __shared__ int wd[PT_WARPS][PT_WSTAGE];
  __shared__ int wh[kHist ? PT_WARPS : 1][256];
  const int s = blockIdx.y;
  int b, nb;
  const Mem mb = Grid<Mem>::at(va.a, S, nmem, b, nb);
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  int start, end;
  block_range(n, b, nb, start, end);
  if (start >= end) return;  // the whole block: no real doc here
  const long long row = mb.row();
  const float* V = va.vec[mb.u()] + (long long)s * D * dim_pad;
  const int* cell = cells == nullptr ? nullptr
                                     : va.cell[mb.u()] + (long long)s * D;
  const unsigned char* probe =
      cells == nullptr ? nullptr : cells + row * cells_pad;
  const bool bits = probe != nullptr && cells_pad <= VT_PROBE_BITS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (bits) {
    for (int c0 = 0; c0 < cells_pad; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      const unsigned bal =
          __ballot_sync(VT_FULL, c < cells_pad && probe[c] != 0);
      if (lane == 0 && c < cells_pad) pbits[c >> 5] = bal;
    }
  }
  if (kHist)
    for (int e = threadIdx.x; e < PT_WARPS * 256; e += blockDim.x)
      (&wh[0][0])[e] = 0;
  __syncthreads();
  const float4* q4 = (const float4*)(q + row * dim_pad);
  long long* cnt = state + row * TS_WORDS + TS_N0;
  unsigned* lk = lkey + row * cap;
  int* ld = ldoc + row * cap;
  const int nch = dim_pad >> 2;    // 4-float chunks of a row
  const int L = min(32, nch);      // lanes to a row
  const int G = 32 / L;            // rows a warp computes at once
  const int g = lane / L, li = lane % L;
  const unsigned below = (1u << lane) - 1u;
  int fill = 0;
  // a warp's tile: VT_TILE docs, lane l's docs t0 + l + 32 j
  for (int t0 = start + w * VT_TILE; t0 < end; t0 += PT_WARPS * VT_TILE) {
    bool cand[VT_DOCS];
#pragma unroll
    for (int j = 0; j < VT_DOCS; ++j) cand[j] = t0 + lane + 32 * j < end;
    if (cell != nullptr) {
      int c[VT_DOCS];  // loaded together (a doc past end reads the last)
#pragma unroll
      for (int j = 0; j < VT_DOCS; ++j)
        c[j] = cell[min(t0 + lane + 32 * j, end - 1)];
#pragma unroll
      for (int j = 0; j < VT_DOCS; ++j) {
        const int k = min(max(c[j], 0), cells_pad - 1);
        cand[j] = cand[j] && (bits ? ((pbits[k >> 5] >> (k & 31)) & 1u) != 0
                                   : probe[k] != 0);
      }
    }
    // the tile's candidates, ranked in (j, lane) order
    int nc = 0;
#pragma unroll
    for (int j = 0; j < VT_DOCS; ++j) {
      const unsigned bal = __ballot_sync(VT_FULL, cand[j]);
      if (cand[j]) slot_doc[w][nc + __popc(bal & below)] = lane + 32 * j;
      nc += __popc(bal);
    }
    if (nc == 0) continue;
    __syncwarp();
    // VT_DOCS candidate rows a lane group at once, their loads in flight
    // together; each row's sum in its one fixed order
    for (int base = 0; base < nc; base += G * VT_DOCS) {
      int jq[VT_DOCS];
      float acc[VT_DOCS];
      const float4* vr[VT_DOCS];
#pragma unroll
      for (int e = 0; e < VT_DOCS; ++e) {
        const int r = base + g + G * e;
        jq[e] = r < nc ? slot_doc[w][r] : -1;
        // a row past the tile's candidates reads the first one's
        vr[e] = (const float4*)(V + (long long)(t0 + slot_doc[w][r < nc ? r
                                                                 : 0]) *
                                        dim_pad);
        acc[e] = -0.0f;
      }
      for (int c = li; c < nch; c += L) {
        float4 x[VT_DOCS];
#pragma unroll
        for (int e = 0; e < VT_DOCS; ++e) x[e] = vr[e][c];
        const float4 y = q4[c];
#pragma unroll
        for (int e = 0; e < VT_DOCS; ++e) {
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e].x, y.x));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e].y, y.y));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e].z, y.z));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e].w, y.w));
        }
      }
#pragma unroll
      for (int e = 0; e < VT_DOCS; ++e) {
        for (int off = L >> 1; off > 0; off >>= 1)
          acc[e] = __fadd_rn(acc[e], __shfl_down_sync(VT_FULL, acc[e], off,
                                                      L));
        if (jq[e] >= 0 && li == 0) sc[w][jq[e]] = acc[e];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < VT_DOCS; ++j) {
      const int d = t0 + lane + 32 * j;
      const unsigned key = cand[j] ? score_key(sc[w][lane + 32 * j]) : 0u;
      stage_append<unsigned, true>(cand[j], key, d, wk[w], wd[w], fill, cnt,
                                   lk, ld, cap, false);
      if (kHist)
        count_bin(cand[j] ? digit_of<unsigned>(key, d, 0) : -1, wh[w]);
    }
    __syncwarp();
  }
  stage_append<unsigned, true>(false, 0u, 0, wk[w], wd[w], fill, cnt, lk, ld,
                               cap, true);
  if (kHist) flush_hist(wh, hist + row * 256);
}

// Pass 2's shared-memory select: the row's n <= local composites loaded
// from its list, the kk largest of them into wk / wd (in no order);
// returns their count, min(n, kk). Every thread of the block calls it.
__device__ int local_select(const unsigned* __restrict__ lk,
                            const int* __restrict__ ld, int n, int kk,
                            unsigned long long* comp, unsigned* wk, int* wd) {
  __shared__ int h[256];
  __shared__ unsigned long long thr_sh;
  __shared__ int bits_sh, krem_sh, done_sh, won_sh;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
  if (threadIdx.x == 0) {
    thr_sh = 0;
    bits_sh = 0;
    krem_sh = kk;
    done_sh = n <= kk;  // every candidate wins
    won_sh = 0;
  }
  __syncthreads();
  // the load counts the first digit
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int bin = -1;
    if (i < n) {
      const unsigned long long c =
          ((unsigned long long)lk[i] << 32) | (unsigned)~ld[i];
      comp[i] = c;
      bin = (int)(c >> 56);
    }
    const unsigned peers = __match_any_sync(VT_FULL, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[bin],
                                                        __popc(peers));
  }
  __syncthreads();
  for (int j = 0; j < 8 && !done_sh; ++j) {
    const unsigned long long prefix = thr_sh;
    if (j > 0) {  // digit j of the composites that share the prefix
      const int shift = 56 - 8 * j;
      for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        int bin = -1;
        if (i < n) {
          const unsigned long long c = comp[i];
          if ((c >> (shift + 8)) == prefix) bin = (int)((c >> shift) & 0xFF);
        }
        const unsigned peers = __match_any_sync(VT_FULL, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[bin],
                                                            __popc(peers));
      }
      __syncthreads();
    }
    if (threadIdx.x < 32) {
      // lane l scans bins 255 - 8l down to 248 - 8l; the first lane whose
      // running count reaches krem holds the digit
      const int krem = krem_sh;
      int c[8], sum = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = h[255 - 8 * lane - e];
        sum += c[e];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(VT_FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned hit = __ballot_sync(VT_FULL, incl >= krem);
      if (lane == __ffs(hit) - 1) {
        int cum = incl - sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (cum + c[e] >= krem && cum < krem) {
            thr_sh = (prefix << 8) | (unsigned long long)(255 - 8 * lane - e);
            bits_sh = 8 * (j + 1);
            krem_sh = krem - cum;
            done_sh = c[e] == krem - cum;  // the bucket fills the cut
          }
          cum += c[e];
        }
      }
    }
    __syncthreads();
  }
  const int nbits = bits_sh;
  const unsigned long long thr = thr_sh;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    unsigned long long c = 0;
    bool win = false;
    if (i < n) {
      c = comp[i];
      win = nbits == 0 || (c >> (64 - nbits)) >= thr;
    }
    const unsigned bal = __ballot_sync(VT_FULL, win);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&won_sh, __popc(bal));
    base = __shfl_sync(VT_FULL, base, 0);
    if (win) {
      const int at = base + __popc(bal & ((1u << lane) - 1u));
      wk[at] = (unsigned)(c >> 32);
      wd[at] = (int)~(unsigned)c;
    }
  }
  __syncthreads();
  return won_sh;
}

template <bool kMask>
__global__ void __launch_bounds__(PT_SORT_THREADS)
vec_select(const __grid_constant__ VecArgs va,
           const double* __restrict__ params,
           const int* __restrict__ num_docs, const int* __restrict__ kq,
           int S, int D, int P, int kk, int n2, long long cap,
           long long local, int sifted,
           const long long* __restrict__ state,
           const unsigned* __restrict__ lkey, const int* __restrict__ ldoc,
           const unsigned* __restrict__ cand_key,
           const int* __restrict__ cand_doc, float* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ Shared sh;
  unsigned long long* comp = smem;
  unsigned* wk = (unsigned*)(comp + local);
  int* wd = (int*)(wk + n2);
  const int r = blockIdx.x;  // row m * S + s
  const int s = r % S;
  Mem mb;
  mb.u_ = va.a.set_of[r / S];
  mb.row_ = r;
  stage_block(va.a, params, r, P, sh);
  const long long* st = state + (long long)r * TS_WORDS;
  const long long count = sifted ? st[TS_MATCHED] : st[TS_N0];
  const bool over = count > cap;
  int won;
  if (!sifted || st[TS_SETTLED] == TS_LOCAL) {
    won = local_select(lkey + (long long)r * cap, ldoc + (long long)r * cap,
                       (int)min(count, local), kk, comp, wk, wd);
  } else {
    won = (int)min(st[TS_SLOT], (long long)kk);
    for (int i = threadIdx.x; i < won; i += blockDim.x) {
      wk[i] = cand_key[(long long)r * kk + i];
      wd[i] = cand_doc[(long long)r * kk + i];
    }
  }
  for (int i = won + threadIdx.x; i < n2; i += blockDim.x) {
    wk[i] = 0;  // below every real key (score_key never gives 0)
    wd[i] = 0x7FFFFFFF;
  }
  __syncthreads();
  bitonic_sort(wk, wd, n2);
  const int mainf = sh.code[H_MAIN];
  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  const int kr = kq[r];
  float* row = out + (long long)r * (1 + 2 * kk);
  int kept = 0;
  for (int i0 = 0; i0 < kk; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool keep = false;
    if (i < kk) {
      const int d = wd[i];
      const float score = key_score(wk[i]);
      if (i < won && !over) {
        const long long doc = (long long)s * D + d;
        keep = i < kr && score > -INFINITY && d < n &&
               doc_valid(va.a, mb, doc) &&
               (mainf < 0 || eval_filter<kMask>(va.a, sh, mainf, mb, doc));
      }
      row[1 + i] = keep ? (float)d : -1.0f;
      row[1 + kk + i] = keep ? score : -INFINITY;
    }
    kept += __syncthreads_count(keep);
  }
  if (threadIdx.x == 0) row[0] = over ? -1.0f : (float)kept;
}

template <bool kMask>
static int launch_select(const VecArgs* va, const double* params,
                         const int* num_docs, const int* kq, int S, int D,
                         int P, int R, int kk, long long cap, long long local,
                         int sifted, const long long* state,
                         const unsigned* lkey, const int* ldoc,
                         const unsigned* cand_key, const int* cand_doc,
                         float* out, cudaStream_t st) {
  const int n2 = sort_width(kk);
  const size_t smem = (size_t)local * sizeof(unsigned long long) +
                      (size_t)n2 * (sizeof(unsigned) + sizeof(int));
  // pt_vec_local_cap keeps smem within VT_SMEM_BYTES, under the limit
  static std::atomic<unsigned> limit_set{0};
  const cudaError_t err = pt_smem_limit_max(vec_select<kMask>, &limit_set);
  if (err != cudaSuccess) return (int)err;
  vec_select<kMask><<<R, PT_SORT_THREADS, smem, st>>>(
      *va, params, num_docs, kq, S, D, P, kk, n2, cap, local, sifted, state,
      lkey, ldoc, cand_key, cand_doc, out);
  return (int)cudaGetLastError();
}

// Launches K8's passes on `stream` for B members (R = B x S rows).
// params: [B, S, P] float64 (the residual filter's); num_docs: [U, S]
// int32; q: [B, S, dim_pad] float32; kq: [B, S] int32; cells: [B, S,
// cells_pad] bool probe masks (null: exact search); cap: the host's bound
// on a row's candidates (1 <= cap <= D); keys / docs: [L, R, cap] u32 /
// int32 lists, L = 1 where cap <= pt_vec_local_cap(kk), else 2; state:
// [R, TS_WORDS] int64; hist: [R, 256] int32, cand_key / cand_doc: [R, kk]
// (read only with L = 2); out: [B, S, 1 + 2 kk] float32. 1 <= kk <=
// min(D, 8192), dim_pad a power of two >= 8, R <= 65535. Returns the first
// nonzero cudaGetLastError().
extern "C" int pt_vector_topk(const VecArgs* va, const double* params,
                              const int* num_docs, const float* q,
                              const int* kq, const unsigned char* cells,
                              int S, int D, int P, int dim_pad, int cells_pad,
                              int nb, int B, int kk, long long cap,
                              unsigned* keys, int* docs, long long* state,
                              int* hist, unsigned* cand_key, int* cand_doc,
                              float* out, int dev, void* stream) {
  cudaSetDevice(dev);
  if (kk < 1 || kk > PT_TOPN_MAX_K || kk > D || (long long)B * S > 65535 ||
      dim_pad < 8 || (dim_pad & (dim_pad - 1)) != 0 || cap < 1 || cap > D ||
      (cells != nullptr && cells_pad < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define PT_CHECK() \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  const int R = B * S;
  const long long room = pt_vec_local_cap(kk);
  const bool sifted = cap > room;
  const long long local = sifted ? room : cap;
  if (sifted) {
    topn_start<<<(R + 127) / 128, 128, 0, st>>>(state, R, kk);
    PT_CHECK();
    cudaMemsetAsync(hist, 0, sizeof(int) * 256 * (size_t)R, st);
    PT_CHECK();
    vec_compact<true><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *va, num_docs, q, cells, S, D, dim_pad, cells_pad, B, cap, keys, docs,
        state, hist);
    PT_CHECK();
    // the sifts' grid: about 2048 blocks over the rows, at most nb a row
    int nbl = (2048 + R - 1) / R;
    nbl = nbl < 1 ? 1 : (nbl > nb ? nb : nbl);
    const int rc =
        sift_passes<unsigned>(keys, docs, R, (int)cap, nbl, kk, local, state,
                              hist, cand_key, cand_doc, st);
    if (rc) return rc;
  } else {
    cudaMemsetAsync(state, 0, sizeof(long long) * TS_WORDS * (size_t)R, st);
    PT_CHECK();
    vec_compact<false><<<dim3(nb * B, S), PT_THREADS, 0, st>>>(
        *va, num_docs, q, cells, S, D, dim_pad, cells_pad, B, cap, keys, docs,
        state, hist);
    PT_CHECK();
  }
#undef PT_CHECK
  return has_mask_leaf(va->a.code)
             ? launch_select<true>(va, params, num_docs, kq, S, D, P, R, kk,
                                   cap, local, sifted, state, keys, docs,
                                   cand_key, cand_doc, out, st)
             : launch_select<false>(va, params, num_docs, kq, S, D, P, R, kk,
                                    cap, local, sifted, state, keys, docs,
                                    cand_key, cand_doc, out, st);
}
