// K2 group_agg: fused filter + value expressions + per-group reductions over
// stacked segment blocks [S, D] with dense mixed-radix keys or compact
// per-segment key codes, packed as [S, G, n_slots].
//
// Replaces the grouped branch of pinot_tpu/ops/kernels.py:537
// `make_kernel`: keys from `_compute_slots` :490-495, `_grouped_reduce`
// :252, `_scatter_sum` :287, `_vmap_scatter` :316. The JAX kernel's one-hot
// matmul for small key spaces (:299-311) was a device for the TPU's matrix
// unit; the function is a scatter-sum, and here it is one.
//
// Also replaces the compact-key branch, kernels.py:488-491: where the
// dense key space exceeds 2^20 the engine stages an int32 [S, D] `gkey`
// block of per-segment codes over the key tuples present, and the program
// names it as the key's only digit at stride 1, so each kept doc's key is
// one load of its code. G (8 to 2^20) comes with the launch.
//
// Also replaces pinot_tpu/ops/timeseries_device.py:166 `bucket_ids` (the
// fused time bucket, kernels.py:496-506): where the plan carries one, each
// doc's floor((t - start) / step) from the timestamp's (hi, lo) i32 planes
// and the member's tb:* parameter cells is the key's lowest digit, and a
// doc outside the window is gated out (interp.cuh ts_bucket). The upsert
// validity mask skips superseded docs before the filter (doc_valid).
//
// Bound on an H100: bytes, as for K1 — each staged element is read once;
// the output [S, G, n_slots] is small beside the columns (a time bucket
// reads two i32 planes more per kept doc and does a handful of integer
// operations: still bytes). At compact G the table's zeroing and its
// decode pass (B x S x G x n_slots words) are no longer small beside the
// columns; they are this design's scratch, not the function's traffic, so
// the bound leaves them out and chip_smoke.py reports them beside it.
//
// Design. The accumulators are words typed by their reduction, and every
// identity is the all-zero word:
//   COUNT        an integer count: u32 on chip, u64 in the global table;
//   SUM (sumsq,  a double (+0.0 is zero bits), so a float32 result is the
//   sum3, sum4)  double-accumulated sum rounded once;
//   MIN / MAX    the value's order key (its bits, sign-flipped to sort as
//                unsigned integers: -0.0 below +0.0), complemented for MIN,
//                taken with integer atomicMax; NaN is the all-ones word, so
//                it sticks (XLA's jnp.min / jnp.max and scatter-min / -max;
//                ops/kernels.py `grouped_reduce` is the plain version).
//                u32 for float32 values, u64 for float64; zero decodes to
//                the identity (+inf for MIN, -inf for MAX).
// So one cudaMemsetAsync initialises the global table [B, S, G, n_slots]
// (u64 words) and a last pass decodes it into the value dtype. MIN / MAX
// take no compare-and-swap loop and a count no f64 atomic (cuobjdump
// -sass, kernel_ab.py: ATOMS / ATOM / REDG .MAX and .ADD); only a double
// sum in shared memory is the compiler's compare-and-swap loop.
//
// The grid is (B members x blocks per (member, segment), S), the member the
// fastest block coordinate (interp.cuh: the member axis; a single launch is
// the B = 1 case), each block of 512 threads over one contiguous doc range.
// Each kept doc updates its key's entry of each slot with one atomic of
// the word's own width. Warp aggregation first (__match_any_sync on the
// key, the lanes that share it folded by the lowest, one update a key and
// warp) ran slower in every tier on an H100 (PERF.md, PR 12): the
// hardware's shared-memory atomics take the conflicts more cheaply.
// The table lives in one of three tiers, chosen from its bytes alone (one
// copy of the [G, n_slots] words, each slot's column padded to 8 bytes;
// ops/_cuda.py `group_tier` mirrors the choice):
//   warp     <= 4 KB (K2_WARP_TABLE_BYTES): one private copy per warp in
//            shared memory (16 x 4 KB at most), so only a warp's own lanes
//            contend on an entry; at the block's end the copies fold in
//            warp order and the block merges every entry it touched into
//            the global table with one atomic each. Dense G = 35, config
//            #3.
//   block    <= 100 KB (K2_BLOCK_TABLE_BYTES): one copy per block in
//            dynamic shared memory, the same atomics and merge. ts.1's
//            G = 1024.
//   global   past that: docs update the global table directly with
//            integer, f64-add and integer-max atomics (native in L2); the
//            blocks of one segment run together, so its slice of the
//            table stays in L2. ts.3's G = 64,000, the compact G = 2^16,
//            2^17 and 2^20.
// In the warp and block tiers a float64 MIN / MAX word goes to the global
// table's native 64-bit atomicMax instead: shared memory has no 64-bit
// integer max (the compiler loops on a compare-and-swap); float32's 32-bit
// words and counts stay on chip, and so do double sums (a compare-and-swap
// loop in shared memory all the same, but routed to the global table ts.1
// ran slower). Its column of the on-chip copy stays zero, so the tier is
// still the bytes' alone. A fourth tier, the table spread over a thread-block
// cluster's distributed shared memory (2-8 CTAs of up to 200 KB, each doc
// updating its key's owning CTA), ran ts.3 and the compact G = 2^16 /
// 2^17 1.5-2.9x slower than the global table did before this design, CAS
// loops and all, on an H100 (kernel_ab.py; PERF.md, PR 12), so there is
// none.
// Blocks of the warp and block tiers each walk at least K2_MIN_DOCS docs,
// and at least K2_FLUSH_RATIO times the entries they merge. Sums take the
// atomics' order, so a float sum varies run to run in its last double
// bits; counts and min / max are exact and order-free.
#include "interp.cuh"

#define K2_THREADS 512
#define K2_WARPS (K2_THREADS / 32)
#define K2_WARP_TABLE_BYTES 4096
#define K2_BLOCK_TABLE_BYTES (100 * 1024)
#define K2_MIN_DOCS 16384
#define K2_FLUSH_RATIO 16
#define K2_MAX_BLOCKS 1024

enum { T_WARP, T_BLOCK, T_GLOBAL };
enum { K_SUM, K_CNT, K_MM };

__host__ __device__ __forceinline__ int word_kind(int op) {
  return op == S_COUNT ? K_CNT : ((op == S_MIN || op == S_MAX) ? K_MM : K_SUM);
}
// Bytes of a slot's on-chip word: 4 for a count and a float32 min / max.
__host__ __device__ __forceinline__ int word_bytes(int op, int f64) {
  const int k = word_kind(op);
  return k == K_CNT ? 4 : (k == K_MM && !f64 ? 4 : 8);
}

// The order key of a float (bits with the sign flip: unsigned compare
// follows the total order, -0.0 below +0.0) and back.
template <typename T> struct MM;
template <> struct MM<float> {
  typedef unsigned W;
  static __device__ __forceinline__ W key(float x) {
    const unsigned b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  static __device__ __forceinline__ float unkey(W k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
  }
};
template <> struct MM<double> {
  typedef unsigned long long W;
  static __device__ __forceinline__ W key(double x) {
    const W b = (W)__double_as_longlong(x);
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
  static __device__ __forceinline__ double unkey(W k) {
    return __longlong_as_double(
        (long long)((k >> 63) ? (k & 0x7FFFFFFFFFFFFFFFull) : ~k));
  }
};

// The word a MIN / MAX slot takes atomicMax of: NaN is all ones, MIN
// complements the key; a non-NaN value never gives 0 or all ones.
template <typename T>
__device__ __forceinline__ typename MM<T>::W mm_word(int op, T x) {
  typedef typename MM<T>::W W;
  if (x != x) return ~(W)0;
  const W k = MM<T>::key(x);
  return op == S_MIN ? ~k : k;
}

template <typename T>
__device__ __forceinline__ T mm_value(int op, typename MM<T>::W w) {
  typedef typename MM<T>::W W;
  if (w == ~(W)0) return (T)PT_QNAN;
  if (w == 0) return op == S_MIN ? (T)INFINITY : (T)-INFINITY;
  return MM<T>::unkey(op == S_MIN ? ~w : w);
}

// One contribution c (a word: double bits, a count or a min / max word)
// into the entry at p, with an atomic of the word's width: in shared memory
// (kGlobal false: the on-chip widths) or in the global table (u64 words).
template <typename T, bool kGlobal>
__device__ __forceinline__ void update(void* p, int kind,
                                       unsigned long long c) {
  typedef typename MM<T>::W W;
  if (kGlobal) {
    if (kind == K_SUM) atomicAdd((double*)p, __longlong_as_double((long long)c));
    else if (kind == K_CNT) atomicAdd((unsigned long long*)p, c);
    else atomicMax((unsigned long long*)p, c);
  } else {  // a 64-bit min / max word never lands here (see the header)
    if (kind == K_SUM) atomicAdd((double*)p, __longlong_as_double((long long)c));
    else if (kind == K_CNT) atomicAdd((unsigned*)p, (unsigned)c);
    else if constexpr (sizeof(W) == 4) atomicMax((W*)p, (W)c);
  }
}

// An on-chip word widened to the global table's u64.
template <typename T>
__device__ __forceinline__ unsigned long long load_word(const char* p,
                                                        int kind) {
  if (kind == K_SUM) return *(const unsigned long long*)p;
  if (kind == K_CNT) return *(const unsigned*)p;
  return (unsigned long long)*(const typename MM<T>::W*)p;
}

// Two words of one kind combined (a sum adds, a count adds, min / max
// take the larger word): the warp copies' fold.
__device__ __forceinline__ unsigned long long fold_word(int kind,
                                                        unsigned long long x,
                                                        unsigned long long y) {
  if (kind == K_SUM)
    return (unsigned long long)__double_as_longlong(
        __longlong_as_double((long long)x) + __longlong_as_double((long long)y));
  if (kind == K_CNT) return x + y;
  return x > y ? x : y;
}

// ng groups x nslot slots as columns: slot j's column of ng words at byte
// offset off[j], each column padded to 8 bytes. Returns the bytes of one
// copy.
__host__ __device__ inline long long slot_offsets(const int* code, long long ng,
                                                  int f64, int* off) {
  const int nslot = code[H_NSLOT];
  const int* slots = code + code[H_SLOT];
  long long b = 0;
  for (int j = 0; j < nslot; ++j) {
    if (off) off[j] = (int)b;
    b += (ng * word_bytes(slots[j * SLOT_W], f64) + 7) / 8 * 8;
  }
  return b;
}

template <typename T, bool kMask, int kTier>
__global__ void __launch_bounds__(K2_THREADS)
group_agg_kernel(const __grid_constant__ Args a,
                 const double* __restrict__ params,
                 const int* __restrict__ num_docs, int S, int D, int P, int G,
                 int nmem, int copy_bytes,
                 unsigned long long* __restrict__ table) {
  __shared__ Shared sh;
  __shared__ int soff[PT_MAX_ACC];
  extern __shared__ __align__(16) char tab[];
  const int s = blockIdx.y;
  int b, nb;
  const Mem mb = Grid<Mem>::at(a, S, nmem, b, nb);
  stage_block(a, params, mb.row(), P, sh);
  const int* code = sh.code;
  const int nslot = code[H_NSLOT], ngcol = code[H_NGCOL], mainf = code[H_MAIN];
  const int tbhi = code[H_TBHI], tbpad = code[H_TBPAD];
  const int* slots = code + code[H_SLOT];
  const int* gcols = code + code[H_GCOL];
  const int f64 = sizeof(T) == 8;
  unsigned long long* seg_table = table + mb.row() * (long long)G * nslot;
  const int copies = kTier == T_WARP ? K2_WARPS : 1;
  if (kTier != T_GLOBAL) {
    if (threadIdx.x == 0) slot_offsets(code, G, f64, soff);
    for (int e = threadIdx.x; e < copies * copy_bytes / 8; e += blockDim.x)
      ((unsigned long long*)tab)[e] = 0ull;
    __syncthreads();
  }
  char* mine = tab + (kTier == T_WARP ? (threadIdx.x >> 5) * copy_bytes : 0);

  const int n = max(0, min(num_docs[(long long)mb.u() * S + s], D));
  const int per = (n + nb - 1) / nb;
  const int start = min(n, b * per), end = min(n, start + per);
  const long long base = (long long)s * D;
  // tile by tile, every lane through every slot (a lane whose doc is out
  // only idles): a doc-strided loop with early `continue`s ran this kernel
  // slower on an H100 in every tier (PERF.md, PR 12)
  for (int t0 = start; t0 < end; t0 += blockDim.x) {
    const int d = t0 + threadIdx.x;
    const long long i = base + d;
    bool live = d < end && doc_valid(a, mb, i) &&
                (mainf < 0 || eval_filter<kMask>(a, sh, mainf, mb, i));
    int key = 0;
    if (live) {
      for (int g = 0; g < ngcol; ++g)
        key += (int)load_col(a, code, mb.u(), gcols[2 * g], i) * gcols[2 * g + 1];
      if (tbhi >= 0) {  // the fused time bucket: the key's lowest digit
        const double* tp = sh.prm + code[H_TBPRM];
        int bk;
        live = ts_bucket(((const int*)a.cols[mb.u()][tbhi])[i],
                         ((const int*)a.cols[mb.u()][code[H_TBLO]])[i],
                         (int)tp[0], (int)tp[1], (int)tp[2], (int)tp[3], tbpad,
                         bk);
        key += bk;
      }
      live = live && key >= 0 && key < G;  // XLA drops out-of-range scatters
    }
    DocCache c = {0u, 0u, 0u};
    T vc[PT_MAX_VALUES];
    for (int j = 0; j < nslot; ++j) {
      const int* sl = slots + j * SLOT_W;
      const int op = sl[0], v = sl[1];
      const int kind = word_kind(op);
      const bool p = live && slot_passes<kMask>(a, sh, sl[2], mb, i, c);
      if (!p) continue;
      unsigned long long w = 1;  // a count
      if (kind != K_CNT) {
        if (!(c.vdone & (1u << v))) {
          vc[v] = eval_value<T>(a, sh, v, mb, i);
          c.vdone |= 1u << v;
        }
        w = kind == K_MM ? (unsigned long long)mm_word<T>(op, vc[v])
                         : (unsigned long long)__double_as_longlong(
                               slot_contrib<T>(op, vc[v]));
      }
      if (kTier == T_GLOBAL || (f64 && kind == K_MM))
        update<T, true>(seg_table + (long long)key * nslot + j, kind, w);
      else
        update<T, false>(mine + soff[j] + (long long)key * word_bytes(op, f64),
                         kind, w);
    }
    if (kTier == T_WARP) __syncwarp();
  }

  if (kTier == T_GLOBAL) return;
  __syncthreads();
  // merge the entries this block holds
  for (int e = threadIdx.x; e < G * nslot; e += blockDim.x) {
    const int g = e / nslot, j = e - g * nslot;
    const int op = slots[j * SLOT_W];
    const int kind = word_kind(op);
    const char* p = tab + soff[j] + (long long)g * word_bytes(op, f64);
    unsigned long long w = load_word<T>(p, kind);
    for (int k = 1; k < copies; ++k)
      w = fold_word(kind, w, load_word<T>(p + k * copy_bytes, kind));
    if (w) update<T, true>(seg_table + (long long)g * nslot + j, kind, w);
  }
}

// The global table's words decoded into the value dtype.
template <typename T>
__global__ void group_decode(const __grid_constant__ Args a, long long n,
                             const unsigned long long* __restrict__ table,
                             T* __restrict__ out) {
  const int nslot = a.code[H_NSLOT];
  const int* slots = a.code + a.code[H_SLOT];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int op = slots[(e % nslot) * SLOT_W];
    const int kind = word_kind(op);
    const unsigned long long w = table[e];
    out[e] = kind == K_CNT ? (T)w
           : kind == K_MM ? mm_value<T>(op, (typename MM<T>::W)w)
           : (T)__longlong_as_double((long long)w);
  }
}

// The tier of a [G, n_slots] table (T_*), from its bytes alone; *smem:
// the dynamic shared memory per block, *copy: one copy's bytes.
static int choose_tier(const int* code, int G, int f64, long long* smem,
                       long long* copy) {
  const long long tb = slot_offsets(code, G, f64, nullptr);
  *copy = tb;
  if (tb <= K2_WARP_TABLE_BYTES) {
    *smem = tb * K2_WARPS;
    return T_WARP;
  }
  if (tb <= K2_BLOCK_TABLE_BYTES) {
    *smem = tb;
    return T_BLOCK;
  }
  *smem = *copy = 0;
  return T_GLOBAL;
}

// The tier K2 takes for a program's table at G (0 warp, 1 block, 2
// global), for the wrapper's check of its Python mirror (ops/_cuda.py
// `group_tier`).
extern "C" int pt_group_tier(const int* code, int G, int f64) {
  long long smem, copy;
  return choose_tier(code, G, f64, &smem, &copy);
}

template <typename T, bool kMask, int kTier>
static cudaError_t launch_tier(const Args* a, const double* params,
                               const int* num_docs, int S, int D, int P,
                               int G, int B, long long smem, long long copy,
                               int nb, unsigned long long* table,
                               cudaStream_t st) {
  auto kern = group_agg_kernel<T, kMask, kTier>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nb * B, S), K2_THREADS, (size_t)smem, st>>>(
      *a, params, num_docs, S, D, P, G, B, (int)copy, table);
  return cudaGetLastError();
}

template <typename T, bool kMask>
static cudaError_t launch_agg(int tier, const Args* a, const double* params,
                              const int* num_docs, int S, int D, int P, int G,
                              int B, long long smem, long long copy, int nb,
                              unsigned long long* table, cudaStream_t st) {
#define PT_TIER(t)                                                         \
  launch_tier<T, kMask, t>(a, params, num_docs, S, D, P, G, B, smem, copy, \
                           nb, table, st)
  switch (tier) {
    case T_WARP: return PT_TIER(T_WARP);
    case T_BLOCK: return PT_TIER(T_BLOCK);
    default: return PT_TIER(T_GLOBAL);
  }
#undef PT_TIER
}

// Launches the table's memset, K2 and the decode pass on `stream` for B
// members. params: [B, S, P] float64; num_docs: [U, S] int32; table:
// [B, S, G, n_slots] u64 scratch words; out: the same shape in the value
// dtype (f64 != 0: float64, else float32); dev: the tensors' device.
// Returns the first CUDA error, else 0.
extern "C" int pt_group_agg(const Args* a, const double* params,
                            const int* num_docs, int S, int D, int P, int G,
                            int B, int f64, unsigned long long* table,
                            void* out, int dev, void* stream) {
  cudaSetDevice(dev);
  cudaStream_t st = (cudaStream_t)stream;
  const int nslot = a->code[H_NSLOT];
  const long long n = (long long)B * S * G * nslot;
  long long smem, copy;
  const int tier = choose_tier(a->code, G, f64, &smem, &copy);
  long long per = K2_MIN_DOCS;
  if (tier != T_GLOBAL && (long long)K2_FLUSH_RATIO * G * nslot > per)
    per = (long long)K2_FLUSH_RATIO * G * nslot;
  const long long want = (D + per - 1) / per;
  const int nb =
      (int)(want < 1 ? 1 : (want > K2_MAX_BLOCKS ? K2_MAX_BLOCKS : want));
  cudaError_t err = cudaMemsetAsync(table, 0, (size_t)n * 8, st);
  if (err != cudaSuccess) return (int)err;
  const bool mask = has_mask_leaf(a->code);
  if (f64 && mask)
    err = launch_agg<double, true>(tier, a, params, num_docs, S, D, P, G, B,
                                   smem, copy, nb, table, st);
  else if (f64)
    err = launch_agg<double, false>(tier, a, params, num_docs, S, D, P, G, B,
                                    smem, copy, nb, table, st);
  else if (mask)
    err = launch_agg<float, true>(tier, a, params, num_docs, S, D, P, G, B,
                                  smem, copy, nb, table, st);
  else
    err = launch_agg<float, false>(tier, a, params, num_docs, S, D, P, G, B,
                                   smem, copy, nb, table, st);
  if (err != cudaSuccess) return (int)err;
  const long long tb = (n + PT_THREADS - 1) / PT_THREADS;
  const int flat = (int)(tb < 4096 ? (tb > 0 ? tb : 1) : 4096);
  if (f64)
    group_decode<double><<<flat, PT_THREADS, 0, st>>>(*a, n, table,
                                                      (double*)out);
  else
    group_decode<float><<<flat, PT_THREADS, 0, st>>>(*a, n, table,
                                                     (float*)out);
  return (int)cudaGetLastError();
}
