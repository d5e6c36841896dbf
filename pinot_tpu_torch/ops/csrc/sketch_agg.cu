// K3 sketch_agg: fused filter + HLL registers + fixed-bucket histograms over
// stacked segment blocks [S, D], written into the packed [S, 1 + sum(w)]
// layout (matched count in column 0, each sketch slot's registers or
// buckets at its `out` column).
//
// Replaces pinot_tpu/ops/kernels.py:429 `_hll_slot` (with `_fmix32` :419)
// and :451 `_hist_slot`, as `_compute_slots` :515-523 calls them, and
// `_pack_flat` :574 for their columns.
//
// Bound on an H100: bytes. Per kept doc an HLL column reads two i32 planes
// and a histogram slot one value: 8-12 bytes against some 20 integer
// operations (two murmur3 finalizers each way) and one shared-memory
// update, far below the rate where the card's compute would limit, so the
// floor is the filter's columns and the kept docs' inputs over 3.35 TB/s.
// Four things held the first design at 8x that floor on an H100: a
// per-doc interpreter for the filter (a dispatch per leaf and per column
// dtype, compares in double, 1-4 bytes a load), the murmur3 chains of a
// column hashed again for each HLL slot on it, an atomic for every kept
// doc although a register only grows and soon stops changing, and uint32
// registers (a rank is at most 33), which left a log2m-16 slot out of
// shared memory, its updates going to global atomics.
//
// Design: grid (blocks per segment, S) for a single launch, (B members x
// blocks per segment, S) for a batch, 256 threads, each block over one
// contiguous doc range (a multiple of PT_TILE docs) of one segment for one
// member (interp.cuh: the member axis); `pt_sketch_grid` sizes the grid to
// about one wave of the blocks the card holds at once. The program, the
// member's parameter row, its leaves' converted literals (interp.cuh
// `prep_leaf`) and small LUT rows sit in shared memory, beside the sketch
// tables. A thread takes a tile of PT_TILE docs and evaluates the filter
// once for the tile, as K1 does (interp.cuh `tile_bytes` for the upsert
// validity mask, `tile_filter` for the main filter and the agg FILTERs
// the sketch slots read); the matched count adds the tile mask's popcount.
// Then the kept docs' sketch inputs:
//   - where a warp's 32 tiles are full and keep at least K3_DENSE of
//     their 512 docs, and the plan's HLL slots hash one column and its
//     histograms read one raw float32 column (config #4's queries), a
//     lane reads its own tile's planes and values with 16-byte loads
//     (`tile_ints`, `tile_f32`), hashes all 16 docs, then reads a slot's
//     16 registers before raising any (`sketch_tile`): its docs overlap
//     their latencies, where a doc at a time left the warp waiting on each;
//   - elsewhere the warp appends its kept docs to a list in shared memory
//     (half a step, 16 tiles, at a time) and takes them a doc a lane.
// A warp's lanes step together either way (no `continue` on a rejected
// doc: with one, an earlier design drifted apart by whole steps and ran
// four times slower under filters). Each doc hashes an HLL column's
// planes once for every slot on it. A register is read before it is
// raised: each HLL slot keeps a byte a register in shared memory, a cache
// of what the block has sent to the segment's uint32 register in a global
// table [B, S, out_width]; a rank above the cached byte is stored in the
// byte and sent with an atomicMax that nothing waits for (`raise_cached`),
// so after a block's first docs nearly every doc takes one shared-memory
// read and no atomic. Histogram buckets are uint32 in shared memory with
// atomicAdd. program.py places each table on chip while SKETCH_SMEM_BYTES
// holds it (the slot row's `acc` field: its byte offset), so log2m 16 (64
// KB of bytes) sits beside a log2m-12 HLL and an 8192-bucket histogram; a
// slot that does not fit tests and raises its global table directly (an
// L2 read first, an atomic where the rank is above it; atomicAdd for
// buckets). At the end a block writes its on-chip histograms, whole, to
// its own row of a partial buffer [B, S, nb, histogram bytes], coalesced
// and without atomics, and a finalize pass sums each bucket over the nb rows
// or reads the global table, and writes the value dtype. Integer tables
// and integer atomics make every result bit-exact whatever the block
// order or partition. (Byte registers raised in place with a
// compare-and-swap on their word, whose result the warp waits for, ran
// over twice as slow on an H100: PERF.md §6, K3's findings.)
//
// Numerics, as the JAX kernel: the hash is uint32 arithmetic on the planes'
// bit patterns; rank = clz(h2) + 1, which is 33 when h2 is 0. The bucket is
// (v - lo) * scale in the value dtype, one rounding per operation (the build
// passes --fmad=false), clipped to [0, B - 1] and truncated; NaN goes to
// bucket 0, where XLA's float to int32 conversion puts it.
#include "interp.cuh"

#define K3_LUT_BYTES 2048           // LUT row bytes a block stages
#define K3_WARPS (PT_THREADS / 32)  // a block's warps
// a warp's list of kept docs: half a step, 16 tiles of PT_TILE docs, each
// entry the doc's offset in the warp's step (below 32 x PT_TILE)
#define K3_KEPT (16 * PT_TILE)
// each block covers at least this many docs of its segment, so that its
// tables' write-out stays small beside its scan
#define K3_MIN_DOCS (1 << 16)
// a warp's step of 32 full tiles (512 docs) keeping at least this many
// takes the tile path, where a plan's inputs allow it; sparser steps the
// kept list
#define K3_DENSE 128

// The launch's layout, built on the host (`k3_layout`). The dynamic shared
// memory holds the sketch tables (`tab` bytes, at offset 0), the program,
// the parameter row, the TileLeaf table, the staged LUT rows, the warps'
// kept lists, the filter stack, the agg FILTER tile masks and the value
// stack, at the offsets o_*.
struct K3Layout {
  int lut_off[PT_MAX_LUTS];  // a LUT's offset in the staged LUT bytes
  int tab;                   // bytes of the on-chip sketch tables
  int part;  // bytes of the on-chip histograms: a block's partial row
  int o_code, o_prm, o_leaf, o_lut, o_kept, o_fst, o_afm, o_vst;
  int smem;      // dynamic shared bytes
  int vec;       // full tiles take 16-byte loads
  int tile;      // dense full steps read their inputs with tile loaders
  int thi, tlo;  // the HLL slots' (hi, lo) plane columns (tile path)
  int tval;      // the histogram slots' float32 column (tile path; -1 none)
  unsigned afilt;  // the agg FILTERs the sketch slots read, as bits
};

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

// Bytes of a sketch slot's on-chip table: a byte a register, a word a
// bucket (program.py `sketch_table_bytes`).
static inline int sketch_table_bytes(const int* sl) {
  return sl[0] == S_HLL ? (1 << sl[4]) : 4 * sl[4];
}

// Raise register `reg` of an HLL slot to `rank`: its byte in the block's
// on-chip cache `t` is read first, and only a rank above it is stored
// there and sent to the segment's global register `g` with an atomicMax
// that nothing waits for. The cache holds no more than the block has sent
// (a race between two lanes' stores can leave it lower, which costs an
// extra atomic later, never a register), so every rank is either at most
// the global register already or sent to it: the global table is the
// exact max.
__device__ __forceinline__ void raise_cached(unsigned char* t, unsigned* g,
                                             unsigned reg, unsigned rank) {
  if (rank > t[reg]) {
    t[reg] = (unsigned char)rank;
    atomicMax(g + reg, rank);
  }
}

// Raise a global register to `rank`, testing first (read past L1, where
// another block's raise would not show).
__device__ __forceinline__ void raise_word(unsigned* p, unsigned rank) {
  if (rank > __ldcg(p)) atomicMax(p, rank);
}

// The sketch slots' updates for kept doc i of column set u (the kept-list
// path): an HLL column's planes are read and hashed once for all its slots
// (a slot's c0 names its column), a value program evaluated once for
// consecutive slots reading it (`vst`: the value stack). The doc's agg
// FILTER bits are bit `bit` of its tile's masks, owned by thread `own`
// (afm[f * nt + own]).
template <typename T>
__device__ __forceinline__ void sketch_doc(
    const Args& a, const int* code, const double* prm, int u, long long i,
    T* vst, const unsigned* afm, int nt, int own, int bit,
    unsigned char* tab, unsigned* grow) {
  const int nslot = code[H_NSLOT];
  const int* slots = code + code[H_SLOT];
  int hc = -1, cv = -1;
  unsigned h1 = 0u, h2 = 0u;
  T x = (T)0;
  for (int j = 0; j < nslot; ++j) {
    const int* sl = slots + j * SLOT_W;
    const int op = sl[0];
    if (!is_sketch(op)) continue;  // K1's slots
    if (sl[2] >= 0 && !((afm[sl[2] * nt + own] >> bit) & 1u)) continue;
    const int sm = sl[3];
    if (op == S_HLL) {
      if (sl[6] != hc) {
        hc = sl[6];
        const unsigned hi = ((const unsigned*)a.cols[u][sl[6]])[i];
        const unsigned lo = ((const unsigned*)a.cols[u][sl[7]])[i];
        h1 = fmix32(fmix32(lo ^ 0x9E3779B9u) ^ hi);
        h2 = fmix32(fmix32(hi ^ 0x85EBCA77u) ^ lo);
      }
      const unsigned reg = h1 & ((1u << sl[4]) - 1u);
      const unsigned rank = (unsigned)__clz((int)h2) + 1u;  // 33 at 0
      if (sm >= 0) raise_cached(tab + sm, grow + sl[5], reg, rank);
      else raise_word(grow + sl[5] + reg, rank);
    } else {
      if (sl[1] != cv) {
        cv = sl[1];
        x = doc_value<T>(a, code, prm, u, cv, i, vst);
      }
      const int bk = hist_bucket<T>(x, (T)prm[sl[6]], (T)prm[sl[7]], sl[4]);
      if (sm >= 0) atomicAdd((unsigned*)(tab + sm) + bk, 1u);
      else atomicAdd(grow + sl[5] + bk, 1u);
    }
  }
}

// The sketch slots' updates for a lane's full tile of PT_TILE docs from
// registers (the tile path): `hi` / `lo` the HLL column's planes, `xv` the
// histograms' float32 values, `m` the tile's kept docs, `afm` the lane's
// agg FILTER masks (stride nt). Every doc's hash first, then slot by
// slot, a slot's register reads for all 16 docs before any raise, so that
// a lane's docs overlap their latencies instead of running one after the
// other.
template <typename T>
__device__ __forceinline__ void sketch_tile(
    const int* code, const double* prm, const unsigned* afm, int nt,
    unsigned char* tab, unsigned* grow, bool hll, const int (&hi)[PT_TILE],
    const int (&lo)[PT_TILE], const float (&xv)[PT_TILE], unsigned m) {
  unsigned h1[PT_TILE], rk[PT_TILE / 4] = {};  // ranks, 4 bytes a word
  if (hll) {
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d) {
      const unsigned a = (unsigned)hi[d], b = (unsigned)lo[d];
      h1[d] = fmix32(fmix32(b ^ 0x9E3779B9u) ^ a);
      const unsigned h2 = fmix32(fmix32(a ^ 0x85EBCA77u) ^ b);
      rk[d >> 2] |= ((unsigned)__clz((int)h2) + 1u) << (8 * (d & 3));
    }
  }
  const int nslot = code[H_NSLOT];
  const int* slots = code + code[H_SLOT];
  for (int j = 0; j < nslot; ++j) {
    const int* sl = slots + j * SLOT_W;
    const int op = sl[0];
    if (!is_sketch(op)) continue;  // K1's slots
    const unsigned keep = sl[2] >= 0 ? afm[sl[2] * nt] : m;
    if (!keep) continue;
    const int sm = sl[3];
    if (op == S_HLL) {
      const unsigned mask = (1u << sl[4]) - 1u;
      unsigned* g = grow + sl[5];
      if (sm >= 0) {
        unsigned char* t = tab + sm;
        unsigned cur[PT_TILE];
#pragma unroll
        for (int d = 0; d < PT_TILE; ++d)
          cur[d] = ((keep >> d) & 1u) ? t[h1[d] & mask] : 255u;
#pragma unroll
        for (int d = 0; d < PT_TILE; ++d) {
          const unsigned rank = (rk[d >> 2] >> (8 * (d & 3))) & 255u;
          if (rank > cur[d]) {
            t[h1[d] & mask] = (unsigned char)rank;
            atomicMax(g + (h1[d] & mask), rank);
          }
        }
      } else {
#pragma unroll
        for (int d = 0; d < PT_TILE; ++d)
          if ((keep >> d) & 1u)
            raise_word(g + (h1[d] & mask),
                       (rk[d >> 2] >> (8 * (d & 3))) & 255u);
      }
    } else {
      const T hlo = (T)prm[sl[6]], hsc = (T)prm[sl[7]];
      unsigned* t = sm >= 0 ? (unsigned*)(tab + sm) : grow + sl[5];
#pragma unroll
      for (int d = 0; d < PT_TILE; ++d)
        if ((keep >> d) & 1u)
          atomicAdd(t + hist_bucket<T>((T)xv[d], hlo, hsc, sl[4]), 1u);
    }
  }
}

// 2 blocks an SM: the tables of config #4's phase-3 plan (100 KB) twice
// (3, at fewer registers a thread, ran the phase-3 plan slower on an
// H100)
template <typename T, typename M>
__global__ void __launch_bounds__(PT_THREADS, 2)
sketch_agg_kernel(const __grid_constant__ Args a,
                  const __grid_constant__ K3Layout ly,
                  const double* __restrict__ params,
                  const int* __restrict__ num_docs, int S, int D, int P,
                  int nmem, unsigned char* __restrict__ partial,
                  unsigned* __restrict__ gtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned warp_cnt[K3_WARPS];
  const int s = blockIdx.y;
  int b, nb;
  const M mb = Grid<M>::at(a, S, nmem, b, nb);
  const int u = mb.u();
  const long long row = mb.row();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  unsigned char* tab = smem;
  int* code = (int*)(smem + ly.o_code);
  double* prm = (double*)(smem + ly.o_prm);
  TileLeaf* tl = (TileLeaf*)(smem + ly.o_leaf);
  unsigned char* slut = smem + ly.o_lut;
  for (int k = tid; k < a.code[H_LEN]; k += nt) code[k] = a.code[k];
  for (int k = tid; k < P; k += nt) prm[k] = params[row * P + k];
  for (int k = tid; k < ly.tab / 16; k += nt)
    ((uint4*)tab)[k] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int nl = code[H_NLEAVES], nfilt = code[H_NFILT];
  const int mainf = code[H_MAIN];
  // the leaves' literals (a thread a leaf), then the LUT rows (a warp a
  // LUT leaf): bit sets of at most 64 entries, larger rows staged
  for (int li = tid; li < nl; li += nt) {
    clamp_leaf(code, prm, li);
    prep_leaf(code, prm, li, tl[li]);
    const int* L = code + code[H_LEAF] + li * LEAF_W;
    if (L[0] == L_LUT) tl[li].lut = ly.lut_off[L[4]];
  }
  __syncthreads();
  for (int li = warp; li < nl; li += nw) {
    const int* L = code + code[H_LEAF] + li * LEAF_W;
    if (L[0] != L_LUT) continue;
    const int C = code[code[H_LUTC] + L[4]];
    const unsigned char* r = a.luts[L[4]] + row * C;
    if (C <= 64) {
      const unsigned lo = __ballot_sync(0xffffffffu, lane < C && r[lane]);
      const unsigned hi =
          __ballot_sync(0xffffffffu, lane + 32 < C && r[lane + 32]);
      if (lane == 0) tl[li].bits = ((unsigned long long)hi << 32) | lo;
    } else if (ly.lut_off[L[4]] >= 0) {
      for (int k = lane; k < C; k += 32) slut[ly.lut_off[L[4]] + k] = r[k];
    }
  }
  __syncthreads();

  unsigned* fst = (unsigned*)(smem + ly.o_fst);
  unsigned* afm = (unsigned*)(smem + ly.o_afm);
  T* vst = (T*)(smem + ly.o_vst);
  unsigned short* kept = (unsigned short*)(smem + ly.o_kept) + warp * K3_KEPT;
  unsigned* grow = gtab + row * code[H_OUTW];
  const int n = max(0, min(num_docs[(long long)u * S + s], D));
  const int per = ((n + nb - 1) / nb + PT_TILE - 1) / PT_TILE * PT_TILE;
  const int start = min(n, b * per), end = min(n, start + per);
  const int ntiles = (end - start + PT_TILE - 1) / PT_TILE;
  const long long base = (long long)s * D + start;
  const unsigned char* vm = a.vmask[u];
  unsigned matched = 0;
  for (int t0 = warp * 32; t0 < ntiles; t0 += nt) {
    const int left = end - (start + (t0 + lane) * PT_TILE);
    const unsigned lim = left <= 0 ? 0u
                       : (left >= PT_TILE ? PT_TILE_BITS : (1u << left) - 1u);
    const long long i0 = base + (long long)(t0 + lane) * PT_TILE;
    // a warp's tiles take one path: 16-byte loads where all are full
    const bool full = ly.vec && __all_sync(0xffffffffu, lim == PT_TILE_BITS);
    unsigned m = lim;
    if (vm != nullptr && m)
      m &= full ? tile_bytes<true>(vm + i0, lim)
                : tile_bytes<false>(vm + i0, lim);
    if (m && mainf >= 0)
      m &= full ? tile_filter<true>(a, code, prm, tl, slut, u, row, mainf,
                                    i0, lim, fst)
                : tile_filter<false>(a, code, prm, tl, slut, u, row, mainf,
                                     i0, lim, fst);
    matched += __popc(m);
    if (m) {
      for (int f = 0; f < nfilt; ++f) {
        if (!((ly.afilt >> f) & 1u)) continue;
        afm[f * nt + tid] =
            m & (full ? tile_filter<true>(a, code, prm, tl, slut, u, row, f,
                                          i0, lim, fst)
                      : tile_filter<false>(a, code, prm, tl, slut, u, row, f,
                                           i0, lim, fst));
      }
    }
    if (ly.tile && full &&
        __reduce_add_sync(0xffffffffu, (unsigned)__popc(m)) >= K3_DENSE) {
      // a dense step: a lane's 16 docs from registers, its tile read
      // whole where it keeps a doc
      int h[PT_TILE] = {}, l[PT_TILE] = {};
      float xv[PT_TILE] = {};
      if (m) {
        if (ly.thi >= 0) {
          tile_ints<true>(a.cols[u][ly.thi], 2, i0, lim, h);
          tile_ints<true>(a.cols[u][ly.tlo], 2, i0, lim, l);
        }
        if (ly.tval >= 0) tile_f32<true>(a.cols[u][ly.tval], i0, lim, xv);
        sketch_tile<T>(code, prm, afm + tid, nt, tab, grow, ly.thi >= 0, h,
                       l, xv, m);
      }
      continue;
    }
    // the kept docs of half the warp's tiles at a time, listed in shared
    // memory, a doc a lane
    for (int half = 0; half < 2; ++half) {
      const int c = (lane >> 4) == half ? __popc(m) : 0;
      int x = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int total = __shfl_sync(0xffffffffu, x, 31);
      if (total == 0) continue;
      int off = x - c;
      for (unsigned mm = c ? m : 0u; mm; mm &= mm - 1)
        kept[off++] = (unsigned short)(lane * PT_TILE + __ffs(mm) - 1);
      __syncwarp();
      for (int r = lane; r < total; r += 32) {
        const int e = kept[r], own = e / PT_TILE, bit = e % PT_TILE;
        const long long i = base + (long long)(t0 + own) * PT_TILE + bit;
        sketch_doc<T>(a, code, prm, u, i, vst, afm, nt, warp * 32 + own,
                      bit, tab, grow);
      }
      __syncwarp();
    }
  }

  // matched count: warp sums, then one global atomic per block
  for (int o = 16; o > 0; o >>= 1)
    matched += __shfl_down_sync(0xffffffffu, matched, o);
  if (lane == 0) warp_cnt[warp] = matched;
  __syncthreads();
  if (tid == 0) {
    unsigned total = 0;
    for (int w = 0; w < nw; ++w) total += warp_cnt[w];
    if (total) atomicAdd(grow, total);
  }
  // this block's on-chip histograms, whole and in slot order, to its row
  // of the partial buffer (its HLL caches stay: their registers are the
  // global table's)
  unsigned* prow = (unsigned*)(partial + (row * nb + b) * ly.part);
  const int* slots = code + code[H_SLOT];
  for (int j = 0; j < code[H_NSLOT]; ++j) {
    const int* sl = slots + j * SLOT_W;
    if (sl[0] != S_HIST || sl[3] < 0) continue;
    for (int k = tid; k < sl[4]; k += nt)
      prow[k] = ((const unsigned*)(tab + sl[3]))[k];
    prow += sl[4];
  }
}

// One thread per (output column, segment, member): the matched count, and
// every sketch column, reduced over the nb block partials (max for a
// register byte, sum for a bucket word) or read from the global table.
// Scalar slots' columns are K1's and are left as they are.
template <typename T>
__global__ void __launch_bounds__(PT_THREADS)
sketch_finalize(const __grid_constant__ Args a,
                const unsigned char* __restrict__ partial,
                const unsigned* __restrict__ gtab, int nb, int part,
                T* __restrict__ out) {
  // the (member, segment) row of partial, gtab and out
  const long long s = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int outw = a.code[H_OUTW];
  if (col >= outw) return;
  const unsigned* grow = gtab + s * outw;
  T* row = out + s * outw;
  if (col == 0) {
    row[0] = (T)grow[0];
    return;
  }
  const int nslot = a.code[H_NSLOT];
  const int* slots = a.code + a.code[H_SLOT];
  int poff = 0;  // the slot's words into a partial row
  for (int j = 0; j < nslot; ++j) {
    const int* sl = slots + j * SLOT_W;
    if (!is_sketch(sl[0])) continue;
    const bool part_row = sl[0] == S_HIST && sl[3] >= 0;
    const int k = col - sl[5];
    if (k < 0 || k >= sketch_width(sl)) {
      if (part_row) poff += sl[4];
      continue;
    }
    if (!part_row) {  // registers and off-chip buckets are global
      row[col] = (T)grow[col];
      return;
    }
    const unsigned* p =
        (const unsigned*)(partial + s * nb * part) + poff + k;
    unsigned x = 0;
    for (int q = 0; q < nb; ++q) x += p[(long long)q * (part / 4)];
    row[col] = (T)x;
    return;
  }
}

static int align16(int x) { return (x + 15) & ~15; }

static bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0ull;
}

// The layout of a K3 launch over B members at block width D with a value
// dtype of `vbytes` bytes.
static void k3_layout(const Args* a, int D, int P, int B, int vbytes,
                      K3Layout& ly) {
  const int* code = a->code;
  const int nl = code[H_NLEAVES], nfilt = code[H_NFILT];
  const int nslot = code[H_NSLOT], mainf = code[H_MAIN];
  const int* slots = code + code[H_SLOT];
  ly.tab = ly.part = 0;
  ly.afilt = 0u;
  ly.thi = ly.tlo = ly.tval = -1;
  bool tile = true;
  for (int j = 0; j < nslot; ++j) {
    const int* sl = slots + j * SLOT_W;
    if (sl[0] != S_HLL && sl[0] != S_HIST) continue;
    if (sl[3] >= 0 && sl[3] + sketch_table_bytes(sl) > ly.tab)
      ly.tab = sl[3] + sketch_table_bytes(sl);
    if (sl[0] == S_HIST && sl[3] >= 0) ly.part += 4 * sl[4];
    if (sl[2] >= 0 && sl[2] != mainf) ly.afilt |= 1u << sl[2];
    if (sl[0] == S_HLL) {
      if (ly.thi < 0) {
        ly.thi = sl[6];
        ly.tlo = sl[7];
      }
      tile = tile && sl[6] == ly.thi && sl[7] == ly.tlo;
    } else {
      // a raw float32 column: one V_COL instruction
      const int* V = code + code[H_VAL] + 2 * sl[1];
      const int* ins = code + V[0];
      const bool raw = V[1] == 1 && ins[0] == V_COL &&
                       code[code[H_COLDT] + ins[1]] == 3;
      if (raw && ly.tval < 0) ly.tval = ins[1];
      tile = tile && raw && ins[1] == ly.tval;
    }
  }
  ly.tab = align16(ly.tab);
  bool vec = D % PT_TILE == 0;
  int lut_bytes = 0;
  for (int k = 0; k < PT_MAX_LUTS; ++k) ly.lut_off[k] = -1;
  for (int l = 0; l < nl; ++l) {
    const int* L = code + code[H_LEAF] + l * LEAF_W;
    if (L[0] == L_MASK) {
      vec = vec && code[code[H_LUTC] + L[4]] == D && aligned16(a->luts[L[4]]);
    } else if (L[0] == L_LUT) {
      const int C = code[code[H_LUTC] + L[4]];
      if (C > 64 && ly.lut_off[L[4]] < 0 && lut_bytes + C <= K3_LUT_BYTES) {
        ly.lut_off[L[4]] = lut_bytes;
        lut_bytes = align16(lut_bytes + C);
      }
    }
  }
  for (int m = 0; m < B; ++m) {
    const int u = a->set_of[m];
    for (int c = 0; c < code[H_NCOL]; ++c)
      vec = vec && aligned16(a->cols[u][c]);
    vec = vec && aligned16(a->vmask[u]);
  }
  ly.vec = vec ? 1 : 0;
  ly.tile = vec && tile ? 1 : 0;
  const int nt = PT_THREADS;
  const int fdepth = program_depth(code, code[H_FILT], nfilt, true);
  const int vdepth = program_depth(code, code[H_VAL], code[H_NVAL], false);
  ly.o_code = ly.tab;
  ly.o_prm = ly.o_code + align16(code[H_LEN] * 4);
  ly.o_leaf = ly.o_prm + align16((P > 0 ? P : 1) * 8);
  ly.o_lut = ly.o_leaf + align16(nl * (int)sizeof(TileLeaf));
  ly.o_kept = ly.o_lut + lut_bytes;
  ly.o_fst = ly.o_kept + K3_WARPS * K3_KEPT * 2;
  ly.o_afm = ly.o_fst + (fdepth - 1) * nt * 4;
  ly.o_vst = ly.o_afm + (ly.afilt ? nfilt * nt * 4 : 0);
  ly.smem = align16(ly.o_vst + (vdepth - 1) * nt * vbytes);
}

// The most dynamic shared bytes a block of K3 may take on device `dev`:
// the card's opt-in limit less the kernel's static arrays.
template <typename T, typename M>
static cudaError_t k3_smem_max(int dev, int& most) {
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, sketch_agg_kernel<T, M>);
  most = optin - (int)fa.sharedSizeBytes;
  return e;
}

// Raises K3's shared-memory limit to its most, once a device.
template <typename T, typename M>
static cudaError_t k3_limit() {
  static std::atomic<unsigned> limit_set{0};
  return pt_smem_limit_max(sketch_agg_kernel<T, M>, &limit_set);
}

// Blocks per segment: as many as fit one wave of the blocks the card holds
// at once at this layout over the launch's S x B rows (a second, partial
// wave would double a launch whose blocks take equal time), each over at
// least K3_MIN_DOCS docs.
template <typename T, typename M>
static int k3_grid(const K3Layout& ly, int S, int D, int B, int dev) {
  cudaError_t e = k3_limit<T, M>();
  int most = 0;
  if (e == cudaSuccess) e = k3_smem_max<T, M>(dev, most);
  if (e != cudaSuccess) return -(int)e;
  if (ly.smem > most) return -(int)cudaErrorInvalidConfiguration;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sketch_agg_kernel<T, M>, PT_THREADS, ly.smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long rows = (long long)S * B;
  long long nb = wave / rows;
  const long long cap = (D + K3_MIN_DOCS - 1) / K3_MIN_DOCS;
  nb = nb < cap ? nb : cap;
  return (int)(nb < 1 ? 1 : nb);
}

template <typename T, typename M>
static int launch(const Args* a, const double* params, const int* num_docs,
                  int S, int D, int P, int nb, int B, unsigned char* partial,
                  unsigned* gtab, T* out, cudaStream_t st) {
  K3Layout ly;
  k3_layout(a, D, P, B, (int)sizeof(T), ly);
  const int outw = a->code[H_OUTW];
  cudaError_t e = k3_limit<T, M>();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(
      gtab, 0, (size_t)B * S * outw * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  sketch_agg_kernel<T, M><<<dim3(nb * B, S), PT_THREADS, ly.smem, st>>>(
      *a, ly, params, num_docs, S, D, P, B, partial, gtab);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sketch_finalize<T><<<dim3((outw + PT_THREADS - 1) / PT_THREADS, S, B),
                       PT_THREADS, 0, st>>>(*a, partial, gtab, nb, ly.part,
                                            out);
  return (int)cudaGetLastError();
}

// The launch's blocks per segment (>= 1) and, in *tab, the bytes of one
// block's on-chip tables and, in *part, of its on-chip histograms (its row
// of the partial buffer), for B members
// of the program in `a` at block width D with P parameters; a negative
// CUDA error where the layout does not fit a block. Raises K3's
// shared-memory limit on the device once.
extern "C" int pt_sketch_grid(const Args* a, int S, int D, int P, int B,
                              int f64, int dev, int* tab, int* part) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return -(int)e;
  K3Layout ly;
  k3_layout(a, D, P, B, f64 ? 8 : 4, ly);
  *tab = ly.tab;
  *part = ly.part;
  const bool one = B == 1 && a->set_of[0] == 0;
  if (f64)
    return one ? k3_grid<double, Single>(ly, S, D, B, dev)
               : k3_grid<double, Mem>(ly, S, D, B, dev);
  return one ? k3_grid<float, Single>(ly, S, D, B, dev)
             : k3_grid<float, Mem>(ly, S, D, B, dev);
}

// Launches K3 and its finalize pass on `stream` for B members. params:
// [B, S, P] float64; num_docs: [U, S] int32; nb: blocks per segment
// (`pt_sketch_grid`); partial: [B, S, nb, part] bytes of scratch, part the
// on-chip histograms' bytes (`pt_sketch_grid`; written whole, no zeroing
// needed); gtab: [B, S, out_width] uint32 scratch, zeroed
// here; out: [B, S, out_width] of the value dtype (f64 != 0: float64, else
// float32), of which K3 writes column 0 and its sketch slots' columns.
// dev: the tensors' device. Returns the first CUDA error, or 0.
extern "C" int pt_sketch_agg(const Args* a, const double* params,
                             const int* num_docs, int S, int D, int P,
                             int nb, int B, int f64, unsigned char* partial,
                             unsigned* gtab, void* out, int dev,
                             void* stream) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const bool one = B == 1 && a->set_of[0] == 0;
  if (f64)
    return one ? launch<double, Single>(a, params, num_docs, S, D, P, nb, B,
                                        partial, gtab, (double*)out, st)
               : launch<double, Mem>(a, params, num_docs, S, D, P, nb, B,
                                     partial, gtab, (double*)out, st);
  return one ? launch<float, Single>(a, params, num_docs, S, D, P, nb, B,
                                     partial, gtab, (float*)out, st)
             : launch<float, Mem>(a, params, num_docs, S, D, P, nb, B,
                                  partial, gtab, (float*)out, st);
}
