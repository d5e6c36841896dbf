// K1 scan_agg: fused filter + value expressions + masked reductions over
// stacked segment blocks [S, D], packed as [S, 1 + sum(w)].
//
// Replaces the ungrouped branch of pinot_tpu/ops/kernels.py:537
// `make_kernel` (`_compute_slots` :468 with `_eval_filter` :128,
// `_eval_value` :197, `_masked_reduce` :228, `_isum_slot` :377,
// `_isum_u_slot` :404, `_pack_flat` :574).
//
// Bound on an H100: bytes. Each staged column element is read once
// (1-8 bytes per doc per column) against a handful of compares and adds, far
// below the ~20 operations per byte where the card's compute would limit,
// so the floor is the staged bytes over 3.35 TB/s. Walking the postfix
// code once per doc (a dispatch per leaf and per column dtype, compares in
// double, 1-2 bytes a load, accumulators indexed by the code and so in
// local memory) holds a kernel far above that floor on instruction issue;
// the design below walks it once per tile.
//
// Design: grid (blocks per segment x member groups, S). A block covers
// one contiguous doc range of one segment (a multiple of PT_TILE docs; the
// range depends on n and the block count only, never on the batch, so a
// member's bits equal its single launch's) for a group of members that
// read one column set: broadcast and dedup members share a block, which
// loads each tile once and evaluates every member on it (the second and
// later members' reads hit L1). The program, each member's parameter row,
// its leaves' converted literals (interp.cuh `prep_leaf`) and small LUT
// rows sit in shared memory. A thread takes a tile of PT_TILE docs and
// evaluates the filter once for the tile (interp.cuh `tile_filter`):
//   - the upsert validity mask's bytes and the tile's bound give the
//     valid bits; the main filter's mask ANDs them;
//   - COUNT slots add the popcount of the tile's mask (and of an agg
//     FILTER's tile mask, evaluated only on tiles that keep a doc);
//   - the kept docs are appended to the member's list of the warp in
//     shared memory, and once 32 wait the warp takes their values, a doc
//     a lane (`kept_docs`): each value program once per doc in T (and once
//     in int for the exact-sum slots), adding into the lane's
//     accumulators. A plan that keeps few docs so pays the value loads'
//     latency once a round, not once a step; a plan with agg FILTERs
//     takes its values every step, while the step's filter masks stand.
// Accumulators are doubles, a double a thread per word in shared memory
// (never local memory): counts and isum planes stay exact integers
// (< 2^53), float sums gain precision over the JAX float32 sum, min/max
// are exact. A block reduces each word in a fixed order (warp shuffles,
// then the warps in order) into scratch [B, S, nb, n_acc]; a second kernel
// reduces the nb partials in a fixed order, so reruns give the same bits,
// and writes the packed output in the value dtype, splitting isum planes
// into (hi, lo) 12-bit halves. Sketch slots (HLL, histogram) are K3's
// (sketch_agg.cu): K1 skips them and leaves their output columns to K3.
// A block whose tiles cannot take 16-byte loads (D not a multiple of
// PT_TILE, or a column, mask or validity block not 16-byte aligned) reads
// every doc with a scalar load, with the same partition and results.
// A block has PT_THREADS threads, or the most of 128, 64 and 32 at which
// one member's accumulators and stacks fit the card's shared memory (a
// plan near program.py's limits: 64 words, filters 32 and values 16
// deep, needs about 250 KB at 256); the plan decides it, not the batch,
// so a member's bits still equal its single launch's.
#include "interp.cuh"

#define K1_SMEM_BUDGET (96 * 1024)  // dynamic shared bytes a block aims at
#define K1_LUT_BYTES 4096           // LUT row bytes a member stages
#define K1_WARPS (PT_THREADS / 32)  // a block's most warps
// a warp's list of kept docs waiting for their values: up to 31 left from
// earlier steps and a step's 32 x PT_TILE
#define K1_KEPT (32 * PT_TILE + 32)

// The launch's layout, built on the host (pt_scan_agg). Members are
// grouped by column set, in member order, at most `mpb` to a group; group
// g holds members mem[start[g] .. start[g + 1]). The dynamic shared memory
// holds one region of `mstride` bytes per member of the group (its
// accumulators, parameter row, TileLeaf table, staged LUT rows and its
// warps' lists of kept docs, at the offsets o_*), then the block's filter
// stack, agg FILTER tile masks, value stacks (T and int) and reduction
// buffer.
struct K1Layout {
  int groups;
  int start[PT_MAX_MEMBERS + 1];
  int mem[PT_MAX_MEMBERS];
  int lut_off[PT_MAX_LUTS];  // a LUT's offset in the member's LUT bytes
  int mstride, o_prm, o_leaf, o_lut, o_kept;
  int o_fst, o_afm, o_vst, o_ist, o_red;
  int values;   // some slot reads a value: the kept docs walk the slots
  int vec;      // full tiles take 16-byte loads
  int threads;  // the block's threads
};

// The value slots of one member over `total` kept docs of a warp's list
// `kept` (each a doc's offset from the block's first doc `base`), 32 to a
// round. Each value program is evaluated once per doc in T and once in
// int for the exact sums (`order` walks the value slots sorted by value).
// An agg FILTER's bit comes from the doc's tile mask in `afm`, its owner
// lane's, when the list holds the warp's step at tile t0 alone (plans with
// agg FILTERs take their values every step).
template <typename T>
__device__ __forceinline__ void kept_docs(
    const Args& a, const int* code, const double* prm, const int* order,
    int nvs, const unsigned* afm, const int* kept, int total, int u,
    long long base, int t0, int warp, double* acc, T* vst, int* ist) {
  const int* slots = code + code[H_SLOT];
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int r = tid & 31; r < total; r += 32) {
    const int e = kept[r];
    const int own = warp * 32 + e / PT_TILE - t0, bit = e % PT_TILE;
    const long long i = base + e;
    int cv = -1, xi = 0;
    bool hx = false, hi = false;
    T xv = (T)0;
    for (int q = 0; q < nvs; ++q) {
      const int* sl = slots + order[q] * SLOT_W;
      const int op = sl[0], v = sl[1], f = sl[2];
      if (f >= 0 && !((afm[f * nt + own] >> bit) & 1u)) continue;
      if (v != cv) {
        cv = v;
        hx = hi = false;
      }
      double* A = acc + sl[3] * nt + tid;
      if (op == S_ISUM || op == S_ISUM_U) {
        if (!hi) {
          xi = doc_value<int>(a, code, prm, u, v, i, ist);
          hi = true;
        }
        if (op == S_ISUM) {
          for (int k = 0; k < 5; ++k)
            A[k * nt] += (double)((xi >> (6 * k)) & 63);
          A[5 * nt] += (double)(xi >> 30);  // signed top digit
        } else {
          for (int k = 0; k < sl[4]; ++k)
            A[k * nt] += (double)((xi >> (7 * k)) & 127);
        }
      } else {
        if (!hx) {
          xv = doc_value<T>(a, code, prm, u, v, i, vst);
          hx = true;
        }
        const double y = slot_contrib<T>(op, xv);
        A[0] = op == S_MIN ? nan_min(A[0], y)
             : op == S_MAX ? nan_max(A[0], y) : A[0] + y;
      }
    }
  }
}

// 4 blocks an SM: 64 registers a thread, whose spills cost less than the
// warps a larger register file would leave out (PERF.md §6)
template <typename T>
__global__ void __launch_bounds__(PT_THREADS, 4)
scan_agg_kernel(const __grid_constant__ Args a,
                const __grid_constant__ K1Layout ly,
                const double* __restrict__ params,
                const int* __restrict__ num_docs, int S, int D, int P,
                double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int code[PT_MAX_CODE];
  __shared__ int order[PT_MAX_ACC];  // the value slots, sorted by value
  __shared__ int nvs;
  __shared__ int nkept[PT_MAX_MEMBERS][K1_WARPS];  // a list's length
  const int grp = blockIdx.x % ly.groups, b = blockIdx.x / ly.groups;
  const int nb = gridDim.x / ly.groups, s = blockIdx.y;
  const int g0 = ly.start[grp], nm = ly.start[grp + 1] - g0;
  const int u = a.set_of[ly.mem[g0]];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  for (int k = tid; k < a.code[H_LEN]; k += nt) code[k] = a.code[k];
  for (int j = 0; j < nm; ++j) {
    double* prm = (double*)(smem + j * ly.mstride + ly.o_prm);
    const long long row = (long long)ly.mem[g0 + j] * S + s;
    for (int k = tid; k < P; k += nt) prm[k] = params[row * P + k];
  }
  __syncthreads();
  const int nl = code[H_NLEAVES], nacc = code[H_NACC];
  const int nslot = code[H_NSLOT], nfilt = code[H_NFILT];
  const int mainf = code[H_MAIN];
  const int* slots = code + code[H_SLOT];
  const int* accs = code + code[H_ACC];
  // each member's literals and LUT rows: a thread per (member, leaf), a
  // warp per (member, LUT leaf) for the bit sets
  for (int q = tid; q < nm * nl; q += nt) {
    const int j = q / nl, li = q % nl;
    unsigned char* mr = smem + j * ly.mstride;
    clamp_leaf(code, (double*)(mr + ly.o_prm), li);
    TileLeaf* tl = (TileLeaf*)(mr + ly.o_leaf);
    prep_leaf(code, (const double*)(mr + ly.o_prm), li, tl[li]);
    const int* L = code + code[H_LEAF] + li * LEAF_W;
    if (L[0] == L_LUT) tl[li].lut = ly.lut_off[L[4]];
  }
  __syncthreads();
  for (int q = warp; q < nm * nl; q += nw) {
    const int j = q / nl, li = q % nl;
    const int* L = code + code[H_LEAF] + li * LEAF_W;
    if (L[0] != L_LUT) continue;
    const int C = code[code[H_LUTC] + L[4]];
    const long long row = (long long)ly.mem[g0 + j] * S + s;
    const unsigned char* r = a.luts[L[4]] + row * C;
    unsigned char* mr = smem + j * ly.mstride;
    if (C <= 64) {
      const unsigned lo = __ballot_sync(0xffffffffu, lane < C && r[lane]);
      const unsigned hi =
          __ballot_sync(0xffffffffu, lane + 32 < C && r[lane + 32]);
      if (lane == 0)
        ((TileLeaf*)(mr + ly.o_leaf))[li].bits =
            ((unsigned long long)hi << 32) | lo;
    } else if (ly.lut_off[L[4]] >= 0) {
      for (int k = lane; k < C; k += 32)
        mr[ly.o_lut + ly.lut_off[L[4]] + k] = r[k];
    }
  }
  if (tid == 0) {  // the value slots, stably sorted by value index
    int n = 0;
    for (int j = 0; j < nslot; ++j) {
      const int op = slots[j * SLOT_W];
      if (op == S_COUNT || is_sketch(op)) continue;
      int k = n++;
      while (k > 0 && slots[order[k - 1] * SLOT_W + 1] >
                          slots[j * SLOT_W + 1]) {
        order[k] = order[k - 1];
        --k;
      }
      order[k] = j;
    }
    nvs = n;
  }
  for (int j = 0; j < nm; ++j) {
    double* acc = (double*)(smem + j * ly.mstride);
    for (int w = 0; w < nacc; ++w)
      acc[w * nt + tid] = identity_of(accs[w * ACC_W]);
    if (lane == 0) nkept[j][warp] = 0;
  }
  __syncthreads();

  unsigned* fst = (unsigned*)(smem + ly.o_fst);
  unsigned* afm = (unsigned*)(smem + ly.o_afm);
  T* vst = (T*)(smem + ly.o_vst);
  int* ist = (int*)(smem + ly.o_ist);
  // plans with agg FILTERs take their kept docs' values every step (the
  // filters' tile masks are the step's); others once a round of 32 waits
  const bool each_step = nfilt > (mainf >= 0 ? 1 : 0);
  const int n = max(0, min(num_docs[(long long)u * S + s], D));
  const int per = ((n + nb - 1) / nb + PT_TILE - 1) / PT_TILE * PT_TILE;
  const int start = min(n, b * per), end = min(n, start + per);
  const int ntiles = (end - start + PT_TILE - 1) / PT_TILE;
  const long long base = (long long)s * D + start;
  const unsigned char* vm = a.vmask[u];
  for (int t0 = warp * 32; t0 < ntiles; t0 += nt) {
    const int left = end - (start + (t0 + lane) * PT_TILE);
    const unsigned lim = left <= 0 ? 0u
                       : (left >= PT_TILE ? PT_TILE_BITS : (1u << left) - 1u);
    const long long i0 = base + (long long)(t0 + lane) * PT_TILE;
    // a warp's tiles take one path: 16-byte loads where all are full
    const bool full = ly.vec && __all_sync(0xffffffffu, lim == PT_TILE_BITS);
    unsigned valid = lim;
    if (vm != nullptr && lim)
      valid &= full ? tile_bytes<true>(vm + i0, lim)
                    : tile_bytes<false>(vm + i0, lim);
    for (int j = 0; j < nm; ++j) {
      unsigned char* mr = smem + j * ly.mstride;
      double* acc = (double*)mr;
      const double* prm = (const double*)(mr + ly.o_prm);
      const TileLeaf* tl = (const TileLeaf*)(mr + ly.o_leaf);
      const unsigned char* slut = mr + ly.o_lut;
      const long long row = (long long)ly.mem[g0 + j] * S + s;
      unsigned m = valid;
      if (m && mainf >= 0)
        m &= full ? tile_filter<true>(a, code, prm, tl, slut, u, row, mainf,
                                      i0, lim, fst)
                  : tile_filter<false>(a, code, prm, tl, slut, u, row, mainf,
                                       i0, lim, fst);
      if (m) {
        for (int f = 0; f < nfilt; ++f) {
          if (f == mainf) continue;
          afm[f * nt + tid] =
              m & (full ? tile_filter<true>(a, code, prm, tl, slut, u, row, f,
                                            i0, lim, fst)
                        : tile_filter<false>(a, code, prm, tl, slut, u, row,
                                             f, i0, lim, fst));
        }
        acc[tid] += (double)__popc(m);  // the matched count
        for (int q = 0; q < nslot; ++q) {
          const int* sl = slots + q * SLOT_W;
          if (sl[0] != S_COUNT) continue;
          const unsigned c = sl[2] < 0 ? m : afm[sl[2] * nt + tid];
          acc[sl[3] * nt + tid] += (double)__popc(c);
        }
      }
      if (!ly.values) continue;
      // the warp's kept docs, appended to the member's list of the warp
      int* kept = (int*)(mr + ly.o_kept) + warp * K1_KEPT;
      const int c = __popc(m);
      int x = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int n0 = nkept[j][warp];
      const int n = n0 + __shfl_sync(0xffffffffu, x, 31);
      if (n == n0) continue;
      int off = n0 + x - c;
      const int tile = (t0 + lane) * PT_TILE;
      for (unsigned mm = m; mm; mm &= mm - 1)
        kept[off++] = tile + __ffs(mm) - 1;
      __syncwarp();
      const int take = each_step ? n : n & ~31;
      if (take)
        kept_docs<T>(a, code, prm, order, nvs, afm, kept, take, u, base, t0,
                     warp, acc, vst, ist);
      __syncwarp();
      // the docs left for a later round, to the list's front
      const int e = lane < n - take ? kept[take + lane] : 0;
      __syncwarp();
      if (lane < n - take) kept[lane] = e;
      if (lane == 0) nkept[j][warp] = n - take;
      __syncwarp();
    }
  }
  for (int j = 0; j < nm; ++j) {  // the lists' last docs
    const int n = nkept[j][warp];
    __syncwarp();
    if (n == 0) continue;
    unsigned char* mr = smem + j * ly.mstride;
    kept_docs<T>(a, code, (const double*)(mr + ly.o_prm), order, nvs, afm,
                 (const int*)(mr + ly.o_kept) + warp * K1_KEPT, n, u, base, 0,
                 warp, (double*)mr, vst, ist);
  }

  // block reduction in a fixed order: warp shuffles, then the warps in
  // order
  __syncthreads();
  double* red = (double*)(smem + ly.o_red);
  for (int j = 0; j < nm; ++j) {
    const double* acc = (const double*)(smem + j * ly.mstride);
    for (int w = 0; w < nacc; ++w) {
      const int r = accs[w * ACC_W];
      double x = acc[w * nt + tid];
      for (int o = 16; o > 0; o >>= 1)
        x = combine(r, x, __shfl_down_sync(0xffffffffu, x, o));
      if (lane == 0) red[(j * nacc + w) * nw + warp] = x;
    }
  }
  __syncthreads();
  for (int q = tid; q < nm * nacc; q += nt) {
    const int j = q / nacc, w = q % nacc, r = accs[w * ACC_W];
    double x = red[q * nw];
    for (int k = 1; k < nw; ++k) x = combine(r, x, red[q * nw + k]);
    const long long row = (long long)ly.mem[g0 + j] * S + s;
    partial[(row * nb + b) * nacc + w] = x;
  }
}

// One block per (accumulator word, segment, member): reduce the nb block
// partials in a fixed tree order and write the packed output.
template <typename T>
__global__ void __launch_bounds__(PT_THREADS)
scan_finalize(const __grid_constant__ Args a, const double* __restrict__ partial,
              int nb, T* __restrict__ out) {
  __shared__ double buf[PT_THREADS];
  const int w = blockIdx.x;
  // the (member, segment) row of partial and out
  const long long s = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int nacc = a.code[H_NACC], outw = a.code[H_OUTW];
  const int* A = a.code + a.code[H_ACC] + w * ACC_W;
  const int r = A[0];
  double x = identity_of(r);
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    x = combine(r, x, partial[((long long)s * nb + b) * nacc + w]);
  buf[threadIdx.x] = x;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) buf[threadIdx.x] = combine(r, buf[threadIdx.x], buf[threadIdx.x + o]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    T* row = out + (long long)s * outw;
    if (A[1] == O_SCALAR) {
      row[A[2]] = (T)buf[0];
    } else {  // isum plane: exact int sum split into 12-bit halves
      const long long v = (long long)buf[0];
      row[A[2]] = (T)(v >> 12);
      row[A[2] + 1] = (T)(v & 4095);
    }
  }
}

static int align16(int x) { return (x + 15) & ~15; }

static bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0ull;
}

// The layout of a launch of B members at block width D, and its dynamic
// shared bytes; -1 when one member does not fit `limit` bytes even at 32
// threads a block.
static int k1_layout(const Args* a, int D, int P, int B, int limit,
                     K1Layout& ly) {
  const int* code = a->code;
  const int nl = code[H_NLEAVES], nacc = code[H_NACC];
  const int nfilt = code[H_NFILT], nslot = code[H_NSLOT];
  int lut_bytes = 0;
  bool vec = D % PT_TILE == 0;
  for (int k = 0; k < PT_MAX_LUTS; ++k) ly.lut_off[k] = -1;
  for (int l = 0; l < nl; ++l) {
    const int* L = code + code[H_LEAF] + l * LEAF_W;
    if (L[0] == L_MASK) {
      vec = vec && code[code[H_LUTC] + L[4]] == D && aligned16(a->luts[L[4]]);
    } else if (L[0] == L_LUT) {
      const int C = code[code[H_LUTC] + L[4]];
      if (C > 64 && ly.lut_off[L[4]] < 0 && lut_bytes + C <= K1_LUT_BYTES) {
        ly.lut_off[L[4]] = lut_bytes;
        lut_bytes = align16(lut_bytes + C);
      }
    }
  }
  ly.values = 0;
  for (int j = 0; j < nslot; ++j) {
    const int op = code[code[H_SLOT] + j * SLOT_W];
    if (op != S_COUNT && op != S_HLL && op != S_HIST) ly.values = 1;
  }
  for (int m = 0; m < B; ++m) {
    const int u = a->set_of[m];
    for (int c = 0; c < code[H_NCOL]; ++c) vec = vec && aligned16(a->cols[u][c]);
    vec = vec && aligned16(a->vmask[u]);
  }
  ly.vec = vec ? 1 : 0;
  const int fdepth = program_depth(code, code[H_FILT], nfilt, true);
  const int vdepth = program_depth(code, code[H_VAL], code[H_NVAL], false);
  // the widest block at which one member fits
  int nt = PT_THREADS, common = 0, per_member = 0;
  for (;; nt >>= 1) {
    if (nt < 32) return -1;
    ly.o_prm = nacc * nt * 8;
    ly.o_leaf = ly.o_prm + align16((P > 0 ? P : 1) * 8);
    ly.o_lut = ly.o_leaf + align16(nl * (int)sizeof(TileLeaf));
    ly.o_kept = ly.o_lut + lut_bytes;
    ly.mstride = ly.o_kept + (ly.values ? (nt / 32) * K1_KEPT * 4 : 0);
    common = align16((fdepth - 1) * nt * 4 + nfilt * nt * 4 +
                     (vdepth - 1) * nt * 12);
    per_member = ly.mstride + nacc * (nt / 32) * 8;
    if (common + per_member <= limit) break;
  }
  ly.threads = nt;
  // members per block: as many as the budget holds, spread evenly over
  // each column set's groups
  int mpb = (K1_SMEM_BUDGET - common) / per_member;
  mpb = mpb < 1 ? 1 : (mpb > PT_MAX_MEMBERS ? PT_MAX_MEMBERS : mpb);
  int ng = 0, nmem = 0;
  bool done[PT_MAX_MEMBERS] = {};
  for (int m = 0; m < B; ++m) {
    if (done[m]) continue;
    int same = 0;
    for (int q = m; q < B; ++q) same += a->set_of[q] == a->set_of[m];
    const int chunks = (same + mpb - 1) / mpb;
    const int size = (same + chunks - 1) / chunks;
    int in = 0;
    for (int q = m; q < B; ++q) {
      if (a->set_of[q] != a->set_of[m]) continue;
      if (in % size == 0) ly.start[ng++] = nmem;
      ly.mem[nmem++] = q;
      done[q] = true;
      ++in;
    }
  }
  ly.start[ng] = nmem;
  ly.groups = ng;
  int big = 0;
  for (int g = 0; g < ng; ++g)
    big = ly.start[g + 1] - ly.start[g] > big ? ly.start[g + 1] - ly.start[g]
                                              : big;
  ly.o_fst = big * ly.mstride;
  ly.o_afm = ly.o_fst + (fdepth - 1) * nt * 4;
  ly.o_vst = ly.o_afm + nfilt * nt * 4;
  // the value stacks of T and of int apart: the compiler may reorder
  // accesses to one region through two types
  ly.o_ist = ly.o_vst + (vdepth - 1) * nt * 8;
  ly.o_red = align16(ly.o_ist + (vdepth - 1) * nt * 4);
  return ly.o_red + big * nacc * (nt / 32) * 8;
}

template <typename T>
static int launch(const Args* a, const double* params, const int* num_docs,
                  int S, int D, int P, int nb, int B, double* partial, T* out,
                  int dev, cudaStream_t st) {
  // the dynamic shared bytes a block may take: the card's opt-in limit
  // less the kernel's static arrays
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, scan_agg_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  K1Layout ly;
  const int smem = k1_layout(a, D, P, B, optin - (int)fa.sharedSizeBytes, ly);
  if (smem < 0) return (int)cudaErrorInvalidConfiguration;
  // raised whatever this launch's size: without the raise a launch may
  // take 48 KB less the kernel's static arrays, not 48 KB (a launch of
  // 44-48 KB first in its process failed with cudaErrorInvalidValue)
  static std::atomic<unsigned> limit_set{0};
  e = pt_smem_limit_max(scan_agg_kernel<T>, &limit_set);
  if (e != cudaSuccess) return (int)e;
  scan_agg_kernel<T><<<dim3(nb * ly.groups, S), ly.threads, smem, st>>>(
      *a, ly, params, num_docs, S, D, P, partial);
  scan_finalize<T><<<dim3(a->code[H_NACC], S, B), PT_THREADS, 0, st>>>(
      *a, partial, nb, out);
  return (int)cudaGetLastError();
}

// Launches K1 and its finalize pass on `stream` for B members. params:
// [B, S, P] float64; num_docs: [U, S] int32; partial: [B, S, nb, n_acc]
// float64 scratch; out: [B, S, out_width] of the value dtype (f64 != 0:
// float64, else float32); dev: the tensors' device. Returns
// cudaGetLastError() (or the error of raising the block's shared-memory
// limit; cudaErrorInvalidConfiguration where one member's layout does not
// fit it).
extern "C" int pt_scan_agg(const Args* a, const double* params,
                           const int* num_docs, int S, int D, int P, int nb,
                           int B, int f64, double* partial, void* out,
                           int dev, void* stream) {
  cudaSetDevice(dev);
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch<double>(a, params, num_docs, S, D, P, nb, B, partial,
                              (double*)out, dev, st)
             : launch<float>(a, params, num_docs, S, D, P, nb, B, partial,
                             (float*)out, dev, st);
}
