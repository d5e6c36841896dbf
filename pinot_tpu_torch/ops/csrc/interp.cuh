// Shared by K1 (scan_agg.cu), K2 (group_agg.cu), K3 (sketch_agg.cu) and K4
// (topn.cu): the launch arguments and the per-document interpreter of the
// plan program that pinot_tpu_torch/ops/program.py compiles, which K2 and
// K4 run, and at the end the tile evaluator of the same program, which K1
// and K3 run. The layout constants below must match program.py.
//
// One program per plan replaces the JAX package's per-plan jit trace
// (pinot_tpu/ops/kernels.py:643): every thread walks the same postfix code,
// so the interpreter's branches are uniform across a warp, and the code and
// this segment's parameter row sit in shared memory.
//
// The member axis: one launch computes B members (coalesced queries of one
// plan), the counterpart of pinot_tpu/ops/kernels.py:793
// `make_batched_kernel`, :823 `make_batched_dedup_kernel` and :858
// `make_batched_topn_kernel` (the plan under vmap over B members). Member m
// reads column set set_of[m] of U sets, its own parameter row of the
// [B, S, P] matrix and its own rows of each [B, S, C] LUT, and writes its
// own [S, ...] output. One kernel serves the three JAX variants: broadcast
// is U = 1 with set_of = 0...0, stacked U = B with set_of = 0...B-1, dedup
// set_of = the member-to-unique-set map; no [B, S, D] stack is copied, the
// launch carries U sets of column pointers instead. num_docs is [U, S].
//
// The kernels are templates on the type of a block's member: `Mem` for a
// batch. K2 and K4 run a single launch (B = U = 1) as the B = 1 case of
// that kernel; K1 and K3 compile a second body on `Single`, a B = 1
// instantiation that carries no member set or row, for it: as the B = 1
// case of `Mem`, their single launch ran 14% (K1) and 12% (K3) slower than
// before the member axis on an H100 (80GB HBM3, 700 W; kernel_ab.py,
// parent / change / change / parent), the member's set and row taking
// registers the interpreter's loop needed (both spilled), where K2 stayed
// within 2% and K4 ran 14% faster. `Single` is not the code from before
// the member axis: K1's float32 `Single` body takes 32 registers and
// spills 40 / 48 bytes (ptxas), where that code took 40 and spilled
// none, and it ran 10% faster than that code all the same, for a reason
// not yet known.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "smem_limit.cuh"

#define PT_MAX_CODE 768
#define PT_MAX_COLS 32
#define PT_MAX_LUTS 16
#define PT_MAX_PARAMS 64
#define PT_MAX_ACC 64
#define PT_MAX_VALUES 16
#define PT_MAX_VDEPTH 16
#define PT_THREADS 256
#define PT_MAX_SETS 16     // column sets per launch (ops/_cuda.py MAX_SETS)
#define PT_MAX_MEMBERS 16  // members per launch (ops/_cuda.py MAX_MEMBERS)

enum { H_NLEAVES, H_NFILT, H_MAIN, H_NVAL, H_NSLOT, H_NACC, H_NGCOL, H_OUTW,
       H_NPARAM, H_LEAF, H_FILT, H_VAL, H_SLOT, H_GCOL, H_ACC, H_NCOL,
       H_COLDT, H_LUTC, H_LEN, H_TBHI, H_TBLO, H_TBPRM, H_TBPAD };
enum { L_RANGE, L_NEQ, L_LUT, L_VRANGE, L_VRANGE64, L_MASK };
enum { F_LEAF, F_AND, F_OR, F_NOT };
enum { V_COL, V_LIT, V_ADD, V_SUB, V_MUL, V_DIV, V_NEG, V_IDS };
enum { S_COUNT, S_SUM, S_SUMSQ, S_SUM3, S_SUM4, S_MIN, S_MAX, S_ISUM,
       S_ISUM_U, S_HLL, S_HIST };
enum { R_ADD, R_MIN, R_MAX };
enum { O_SCALAR, O_PLANE };
#define LEAF_W 5
#define SLOT_W 8  // (op, value, filter, acc, n, out, c0, c1)
#define ACC_W 3

// Passed by value (__grid_constant__): the column pointers of each column
// set, each set's upsert validity mask (a [S, D] block of one byte per doc,
// nonzero = valid; null: the set has no mask), the LUT pointers, the
// program and the member-to-set map. 7488 bytes: past the classic
// 4,096-byte kernel-parameter limit, inside the 32,764 bytes that CUDA 12.1
// and later allow on sm_70 and later (the build uses CUDA 12.8 for
// sm_90a), so no device-side pointer table is uploaded per launch. Its
// size is checked against the ctypes mirror (ops/_cuda.py `_Args`) when a
// library loads (`pt_args_bytes`).
struct Args {
  const void* cols[PT_MAX_SETS][PT_MAX_COLS];
  const unsigned char* vmask[PT_MAX_SETS];
  const unsigned char* luts[PT_MAX_LUTS];
  int code[PT_MAX_CODE];
  int set_of[PT_MAX_MEMBERS];
};

extern "C" int pt_args_bytes() { return (int)sizeof(Args); }

// Block-shared copy of the program and of this member's parameter row for
// this segment.
struct Shared {
  int code[PT_MAX_CODE];
  double prm[PT_MAX_PARAMS];
};

// A block's member: its column set u() and its LUT / parameter row row()
// (m * S + s). Passed by value. A single launch's member is set 0, row s.
struct Single {
  int s;
  __device__ __forceinline__ int u() const { return 0; }
  __device__ __forceinline__ long long row() const { return s; }
};
struct Mem {
  int u_;
  long long row_;
  __device__ __forceinline__ int u() const { return u_; }
  __device__ __forceinline__ long long row() const { return row_; }
};

// The member of this block and its doc-range block b of nb. A single
// launch's grid is (nb, S); a batch's (B x nb, S), the member the
// fastest-varying block coordinate, so the B blocks of one doc range run
// side by side and read a shared column set through L2 once.
template <typename M> struct Grid;
template <> struct Grid<Single> {
  static __device__ __forceinline__ Single at(const Args&, int, int, int& b,
                                              int& nb) {
    b = blockIdx.x;
    nb = gridDim.x;
    Single r;
    r.s = blockIdx.y;
    return r;
  }
};
template <> struct Grid<Mem> {
  static __device__ __forceinline__ Mem at(const Args& a, int S, int nmem,
                                           int& b, int& nb) {
    const int m = blockIdx.x % nmem;
    b = blockIdx.x / nmem;
    nb = gridDim.x / nmem;
    Mem r;
    r.u_ = a.set_of[m];
    r.row_ = (long long)m * S + blockIdx.y;
    return r;
  }
};

// A staged column element widened to double: exact for every staged dtype
// (i8/i16/i32 ids, i32 split planes, f32/f64 values).
__device__ __forceinline__ double load_col(const Args& a, const int* code,
                                           int u, int c, long long i) {
  const void* p = a.cols[u][c];
  switch (code[code[H_COLDT] + c]) {
    case 0: return (double)((const signed char*)p)[i];
    case 1: return (double)((const short*)p)[i];
    case 2: return (double)((const int*)p)[i];
    case 3: return (double)((const float*)p)[i];
    default: return ((const double*)p)[i];
  }
}

// The upsert validity of doc i for member mb (JAX kernels.py:565, :604
// `valid & cols["vmask"]`): one byte read beside the num_docs bound, and
// nothing where the member's column set carries no mask.
template <typename M>
__device__ __forceinline__ bool doc_valid(const Args& a, M mb, long long i) {
  const unsigned char* v = a.vmask[mb.u()];
  return v == nullptr || v[i] != 0;
}

// The fused time bucket of doc i (JAX timeseries_device.py:166
// `bucket_ids`, called at kernels.py:496-506): from the timestamp's (hi, lo)
// i32 planes and the member's tb:* cells (start's planes, step, count),
// delta = (vhi - shi) * 2^24 + (vlo - slo) wrapping in 32 bits as XLA's i32
// arithmetic does (computed in uint32: signed overflow is undefined in
// CUDA C), b = floor(delta / step) (C division truncates toward zero, so
// a negative inexact quotient steps down by one), then b clipped to
// [0, count_pad). Returns the gate delta >= 0 && b < count: a doc outside
// the window contributes to no slot, whatever its wrapped delta is.
__device__ __forceinline__ bool ts_bucket(int vhi, int vlo, int shi, int slo,
                                          int step, int count, int count_pad,
                                          int& b) {
  const unsigned ud = ((unsigned)vhi - (unsigned)shi) * (1u << 24) +
                      ((unsigned)vlo - (unsigned)slo);
  const int delta = (int)ud;
  int q = delta / step;
  if (delta % step != 0 && ((delta < 0) != (step < 0))) --q;
  b = q < 0 ? 0 : (q > count_pad - 1 ? count_pad - 1 : q);
  return delta >= 0 && q < count;
}

// A double's bits as a signed integer in the total order of the bits:
// -inf < ... < -0.0 < +0.0 < ... < +inf (ops/kernels.py `order_keys`).
__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFll);
}
// The quiet NaN a min / max over a NaN gives, in every kernel and in the
// plain versions (torch's float("nan")); it narrows to float32's.
#define PT_QNAN __longlong_as_double(0x7FF8000000000000ll)

// Reductions that propagate NaN, as jnp.min / jnp.max and XLA's scatter-min
// and scatter-max do (fmin/fmax would drop it), and rank -0.0 below +0.0
// as they do, whatever the order of the operands (a float compare holds
// the two zeros equal).
__device__ __forceinline__ double nan_min(double x, double y) {
  return (x != x || y != y) ? PT_QNAN
                            : (order_key(y) < order_key(x) ? y : x);
}
__device__ __forceinline__ double nan_max(double x, double y) {
  return (x != x || y != y) ? PT_QNAN
                            : (order_key(y) > order_key(x) ? y : x);
}
__device__ __forceinline__ double combine(int r, double x, double y) {
  return r == R_ADD ? x + y : (r == R_MIN ? nan_min(x, y) : nan_max(x, y));
}
__device__ __forceinline__ double identity_of(int r) {
  return r == R_ADD ? 0.0 : (r == R_MIN ? INFINITY : -INFINITY);
}
__device__ __forceinline__ bool is_sketch(int op) {
  return op == S_HLL || op == S_HIST;
}
__device__ __forceinline__ int slot_red(int op) {
  return op == S_MIN ? R_MIN : (op == S_MAX ? R_MAX : R_ADD);
}

// The integer range of a staged id dtype (0: i8, 1: i16, 2: i32).
__device__ __forceinline__ void int_range(int dt, double& lo, double& hi) {
  lo = dt == 0 ? -128.0 : (dt == 1 ? -32768.0 : -2147483648.0);
  hi = dt == 0 ? 127.0 : (dt == 1 ? 32767.0 : 2147483647.0);
}

// Clamp leaf li's range / neq bounds in the parameter row `prm` into its
// i8 / i16 id column's range, as the JAX kernel's `_clamp_to` does before
// comparing at the narrow width.
__device__ void clamp_leaf(const int* code, double* prm, int li) {
  const int* L = code + code[H_LEAF] + li * LEAF_W;
  if (L[0] != L_RANGE && L[0] != L_NEQ) return;
  const int dt = code[code[H_COLDT] + L[1]];
  if (dt > 1) return;
  double lo, hi;
  int_range(dt, lo, hi);
  const int np = L[0] == L_RANGE ? 2 : 1;
  for (int q = 0; q < np; ++q)
    prm[L[3] + q] = fmin(fmax(prm[L[3] + q], lo), hi);
}

// Copy the program and parameter row `row` (member m, segment s) into
// shared memory, then clamp range / neq bounds into the id column's dtype
// (`clamp_leaf`).
__device__ void stage_block(const Args& a, const double* params,
                            long long row, int P, Shared& sh) {
  const int len = a.code[H_LEN];
  for (int k = threadIdx.x; k < len; k += blockDim.x) sh.code[k] = a.code[k];
  for (int k = threadIdx.x; k < P; k += blockDim.x)
    sh.prm[k] = params[row * P + k];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int l = 0; l < sh.code[H_NLEAVES]; ++l) clamp_leaf(sh.code, sh.prm, l);
  __syncthreads();
}

// Leaf li over doc i, widened to double: the program `code`, the clamped
// parameter row `prm`, column set u and LUT row `row`. kMask admits
// L_MASK, a CLP leaf: K7's [S, D] match mask (csrc/clp_match.cu), read
// like a LUT of width D at the doc's own index, each member its own rows.
// Only a program holding such a leaf takes that instantiation
// (`has_mask_leaf`): the case cost K1's other programs 21% on an H100
// (80GB HBM3, 700 W; kernel_ab.py), as K4's V_IDS case would have cost
// K1-K3 (kIds below).
template <bool kMask>
__device__ __forceinline__ bool leaf_at(const Args& a, const int* code,
                                        const double* prm, int u,
                                        long long row, int li, long long i) {
  const int* L = code + code[H_LEAF] + li * LEAF_W;
  const double* p = prm + L[3];
  switch (L[0]) {
    case L_RANGE: {
      const double id = load_col(a, code, u, L[1], i);
      return id >= p[0] && id <= p[1];
    }
    case L_NEQ:
      return load_col(a, code, u, L[1], i) != p[0];
    case L_LUT: {
      const int id = (int)load_col(a, code, u, L[1], i);
      const int C = code[code[H_LUTC] + L[4]];
      return a.luts[L[4]][row * C + id] != 0;
    }
    case L_VRANGE: {
      const double v = load_col(a, code, u, L[1], i);
      return v >= p[0] && v <= p[1];
    }
    default: {  // L_VRANGE64: lexicographic compare on (hi, lo) planes
      if constexpr (kMask) {
        if (L[0] == L_MASK) {
          const int C = code[code[H_LUTC] + L[4]];
          return a.luts[L[4]][row * C + i % C] != 0;
        }
      }
      const double hi = load_col(a, code, u, L[1], i);
      const double lo = load_col(a, code, u, L[2], i);
      const bool ge = hi > p[0] || (hi == p[0] && lo >= p[1]);
      const bool le = hi < p[2] || (hi == p[2] && lo <= p[3]);
      return ge && le;
    }
  }
}

// Leaf li over doc i for member mb, from the block's staged program and
// parameter row.
template <bool kMask, typename M>
__device__ __forceinline__ bool eval_leaf(const Args& a, const Shared& sh,
                                          int li, M mb, long long i) {
  return leaf_at<kMask>(a, sh.code, sh.prm, mb.u(), mb.row(), li, i);
}

// Whether a program holds a CLP mask leaf (L_MASK), on the host: its
// launch takes the kernels' kMask instantiation.
static inline bool has_mask_leaf(const int* code) {
  for (int l = 0; l < code[H_NLEAVES]; ++l)
    if (code[code[H_LEAF] + l * LEAF_W] == L_MASK) return true;
  return false;
}

// Filter f over doc i. The bool stack is a shift register: bit 0 is the
// top, so depth is bounded by 32 (program.py MAX_FILTER_DEPTH).
template <bool kMask, typename M>
__device__ bool eval_filter(const Args& a, const Shared& sh, int f, M mb,
                            long long i) {
  const int* F = sh.code + sh.code[H_FILT] + 2 * f;
  const int* ins = sh.code + F[0];
  const int n = F[1];
  unsigned st = 0;
  for (int k = 0; k < n; ++k) {
    const int op = ins[2 * k];
    if (op == F_LEAF) {
      st = (st << 1) | (eval_leaf<kMask>(a, sh, ins[2 * k + 1], mb, i) ? 1u
                                                                       : 0u);
    } else if (op == F_NOT) {
      st ^= 1u;
    } else {
      const unsigned b = st & 1u;
      st >>= 1;
      st = op == F_AND ? (st & ~1u) | (st & b) : st | b;
    }
  }
  return st & 1u;
}

// Value program v over doc i in type T: float / double round after every
// operation as the JAX kernel does (the build passes --fmad=false so no
// multiply-add is fused); int is the exact-sum mode (kernels.py:354),
// where a staged float converts by truncation like astype(int32).
// kIds admits V_IDS, a staged i8/i16/i32 dictId widened to the value type
// (exact, as the JAX kernel's astype: the engine orders only by ids below
// 2^24); only K4 (topn.cu) reads order values, so K1-K3 instantiate the
// interpreter without that case and keep their code as it was.
template <typename T, bool kIds = false, typename M>
__device__ T eval_value(const Args& a, const Shared& sh, int v, M mb,
                        long long i) {
  const int* V = sh.code + sh.code[H_VAL] + 2 * v;
  const int* ins = sh.code + V[0];
  const int n = V[1];
  T st[PT_MAX_VDEPTH];
  int sp = 0;
  for (int k = 0; k < n; ++k) {
    const int op = ins[2 * k], arg = ins[2 * k + 1];
    if (op == V_COL || (kIds && op == V_IDS)) {
      st[sp++] = (T)load_col(a, sh.code, mb.u(), arg, i);
    } else if (op == V_LIT) {
      st[sp++] = (T)sh.prm[arg];
    } else if (op == V_NEG) {
      st[sp - 1] = -st[sp - 1];
    } else {
      const T y = st[--sp];
      const T x = st[sp - 1];
      st[sp - 1] = op == V_ADD ? x + y
                 : op == V_SUB ? x - y
                 : op == V_MUL ? x * y
                 : x / y;
    }
  }
  return st[0];
}

// Per-document caches of agg-filter results and evaluated values, so slots
// that share a FILTER tree or an input evaluate it once.
struct DocCache {
  unsigned fdone, fval, vdone;
};

template <bool kMask, typename M>
__device__ __forceinline__ bool slot_passes(const Args& a, const Shared& sh,
                                            int f, M mb, long long i,
                                            DocCache& c) {
  if (f < 0) return true;
  const unsigned bit = 1u << f;
  if (!(c.fdone & bit)) {
    c.fdone |= bit;
    if (eval_filter<kMask>(a, sh, f, mb, i)) c.fval |= bit;
  }
  return (c.fval & bit) != 0;
}

// The value a sum-family or min/max slot adds, in T, widened to double.
template <typename T>
__device__ __forceinline__ double slot_contrib(int op, T x) {
  switch (op) {
    case S_SUMSQ: return (double)(x * x);
    case S_SUM3: return (double)(x * x * x);
    case S_SUM4: { const T x2 = x * x; return (double)(x2 * x2); }
    default: return (double)x;
  }
}

// ---------------------------------------------------------------------------
// The tile evaluator (K1 csrc/scan_agg.cu, K3 csrc/sketch_agg.cu). A
// thread takes PT_TILE consecutive docs of one segment at a time, and each
// filter instruction is dispatched once for the tile, not once per doc:
// a leaf reads its column
// for the whole tile (16-byte loads in a full, aligned tile: one for i8,
// two for i16, four for i32 / f32, eight for f64; docs outside `lim` are
// not read in a partial one) and returns a PT_TILE-bit mask, bit d for doc
// i0 + d. Range, neq and f32 vrange leaves compare in the column's own type
// against literals converted once per block (`prep_leaf`); a LUT of at most
// 64 entries is a bit set, a larger one a row in shared memory or, past the
// launch's budget, in global memory. Every other (kind, dtype) widens each
// doc to double as the per-doc interpreter above does (`doc_leaf`). The
// filter's mask stack keeps its top in a register and the rest in shared
// memory, one word per thread per level (`fst`).
// ---------------------------------------------------------------------------
#define PT_TILE 16
#define PT_TILE_BITS 0xFFFFu

enum { TL_SOME, TL_EMPTY, TL_ALL };

// A leaf's literals for the tile evaluator: an id range [lo, hi] or a neq
// value in the column's integer type, `fl` TL_EMPTY (the range holds no
// integer of the type) or TL_ALL (no id of the type equals the neq value);
// an f32 vrange's bounds rounded inward, so that a float doc compares as
// its double did (v >= lo <=> v >= ru(lo), v <= hi <=> v <= rd(hi)); a LUT
// row of at most 64 entries as bits; `lut` the byte offset of a larger
// row staged in the member's shared memory (-1: read in global memory).
struct TileLeaf {
  unsigned long long bits;
  int lo, hi, fl, lut;
  float flo, fhi;
};

// Leaf li's TileLeaf from the member's parameter row `prm`, which
// `clamp_leaf` has already clamped.
__device__ void prep_leaf(const int* code, const double* prm, int li,
                          TileLeaf& t) {
  const int* L = code + code[H_LEAF] + li * LEAF_W;
  const double* p = prm + L[3];
  t.bits = 0ull;
  t.lo = t.hi = 0;
  t.fl = TL_SOME;
  t.lut = -1;
  t.flo = t.fhi = 0.0f;
  const int dt = L[0] == L_MASK ? 0 : code[code[H_COLDT] + L[1]];
  double tmin, tmax;
  int_range(dt, tmin, tmax);
  if (L[0] == L_RANGE && dt <= 2) {
    const double lo = ceil(p[0]), hi = floor(p[1]);
    if (!(lo <= hi) || lo > tmax || hi < tmin) {
      t.fl = TL_EMPTY;
    } else {
      t.lo = (int)fmax(lo, tmin);
      t.hi = (int)fmin(hi, tmax);
    }
  } else if (L[0] == L_NEQ && dt <= 2) {
    if (!(p[0] == floor(p[0])) || p[0] < tmin || p[0] > tmax) t.fl = TL_ALL;
    else t.lo = (int)p[0];
  } else if (L[0] == L_VRANGE && dt == 3) {
    t.flo = __double2float_ru(p[0]);
    t.fhi = __double2float_rd(p[1]);
  }
}

// Leaf li over doc i as the per-doc interpreter reads it (`leaf_at`), out
// of line: the tile evaluator's case for a (kind, dtype) it does not take
// a tile at a time.
__device__ __noinline__ bool doc_leaf(const Args& a, const int* code,
                                      const double* prm, int u, long long row,
                                      int li, long long i) {
  return leaf_at<true>(a, code, prm, u, row, li, i);
}

// PT_TILE docs of an i8 / i16 / i32 column (dt 0-2) from doc i0,
// sign-extended.
template <bool kFull>
__device__ __forceinline__ void tile_ints(const void* p, int dt, long long i0,
                                          unsigned lim, int (&x)[PT_TILE]) {
  if (kFull) {
    if (dt == 0) {
      const uint4 v = __ldg((const uint4*)((const signed char*)p + i0));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int d = 0; d < PT_TILE; ++d)
        x[d] = (int)(signed char)(w[d >> 2] >> (8 * (d & 3)));
    } else if (dt == 1) {
      const uint4* q = (const uint4*)((const short*)p + i0);
      const uint4 v0 = __ldg(q), v1 = __ldg(q + 1);
      const unsigned w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int d = 0; d < PT_TILE; ++d)
        x[d] = (int)(short)(w[d >> 1] >> (16 * (d & 1)));
    } else {
      const uint4* q = (const uint4*)((const int*)p + i0);
#pragma unroll
      for (int k = 0; k < PT_TILE / 4; ++k) {
        const uint4 v = __ldg(q + k);
        x[4 * k] = (int)v.x;
        x[4 * k + 1] = (int)v.y;
        x[4 * k + 2] = (int)v.z;
        x[4 * k + 3] = (int)v.w;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d) {
      x[d] = 0;
      if ((lim >> d) & 1u)
        x[d] = dt == 0 ? (int)((const signed char*)p)[i0 + d]
             : dt == 1 ? (int)((const short*)p)[i0 + d]
                       : ((const int*)p)[i0 + d];
    }
  }
}

// PT_TILE docs of a float32 column from doc i0.
template <bool kFull>
__device__ __forceinline__ void tile_f32(const void* p, long long i0,
                                         unsigned lim, float (&x)[PT_TILE]) {
  if (kFull) {
    const uint4* q = (const uint4*)((const float*)p + i0);
#pragma unroll
    for (int k = 0; k < PT_TILE / 4; ++k) {
      const uint4 v = __ldg(q + k);
      x[4 * k] = __uint_as_float(v.x);
      x[4 * k + 1] = __uint_as_float(v.y);
      x[4 * k + 2] = __uint_as_float(v.z);
      x[4 * k + 3] = __uint_as_float(v.w);
    }
  } else {
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d)
      x[d] = ((lim >> d) & 1u) ? ((const float*)p)[i0 + d] : 0.0f;
  }
}

// The tile's bytes of a byte block (an upsert validity mask, a CLP match
// mask row) at q as bits: nonzero bytes set their doc's bit.
template <bool kFull>
__device__ __forceinline__ unsigned tile_bytes(const unsigned char* q,
                                               unsigned lim) {
  unsigned m = 0;
  if (kFull) {
    const uint4 v = __ldg((const uint4*)q);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d)
      m |= (((w[d >> 2] >> (8 * (d & 3))) & 0xFFu) != 0u ? 1u : 0u) << d;
  } else {
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d)
      if ((lim >> d) & 1u) m |= (q[d] != 0 ? 1u : 0u) << d;
  }
  return m;
}

// Leaf li over the tile at doc i0 for a member (its clamped row `prm`, its
// TileLeaf table `tl`, its staged LUT bytes `slut`, its LUT row `row`).
template <bool kFull>
__device__ unsigned tile_leaf(const Args& a, const int* code,
                              const double* prm, const TileLeaf* tl,
                              const unsigned char* slut, int u, long long row,
                              int li, long long i0, unsigned lim) {
  const int* L = code + code[H_LEAF] + li * LEAF_W;
  const TileLeaf& t = tl[li];
  unsigned m = 0;
  if (L[0] == L_MASK) {  // K7's mask row: C == D, so the doc's own index
    const int C = code[code[H_LUTC] + L[4]];
    const unsigned char* q = a.luts[L[4]] + row * C;
    if (kFull) return tile_bytes<true>(q + i0 % C, lim);
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d)
      if ((lim >> d) & 1u) m |= (q[(i0 + d) % C] != 0 ? 1u : 0u) << d;
    return m;
  }
  const int dt = code[code[H_COLDT] + L[1]];
  const void* col = a.cols[u][L[1]];
  if ((L[0] == L_RANGE || L[0] == L_NEQ || L[0] == L_LUT) && dt <= 2) {
    if (L[0] == L_RANGE && t.fl == TL_EMPTY) return 0u;
    if (L[0] == L_NEQ && t.fl == TL_ALL) return PT_TILE_BITS;
    int x[PT_TILE];
    tile_ints<kFull>(col, dt, i0, lim, x);
    if (L[0] == L_RANGE) {
      const unsigned lo = (unsigned)t.lo, span = (unsigned)t.hi - lo;
#pragma unroll
      for (int d = 0; d < PT_TILE; ++d)
        m |= ((unsigned)x[d] - lo <= span ? 1u : 0u) << d;
    } else if (L[0] == L_NEQ) {
#pragma unroll
      for (int d = 0; d < PT_TILE; ++d) m |= (x[d] != t.lo ? 1u : 0u) << d;
    } else {
      const int C = code[code[H_LUTC] + L[4]];
      if (C <= 64) {
#pragma unroll
        for (int d = 0; d < PT_TILE; ++d)
          m |= (unsigned)((t.bits >> (x[d] & 63)) & 1ull) << d;
      } else {
        const unsigned char* r =
            t.lut >= 0 ? slut + t.lut : a.luts[L[4]] + row * C;
#pragma unroll
        for (int d = 0; d < PT_TILE; ++d)
          m |= (r[x[d]] != 0 ? 1u : 0u) << d;
      }
    }
    return m;
  }
  if (L[0] == L_VRANGE && dt == 3) {
    float x[PT_TILE];
    tile_f32<kFull>(col, i0, lim, x);
#pragma unroll
    for (int d = 0; d < PT_TILE; ++d)
      m |= (x[d] >= t.flo && x[d] <= t.fhi ? 1u : 0u) << d;
    return m;
  }
  const double* p = prm + L[3];
  // the wide cases four docs at a time, so they hold no more registers
  // than the narrow ones
  if (L[0] == L_VRANGE && dt == 4) {
    const double* q = (const double*)col + i0;
#pragma unroll 1
    for (int c = 0; c < PT_TILE; c += 4) {
      double x[4];
      if (kFull) {
        const double2 v0 = __ldg((const double2*)(q + c));
        const double2 v1 = __ldg((const double2*)(q + c) + 1);
        x[0] = v0.x;
        x[1] = v0.y;
        x[2] = v1.x;
        x[3] = v1.y;
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d)
          x[d] = ((lim >> (c + d)) & 1u) ? q[c + d] : 0.0;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d)
        m |= (x[d] >= p[0] && x[d] <= p[1] ? 1u : 0u) << (c + d);
    }
    return m;
  }
  if (L[0] == L_VRANGE64 && dt == 2 && code[code[H_COLDT] + L[2]] == 2) {
    const int* qh = (const int*)col + i0;
    const int* ql = (const int*)a.cols[u][L[2]] + i0;
#pragma unroll 1
    for (int c = 0; c < PT_TILE; c += 4) {
      int h[4], l[4];
      if (kFull) {
        const int4 vh = __ldg((const int4*)(qh + c));
        const int4 vl = __ldg((const int4*)(ql + c));
        h[0] = vh.x; h[1] = vh.y; h[2] = vh.z; h[3] = vh.w;
        l[0] = vl.x; l[1] = vl.y; l[2] = vl.z; l[3] = vl.w;
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const bool in = (lim >> (c + d)) & 1u;
          h[d] = in ? qh[c + d] : 0;
          l[d] = in ? ql[c + d] : 0;
        }
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const double hi = (double)h[d], lo = (double)l[d];
        const bool in = (hi > p[0] || (hi == p[0] && lo >= p[1])) &&
                        (hi < p[2] || (hi == p[2] && lo <= p[3]));
        m |= (in ? 1u : 0u) << (c + d);
      }
    }
    return m;
  }
  for (int d = 0; d < PT_TILE; ++d)  // any other (kind, dtype): per doc
    if ((lim >> d) & 1u)
      m |= (doc_leaf(a, code, prm, u, row, li, i0 + d) ? 1u : 0u) << d;
  return m;
}

// Filter f over the tile at doc i0: the PT_TILE-bit mask of the docs it
// keeps (bits outside `lim` are left to the caller to clear). `fst`: the
// block's mask stack, level k of thread t at fst[k * blockDim.x + t].
template <bool kFull>
__device__ unsigned tile_filter(
    const Args& a, const int* code, const double* prm, const TileLeaf* tl,
    const unsigned char* slut, int u, long long row, int f, long long i0,
    unsigned lim, unsigned* fst) {
  const int* F = code + code[H_FILT] + 2 * f;
  const int* ins = code + F[0];
  const int n = F[1];
  unsigned top = 0;
  int d = 0;
  for (int k = 0; k < n; ++k) {
    const int op = ins[2 * k];
    if (op == F_LEAF) {
      if (d) fst[(d - 1) * blockDim.x + threadIdx.x] = top;
      ++d;
      top = tile_leaf<kFull>(a, code, prm, tl, slut, u, row, ins[2 * k + 1],
                             i0, lim);
    } else if (op == F_NOT) {
      top ^= PT_TILE_BITS;
    } else {
      --d;
      const unsigned y = fst[(d - 1) * blockDim.x + threadIdx.x];
      top = op == F_AND ? (y & top) : (y | top);
    }
  }
  return top;
}

// Value program v over doc i in type V, as eval_value does (V = int: the
// exact-sum mode), the stack's top in a register and the rest in shared
// memory (`vst`, level k of thread t at vst[k * blockDim.x + t]).
template <typename V>
__device__ __forceinline__ V doc_value(const Args& a, const int* code, const double* prm,
                       int u, int v, long long i, V* vst) {
  const int* Vr = code + code[H_VAL] + 2 * v;
  const int* ins = code + Vr[0];
  const int n = Vr[1];
  V top = (V)0;
  int d = 0;
  for (int k = 0; k < n; ++k) {
    const int op = ins[2 * k], arg = ins[2 * k + 1];
    if (op == V_COL || op == V_IDS || op == V_LIT) {
      if (d) vst[(d - 1) * blockDim.x + threadIdx.x] = top;
      ++d;
      top = op == V_LIT ? (V)prm[arg] : (V)load_col(a, code, u, arg, i);
    } else if (op == V_NEG) {
      top = -top;
    } else {
      --d;
      const V x = vst[(d - 1) * blockDim.x + threadIdx.x];
      top = op == V_ADD ? x + top
          : op == V_SUB ? x - top
          : op == V_MUL ? x * top
          : x / top;
    }
  }
  return top;
}

// The deepest stack any of `count` programs of the table at code[tab]
// needs (filters: F_* instructions; else values: V_*), on the host.
static inline int program_depth(const int* code, int tab, int count,
                                bool filters) {
  int deepest = 1;
  for (int r = 0; r < count; ++r) {
    const int* ins = code + code[tab + 2 * r];
    int d = 0;
    for (int k = 0; k < code[tab + 2 * r + 1]; ++k) {
      const int op = ins[2 * k];
      const bool push = filters ? op == F_LEAF
                                : (op == V_COL || op == V_IDS || op == V_LIT);
      const bool keep = filters ? op == F_NOT : op == V_NEG;
      d += push ? 1 : (keep ? 0 : -1);
      deepest = d > deepest ? d : deepest;
    }
  }
  return deepest;
}
