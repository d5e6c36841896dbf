// Shared by K1 (scan_agg.cu), K2 (group_agg.cu), K3 (sketch_agg.cu) and K4
// (topn.cu): the launch arguments and the per-document interpreter of the plan program that
// pinot_tpu_torch/ops/program.py compiles. The layout constants below must
// match program.py.
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

// Copy the program and parameter row `row` (member m, segment s) into
// shared memory, then clamp range / neq bounds into the id column's dtype,
// as the JAX kernel's `_clamp_to` does before comparing at the narrow width.
__device__ void stage_block(const Args& a, const double* params,
                            long long row, int P, Shared& sh) {
  const int len = a.code[H_LEN];
  for (int k = threadIdx.x; k < len; k += blockDim.x) sh.code[k] = a.code[k];
  for (int k = threadIdx.x; k < P; k += blockDim.x)
    sh.prm[k] = params[row * P + k];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nl = sh.code[H_NLEAVES];
    for (int l = 0; l < nl; ++l) {
      const int* L = sh.code + sh.code[H_LEAF] + l * LEAF_W;
      if (L[0] != L_RANGE && L[0] != L_NEQ) continue;
      const int dt = sh.code[sh.code[H_COLDT] + L[1]];
      if (dt > 1) continue;
      const double lo = dt == 0 ? -128.0 : -32768.0;
      const double hi = dt == 0 ? 127.0 : 32767.0;
      const int np = L[0] == L_RANGE ? 2 : 1;
      for (int q = 0; q < np; ++q)
        sh.prm[L[3] + q] = fmin(fmax(sh.prm[L[3] + q], lo), hi);
    }
  }
  __syncthreads();
}

// kMask admits L_MASK, a CLP leaf: K7's [S, D] match mask (csrc/
// clp_match.cu), read like a LUT of width D at the doc's own index, each
// member its own rows. Only a program holding such a leaf takes that
// instantiation (`has_mask_leaf`): the case cost K1's other programs 21%
// on an H100 (80GB HBM3, 700 W; kernel_ab.py), as K4's V_IDS case would
// have cost K1-K3 (kIds below).
template <bool kMask, typename M>
__device__ __forceinline__ bool eval_leaf(const Args& a, const Shared& sh,
                                          int li, M mb, long long i) {
  const int* L = sh.code + sh.code[H_LEAF] + li * LEAF_W;
  const double* p = sh.prm + L[3];
  switch (L[0]) {
    case L_RANGE: {
      const double id = load_col(a, sh.code, mb.u(), L[1], i);
      return id >= p[0] && id <= p[1];
    }
    case L_NEQ:
      return load_col(a, sh.code, mb.u(), L[1], i) != p[0];
    case L_LUT: {
      const int id = (int)load_col(a, sh.code, mb.u(), L[1], i);
      const int C = sh.code[sh.code[H_LUTC] + L[4]];
      return a.luts[L[4]][mb.row() * C + id] != 0;
    }
    case L_VRANGE: {
      const double v = load_col(a, sh.code, mb.u(), L[1], i);
      return v >= p[0] && v <= p[1];
    }
    default: {  // L_VRANGE64: lexicographic compare on (hi, lo) planes
      if constexpr (kMask) {
        if (L[0] == L_MASK) {
          const int C = sh.code[sh.code[H_LUTC] + L[4]];
          return a.luts[L[4]][mb.row() * C + i % C] != 0;
        }
      }
      const double hi = load_col(a, sh.code, mb.u(), L[1], i);
      const double lo = load_col(a, sh.code, mb.u(), L[2], i);
      const bool ge = hi > p[0] || (hi == p[0] && lo >= p[1]);
      const bool le = hi < p[2] || (hi == p[2] && lo <= p[3]);
      return ge && le;
    }
  }
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
