// K7 clp_match: the per-doc match of LIKE / REGEXP_LIKE leaves over a CLP
// log column, as [L, B, S, D] bool masks (leaf, member, segment, doc).
//
// Replaces pinot_tpu/ops/clp_device.py:700 `eval_leaf` (standalone as
// :757 `make_match_kernel`, fused into the scan kernel at
// pinot_tpu/ops/kernels.py:180-183). The port keeps it standalone: K1 /
// K2 / K4 read its masks as a filter leaf (interp.cuh L_MASK), so their
// interpreter gains one leaf case instead of the CLP pseudo-columns (up to
// 1 + 16 + 32 blocks, past PT_MAX_COLS) and condition tables.
//
// Per doc (pinot_tpu_torch/ops/kernels.py `clp_match` is the plain
// version): match = alut[id]. Mode 'a' ORs the dict-var LUT at each of the
// Kd dict-var slots. Mode 'b' matches when some group g has glt[g] == id
// and every condition of gmem[g] holds (ck 0: padding, holds; ck 1:
// ehi[cs] == chi and elo[cs] == clo, the exact (hi, lo) int32 pair; ck 2:
// dlut[cl][dv[cs]]): the doc's conditions are evaluated once into `ok`
// and each of its logtype's groups tested as (need & ~ok) == 0, as the
// plain version and the JAX einsum do. Slot, LUT and table indexes are
// clipped into their tables, as the plain version clips them; staged data
// never needs it.
//
// Bound on an H100: bytes. A doc reads its logtype id, its slots (mode
// 'a': Kd dict-var ids; mode 'b': at most the slots its conditions name,
// only when its logtype has a group) and writes one byte, against a few
// compares: the floor is (1 + Kd + 2 Ke) x 4 + 1 bytes per doc over 3.35
// TB/s, beside the table bytes it reads.
//
// Design: grid (doc ranges x B members, S, L leaves), the member the
// fastest block coordinate so the B blocks of one range read the shared
// column set through L2 once. A thread takes CLP_TILE docs at a time: one
// 16-byte load of the id block (and of each slot block a condition of its
// docs names), one 4-byte store of the mask bytes. A block stages in
// shared memory its member's condition table (each condition's kind,
// slot, literals and bank pointer, each slot's conditions as a bit set)
// and its set's slot pointers, so no lane-varying index reaches the
// argument struct, and, from glt / gmem, a lookup from logtype id to its
// groups: the sorted distinct logtypes the groups name (<= 64), each with
// the bit set of its groups and the union of their conditions. A doc
// whose LUT hits, or whose logtype names no group, costs its id read and a
// 6-step binary search; else the warp walks the slots its docs'
// conditions name, loading each slot once (the lanes whose docs need one
// of its conditions) and evaluating its conditions on it. The dict-var
// LUTs (`dvlutp`, `dlutp`) are read packed, one bit per entry
// (ops/clp_device.py `pack_banks`, staged once with the leaf's
// parameters): 8 x fewer bytes than the bool tables, so a segment's banks
// stay in L2 for all members of a batch. The logtype LUT follows the
// dictionary's size and is read in global memory.
#include <cuda_runtime.h>

#define CLP_THREADS 256
#define CLP_TILE 4
#define CLP_MAX_SETS 16     // column sets per launch (ops/_cuda.py MAX_SETS)
#define CLP_MAX_MEMBERS 16  // members per launch (ops/_cuda.py MAX_MEMBERS)
#define CLP_MAX_LEAVES 4    // leaves of one column per launch
#define CLP_MAX_SLOTS 16    // Kd, Ke (ops/clp_device.py KD_MAX, KE_MAX)
#define CLP_MAX_GROUPS 64   // padded groups (GROUPS_MAX)
#define CLP_MAX_CONDS 16    // padded conditions (CONDS_MAX)

// One leaf: its mode and slot counts, and per member its parameter tables
// (each [S, width] row-major, the member's own rows) and their widths.
// vlut: the packed dict-var LUT bits, 'a': dvlutp [S, vp / 8]; 'b':
// dlutp [S, nlp, vp / 8]; entry x of a row is bit x % 8 of its byte
// x / 8, and vp counts the row's bits (`clp_device.pack_banks` fills
// those past the bool table's width with its last entry, so clipping into
// [0, vp) reads what the plain version's clip reads).
struct ClpLeaf {
  const unsigned char* alut[CLP_MAX_MEMBERS];  // [S, cp] logtype LUT
  const unsigned char* vlut[CLP_MAX_MEMBERS];
  const int* glt[CLP_MAX_MEMBERS];             // [S, gp], -1 = pad
  const unsigned char* gmem[CLP_MAX_MEMBERS];  // [S, gp, ncp]
  const signed char* ck[CLP_MAX_MEMBERS];      // [S, ncp]
  const int* cs[CLP_MAX_MEMBERS];
  const int* chi[CLP_MAX_MEMBERS];
  const int* clo[CLP_MAX_MEMBERS];
  const int* cl[CLP_MAX_MEMBERS];
  int cp[CLP_MAX_MEMBERS], vp[CLP_MAX_MEMBERS], gp[CLP_MAX_MEMBERS];
  int ncp[CLP_MAX_MEMBERS], nlp[CLP_MAX_MEMBERS];
  int mode_b, kd, ke, pad_;
};

// Passed by value (__grid_constant__): per column set the column's
// pseudo-column blocks ([S, D] int32 each), the leaves, the member-to-set
// map. Its size is checked against the ctypes mirror (ops/_cuda.py
// `_ClpArgs`) when the library loads.
struct ClpArgs {
  const int* id[CLP_MAX_SETS];
  const int* dv[CLP_MAX_SETS][CLP_MAX_SLOTS];
  const int* ehi[CLP_MAX_SETS][CLP_MAX_SLOTS];
  const int* elo[CLP_MAX_SETS][CLP_MAX_SLOTS];
  ClpLeaf leaf[CLP_MAX_LEAVES];
  int set_of[CLP_MAX_MEMBERS];
};

extern "C" int pt_clp_args_bytes() { return (int)sizeof(ClpArgs); }

__device__ __forceinline__ int clip(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// Entry x (clipped into [0, vp)) of a packed LUT row.
__device__ __forceinline__ bool lut_bit(const unsigned char* row, int x,
                                        int vp) {
  x = clip(x, vp);
  return (__ldg(row + (x >> 3)) >> (x & 7)) & 1;
}

// CLP_TILE consecutive int32s from doc i (docs outside `lim` are 0).
template <bool kFull>
__device__ __forceinline__ void tile4(const int* p, long long i, unsigned lim,
                                      int (&x)[CLP_TILE]) {
  if (kFull) {
    const int4 v = __ldg((const int4*)(p + i));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int d = 0; d < CLP_TILE; ++d)
      x[d] = ((lim >> d) & 1u) ? __ldg(p + i + d) : 0;
  }
}

enum { C_HOLDS, C_ENC, C_DICT };

struct ClpShared {
  // conditions: kind (C_*), slot, literals and dict LUT bank
  int kind[CLP_MAX_CONDS], cslot[CLP_MAX_CONDS];
  int chi[CLP_MAX_CONDS], clo[CLP_MAX_CONDS];
  const unsigned char* bank[CLP_MAX_CONDS];
  const int* dv[CLP_MAX_SLOTS];  // the set's slot blocks
  const int* ehi[CLP_MAX_SLOTS];
  const int* elo[CLP_MAX_SLOTS];
  // mode 'b': the conditions on each dict-var slot (C_DICT) and on each
  // encoded slot (C_ENC), and those that hold (C_HOLDS)
  unsigned dmask[CLP_MAX_SLOTS], emask[CLP_MAX_SLOTS], hmask;
  // groups and the logtype lookup
  int glt[CLP_MAX_GROUPS];
  unsigned need[CLP_MAX_GROUPS];
  int first[CLP_MAX_GROUPS];
  int key[CLP_MAX_GROUPS];  // distinct named logtypes, ascending
  unsigned gm_lo[CLP_MAX_GROUPS], gm_hi[CLP_MAX_GROUPS], kneed[CLP_MAX_GROUPS];
  int nkeys;
};

// Mode 'b' for the tile's docs that the logtype LUT did not match.
template <bool kFull>
__device__ __forceinline__ void match_groups(const ClpShared& sh, int vp,
                                             int kd, int ke,
                                             long long i, unsigned lim,
                                             const int (&id)[CLP_TILE],
                                             bool (&match)[CLP_TILE]) {
  unsigned need[CLP_TILE], ok[CLP_TILE];
  unsigned long long gm[CLP_TILE];
  unsigned any = 0;
#pragma unroll
  for (int d = 0; d < CLP_TILE; ++d) {
    need[d] = 0u;
    ok[d] = 0u;
    gm[d] = 0ull;
    if (match[d] || !((lim >> d) & 1u)) continue;
    int pos = 0;
    for (int step = 32; step > 0; step >>= 1)
      if (pos + step - 1 < sh.nkeys && sh.key[pos + step - 1] < id[d])
        pos += step;
    if (pos < sh.nkeys && sh.key[pos] == id[d]) {
      need[d] = sh.kneed[pos];
      gm[d] = ((unsigned long long)sh.gm_hi[pos] << 32) | sh.gm_lo[pos];
      any |= need[d];
    }
  }
  // the warp walks the slots its docs' conditions name, loading each once
  // (a lane only where one of its docs needs one of the slot's
  // conditions), and evaluates those conditions on it
  const unsigned todo = __reduce_or_sync(0xffffffffu, any);
#pragma unroll
  for (int d = 0; d < CLP_TILE; ++d) ok[d] |= sh.hmask;
  for (int j = 0; j < kd; ++j) {
    const unsigned cm = sh.dmask[j] & todo;
    if (!cm || !(any & cm)) continue;
    int x[CLP_TILE];
    tile4<kFull>(sh.dv[j], i, lim, x);
    for (unsigned r = cm & any; r; r &= r - 1) {
      const int c = __ffs(r) - 1;
      const unsigned bit = 1u << c;
#pragma unroll
      for (int d = 0; d < CLP_TILE; ++d)
        if ((need[d] & bit) && lut_bit(sh.bank[c], x[d], vp)) ok[d] |= bit;
    }
  }
  for (int j = 0; j < ke; ++j) {
    const unsigned cm = sh.emask[j] & todo;
    if (!cm || !(any & cm)) continue;
    int x[CLP_TILE], y[CLP_TILE];
    tile4<kFull>(sh.ehi[j], i, lim, x);
    tile4<kFull>(sh.elo[j], i, lim, y);
    for (unsigned r = cm & any; r; r &= r - 1) {
      const int c = __ffs(r) - 1;
#pragma unroll
      for (int d = 0; d < CLP_TILE; ++d)
        if (x[d] == sh.chi[c] && y[d] == sh.clo[c]) ok[d] |= 1u << c;
    }
  }
#pragma unroll
  for (int d = 0; d < CLP_TILE; ++d) {
    for (unsigned long long g = gm[d]; g && !match[d]; g &= g - 1)
      match[d] = (sh.need[__ffsll((long long)g) - 1] & ~ok[d]) == 0u;
  }
}

template <bool kFull>
__device__ __forceinline__ void match_tile(const ClpShared& sh,
                                           const unsigned char* alut,
                                           const unsigned char* dvlut,
                                           const int* ids, int mode_b,
                                           int kd, int ke, int cp, int vp,
                                           long long i, unsigned lim,
                                           unsigned char* o) {
  int id[CLP_TILE];
  bool match[CLP_TILE];
  tile4<kFull>(ids, i, lim, id);
#pragma unroll
  for (int d = 0; d < CLP_TILE; ++d)
    match[d] = ((lim >> d) & 1u) && __ldg(alut + clip(id[d], cp)) != 0;
  if (!mode_b) {
    for (int j = 0; j < kd; ++j) {
      int x[CLP_TILE];
      tile4<kFull>(sh.dv[j], i, lim, x);
#pragma unroll
      for (int d = 0; d < CLP_TILE; ++d)
        match[d] = match[d] || (((lim >> d) & 1u) && lut_bit(dvlut, x[d], vp));
    }
  } else {
    match_groups<kFull>(sh, vp, kd, ke, i, lim, id, match);
  }
  if (kFull) {
    *(unsigned*)o = (match[0] ? 1u : 0u) | (match[1] ? 1u << 8 : 0u) |
                    (match[2] ? 1u << 16 : 0u) | (match[3] ? 1u << 24 : 0u);
  } else {
#pragma unroll
    for (int d = 0; d < CLP_TILE; ++d)
      if ((lim >> d) & 1u) o[d] = match[d] ? 1 : 0;
  }
}

__global__ void __launch_bounds__(CLP_THREADS)
clp_match_kernel(const __grid_constant__ ClpArgs a, int S, int D, int B,
                 int vec, unsigned char* __restrict__ out) {
  __shared__ ClpShared sh;
  const int m = blockIdx.x % B, tile = blockIdx.x / B, ntile = gridDim.x / B;
  const int s = blockIdx.y, l = blockIdx.z;
  const ClpLeaf& L = a.leaf[l];
  const int u = a.set_of[m];
  const long long row = s;  // the row of the member's own [S, ...] tables
  const int cp = L.cp[m], vp = L.vp[m], kd = L.kd, ke = L.ke;
  const int vpb = vp >> 3;
  const int tid = threadIdx.x;
  const unsigned char* alut = L.alut[m] + row * cp;
  const unsigned char* dvlut = nullptr;
  if (tid < kd) sh.dv[tid] = a.dv[u][tid];
  if (tid < ke) {
    sh.ehi[tid] = a.ehi[u][tid];
    sh.elo[tid] = a.elo[u][tid];
  }
  if (!L.mode_b) {
    if (kd) dvlut = L.vlut[m] + row * vpb;
  } else {
    const int gp = L.gp[m], ncp = L.ncp[m], nlp = L.nlp[m];
    if (tid < ncp) {
      const int c = tid;
      const long long k = row * ncp + c;
      const int ck = L.ck[m][k], cs = L.cs[m][k];
      int kind = C_HOLDS;
      if (ck == 1 && ke) {
        kind = C_ENC;
        sh.cslot[c] = clip(cs, ke);
      } else if (ck == 2 && kd) {
        kind = C_DICT;
        sh.cslot[c] = clip(cs, kd);
        sh.bank[c] =
            L.vlut[m] + (row * nlp + clip(L.cl[m][k], nlp)) * (long long)vpb;
      }
      sh.kind[c] = kind;
      sh.chi[c] = L.chi[m][k];
      sh.clo[c] = L.clo[m][k];
    }
    if (tid < CLP_MAX_GROUPS) {
      const int g = tid;
      sh.glt[g] = g < gp ? L.glt[m][row * gp + g] : -1;
      unsigned need = 0;
      if (g < gp) {
        const unsigned char* gm = L.gmem[m] + (row * gp + g) * ncp;
        for (int c = 0; c < ncp; ++c)
          if (gm[c]) need |= 1u << c;
      }
      sh.need[g] = need;
      sh.gm_lo[g] = sh.gm_hi[g] = sh.kneed[g] = 0u;
    }
    __syncthreads();
    // the sorted distinct logtypes the groups name: group g is the first
    // of its logtype when no earlier group names it; its rank is the
    // number of such first groups with a smaller logtype
    if (tid < CLP_MAX_GROUPS) {
      const int g = tid, lt = sh.glt[g];
      bool first = lt >= 0;
      for (int q = 0; q < g && first; ++q) first = sh.glt[q] != lt;
      sh.first[g] = first;
    } else if (tid <= CLP_MAX_GROUPS + 2 * CLP_MAX_SLOTS) {
      // each slot's conditions, and those that hold
      const int j = (tid - CLP_MAX_GROUPS) % CLP_MAX_SLOTS;
      const int want = tid == CLP_MAX_GROUPS + 2 * CLP_MAX_SLOTS ? C_HOLDS
                       : tid < CLP_MAX_GROUPS + CLP_MAX_SLOTS ? C_DICT
                                                              : C_ENC;
      unsigned cm = 0;
      for (int c = 0; c < ncp; ++c)
        if (sh.kind[c] == want && (want == C_HOLDS || sh.cslot[c] == j))
          cm |= 1u << c;
      if (want == C_HOLDS) sh.hmask = cm;
      else if (want == C_DICT) sh.dmask[j] = cm;
      else sh.emask[j] = cm;
    }
    __syncthreads();
    if (tid < CLP_MAX_GROUPS) {
      const int g = tid, lt = sh.glt[g];
      int rank = 0, n = 0;
      for (int q = 0; q < CLP_MAX_GROUPS; ++q) {
        n += sh.first[q];
        rank += sh.first[q] && sh.glt[q] < lt;
      }
      if (g == 0) sh.nkeys = n;
      if (sh.first[g]) sh.key[rank] = lt;
      if (lt >= 0) {
        atomicOr(g < 32 ? &sh.gm_lo[rank] : &sh.gm_hi[rank], 1u << (g & 31));
        atomicOr(&sh.kneed[rank], sh.need[g]);
      }
    }
  }
  __syncthreads();
  const int* ids = a.id[u];
  const int per = ((D + ntile - 1) / ntile + CLP_TILE - 1) / CLP_TILE * CLP_TILE;
  const int start = min(D, tile * per), end = min(D, start + per);
  const int ntiles = (end - start + CLP_TILE - 1) / CLP_TILE;
  const long long base = (long long)s * D + start;
  unsigned char* o = out + (((long long)l * B + m) * S + s) * D + start;
  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = warp * 32; t0 < ntiles; t0 += (CLP_THREADS / 32) * 32) {
    const int t = t0 + lane;
    const int left = end - (start + t * CLP_TILE);
    const unsigned lim = left <= 0 ? 0u
                       : (left >= CLP_TILE ? 0xFu : (1u << left) - 1u);
    const long long i = base + (long long)t * CLP_TILE;
    if (vec && lim == 0xFu)
      match_tile<true>(sh, alut, dvlut, ids, L.mode_b, kd, ke, cp, vp, i, lim,
                       o + t * CLP_TILE);
    else
      match_tile<false>(sh, alut, dvlut, ids, L.mode_b, kd, ke, cp, vp, i,
                        lim,
                        o + t * CLP_TILE);
  }
}

static bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0ull;
}

// Launches K7 on `stream` for L leaves of one column and B members over
// the sets of `a`; out: [L, B, S, D] bytes (0 / 1); dev: its device.
// Full tiles take 16-byte loads where D is a multiple of CLP_TILE and
// every block and the output are 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int pt_clp_match(const ClpArgs* a, int S, int D, int B, int L,
                            int ntile, void* out, int dev, void* stream) {
  cudaSetDevice(dev);
  bool vec = D % CLP_TILE == 0 && aligned16(out);
  for (int m = 0; m < B; ++m) {
    const int u = a->set_of[m];
    vec = vec && aligned16(a->id[u]);
    for (int j = 0; j < CLP_MAX_SLOTS; ++j)
      vec = vec && aligned16(a->dv[u][j]) && aligned16(a->ehi[u][j]) &&
            aligned16(a->elo[u][j]);
  }
  clp_match_kernel<<<dim3(ntile * B, S, L), CLP_THREADS, 0,
                     (cudaStream_t)stream>>>(*a, S, D, B, vec ? 1 : 0,
                                             (unsigned char*)out);
  return (int)cudaGetLastError();
}
