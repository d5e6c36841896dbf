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
// dlut[cl][dv[cs]]); the JAX kernel evaluates all <= 16 conditions into
// `ok` and counts each group's failures in an f32 einsum, exactly, where
// K7 evaluates a condition only when a group of the doc's logtype needs
// it, once, and leaves a group at its first failing condition. Slot, LUT and
// table indexes are clipped into their tables, as the plain version
// clips them; staged data never needs it.
//
// Bound on an H100: bytes. A doc reads its logtype id, its slots (mode
// 'a': Kd dict-var ids; mode 'b': at most the slots its conditions name,
// only when its logtype has a group) and writes one byte, against a few
// compares: the floor is (1 + Kd + 2 Ke) x 4 + 1 bytes per doc over 3.35
// TB/s. Design: grid (tiles x B members, S, L leaves), one thread per doc
// of a tile, the member the fastest block coordinate so the B blocks of
// one tile read the shared column set through L2 once. A block stages its
// member's condition table and groups (<= 64, each group's member
// conditions as a bit set) in shared memory; the logtype and dict-var
// LUTs, which follow the dictionaries' sizes (a var LUT row holds the
// column's var-dictionary cardinality, 2^20 at 2^22 bench log lines per
// segment), stay in global memory. Every member reads its own parameter
// tables through pointers in the argument struct, so members whose tables
// pad to other widths launch together.
#include <cuda_runtime.h>

#define CLP_THREADS 256
#define CLP_MAX_SETS 16     // column sets per launch (ops/_cuda.py MAX_SETS)
#define CLP_MAX_MEMBERS 16  // members per launch (ops/_cuda.py MAX_MEMBERS)
#define CLP_MAX_LEAVES 4    // leaves of one column per launch
#define CLP_MAX_SLOTS 16    // Kd, Ke (ops/clp_device.py KD_MAX, KE_MAX)
#define CLP_MAX_GROUPS 64   // padded groups (GROUPS_MAX)
#define CLP_MAX_CONDS 16    // padded conditions (CONDS_MAX)

// One leaf: its mode and slot counts, and per member its parameter tables
// (each [S, width] row-major, the member's own rows) and their widths.
struct ClpLeaf {
  const unsigned char* alut[CLP_MAX_MEMBERS];  // [S, cp] logtype LUT
  const unsigned char* vlut[CLP_MAX_MEMBERS];  // 'a': dvlut [S, vp];
                                               // 'b': dlut [S, nlp, vp]
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

__global__ void __launch_bounds__(CLP_THREADS)
clp_match_kernel(const __grid_constant__ ClpArgs a, int S, int D, int B,
                 unsigned char* __restrict__ out) {
  __shared__ int s_ck[CLP_MAX_CONDS], s_cs[CLP_MAX_CONDS];
  __shared__ int s_chi[CLP_MAX_CONDS], s_clo[CLP_MAX_CONDS];
  __shared__ int s_cl[CLP_MAX_CONDS];
  __shared__ int s_glt[CLP_MAX_GROUPS];
  __shared__ unsigned s_need[CLP_MAX_GROUPS];
  const int m = blockIdx.x % B, tile = blockIdx.x / B, ntile = gridDim.x / B;
  const int s = blockIdx.y, l = blockIdx.z;
  const ClpLeaf& L = a.leaf[l];
  const int u = a.set_of[m];
  const long long row = s;  // the row of the member's own [S, ...] tables
  const int cp = L.cp[m], vp = L.vp[m], kd = L.kd, ke = L.ke;
  const unsigned char* alut = L.alut[m] + row * cp;
  int gp = 0, ncp = 0, nlp = 0;
  if (L.mode_b) {
    gp = L.gp[m];
    ncp = L.ncp[m];
    nlp = L.nlp[m];
    for (int c = threadIdx.x; c < ncp; c += blockDim.x) {
      const long long k = row * ncp + c;
      s_ck[c] = L.ck[m][k];
      s_cs[c] = L.cs[m][k];
      s_chi[c] = L.chi[m][k];
      s_clo[c] = L.clo[m][k];
      s_cl[c] = L.cl[m][k];
    }
    for (int g = threadIdx.x; g < gp; g += blockDim.x) {
      s_glt[g] = L.glt[m][row * gp + g];
      const unsigned char* gm = L.gmem[m] + (row * gp + g) * ncp;
      unsigned need = 0;
      for (int c = 0; c < ncp; ++c)
        if (gm[c]) need |= 1u << c;
      s_need[g] = need;
    }
    __syncthreads();
  }
  const int* ids = a.id[u];
  const int per = (D + ntile - 1) / ntile;
  const int start = tile * per, end = min(D, start + per);
  const long long base = (long long)s * D;
  unsigned char* o = out + (((long long)l * B + m) * S + s) * D;
  for (int d = start + threadIdx.x; d < end; d += blockDim.x) {
    const long long i = base + d;
    const int id = ids[i];
    bool match = alut[clip(id, cp)] != 0;
    if (!L.mode_b) {
      const unsigned char* dvlut = L.vlut[m] + row * vp;
      for (int j = 0; j < kd && !match; ++j)
        match = dvlut[clip(a.dv[u][j][i], vp)] != 0;
    } else if (!match) {
      // each condition evaluated at most once per doc, and only where a
      // group of the doc's logtype needs it: `done` marks the evaluated
      // ones, `ok` those that hold; a group stops at its first failing
      // condition (the same answer as evaluating all of them first)
      unsigned done = 0, ok = 0;
      for (int g = 0; g < gp && !match; ++g) {
        const int lt = s_glt[g];
        if (lt < 0 || lt != id) continue;
        const unsigned need = s_need[g];
        unsigned todo = need & ~done;
        bool fails = (need & done & ~ok) != 0;
        while (todo && !fails) {
          const int c = __ffs(todo) - 1;
          todo &= todo - 1;
          const int k = s_ck[c];
          bool hold = true;
          if (k == 1 && ke) {
            const int j = clip(s_cs[c], ke);
            hold = a.ehi[u][j][i] == s_chi[c] && a.elo[u][j][i] == s_clo[c];
          } else if (k == 2 && kd) {
            const int j = clip(s_cs[c], kd);
            const unsigned char* bank =
                L.vlut[m] + (row * nlp + clip(s_cl[c], nlp)) * vp;
            hold = bank[clip(a.dv[u][j][i], vp)] != 0;
          }
          done |= 1u << c;
          if (hold) ok |= 1u << c;
          else fails = true;
        }
        match = !fails;
      }
    }
    o[d] = match ? 1 : 0;
  }
}

// Launches K7 on `stream` for L leaves of one column and B members over
// the sets of `a`; out: [L, B, S, D] bytes (0 / 1); dev: its device.
// Returns cudaGetLastError().
extern "C" int pt_clp_match(const ClpArgs* a, int S, int D, int B, int L,
                            int ntile, void* out, int dev, void* stream) {
  cudaSetDevice(dev);
  clp_match_kernel<<<dim3(ntile * B, S, L), CLP_THREADS, 0,
                     (cudaStream_t)stream>>>(*a, S, D, B,
                                             (unsigned char*)out);
  return (int)cudaGetLastError();
}
