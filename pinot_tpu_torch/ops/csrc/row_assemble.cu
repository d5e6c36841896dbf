// K6 row_assemble: the zero-padded [S, D] block of one column, assembled
// on the card from the resident rows of its segments, in one launch.
//
// Replaces pinot_tpu/ops/kernels.py:100 `compiled_row_assembler` in both of
// its forms: `jnp.stack` when every row is full-length, and `jnp.zeros`
// plus one `dynamic_update_slice` per row otherwise (S + 1 copies).
//
// Row s (s < rows) is copied up to its length in bytes and followed by
// zeros up to the block's row width; rows past `rows` (padded segments)
// are zero. The kernel copies bytes, so one kernel serves every element
// size the engine stages (1-byte ids and masks, 4-byte ids and values,
// 8-byte values).
//
// Bound on an H100: bytes (each row read once, the block written once; no
// arithmetic). Design: grid (blocks per row, rows), each thread one 16-byte
// unit of its row where the row's source, its length and the row width
// are 16-byte aligned (every block the engine stages: rows are
// power-of-two buckets of at least 128 elements, tensors start 512-byte
// aligned), neighbouring threads on neighbouring units; the zero padding
// and padded rows are stores only; other rows are copied a byte at a
// time. Many short blocks in address order were the fastest of the
// layouts timed on an H100 (PERF.md §6, K6's design points): one wave of
// the card's resident blocks striding over the rows, several loads in
// flight a thread, non-allocating loads and streaming stores were each
// slower, and so were equal contiguous shares of the block.
#include <cuda_runtime.h>
#include <stdint.h>

#define RA_THREADS 256
#define RA_MAX_ROWS 1024

// ops/_cuda.py `_RowArgs`, passed by value: 16 KB, inside the 32,764 bytes
// of kernel parameters that CUDA 12.1 and later allow on sm_70 and later.
struct RowArgs {
  const void* src[RA_MAX_ROWS];
  long long len[RA_MAX_ROWS];  // bytes of row s to copy (<= row_bytes)
};

__global__ void __launch_bounds__(RA_THREADS)
row_assemble(const __grid_constant__ RowArgs a, int rows, long long row_bytes,
             unsigned char* __restrict__ out) {
  const int r = blockIdx.y;
  const unsigned char* src =
      r < rows ? (const unsigned char*)a.src[r] : nullptr;
  const long long len = r < rows ? a.len[r] : 0;
  unsigned char* dst = out + (long long)r * row_bytes;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (((((uintptr_t)src) | ((uintptr_t)dst) | (uintptr_t)len |
        (uintptr_t)row_bytes) & 15) == 0) {
    const uint4* s4 = (const uint4*)src;
    uint4* d4 = (uint4*)dst;
    const long long n = row_bytes >> 4, l = len >> 4;
    for (long long i = first; i < n; i += step)
      d4[i] = i < l ? s4[i] : make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (long long i = first; i < row_bytes; i += step)
      dst[i] = i < len ? src[i] : (unsigned char)0;
  }
}

// The size of RowArgs as this compiler lays it out, for the wrapper's check
// of its ctypes mirror.
extern "C" int pt_row_assemble_args_bytes() { return (int)sizeof(RowArgs); }

// Launches K6 on `stream` over block rows [0, S): rows with an index below
// `rows` come from a, the others are zero. out: [S, row_bytes] bytes; dev:
// its device. Returns cudaGetLastError().
extern "C" int pt_row_assemble(const RowArgs* a, int rows, int S,
                               long long row_bytes, void* out, int dev,
                               void* stream) {
  cudaSetDevice(dev);
  // a block per 256 16-byte units of a row
  long long per_row = (row_bytes + RA_THREADS * 16 - 1) / (RA_THREADS * 16);
  if (per_row < 1) per_row = 1;
  row_assemble<<<dim3((unsigned)per_row, (unsigned)S), RA_THREADS, 0,
                 (cudaStream_t)stream>>>(*a, rows, row_bytes,
                                         (unsigned char*)out);
  return (int)cudaGetLastError();
}
