// The dynamic shared-memory limit of K1-K5 and K8 (scan_agg.cu,
// group_agg.cu, sketch_agg.cu, topn.cu, startree_agg.cu, vector_topk.cu).
//
// A kernel's limit (cudaFuncAttributeMaxDynamicSharedMemorySize) belongs
// to the function and is shared by every host thread that launches it, as
// the dispatch ring's clients do, each on its own thread. Set to one
// launch's own size, it could be lowered by another thread's smaller launch
// between this thread's setting and its launch, which then fails with
// cudaErrorInvalidValue. So it is only ever set to the most a block of the
// kernel may take: the card's opt-in limit less the kernel's static arrays.
#pragma once

#include <atomic>
#include <cuda_runtime.h>

// Raises `kern`'s limit to its most on the current device, once a device:
// `done` is the call site's own flag word, one bit a device.
template <typename F>
static inline cudaError_t pt_smem_limit_max(F* kern,
                                            std::atomic<unsigned>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done->load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess) done->fetch_or(bit, std::memory_order_release);
  return e;
}
