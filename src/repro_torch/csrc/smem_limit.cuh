// Shared by the port's CUDA sources: raising a kernel's dynamic shared
// memory limit once per (kernel instance, device). `kernels/_build.py`
// hashes every `.cuh` here into each library's name, so an edit rebuilds
// the sources that include it.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;   // devices whose shared memory limits are kept

// Lets `kern` launch with `bytes` of dynamic shared memory. The limit that
// cudaFuncSetAttribute raises holds on the current device for the rest of
// the process, so `set` keeps, per device, the largest size set so far and
// the CUDA call is made only for a larger one; none is made up to the
// 48 KB that every kernel may take. One `set` (kMaxDevices entries) per
// kernel instance.
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, std::atomic<int>* set) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>* mine = dev < kMaxDevices ? set + dev : nullptr;
  if (mine != nullptr && bytes <= mine->load(std::memory_order_relaxed))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && mine != nullptr) {
    int was = mine->load(std::memory_order_relaxed);
    while (was < bytes && !mine->compare_exchange_weak(was, bytes)) {
    }
  }
  return e;
}

}  // namespace
