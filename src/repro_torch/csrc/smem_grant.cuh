// The dynamic shared-memory opt-in of a kernel, made once.
//
// A kernel that takes more than 48 KB of dynamic shared memory must be
// allowed it with cudaFuncSetAttribute, a host-side call that is no stream
// operation.  The attribute is a ceiling, so one call at the largest size
// asked for so far covers every smaller launch: a launch makes the call
// only when it asks for more than any launch of the same kernel before it
// on the same device.  After the first launch at a shape, a launch is a
// stream operation alone, and a CUDA graph can record it.
//
// One SmemGrant serves one kernel: declare it `static` beside the launch
// of that kernel (a template launch function has one per instantiation).
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace smem {

constexpr int kMaxDevices = 64;
constexpr size_t kDefaultLimit = 48 * 1024;  // needs no opt-in

class SmemGrant {
 public:
  template <typename K>
  cudaError_t allow(K kernel, size_t smem) {
    if (smem <= kDefaultLimit) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    const int want = static_cast<int>(smem);
    int have = granted_[dev].load(std::memory_order_acquire);
    if (have >= want) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
    if (err != cudaSuccess) return err;
    while (have < want &&
           !granted_[dev].compare_exchange_weak(have, want,
                                                std::memory_order_acq_rel)) {
    }
    return cudaSuccess;
  }

 private:
  std::atomic<int> granted_[kMaxDevices] = {};
};

}  // namespace smem
