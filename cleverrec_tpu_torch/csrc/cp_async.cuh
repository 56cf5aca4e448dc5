// cp.async staging from device memory into shared memory, shared by the
// scoring kernels (dot_scores.cu) and the tower epoch (mlp_epoch.cu).
// A copy of n < its size bytes zero-fills the rest of its destination, so
// n = 0 writes zeros: the kernels pad their shared tiles that way.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp16(float* dst, const float* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
