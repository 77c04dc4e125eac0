// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), for the marching kernels (stencil.cu's row march,
// zmarch3.cuh's z march): each thread issues the copies of the cells it
// will read, commits them as one group per row or plane, and waits for the
// group before it reads.  A copy whose source lies outside the array fills
// zeros (src-size 0): `src` must still be a valid address, and is never
// read then.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, or 4 zero bytes when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes (both addresses 16-byte aligned), or 16 zero bytes when !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
