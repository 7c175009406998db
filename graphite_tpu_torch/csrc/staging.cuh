// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the kernels that stage their rows before computing on them:
// K3 (segprod.cu), K4 and K5 (segmv.cu).
//
// A copy is issued by one thread and lands in shared memory without
// passing through its registers; cp_async_commit closes the thread's
// current group of copies and cp_async_wait<N> waits until at most N of
// its groups are still in flight. Other threads see the data only after a
// barrier that follows the wait.

#pragma once

#include <cuda_runtime.h>

// 4 bytes: any 4-byte-aligned source (rows of odd width, gathered rows).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1 (.cg).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
