// Asynchronous copies from device memory into shared memory (cp.async),
// 4, 8 or 16 bytes a copy, shared by the kernels that stage their rows
// before computing on them:
// K2 (pcg_dense.cu), K3 (segprod.cu), K4 and K5 (segmv.cu), K7 (bal.cu) and
// K10 (schur_w.cu); and the copy of a staged span back out in 16-byte
// stores (K7, K10).
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

// 8 bytes: any 8-byte-aligned source (float64 rows, gathered or of odd
// width).
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One element of a float32 or float64 row: cp_async4 or cp_async8.
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void cp_async_elem(double* dst,
                                              const double* src) {
  cp_async8(dst, src);
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

// Stages the n elements (float or double) at src (aligned to its
// element) into the shared span dst + m (dst 16-byte aligned), m the
// offset of src in elements from a 16-byte boundary, so that every 16-byte
// piece is aligned on both sides: 16-byte cp.async copies between the
// first and the last boundary, one-element ones (cp_async_elem) before and
// after, by the CTA's kThreads threads. Returns m (0 where src is 16-byte
// aligned). The caller commits and waits.
template <int kThreads, typename E>
__device__ __forceinline__ int stage_span(E* dst, const E* __restrict__ src,
                                          int n) {
  constexpr int kPer = 16 / sizeof(E);
  const int m = static_cast<int>(
      (reinterpret_cast<unsigned long long>(src) / sizeof(E)) & (kPer - 1));
  const int head = min(n, (kPer - m) & (kPer - 1));
  const int nv = (n - head) / kPer;
  E* d = dst + m;
  for (int x = threadIdx.x; x < nv; x += kThreads) {
    cp_async16(reinterpret_cast<float*>(d + head + kPer * x),
               reinterpret_cast<const float*>(src + head + kPer * x));
  }
  for (int x = threadIdx.x; x < head; x += kThreads) {
    cp_async_elem(d + x, src + x);
  }
  for (int x = head + kPer * nv + threadIdx.x; x < n; x += kThreads) {
    cp_async_elem(d + x, src + x);
  }
  return m;
}

// The n elements of the shared span src out to dst, src at the same offset
// from a 16-byte boundary as dst (as stage_span leaves a span staged from
// an address so aligned): 16-byte stores between the first and the last
// boundary, element stores before and after, by the CTA's kThreads
// threads.
template <int kThreads, typename T>
__device__ __forceinline__ void store_span(T* __restrict__ dst, const T* src,
                                           int n) {
  constexpr int kPer = 16 / sizeof(T);
  const int m = static_cast<int>(
      (reinterpret_cast<unsigned long long>(dst) / sizeof(T)) & (kPer - 1));
  const int head = min(n, (kPer - m) & (kPer - 1));
  const int nv = (n - head) / kPer;
  for (int x = threadIdx.x; x < nv; x += kThreads) {
    reinterpret_cast<uint4*>(dst + head)[x] =
        reinterpret_cast<const uint4*>(src + head)[x];
  }
  for (int x = threadIdx.x; x < head; x += kThreads) dst[x] = src[x];
  for (int x = head + kPer * nv + threadIdx.x; x < n; x += kThreads) {
    dst[x] = src[x];
  }
}
