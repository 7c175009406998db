// Launching one thread-block cluster, shared by the whole-PCG kernels K2
// (pcg_dense.cu) and K6 (pcg_mf.cu) and by K9's cluster form (dot.cu).
//
// Each runs a whole CG solve as one cluster of up to 16 CTAs that meet at
// cluster barriers and exchange partial sums through distributed shared
// memory. A cluster larger than 8 CTAs is non-portable: the kernel is
// allowed it, and the first launch of each (kernel, device, cluster size,
// shared memory) asks the card whether one such cluster fits at all
// (cudaOccupancyMaxActiveClusters; the answer is kept). If it does not,
// the launch returns cudaErrorLaunchOutOfResources and the wrapper raises:
// a solve never runs on a smaller cluster than it asked for.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <utility>

constexpr int kMaxCluster = 16;

// The dynamic shared memory a block of the current device may opt in to
// (232,448 bytes on an H100).
inline int max_dynamic_smem() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// Sets the kernel's attributes and checks that one cluster of `cfg` fits,
// once per (kernel, device, cluster size, shared memory).
inline cudaError_t prepare_cluster(const void* kernel,
                                   const cudaLaunchConfig_t& cfg,
                                   int cluster) {
  struct Seen {
    const void* kernel;
    int dev, cluster;
    size_t smem;
    cudaError_t verdict;
  };
  static Seen seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    const Seen& s = seen[i];
    if (s.kernel == kernel && s.dev == dev && s.cluster == cluster &&
        s.smem == cfg.dynamicSmemBytes) {
      return s.verdict;
    }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cfg.dynamicSmemBytes));
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err == cudaSuccess && active < 1) err = cudaErrorLaunchOutOfResources;
  }
  if (n_seen < 64) seen[n_seen++] = {kernel, dev, cluster,
                                     cfg.dynamicSmemBytes, err};
  return err;
}

// Fence-free exchange between the CTAs of a cluster. A cluster barrier
// that orders memory (barrier.cluster.arrive.release) costs ~0.7 us on an
// H100, most of it the release fence; an exchange below ~0.2 us
// (kernel_sweep.py). So values that other CTAs wait for travel as
// st.async stores into their shared memory, each counted in bytes on the
// receiver's mbarrier (complete_tx, which releases at cluster scope): the
// receiver posts the bytes it expects (mbar_expect), and its wait on the
// barrier's phase (mbar_wait, acquire at cluster scope) returns once all
// of them have landed.

// The shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// Stores `v` at `p` (an address of this CTA's shared memory layout) in CTA
// `rank` and counts its 4 bytes on that CTA's mbarrier `bar`.
__device__ __forceinline__ void st_async(const float* p, float v,
                                         const unsigned long long* bar,
                                         int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(cluster_addr(p, rank)),
      "r"(__float_as_uint(v)), "r"(cluster_addr(bar, rank))
      : "memory");
}

// The same for a double: 8 bytes counted on `bar`.
__device__ __forceinline__ void st_async(const double* p, double v,
                                         const unsigned long long* bar,
                                         int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(cluster_addr(p, rank)),
      "l"(__double_as_longlong(v)), "r"(cluster_addr(bar, rank))
      : "memory");
}

// This CTA's rank in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// A cluster barrier in two halves, every thread of the cluster taking
// both: arrive (relaxed: it orders no memory, so it costs no fence) and,
// later, wait. After an mbarrier's init and fence_mbar_init, the wait
// makes the mbarrier visible to the cluster, and the work between the
// halves hides the barrier's latency.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One thread: an mbarrier for one expected arrival (the mbar_expect of
// each phase). Make it visible to the cluster (fence_mbar_init, then a
// cluster barrier) before any CTA stores to it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar)))
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread per phase: the phase completes once `bytes` have landed.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          static_cast<unsigned>(__cvta_generic_to_shared(bar))),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `parity` to complete. A phase that never
// completes (bytes expected that no CTA stores) traps after ~2 s rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

// Launches `kernel` on `stream` as one cluster of `cluster` CTAs of
// `threads` threads with `smem` bytes of dynamic shared memory each, and
// returns the launch's error code.
template <class... Params, class... Actual>
cudaError_t launch_cluster(void (*kernel)(Params...), int cluster,
                           int threads, size_t smem, cudaStream_t stream,
                           Actual&&... args) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      prepare_cluster(reinterpret_cast<const void*>(kernel), cfg, cluster);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Actual>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
