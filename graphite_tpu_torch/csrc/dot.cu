// K9: the PCG's inner products (ops/pcg_loop.tree_dot) in one launch each
// on Hopper (sm_90a).
//
// Replaces no pl.pallas_call: it is the port's counterpart of XLA's
// reduction of jnp.dot in the JAX package's CG loop
// (graphite_tpu/ops/pcg_loop.py:27, 36, 46, 50). The port sums every dot
// in one fixed order, pcg_loop.tree_sum over the products, so that a CPU
// run and a card run take the same CG steps bit for bit; as plain PyTorch
// ops that order costs 22 launches a dot at Venice's n = 16,002 (one
// product, then at each of three levels a zero fill, a copy and five
// halving adds), three dots a CG step.
//
// The order: each product u[i] * v[i] is rounded on its own (-fmad=false,
// ops/cuda/build.py). Level 1 cuts the products into groups of 32
// consecutive entries, the last one padded with +0.0, and sums each group
// by the halving tree w[i] + w[i + o], o = 16, 8, 4, 2, 1 (a warp's
// shuffle-down sum, pcg_dense.cu's warp_sum); every later level does the
// same over the previous level's sums until one value is left, and there
// are at least two levels. The pads are added, not skipped: a group of
// -0.0 products sums to -0.0 without them and to +0.0 with them.
//
// Design. A warp loads 32 V consecutive entries, V = 4 floats or 2 doubles
// to a lane: one 16-byte load of u and one of v where both are contiguous
// and 16-byte aligned, scalar loads otherwise. So a lane holds V
// neighbouring products of one group (a group is 32 / V lanes): the tree's
// steps o >= V are shuffles over o / V lanes and the last steps are adds in
// registers, the same pairs in the same order.
// - n <= 32,768 (three levels; Venice's dim_p 16,002 and sphere2500's n d
//   14,994): one thread-block cluster of C CTAs (csrc/cluster.cuh; C a
//   power of two up to 16, from the wrapper). CTA c takes whole 1,024-entry
//   chunks [c per, (c + 1) per), per = ceil(chunks / C), a warp for each
//   warp load (32 warps at most; beyond, they loop), sums their groups
//   (level 1) and each
//   chunk's 32 group sums (level 2) with shuffles, and stores each chunk
//   sum into the leader CTA's shared memory with st.async, counted on the
//   leader's mbarrier. The leader's first warp waits for the chunks' bytes
//   and sums level 3 over them, padded with +0.0 to 32. The mbarrier's
//   init reaches the cluster through one relaxed cluster barrier whose
//   arrive comes before the loads and whose wait after them. So the
//   vectors are pulled by C SMs at once, and a call costs its launch, one
//   DRAM round trip, the warp sums and one exchange: no scratch, no ticket,
//   no fence. Each chunk's sum is computed whole by one CTA, so the split
//   is pcg_loop.tree_sum_chunked's, bitwise tree_sum for any C.
// - larger n: each CTA takes rounds of V whole chunks (tree_sum's first two
//   levels) and writes each chunk's sum to a scratch vector; the last CTA
//   to finish (an integer ticket counted with atomicAdd after a fence) runs
//   the rest of the tree over the chunk sums, in place, and resets the
//   ticket, so the next launch (a replayed graph too) finds it at 0. This
//   is tree_sum_chunked's split too. The ticket is one per device: two dots
//   above 32,768 entries must not run at once on two streams of one device
//   (the port takes its dots on one stream).
// No float atomics. The kernel allocates nothing (the wrapper gives the
// output and the scratch), never synchronises with the host and launches
// on the given stream, so it runs inside a captured CUDA graph and inside
// its conditional and "while" nodes (the CG step of pcg_loop.run_pcg_fixed).
//
// Bound: memory: u and v read once, 2 n 4 (or 8) bytes, and two operations
// an entry. At n = 16,002 in float32 the bytes take 0.04 us at 3.35 TB/s;
// a call costs its launch and its latencies.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;                 // entries of a tree_sum group
constexpr long long kChunk = kGroup * kGroup;  // 1,024: two levels
// CTAs of the multi-CTA form: two of 1,024 threads fit an SM, 132 SMs
constexpr long long kMaxCtas = 2 * 132;

// CTAs that have written their chunk sums in the running launch
__device__ unsigned int g_ticket = 0;

// V entries (16 bytes) to a lane
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void products(const float* u,
                                                  const float* v, float* p) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(u));
    const float4 y = __ldg(reinterpret_cast<const float4*>(v));
    p[0] = x.x * y.x;
    p[1] = x.y * y.y;
    p[2] = x.z * y.z;
    p[3] = x.w * y.w;
  }
};

template <>
struct Vec<double> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void products(const double* u,
                                                  const double* v,
                                                  double* p) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(u));
    const double2 y = __ldg(reinterpret_cast<const double2*>(v));
    p[0] = x.x * y.x;
    p[1] = x.y * y.y;
  }
};

template <typename T>
struct Operands {
  const T* u;
  const T* v;
  long long su, sv;  // element strides
  long long n;
  bool vec;  // both contiguous and 16-byte aligned
};

// The V products lane l holds of the warp's 32 V entries from e0: entries
// e0 + V l + k, +0.0 at and past n.
template <typename T>
__device__ __forceinline__ void load_products(const Operands<T>& a,
                                              long long e0, T* p) {
  constexpr int V = Vec<T>::N;
  const long long e = e0 + V * (threadIdx.x & 31);
  if (a.vec && e0 + 32 * V <= a.n) {  // warp-uniform
    Vec<T>::products(a.u + e, a.v + e, p);
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    p[k] = e + k < a.n ? a.u[(e + k) * a.su] * a.v[(e + k) * a.sv]
                       : static_cast<T>(0);
  }
}

// tree_sum's halving tree over one value a lane: the sum of the warp's 32
// values in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// The same tree over groups of 32 products held V to a lane: each group's
// sum in its first lane (lane % (32 / V) == 0). Step o >= V adds lane
// l + o / V's values (entry i + o to entry i); the steps o < V add within
// the lane.
template <typename T>
__device__ __forceinline__ T group_sum(T* p) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int o = 16; o >= V; o >>= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p[k] += __shfl_down_sync(0xffffffffu, p[k], o / V);
    }
  }
#pragma unroll
  for (int o = V / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < o; ++k) p[k] += p[k + o];
  }
  return p[0];
}

// The cluster form (n_chunks <= 32): CTA `rank` of the cluster sums chunks
// [rank per, min((rank + 1) per, n_chunks)), one warp load a warp (the
// block has per 32 / V warps, at most 32: more loads loop), and stores
// each chunk's sum into the leader's `level2` with st.async; the leader's
// first warp sums level 3.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tree_dot_cluster_kernel(Operands<T> a, int n_chunks, int per,
                            T* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  constexpr int kLanes = 32 / V;  // lanes of a group
  __shared__ T level1[kGroup * kGroup];  // per <= 32 chunks of 32 groups
  __shared__ T level2[kGroup];  // the chunk sums (the leader's)
  __shared__ unsigned long long bar;
  const int rank = static_cast<int>(cluster_rank());
  if (rank == 0 && threadIdx.x == 0) {
    mbar_init(&bar);
    mbar_expect(&bar, static_cast<unsigned>(n_chunks * sizeof(T)));
    fence_mbar_init();
  }
  cluster_arrive_relaxed();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = rank * per;
  const int nc = max(0, min(per, n_chunks - c0));  // this CTA's chunks
  const int loads = nc * (kGroup / V);  // warp loads: 32 V entries each
  const long long base = static_cast<long long>(c0) * kChunk;
  for (int q = warp; q < loads; q += blockDim.x >> 5) {
    T p[V];
    load_products(a, base + static_cast<long long>(q) * 32 * V, p);
    const T s = group_sum(p);
    if (lane % kLanes == 0) level1[q * V + lane / kLanes] = s;
  }
  __syncthreads();
  cluster_wait();  // the leader's mbarrier is initialized
  if (warp < nc) {
    const T s = warp_sum(level1[kGroup * warp + lane]);
    if (lane == 0) st_async(&level2[c0 + warp], s, &bar, 0);
  }
  if (rank == 0 && warp == 0) {
    mbar_wait(&bar, 0);
    // level 3, where level 2 left more than one sum
    const T s = n_chunks == 1
                    ? level2[0]
                    : warp_sum(lane < n_chunks ? level2[lane]
                                               : static_cast<T>(0));
    if (lane == 0) *out = s;
  }
}

// The multi-CTA form (n_chunks > 32): rounds of V chunks, their sums to
// `scratch`; the last CTA sums the rest of the tree.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tree_dot_kernel(Operands<T> a, long long n_chunks, T* __restrict__ scratch,
                    T* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  constexpr int kLanes = 32 / V;                  // lanes of a group
  constexpr int kRoundGroups = kWarps * V;        // level-1 groups a round
  constexpr int kRoundChunks = kRoundGroups / kGroup;
  __shared__ T level1[kRoundGroups];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long rounds = (n_chunks + kRoundChunks - 1) / kRoundChunks;
  for (long long rd = blockIdx.x; rd < rounds; rd += gridDim.x) {
    const long long base = rd * kRoundGroups * kGroup;
    T p[V];
    load_products(a, base + static_cast<long long>(warp) * 32 * V, p);
    const T s = group_sum(p);
    if (lane % kLanes == 0) level1[warp * V + lane / kLanes] = s;
    __syncthreads();
    if (warp < kRoundChunks) {
      const T s2 = warp_sum(level1[kGroup * warp + lane]);
      const long long chunk = rd * kRoundChunks + warp;
      if (lane == 0 && chunk < n_chunks) __stcg(scratch + chunk, s2);
    }
    __syncthreads();
  }
  // this CTA's chunk sums are written: count it; the last CTA finishes
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // levels 3, 4, ... over the m sums in place: pass g0 reads groups
  // [g0, g0 + 32) (entries below 32 (g0 + 32)) and then writes their sums
  // to entries [g0, g0 + 32), which earlier passes (or this one, before
  // the barrier) have read
  long long m = n_chunks;
  while (m > 1) {
    const long long m2 = (m + kGroup - 1) / kGroup;
    for (long long g0 = 0; g0 < m2; g0 += kWarps) {
      const long long g = g0 + warp;
      const long long e = kGroup * g + lane;
      const T s = warp_sum(g < m2 && e < m ? __ldcg(scratch + e)
                                           : static_cast<T>(0));
      __syncthreads();
      if (g < m2 && lane == 0) __stcg(scratch + g, s);
      __syncthreads();
    }
    m = m2;
  }
  if (threadIdx.x == 0) {
    *out = __ldcg(scratch);
    atomicExch(&g_ticket, 0u);
  }
}

template <typename T>
int tree_dot(const void* u, const void* v, long long n, long long su,
             long long sv, void* out, void* scratch, int cluster,
             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = Vec<T>::N;
  Operands<T> a;
  a.u = static_cast<const T*>(u);
  a.v = static_cast<const T*>(v);
  a.su = su;
  a.sv = sv;
  a.n = n;
  a.vec = su == 1 && sv == 1 &&
          ((reinterpret_cast<unsigned long long>(u) |
            reinterpret_cast<unsigned long long>(v)) & 15) == 0;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_chunks <= kGroup) {
    if (cluster < 1 || cluster > kMaxCluster) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int per = static_cast<int>((n_chunks + cluster - 1) / cluster);
    const int warps = per * (kGroup / V) < kWarps ? per * (kGroup / V)
                                                  : kWarps;
    return static_cast<int>(launch_cluster(
        tree_dot_cluster_kernel<T>, cluster, 32 * warps, 0, s, a,
        static_cast<int>(n_chunks), per, static_cast<T*>(out)));
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long rounds = (n_chunks + V - 1) / V;
  const unsigned grid =
      static_cast<unsigned>(rounds < kMaxCtas ? rounds : kMaxCtas);
  tree_dot_kernel<T><<<grid, kThreads, 0, s>>>(
      a, n_chunks, static_cast<T*>(scratch), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, v: n float32 entries at element strides su, sv; out: one float32;
// scratch: ceil(n / 1024) float32 where n > 32,768 (else unused, may be
// null); cluster: the CTAs of the cluster form (n <= 32,768; 1-16).
// Launches on `stream` and returns the cudaError_t code (0 on success).
extern "C" int gt_tree_dot_f32(const void* u, const void* v, long long n,
                               long long su, long long sv, void* out,
                               void* scratch, int cluster, void* stream) {
  return tree_dot<float>(u, v, n, su, sv, out, scratch, cluster, stream);
}

// The same in float64.
extern "C" int gt_tree_dot_f64(const void* u, const void* v, long long n,
                               long long su, long long sv, void* out,
                               void* scratch, int cluster, void* stream) {
  return tree_dot<double>(u, v, n, su, sv, out, scratch, cluster, stream);
}

extern "C" const char* gt_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
