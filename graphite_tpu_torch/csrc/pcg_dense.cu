// K2: a whole block-Jacobi preconditioned CG solve in one launch, on one
// thread-block cluster of a Hopper card (sm_90a).
//
// Replaces graphite_tpu/ops/pallas/pcg_dense.py (_kernel, dense_pcg), which
// kept S, M and the CG vectors in VMEM. Semantics follow
// graphite_tpu/ops/pcg_loop.run_pcg step for step:
//   - the residual is normalized before each preconditioner application;
//   - a step with |rz_new| > rejection_ratio * rz_min (or a NaN rz_new) is
//     rejected: x, r, p, z and rz keep their previous values and the loop
//     stops;
//   - rz_min starts at +inf and is a running minimum of |rz_new|;
//   - the loop stops on |rz_new| < tol, and never starts an iteration
//     while rz == 0.
// The matvecs are row-vector products, v = p @ S and z = y @ M, as in the
// TPU kernel (S and M are symmetric up to rounding).
//
// Design: one cluster of C <= 16 CTAs of 1024 threads (C from the
// wrapper), n <= 1024. The n entries are cut into 32-entry groups; CTA c
// owns ceil(groups / C) consecutive groups, so whole columns of S and M,
// and thread i of its first 32 * groups holds entry c0 + i of x, r, p, z
// in registers and runs that entry's two matvec chains, sum_j vec[j] *
// A[j, i] in j order in one thread. The column slices of S and M stay in
// the CTA's shared memory for the whole solve where both fit (2 n 32 * 4
// bytes a group: n = 441 at one group a CTA takes 113 KB); otherwise they
// are streamed through a ring of row tiles on every matvec (cp.async,
// issued by all 1024 threads). Every CTA keeps the whole of p and of the
// normalized residual in shared memory: each step a CTA stores its
// entries of r_new and z_new, with its groups' dot partials, into every
// CTA's shared memory (distributed shared memory) as st.async stores
// counted on the receiver's mbarrier (cluster.cuh: no release fence, no
// cluster barrier); once a phase has all its bytes, every CTA computes
// y = r_new / ||r_new|| and p_new = z_new + beta p for all n entries
// itself, the same bits as the owner's. So a step takes three exchanges
// (p.v; r_new.r_new with r_new; r_new.z_new with z_new). Each CTA waits
// for every other's stores before its next ones, so no store lands in a
// phase or a buffer still in use. Dots are pcg_loop.tree_sum's order (for
// n <= 1024, K2's original block_sum): each group summed by a warp's
// shuffle-down halving tree, then the group sums the same way, by every
// warp of every CTA, so every thread holds the same rz, rz_min and done
// and the loop is uniform across the cluster (a CTA leaving early would
// leave the others waiting). No sum depends on C. All arithmetic is IEEE fp32
// (no TF32, no fast math) and the file is built with -fmad=false: every
// product and sum is rounded on its own, so the plain version
// (ops/cuda/pcg_dense.py, dense_pcg_plain), which takes each operation in
// this order, gives the same bits on the CPU.
//
// Bound: the 2n-long in-order chain per entry (two matvecs a step) and
// three exchanges a step; the operations (~2 n^2 a matvec) take ~0.03 us
// at the card's rate for n = 441.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"
#include "staging.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = 1024;
constexpr int kRing = 4;       // row tiles in flight when streaming
constexpr int kTileRows = 64;  // rows of a streamed tile, at most

struct Args {
  const float* S;
  const float* M;
  const float* b;
  float* x_out;
  int* iters_out;
  int n, max_iter;
  float tol, ratio;
  int smem_bytes;  // the launch's dynamic shared memory
};

// This CTA's columns: [c0, c0 + W) for its chain threads (those >= n are
// dead), of which the first wc < n are copied.
struct Slice {
  int c0, W, wc;
  bool vec4;      // 16-byte copies (n and wc multiples of 4)
  int tile_rows;  // streamed tiles; 0 when the slices are resident
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// tree_sum's second level over the G (<= 32) group sums; every warp
// computes it, so every thread gets the value with no barrier.
__device__ float group_total(const float* part, int G) {
  const int lane = threadIdx.x & 31;
  return __shfl_sync(0xffffffffu, warp_sum(lane < G ? part[lane] : 0.0f),
                     0);
}

// Stores this CTA's group sums of val (one per chain warp; val is 0 on
// dead entries) into `part` of every CTA of the cluster, counted on the
// receiver's mbarrier `bar`.
__device__ void publish_groups(float* part, float val, int g,
                               bool chain_warp, int C,
                               const unsigned long long* bar) {
  if (!chain_warp) return;  // warp-uniform
  const float s = __shfl_sync(0xffffffffu, warp_sum(val), 0);
  const int lane = threadIdx.x & 31;
  if (lane < C) st_async(part + g, s, bar, lane);
}

// Stores a chain thread's entry i of a vector into `full` of every CTA.
__device__ void publish(float* full, int i, float val, bool chain, int C,
                        const unsigned long long* bar) {
  if (!chain) return;
  for (int r = 0; r < C; ++r) st_async(full + i, val, bar, r);
}

// Thread 0 posts the bytes this CTA receives in the phase of `bar`; every
// thread waits for them.
__device__ void receive(unsigned long long* bar, unsigned bytes,
                        unsigned& parity) {
  if (threadIdx.x == 0) mbar_expect(bar, bytes);
  mbar_wait(bar, parity);
  parity ^= 1;
}

// Copies rows [j0, j1) of A's columns [c0, c0 + wc) into dst (row stride
// W) with cp.async issued by every thread; the caller commits and waits.
__device__ void load_rows(float* dst, const float* A, int n,
                          const Slice& sl, int j0, int j1) {
  if (sl.vec4) {
    const int q = sl.wc >> 2;  // 16-byte words a row
    for (int k = threadIdx.x; k < (j1 - j0) * q; k += kThreads) {
      const int jj = k / q;
      const int w = (k - jj * q) << 2;
      cp_async16(dst + jj * sl.W + w,
                 A + static_cast<long long>(j0 + jj) * n + sl.c0 + w);
    }
  } else {
    for (int k = threadIdx.x; k < (j1 - j0) * sl.wc; k += kThreads) {
      const int jj = k / sl.wc;
      const int w = k - jj * sl.wc;
      cp_async4(dst + jj * sl.W + w,
                A + static_cast<long long>(j0 + jj) * n + sl.c0 + w);
    }
  }
}

// (vec @ A)[c0 + il] for chain thread il < W: sum over j in order of
// vec[j] * A[j, c0 + il], one rounding per product and per add. A's slice
// is `res` when resident, else streamed through `ring`. Every thread of
// the CTA calls it.
__device__ float vec_mat(const float* vec, const float* A, const float* res,
                         float* ring, const Slice& sl, int n) {
  const int il = threadIdx.x;
  float acc = 0.0f;
  if (sl.tile_rows == 0) {
    if (il < sl.W) {
      for (int j = 0; j < n; ++j) acc += vec[j] * res[j * sl.W + il];
    }
    return acc;
  }
  const int TJ = sl.tile_rows;
  const int nt = (n + TJ - 1) / TJ;
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < nt) load_rows(ring + t * TJ * sl.W, A, n, sl, t * TJ,
                          min(n, (t + 1) * TJ));
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kRing - 2>();  // tile t has landed (this thread's part)
    __syncthreads();             // ... everyone's; tile t - 1 is consumed
    const int tn = t + kRing - 1;
    if (tn < nt) load_rows(ring + (tn % kRing) * TJ * sl.W, A, n, sl,
                           tn * TJ, min(n, (tn + 1) * TJ));
    cp_async_commit();
    if (il < sl.W) {
      const float* tile = ring + (t % kRing) * TJ * sl.W + il;
      const int j0 = t * TJ;
      const int j1 = min(n, j0 + TJ);
      for (int j = j0; j < j1; ++j) acc += vec[j] * tile[(j - j0) * sl.W];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next matvec
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
    pcg_dense_kernel(const Args a) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n;
  const int C = static_cast<int>(gridDim.x);  // the grid is one cluster
  const int rank = static_cast<int>(cl.block_rank());
  const int G = (n + 31) >> 5;
  const int per = (G + C - 1) / C;
  const int g0 = min(rank * per, G);
  const int ng = min(per, G - g0);
  const int npad = G << 5;
  Slice sl;
  sl.c0 = g0 << 5;
  sl.W = ng << 5;
  sl.wc = max(0, min(sl.W, n - sl.c0));
  sl.vec4 = (n & 3) == 0;  // then wc is a multiple of 4 as well

  // shared memory: the mbarriers of the three exchanges, the dots' group
  // sums and r_new, z_new (stored by every CTA), then p and y (this
  // CTA's), then S's and M's slices or the ring
  unsigned long long* bar_pv = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* bar_rr = bar_pv + 1;
  unsigned long long* bar_rz = bar_pv + 2;
  float* sm = reinterpret_cast<float*>(smem + 32);
  float* part_pv = sm;
  float* part_rr = sm + 32;
  float* part_rz = sm + 64;
  float* rn_full = sm + 96;
  float* z_full = rn_full + npad;
  float* p_full = z_full + npad;
  float* y_full = p_full + npad;
  float* tiles = y_full + npad;
  const long long room = (a.smem_bytes - 32) / 4 - (tiles - sm);
  float* s_res = tiles;
  float* m_res = tiles + static_cast<long long>(n) * sl.W;
  if (threadIdx.x == 0) {
    mbar_init(bar_pv);
    mbar_init(bar_rr);
    mbar_init(bar_rz);
    fence_mbar_init();
  }
  if (2LL * n * sl.W <= room) {
    sl.tile_rows = 0;
    if (sl.W > 0) {
      load_rows(s_res, a.S, n, sl, 0, n);
      load_rows(m_res, a.M, n, sl, 0, n);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {  // at most kTileRows rows a tile, kRing tiles in `room`
    sl.tile_rows = static_cast<int>(
        min(static_cast<long long>(kTileRows), room / (kRing * sl.W)));
  }
  cl.sync();  // the slices staged, every CTA's mbarriers initialized

  const int il = threadIdx.x;
  const int warp = il >> 5;
  const bool chain = il < sl.W;
  const bool chain_warp = warp < ng;
  const int i = sl.c0 + il;
  const bool live = chain && i < n;
  const int g = g0 + warp;
  const unsigned part_bytes = 4u * G;
  const unsigned vec_bytes = 4u * (npad + G);
  unsigned par_pv = 0, par_rr = 0, par_rz = 0;

  float x = 0.0f;
  float r = live ? a.b[i] : 0.0f;
  // z = (r / ||r||) @ M (||r|| == 0 taken as 1), from the r_new entries
  // and rr group sums every CTA received
  auto precondition = [&]() {
    const float rnorm = __fsqrt_rn(group_total(part_rr, G));
    const float s = rnorm == 0.0f ? 1.0f : rnorm;
    for (int j = il; j < npad; j += kThreads) {
      y_full[j] = __fdiv_rn(rn_full[j], s);
    }
    __syncthreads();
    const float zz = vec_mat(y_full, a.M, m_res, tiles, sl, n);
    return live ? zz : 0.0f;
  };

  publish(rn_full, i, r, chain, C, bar_rr);
  publish_groups(part_rr, r * r, g, chain_warp, C, bar_rr);
  receive(bar_rr, vec_bytes, par_rr);
  float z = precondition();
  float p = z;
  publish(z_full, i, z, chain, C, bar_rz);
  publish_groups(part_rz, live ? r * z : 0.0f, g, chain_warp, C, bar_rz);
  receive(bar_rz, vec_bytes, par_rz);
  float rz = group_total(part_rz, G);
  for (int j = il; j < npad; j += kThreads) p_full[j] = z_full[j];
  __syncthreads();

  float rz_min = INFINITY;
  int k = 0;
  bool done = false;
  while (k < a.max_iter && !done && rz != 0.0f) {
    float v = vec_mat(p_full, a.S, s_res, tiles, sl, n);
    v = live ? v : 0.0f;
    publish_groups(part_pv, live ? p * v : 0.0f, g, chain_warp, C, bar_pv);
    receive(bar_pv, part_bytes, par_pv);
    const float alpha = __fdiv_rn(rz, group_total(part_pv, G));
    const float x_new = x + alpha * p;
    const float r_new = live ? r - alpha * v : 0.0f;
    publish(rn_full, i, r_new, chain, C, bar_rr);
    publish_groups(part_rr, r_new * r_new, g, chain_warp, C, bar_rr);
    receive(bar_rr, vec_bytes, par_rr);
    const float z_new = precondition();
    publish(z_full, i, z_new, chain, C, bar_rz);
    publish_groups(part_rz, live ? r_new * z_new : 0.0f, g, chain_warp, C,
                   bar_rz);
    receive(bar_rz, vec_bytes, par_rz);
    const float rz_new = group_total(part_rz, G);

    const bool reject = fabsf(rz_new) > a.ratio * rz_min || isnan(rz_new);
    const float aa = fabsf(rz_new);
    rz_min = (isnan(aa) || isnan(rz_min)) ? NAN : fminf(rz_min, aa);
    const float beta = __fdiv_rn(rz_new, rz);
    const bool converged = fabsf(rz_new) < a.tol;
    ++k;
    if (!reject) {
      x = x_new;
      r = r_new;
      p = z_new + beta * p;
      z = z_new;
      rz = rz_new;
      for (int j = il; j < npad; j += kThreads) {
        p_full[j] = z_full[j] + beta * p_full[j];
      }
      __syncthreads();
    }
    done = reject || converged;
  }
  if (live) a.x_out[i] = x;
  if (rank == 0 && il == 0) *a.iters_out = k;
  cl.sync();  // no CTA leaves while another may still use the cluster
}

}  // namespace

// S, M: (n, n) float32 row-major; b, x: (n,) float32; iters: (1,) int32;
// cluster: the CTAs (1-16). Launches on `stream` and returns the CUDA
// error code (cudaErrorLaunchOutOfResources when one cluster of that size
// does not fit on the card).
extern "C" int gt_pcg_dense_f32(const void* S, const void* M, const void* b,
                                void* x, void* iters, int n, int max_iter,
                                float tol, float rejection_ratio,
                                int cluster, void* stream) {
  if (n <= 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.S = static_cast<const float*>(S);
  a.M = static_cast<const float*>(M);
  a.b = static_cast<const float*>(b);
  a.x_out = static_cast<float*>(x);
  a.iters_out = static_cast<int*>(iters);
  a.n = n;
  a.max_iter = max_iter;
  a.tol = tol;
  a.ratio = rejection_ratio;
  a.smem_bytes = max_dynamic_smem();
  return static_cast<int>(launch_cluster(pcg_dense_kernel, cluster, kThreads,
                                         a.smem_bytes,
                                         static_cast<cudaStream_t>(stream),
                                         a));
}

extern "C" const char* gt_pcg_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
