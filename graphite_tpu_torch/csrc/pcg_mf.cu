// K6: a whole matrix-free preconditioned CG solve in one launch, on Hopper
// (sm_90a).
//
// Replaces graphite_tpu/ops/pallas/pcg_mf.py (_kernel, solve_pcg_mf), which
// held the folded Jacobian and the CG vectors in VMEM as slot-packed
// 128-lane tables. It solves (J'^T J' + diag(damp)) x = b on the rows of
// one vertex type, where J' = sqrt(max(dL, 0)) chol(P)^T J is the folded
// Jacobian of every factor block (folded by the wrapper), with the
// block-Jacobi inverse blocks (or the identity) as preconditioner.
// Semantics follow graphite_tpu_torch/ops/pcg_loop.run_pcg step for step:
//   - the residual is normalized before each preconditioner application;
//   - a step with |rz_new| > rejection_ratio * rz_min (or a NaN rz_new) is
//     rejected: x, r, p, z and rz keep their previous values and the loop
//     stops;
//   - rz_min starts at +inf and is a running minimum of |rz_new|;
//   - the loop stops on |rz_new| < tol, and never starts a step while
//     rz == 0.
//
// Design: one block of 1024 threads, no grid-wide sync. J', the slot rows,
// the row CSR of the (factor, slot) incidences and the inverse blocks are
// read from global memory, where they stay in L2 (the plan admits at most
// 6 MiB of J'). The vectors x, r, p, z, the candidates r_new, z_new, H p
// and the per-factor J' p live in a global scratch buffer; p carries one
// zero trash row (index n), where the slots of fixed vertices point. A CG
// step is a sequence of phases separated by __syncthreads():
//   1. v_f = sum_s J'_{f,s} p[row_s]: one thread per (factor, residual
//      row), slots then columns in order;
//   2. Hp[row] = damp * p + sum over the row's incidences, in CSR order,
//      of J'_{f,s}^T v_f: one thread per (row, column), no atomics;
//   3. dots in pcg_loop.tree_sum's order: groups of 32 entries by a
//      shuffle-down halving tree, then the group sums the same way, level
//      after level (partials in shared memory);
//   4. the vector updates, one thread per entry;
//   5. z = M_row (r / ||r||), the products taken in column order.
// All arithmetic is IEEE fp32 and the file is built with -fmad=false, so
// the plain version (ops/cuda/pcg_mf.py, solve_pcg_mf_plain), which takes
// every product, sum and dot in this order, gives the same bits.
//
// Bound: each step re-reads J' (~0.8 MB at sphere2500) from L2 twice with
// one SM, and waits on ~20 block-wide barriers; the card's other SMs are
// idle. The operations of a 50-step solve take ~1 us at the card's fp32
// rate. A multi-SM (cluster or persistent) design is the speed work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kDesc = 6;  // jbase, vbase, rbase, F, E, arity

// Dynamic shared memory: the dot partials of the first two tree_sum levels
// (ceil(N/32) + ceil(N/1024) floats), then the block descriptors.
__host__ __device__ inline long long partial_floats(long long N) {
  const long long g1 = (N + 31) / 32;
  return g1 + (g1 + 31) / 32;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One level of tree_sum: values val(0..m) -> ceil(m/32) group sums in
// `out` (at least one). Every thread of the block must call it.
template <class Val>
__device__ int tree_level(Val val, int m, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int groups = m > 0 ? (m + 31) >> 5 : 1;
  for (int g = warp; g < groups; g += nwarps) {
    const int i = (g << 5) + lane;
    const float v = warp_sum(i < m ? val(i) : 0.0f);
    if (lane == 0) out[g] = v;
  }
  __syncthreads();
  return groups;
}

// sum over i < m of a[i] * b[i] in pcg_loop.tree_dot's order; the same
// value in every thread.
__device__ float tree_dot(const float* a, const float* b, int m, float* buf0,
                          float* buf1) {
  int k = tree_level([=](int i) { return a[i] * b[i]; }, m, buf0);
  float* src = buf0;
  float* dst = buf1;
  for (int levels = 1; levels < 2 || k > 1; ++levels) {
    const float* s = src;
    k = tree_level([=](int i) { return s[i]; }, k, dst);
    float* t = src;
    src = dst;
    dst = t;
  }
  const float out = src[0];
  __syncthreads();
  return out;
}

// z = M_row (r / ||r||) (the identity when minv is null), ||r|| == 0
// taken as 1.
__device__ void precondition(const float* r, float* z,
                             const float* __restrict__ minv, int n, int d,
                             float* buf0, float* buf1) {
  const int N = n * d;
  const float rnorm = __fsqrt_rn(tree_dot(r, r, N, buf0, buf1));
  const float s = rnorm == 0.0f ? 1.0f : rnorm;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (minv == nullptr) {
      z[i] = __fdiv_rn(r[i], s);
      continue;
    }
    const int row = i / d;
    const int c = i - row * d;
    const float* m = minv + static_cast<long long>(row) * d * d + c * d;
    const float* rr = r + static_cast<long long>(row) * d;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) acc += m[j] * __fdiv_rn(rr[j], s);
    z[i] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) pcg_mf_kernel(
    const float* __restrict__ jf, const int* __restrict__ rows,
    const int* __restrict__ desc_g, int nb, const int* __restrict__ csr_off,
    const int* __restrict__ inc_j, const int* __restrict__ inc_v,
    const int* __restrict__ inc_e, const float* __restrict__ b,
    const float* __restrict__ damp, const float* __restrict__ minv,
    float* __restrict__ work, float* __restrict__ x_out,
    int* __restrict__ iters_out, int n, int d, int max_iter, float tol,
    float ratio) {
  extern __shared__ float red[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int N = n * d;
  const int NP = N + d;  // one trash row
  float* buf0 = red;
  float* buf1 = red + ((N + 31) >> 5);
  int* desc = reinterpret_cast<int*>(red + partial_floats(N));
  for (int i = tid; i < nb * kDesc; i += nt) desc[i] = desc_g[i];

  float* x = work;
  float* r = x + NP;
  float* p = r + NP;
  float* z = p + NP;
  float* rn = z + NP;
  float* zn = rn + NP;
  float* hp = zn + NP;
  float* v = hp + NP;
  for (int i = tid; i < N; i += nt) {
    x[i] = 0.0f;
    r[i] = b[i];
  }
  for (int i = tid; i < d; i += nt) p[N + i] = 0.0f;
  __syncthreads();

  precondition(r, z, minv, n, d, buf0, buf1);
  for (int i = tid; i < N; i += nt) p[i] = z[i];
  __syncthreads();
  float rz = tree_dot(r, z, N, buf0, buf1);
  float rz_min = INFINITY;
  int k = 0;
  bool done = false;
  // rz, rz_min and done are equal in every thread (block-wide sums), so
  // the loop and its branches are uniform across the block.
  while (k < max_iter && !done && rz != 0.0f) {
    // 1. v = J' p per factor block
    for (int bi = 0; bi < nb; ++bi) {
      const int* ds = desc + bi * kDesc;
      const int jbase = ds[0], vbase = ds[1], rbase = ds[2];
      const int F = ds[3], E = ds[4], arity = ds[5];
      const int W = arity * E * d;
      for (int q = tid; q < F * E; q += nt) {
        const int f = q / E;
        const int e = q - f * E;
        float acc = 0.0f;
        for (int s = 0; s < arity; ++s) {
          const float* jr =
              jf + jbase + static_cast<long long>(f) * W + (s * E + e) * d;
          const float* pr =
              p + static_cast<long long>(rows[rbase + s * F + f]) * d;
          for (int j = 0; j < d; ++j) acc += jr[j] * pr[j];
        }
        v[vbase + q] = acc;
      }
    }
    __syncthreads();
    // 2. Hp = damp * p + J'^T v, each row's incidences in CSR order
    for (int i = tid; i < N; i += nt) {
      const int row = i / d;
      const int c = i - row * d;
      float acc = 0.0f;
      for (int t = csr_off[row]; t < csr_off[row + 1]; ++t) {
        const float* jc = jf + inc_j[t] + c;
        const float* vf = v + inc_v[t];
        const int E = inc_e[t];
        float g = 0.0f;
        for (int e = 0; e < E; ++e) g += jc[e * d] * vf[e];
        acc += g;
      }
      hp[i] = damp[i] * p[i] + acc;
    }
    __syncthreads();
    const float alpha = __fdiv_rn(rz, tree_dot(p, hp, N, buf0, buf1));
    for (int i = tid; i < N; i += nt) rn[i] = r[i] - alpha * hp[i];
    __syncthreads();
    precondition(rn, zn, minv, n, d, buf0, buf1);
    const float rz_new = tree_dot(rn, zn, N, buf0, buf1);

    const bool reject = fabsf(rz_new) > ratio * rz_min || isnan(rz_new);
    const float a = fabsf(rz_new);
    rz_min = (isnan(a) || isnan(rz_min)) ? NAN : fminf(rz_min, a);
    const float beta = __fdiv_rn(rz_new, rz);
    const bool converged = fabsf(rz_new) < tol;
    ++k;
    if (!reject) {
      for (int i = tid; i < N; i += nt) {
        x[i] = x[i] + alpha * p[i];
        p[i] = zn[i] + beta * p[i];
      }
      float* t = r;
      r = rn;
      rn = t;
      t = z;
      z = zn;
      zn = t;
      rz = rz_new;
    }
    __syncthreads();
    done = reject || converged;
  }
  for (int i = tid; i < N; i += nt) x_out[i] = x[i];
  if (tid == 0) *iters_out = k;
}

}  // namespace

// jf: folded J' of every factor block, block b at desc[b][0], row-major
// (F, arity*E*d); rows: per block and slot the (F,) vertex rows (n for a
// fixed vertex), block b's slot s at desc[b][2] + s*F; desc: (nb, 6) int32
// (jbase, vbase, rbase, F, E, arity); csr_off (n+1), inc_j / inc_v / inc_e
// (incidences): the J' offset of (f, s), the v offset of f and E, sorted
// by row then by (block, slot, factor); b, damp, x: (n*d,); minv: (n, d*d)
// row-major or null; work: 7*(n+1)*d + sum F*E floats; iters: (1,) int32.
// Launches on `stream` and returns the cudaGetLastError() code (an error
// when the partials and descriptors exceed the card's shared memory).
extern "C" int gt_pcg_mf_f32(const void* jf, const void* rows,
                             const void* desc, int nb, const void* csr_off,
                             const void* inc_j, const void* inc_v,
                             const void* inc_e, const void* b,
                             const void* damp, const void* minv, void* work,
                             void* x, void* iters, int n, int d, int max_iter,
                             float tol, float rejection_ratio, void* stream) {
  const long long N = static_cast<long long>(n) * d;
  if (nb < 1 || n < 1 || d < 1 || N > (1 << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shmem = static_cast<size_t>(partial_floats(N)) * sizeof(float) +
                       static_cast<size_t>(nb) * kDesc * sizeof(int);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pcg_mf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pcg_mf_kernel<<<1, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(jf), static_cast<const int*>(rows),
      static_cast<const int*>(desc), nb, static_cast<const int*>(csr_off),
      static_cast<const int*>(inc_j), static_cast<const int*>(inc_v),
      static_cast<const int*>(inc_e), static_cast<const float*>(b),
      static_cast<const float*>(damp), static_cast<const float*>(minv),
      static_cast<float*>(work), static_cast<float*>(x),
      static_cast<int*>(iters), n, d, max_iter, tol, rejection_ratio);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_pcg_mf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
