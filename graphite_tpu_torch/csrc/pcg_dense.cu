// K2: a whole block-Jacobi preconditioned CG solve in one launch, on Hopper
// (sm_90a).
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
// Design: one block of up to 1024 threads, n <= 1024. Thread i owns entry i
// of x, r, p, z in registers; p and the normalized residual y are shared
// through shared memory for the matvecs. Thread i reads column i of S and
// M (S[j*n + i] for j = 0..n-1), so each warp's loads are coalesced. S and
// M are read from global memory every iteration, where they stay in L2
// (2 x 778 KB at n = 441). Dot products use a fixed-order warp shuffle
// tree plus a shared-memory pass over the per-warp partials, so results
// are deterministic. All arithmetic is IEEE fp32 (no TF32, no fast math),
// and the file is built with -fmad=false: every product and sum is
// rounded on its own, so the plain version (ops/cuda/pcg_dense.py,
// dense_pcg_plain), which takes each operation in this order, gives the
// same bits on the CPU.
//
// Bound: one SM's load bandwidth from L2. Each iteration reads S and M
// once (2 * n^2 * 4 bytes); the rest of the card is idle. A cluster or a
// persistent multi-SM design would spread those reads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Sum of one float per thread over the block, in a fixed order. `red`
// holds 33 floats. Every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// (row vector in shared memory) @ A, entry i: sum_j vec[j] * A[j*n + i].
__device__ float vec_mat(const float* vec, const float* __restrict__ A,
                         int n, int i) {
  float acc = 0.0f;
  if (i < n) {
    for (int j = 0; j < n; ++j) {
      acc += vec[j] * A[static_cast<long long>(j) * n + i];
    }
  }
  return acc;
}

// z = (r / ||r||) @ M, with ||r|| == 0 treated as 1.
__device__ float precondition(float r, const float* __restrict__ M, int n,
                              float* y_sh, float* red) {
  const int i = threadIdx.x;
  const float rnorm = sqrtf(block_sum(r * r, red));
  const float y = r / (rnorm == 0.0f ? 1.0f : rnorm);
  if (i < n) y_sh[i] = y;
  __syncthreads();
  const float z = vec_mat(y_sh, M, n, i);
  __syncthreads();
  return z;
}

__global__ void pcg_dense_kernel(const float* __restrict__ S,
                                 const float* __restrict__ M,
                                 const float* __restrict__ b,
                                 float* __restrict__ x_out,
                                 int* __restrict__ iters_out, int n,
                                 int max_iter, float tol, float ratio) {
  extern __shared__ float sh[];  // p_sh: [0, n), y_sh: [n, 2n)
  __shared__ float red[33];
  float* p_sh = sh;
  float* y_sh = sh + n;
  const int i = threadIdx.x;
  const bool live = i < n;

  float x = 0.0f;
  float r = live ? b[i] : 0.0f;
  float z = precondition(r, M, n, y_sh, red);
  float p = z;
  float rz = block_sum(r * z, red);
  float rz_min = INFINITY;
  int k = 0;
  bool done = false;
  // rz, rz_min and done are equal in every thread (block-wide sums), so
  // the loop and its branches are uniform across the block.
  while (k < max_iter && !done && rz != 0.0f) {
    if (live) p_sh[i] = p;
    __syncthreads();
    const float v = vec_mat(p_sh, S, n, i);
    const float alpha = rz / block_sum(p * v, red);
    const float x_new = x + alpha * p;
    const float r_new = r - alpha * v;
    const float z_new = precondition(r_new, M, n, y_sh, red);
    const float rz_new = block_sum(r_new * z_new, red);

    const bool reject = fabsf(rz_new) > ratio * rz_min || isnan(rz_new);
    const float a = fabsf(rz_new);
    rz_min = (isnan(a) || isnan(rz_min)) ? NAN : fminf(rz_min, a);
    const float beta = rz_new / rz;
    const float p_new = z_new + beta * p;
    const bool converged = fabsf(rz_new) < tol;
    ++k;
    if (!reject) {
      x = x_new;
      r = r_new;
      p = p_new;
      z = z_new;
      rz = rz_new;
    }
    done = reject || converged;
  }
  if (live) x_out[i] = x;
  if (i == 0) *iters_out = k;
}

}  // namespace

// S, M: (n, n) float32 row-major; b, x: (n,) float32; iters: (1,) int32.
// Launches on `stream` and returns the cudaGetLastError() code.
extern "C" int gt_pcg_dense_f32(const void* S, const void* M, const void* b,
                                void* x, void* iters, int n, int max_iter,
                                float tol, float rejection_ratio,
                                void* stream) {
  if (n <= 0 || n > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((n + 31) / 32) * 32;
  const size_t shmem = 2 * static_cast<size_t>(n) * sizeof(float);
  pcg_dense_kernel<<<1, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(M),
      static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<int*>(iters), n, max_iter, tol, rejection_ratio);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_pcg_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
