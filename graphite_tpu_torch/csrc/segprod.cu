// K3: gathered triple product reduced over sorted segments, on Hopper
// (sm_90a).
//
//   out[s] = sum over r in [offsets[s], offsets[s+1]) of L[li[r]] R[ri[r]]^T
//
// L rows are flat row-major (m, k) blocks, R rows (n, k) blocks and out rows
// (m, n) blocks. A null li (ri) means the identity: the rows were gathered
// beforehand, one per r.
//
// Replaces two TPU kernels that compute this same function:
// graphite_tpu/ops/pallas/segsum_stream.py _kernel_prod
// (streaming_segment_product_sum; both operands pre-gathered streams) and
// _kernel_prod_rtbl (streaming_segment_product_sum_rtbl; the right operand
// read from a rolling window of a packed table). On the TPU the per-row
// product ran on the MXU through expansion one-hots and the reduction was a
// windowed one-hot matmul with a host flush schedule, all to fit VMEM. Here
// the Schur complement's S -= sum W_left R_right^T reads W and the Hessian's
// Hpl rows straight from their tables by index, and no (K, m*n) product is
// ever written to memory.
//
// Design: one thread per (segment, output block row a). It walks its
// segment's rows in order; per row it keeps L's row a (k values) in
// registers, reads R's n*k values through the read-only cache, and adds each
// p_b = sum_j L[a, j] R[b, j] (j in order; built with -fmad=false, so one
// rounding per product and per add) to its b-th accumulator. No atomics and
// a fixed order: results are bitwise the same from run to run, and equal to
// the plain version on the CPU (per-row products, then index_add_, which
// adds rows in order).
//
// Bound: at BAL Venice-1778, 17,048,613 rows into 1,580,797 segments of
// (9, 9) blocks, the kernel issues 9 + 81 float loads per row and thread
// group; the 9 threads of a segment read the same 27-float L and R rows, so
// the loads are served mostly by L1 and the bound is load instructions, not
// device-memory bytes (about 3.7 GB of unique rows).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 16;  // largest m, k and n the kernel takes

__global__ void segprod_kernel(const float* __restrict__ L,
                               const int* __restrict__ li,
                               const float* __restrict__ R,
                               const int* __restrict__ ri,
                               const int* __restrict__ offsets,
                               float* __restrict__ out, int num_segments,
                               int m, int k, int n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(num_segments) * m) return;
  const int s = static_cast<int>(t / m);
  const int a = static_cast<int>(t - static_cast<long long>(s) * m);
  const long long lw = static_cast<long long>(m) * k;
  const long long rw = static_cast<long long>(n) * k;

  float acc[kMaxDim];
#pragma unroll
  for (int b = 0; b < kMaxDim; ++b) acc[b] = 0.0f;

  const int r1 = offsets[s + 1];
  for (int r = offsets[s]; r < r1; ++r) {
    const long long lrow = li != nullptr ? __ldg(li + r) : r;
    const long long rrow = ri != nullptr ? __ldg(ri + r) : r;
    const float* lp = L + lrow * lw + static_cast<long long>(a) * k;
    const float* rp = R + rrow * rw;
    float lv[kMaxDim];
#pragma unroll
    for (int j = 0; j < kMaxDim; ++j) lv[j] = j < k ? __ldg(lp + j) : 0.0f;
#pragma unroll
    for (int b = 0; b < kMaxDim; ++b) {
      if (b < n) {
        const float* rb = rp + b * k;
        float p = lv[0] * __ldg(rb);
#pragma unroll
        for (int j = 1; j < kMaxDim; ++j) {
          if (j < k) p = p + lv[j] * __ldg(rb + j);
        }
        acc[b] = acc[b] + p;
      }
    }
  }
  float* o = out + (static_cast<long long>(s) * m + a) * n;
#pragma unroll
  for (int b = 0; b < kMaxDim; ++b) {
    if (b < n) o[b] = acc[b];
  }
}

}  // namespace

// L: (*, m*k) float32; li: (rows,) int32 or null; R: (*, n*k) float32;
// ri: (rows,) int32 or null; offsets: (num_segments+1,) int32 over the
// destination-sorted rows; out: (num_segments, m*n) float32. m, k, n <= 16.
// Launches on `stream` and returns the cudaGetLastError() code.
extern "C" int gt_segprod_f32(const void* L, const void* li, const void* R,
                              const void* ri, const void* offsets, void* out,
                              int num_segments, int m, int k, int n,
                              void* stream) {
  if (m < 1 || k < 1 || n < 1 || m > kMaxDim || k > kMaxDim ||
      n > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(num_segments) * m;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  segprod_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const int*>(li),
      static_cast<const float*>(R), static_cast<const int*>(ri),
      static_cast<const int*>(offsets), static_cast<float*>(out),
      num_segments, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_segprod_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
