// K1: sorted segmented row sum on Hopper (sm_90a).
//
//   out[s, c] = sum over r in [offsets[s], offsets[s+1]) of vals[row(r), c]
//   row(r) = perm[r] when a permutation is given, else r
//
// Replaces two TPU kernels that compute this same function:
// graphite_tpu/ops/pallas/segsum.py (_kernel, sorted_segment_sum; output
// resident in VMEM) and graphite_tpu/ops/pallas/segsum_stream.py (_kernel,
// streaming_segment_sum; output streamed through a rolling VMEM window).
// On the TPU the reduction was a windowed one-hot matmul on the MXU with a
// host flush schedule; here each thread owns one (segment, column) output
// and walks that segment's rows, so no windows, flush plans or atomics are
// needed. The optional permutation lets unsorted destinations reuse the
// kernel without a separate gather pass.
//
// Bound: memory. The kernel reads about K*D*4 bytes of values (plus the
// permutation) and writes NS*D*4 bytes; it does one add per value read.
// Neighbouring threads handle neighbouring columns of the same segment,
// so each row read is coalesced across the D columns. The summation order
// is fixed (row order within a segment, fp32 accumulation, one write per
// output), so results are bitwise identical from run to run, and equal to
// the plain version on the CPU (index_add_ also adds rows in order).

#include <cuda_runtime.h>

namespace {

__global__ void segsum_rows_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ out,
                                   int num_segments, int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(num_segments) * d) return;
  const int s = static_cast<int>(t / d);
  const int c = static_cast<int>(t - static_cast<long long>(s) * d);
  const int r0 = offsets[s];
  const int r1 = offsets[s + 1];
  float acc = 0.0f;
  if (perm != nullptr) {
    for (int r = r0; r < r1; ++r) {
      acc += vals[static_cast<long long>(perm[r]) * d + c];
    }
  } else {
    for (int r = r0; r < r1; ++r) {
      acc += vals[static_cast<long long>(r) * d + c];
    }
  }
  out[t] = acc;
}

}  // namespace

// vals: (K, d) float32; perm: (K,) int32 or null; offsets: (num_segments+1,)
// int32; out: (num_segments, d) float32. Launches on `stream` and returns
// the cudaGetLastError() code (0 on success).
extern "C" int gt_segsum_f32(const void* vals, const void* perm,
                             const void* offsets, void* out,
                             int num_segments, int d, void* stream) {
  const long long total = static_cast<long long>(num_segments) * d;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  segsum_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<float*>(out),
      num_segments, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
