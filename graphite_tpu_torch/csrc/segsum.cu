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
// host flush schedule; here no windows, flush plans or atomics are needed.
// The optional permutation lets unsorted destinations reuse the kernel
// without a separate gather pass. K5 (segmv.cu) runs this kernel as its
// second pass, over the row products of the S blocks.
//
// The order (also K4's and K5's): a segment is summed by G lanes, G a power
// of two chosen on the host from the mean segment length (segsum.py,
// group_size). Lane l sums the segment's sorted rows l, l+G, l+2G, ... in
// order; the G lane sums are then combined by a halving tree (lane l +=
// lane l+h, h = G/2, ..., 1). The order is fixed, so results are bitwise
// the same from run to run, and the plain version (segsum.py, lane_sum)
// adds in the same order, so they equal it bitwise on the CPU.
//
// Bound: memory. The kernel reads about K*D*sizeof(T) bytes of values
// (plus the permutation) and writes NS*D*sizeof(T) bytes; it does one add
// per value read.
//
// Both kernels are templates over the value type T: float (gt_segsum_f32)
// and double (gt_segsum_f64, the float64 sites of the FP64 policies). The
// plan, the lanes per segment, the threads and the halving tree are the
// same for both; a double takes twice the registers and shared memory of
// a float (at most 512 threads x 3 columns x 8 bytes = 12 KiB of tree).
// Values are read one scalar at a time (no vector loads), so a row needs
// only T's own alignment.
//
// G = 1 (short segments: landmarks, pose-graph rows): one thread owns one
// (segment, column) and walks the segment's rows; neighbouring threads
// take neighbouring columns, so each row read is coalesced.
//
// G > 1 (long segments: a camera's ~600-2,800 rows, read through the
// permutation): one thread walking 2,800 dependent adds left most of the
// card idle, so the rows are summed in parallel too. A CTA takes one
// segment (or a few short ones) and up to 96 columns (all 81 of a 9x9
// block). Its threads are (slot q, column c), c fastest: the ct threads of
// a slot read ct consecutive floats of a row, C times for rows wider than
// 32 (C * ct >= the CTA's columns), so each row is read whole, at once, as
// C coalesced loads. Q slots (a power of two, Q * ct <= 512 threads) hold
// the G lanes: slot q owns lanes q, q+Q, ..., G/Q of them, with one
// register accumulator per (lane, column) and their loads issued together.
// The lane tree runs in registers for the levels h >= Q and through
// shared memory below.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 96;      // most columns a CTA sums
constexpr int kMaxThreads = 512;  // most threads of a CTA (slots x ct)
constexpr int kMinThreads = 256;  // short segments share a CTA up to this

template <typename T>
__global__ void segsum_rows_kernel(const T* __restrict__ vals,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ offsets,
                                   T* __restrict__ out,
                                   int num_segments, int d) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(num_segments) * d) return;
  const int s = static_cast<int>(t / d);
  const int c = static_cast<int>(t - static_cast<long long>(s) * d);
  const int r0 = offsets[s];
  const int r1 = offsets[s + 1];
  T acc = T(0);
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

// The value row at sorted position r of a segment ending at r1, or -1.
__device__ __forceinline__ int sorted_row(const int* __restrict__ perm,
                                          int r, int r1) {
  return r < r1 ? (perm != nullptr ? __ldg(perm + r) : r) : -1;
}

// L lanes and C columns per thread: G = Q * L lanes per segment, columns
// c + u * ct (u < C) of the CTA's tile of tw columns. blockDim.x = spc * Q
// * ct; the CTA sums segments blockIdx.x * spc + [0, spc), columns
// blockIdx.y * tw + [0, tw). Dynamic shared memory: blockDim.x * C values
// of T (the lane tree).
template <typename T, int L, int C>
__global__ void segsum_lanes_kernel(const T* __restrict__ vals,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ offsets,
                                    T* __restrict__ out,
                                    int num_segments, int d, int tw, int ct,
                                    int q_log2, int spc) {
  // one buffer of the widest type, viewed as T: a template cannot
  // declare the same extern shared array with two types
  extern __shared__ double tree_storage[];
  T* tree = reinterpret_cast<T*>(tree_storage);
  const int Q = 1 << q_log2;
  const int G = Q * L;
  const int per_seg = Q * ct;
  const int sub = threadIdx.x / per_seg;
  const int t = threadIdx.x - sub * per_seg;
  const int q = t / ct;
  const int c = t - q * ct;
  const long long s = static_cast<long long>(blockIdx.x) * spc + sub;
  const bool live = s < num_segments;
  int col[C];
  bool has[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    col[u] = blockIdx.y * tw + c + u * ct;
    has[u] = c + u * ct < tw && col[u] < d;
  }

  T acc[L][C];
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int u = 0; u < C; ++u) acc[j][u] = T(0);
  }
  if (live) {
    const int r1 = offsets[s + 1];
    // lane q + j*Q takes sorted row base + j*Q of each round; the next
    // round's rows are fetched before this round's values are read
    int row[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      row[j] = sorted_row(perm, offsets[s] + q + j * Q, r1);
    }
    for (int base = offsets[s] + q; base < r1; base += G) {
      int next[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        next[j] = sorted_row(perm, base + G + j * Q, r1);
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (row[j] < 0) continue;
        const T* v = vals + static_cast<long long>(row[j]) * d;
#pragma unroll
        for (int u = 0; u < C; ++u) {
          if (has[u]) acc[j][u] = acc[j][u] + __ldg(v + col[u]);
        }
      }
#pragma unroll
      for (int j = 0; j < L; ++j) row[j] = next[j];
    }
  }

  // the tree's levels h = G/2, ..., Q: lane q + j*Q += lane q + (j+h/Q)*Q,
  // both in this thread
#pragma unroll
  for (int h = L / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
#pragma unroll
      for (int u = 0; u < C; ++u) acc[j][u] = acc[j][u] + acc[j + h][u];
    }
  }
  // levels h = Q/2, ..., 1: slot q += slot q+h, through shared memory
  T* mine = tree + (sub * per_seg + c) * C;
  for (int h = Q >> 1; h >= 1; h >>= 1) {
    if (q >= h && q < 2 * h) {
#pragma unroll
      for (int u = 0; u < C; ++u) mine[q * ct * C + u] = acc[0][u];
    }
    __syncthreads();
    if (q < h) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        acc[0][u] = acc[0][u] + mine[(q + h) * ct * C + u];
      }
    }
    __syncthreads();
  }
  if (live && q == 0) {
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (has[u]) out[s * d + col[u]] = acc[0][u];
    }
  }
}

template <typename T>
struct LanesLaunch {
  dim3 grid;
  int threads;
  cudaStream_t stream;
  const T* vals;
  const int* perm;
  const int* offsets;
  T* out;
  int num_segments, d, tw, ct, q_log2, spc;
};

template <typename T, int L, int C>
cudaError_t launch_lanes(const LanesLaunch<T>& a) {
  segsum_lanes_kernel<T, L, C>
      <<<a.grid, a.threads, a.threads * C * sizeof(T), a.stream>>>(
          a.vals, a.perm, a.offsets, a.out, a.num_segments, a.d, a.tw, a.ct,
          a.q_log2, a.spc);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_lanes_c(const LanesLaunch<T>& a, int l_log2) {
  switch (l_log2) {
    case 0: return launch_lanes<T, 1, C>(a);
    case 1: return launch_lanes<T, 2, C>(a);
    case 2: return launch_lanes<T, 4, C>(a);
    case 3: return launch_lanes<T, 8, C>(a);
    case 4: return launch_lanes<T, 16, C>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int segsum(const void* vals_, const void* perm_, const void* offsets_,
           void* out_, int num_segments, int d, int group_log2,
           void* stream_) {
  if (group_log2 < 0 || group_log2 > 8 || d < 0 || num_segments < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(num_segments) * d;
  if (total == 0) return 0;
  const auto* vals = static_cast<const T*>(vals_);
  const auto* perm = static_cast<const int*>(perm_);
  const auto* offsets = static_cast<const int*>(offsets_);
  auto* out = static_cast<T*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (group_log2 == 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    segsum_rows_kernel<T>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            vals, perm, offsets, out, num_segments, d);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (d + kMaxCols - 1) / kMaxCols;
  const int tw = (d + tiles - 1) / tiles;  // columns of a CTA
  const int C = (tw + 31) / 32;            // loads per row and slot
  const int ct = (tw + C - 1) / C;         // threads per slot
  int q_log2 = 0;  // Q: the most slots that fit, at most G
  while (q_log2 < group_log2 && (ct << (q_log2 + 1)) <= kMaxThreads) {
    ++q_log2;
  }
  const int per_seg = ct << q_log2;
  const int spc = per_seg >= kMinThreads ? 1 : kMinThreads / per_seg;
  const LanesLaunch<T> a{dim3((num_segments + spc - 1) / spc, tiles),
                         spc * per_seg, stream, vals, perm, offsets, out,
                         num_segments, d, tw, ct, q_log2, spc};
  const int l_log2 = group_log2 - q_log2;  // L = G / Q lanes per thread
  cudaError_t err;
  switch (C) {
    case 1: err = launch_lanes_c<T, 1>(a, l_log2); break;
    case 2: err = launch_lanes_c<T, 2>(a, l_log2); break;
    case 3: err = launch_lanes_c<T, 3>(a, l_log2); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// vals: (K, d) float32; perm: (K,) int32 or null; offsets: (num_segments+1,)
// int32; out: (num_segments, d) float32; 2^group_log2 <= 256 lanes per
// segment. Launches on `stream` and returns the cudaGetLastError() code (0
// on success).
extern "C" int gt_segsum_f32(const void* vals, const void* perm,
                             const void* offsets, void* out,
                             int num_segments, int d, int group_log2,
                             void* stream) {
  return segsum<float>(vals, perm, offsets, out, num_segments, d, group_log2,
                       stream);
}

// The same with vals and out float64.
extern "C" int gt_segsum_f64(const void* vals, const void* perm,
                             const void* offsets, void* out,
                             int num_segments, int d, int group_log2,
                             void* stream) {
  return segsum<double>(vals, perm, offsets, out, num_segments, d,
                        group_log2, stream);
}

extern "C" const char* gt_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
