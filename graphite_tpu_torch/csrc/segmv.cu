// K4 and K5: gathered block matvecs reduced over segments, on Hopper
// (sm_90a).
//
// K4 (gt_segmv_f32):
//   y[s] = sum over r in [offsets[s], offsets[s+1]) of op(A[row]) x[xi[row]]
//   row = perm[r] when a permutation is given (unsorted destinations), else r
//   op(A) = A (m, k) or, with `transpose`, A^T (k, m)
// A null xi means the identity (x was gathered beforehand, one row per A
// row). An x index outside [0, n_x) reads a zero row: masked and padded rows
// contribute nothing.
//
// K5 (gt_segmv_sym_f32): the symmetric block-sparse S matvec over the
// stored upper triangle, both halves in one launch:
//   y_r[rid_b] += S_b x_c[cid_b]       for every stored block b
//   y_c[cid_b] += S_b^T x_r[rxi_b]     rxi_b = rid_b off the diagonal, and a
//                                      zero row for diagonal blocks
// Each half is a K4 problem: the row half reads the blocks through a
// host-built row-sorted permutation, the column half in the stored (CSC,
// column-sorted) order. The caller adds the two halves.
//
// Replaces graphite_tpu/ops/pallas/segsum_stream.py _kernel_mv_tbl
// (streaming_matvec_tbl: the landmark back-substitution), ops/pallas/segmv.py
// _kernel_stream (block_matvec_stream) and _kernel_wtbl (block_matvec_wtbl:
// b_schur), all K4, and segmv.py _kernel_sym (matvec_sym_stream: the PCG
// matvec), K5. The TPU kernels gathered x rows by one-hot MXU products from
// slot-packed VMEM tables, reduced few destinations by transposed one-hot
// matmuls and many sorted ones through a windowed flush schedule. On the GPU
// a thread reads its x row by index and no windows or plans are needed.
//
// Design: a segment is reduced by a group of G threads (a power of two up
// to 256, chosen on the host from the mean segment length: one thread for
// the ~5 rows of a landmark, 128-256 threads for the ~900-2,800 rows of a
// pose row). Lane l of a group sums the segment's rows l, l+G, l+2G, ... in
// order; the G partial sums are then combined by a halving tree (lane l adds
// lane l+h, h = G/2, ..., 1) through shared memory down to one warp and by
// warp shuffles below. The order is fixed, so results are bitwise the same
// from run to run, and the plain version (segmv.py) adds in the same order,
// so they equal it bitwise on the CPU. Built with -fmad=false: one rounding
// per product and per add, as the plain version's elementwise products.
//
// Bound: device-memory bytes. Each row reads its m*k block once (and its x
// row, mostly from L1/L2: the pose x tables are a few hundred KB); the
// Venice-1778 PCG matvec reads the 512 MB of S values twice (once per half),
// b_schur and the back-substitution 540 MB of Hpl values each.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 16;  // largest m and k the kernels take
constexpr int kBlock = 256;  // threads per block; a group never spans blocks

struct Half {
  const float* A;       // (rows, m*k)
  const int* xi;        // (rows,) x row of each A row, or null (identity)
  const float* x;       // (n_x, m or k)
  int n_x;
  const int* perm;      // (rows,) sorted position -> A row, or null
  const int* offsets;   // (num_segments + 1,) over the sorted positions
  float* out;           // (num_segments, k or m)
  int num_segments;
  int transpose;
  int group_log2;
};

// One group of G = 2^group_log2 threads reduces segment gtid >> group_log2.
// Every thread of the block calls this (the tree synchronises the block).
__device__ void segmv_group(const Half& h, int m, int k, long long gtid,
                            float (*smem)[kMaxDim + 1]) {
  const int G = 1 << h.group_log2;
  const long long seg = gtid >> h.group_log2;
  const int lane = static_cast<int>(gtid & (G - 1));
  const bool live = seg < h.num_segments;
  const int d = h.transpose ? k : m;   // outputs per segment
  const int xd = h.transpose ? m : k;  // x row width
  const long long aw = static_cast<long long>(m) * k;

  float acc[kMaxDim];
#pragma unroll
  for (int i = 0; i < kMaxDim; ++i) acc[i] = 0.0f;

  if (live) {
    const int s = static_cast<int>(seg);
    const int r1 = h.offsets[s + 1];
    for (int r = h.offsets[s] + lane; r < r1; r += G) {
      const int row = h.perm != nullptr ? __ldg(h.perm + r) : r;
      const int xrow = h.xi != nullptr ? __ldg(h.xi + row) : row;
      const bool valid = xrow >= 0 && xrow < h.n_x;
      const float* xp = h.x + static_cast<long long>(xrow) * xd;
      float xv[kMaxDim];
#pragma unroll
      for (int j = 0; j < kMaxDim; ++j) {
        xv[j] = (valid && j < xd) ? __ldg(xp + j) : 0.0f;
      }
      const float* a = h.A + static_cast<long long>(row) * aw;
      if (!h.transpose) {
        // acc[i] += sum_j A[i, j] x[j]
#pragma unroll
        for (int i = 0; i < kMaxDim; ++i) {
          if (i < m) {
            float p = __ldg(a + i * k) * xv[0];
#pragma unroll
            for (int j = 1; j < kMaxDim; ++j) {
              if (j < k) p = p + __ldg(a + i * k + j) * xv[j];
            }
            acc[i] = acc[i] + p;
          }
        }
      } else {
        // acc[j] += sum_i A[i, j] x[i]
#pragma unroll
        for (int j = 0; j < kMaxDim; ++j) {
          if (j < k) {
            float p = __ldg(a + j) * xv[0];
#pragma unroll
            for (int i = 1; i < kMaxDim; ++i) {
              if (i < m) p = p + __ldg(a + i * k + j) * xv[i];
            }
            acc[j] = acc[j] + p;
          }
        }
      }
    }
  }

  // halving tree: lane l adds lane l + off, off = G/2, ..., 1; through
  // shared memory while the partner is in another warp
  for (int off = G >> 1; off >= 32; off >>= 1) {
    if (lane >= off && lane < 2 * off) {
#pragma unroll
      for (int i = 0; i < kMaxDim; ++i) smem[threadIdx.x][i] = acc[i];
    }
    __syncthreads();
    if (lane < off) {
#pragma unroll
      for (int i = 0; i < kMaxDim; ++i) {
        acc[i] = acc[i] + smem[threadIdx.x + off][i];
      }
    }
    __syncthreads();
  }
  const int width = G < 32 ? G : 32;
  const int wl = lane & (width - 1);
  for (int off = width >> 1; off >= 1; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kMaxDim; ++i) {
      const float other = __shfl_down_sync(0xffffffffu, acc[i], off, width);
      if (wl < off) acc[i] = acc[i] + other;
    }
  }

  if (live && lane == 0) {
    float* o = h.out + seg * d;
#pragma unroll
    for (int i = 0; i < kMaxDim; ++i) {
      if (i < d) o[i] = acc[i];
    }
  }
}

long long blocks_for(const Half& h) {
  const long long threads =
      static_cast<long long>(h.num_segments) << h.group_log2;
  return (threads + kBlock - 1) / kBlock;
}

__global__ void __launch_bounds__(kBlock)
    segmv_kernel(Half h, int m, int k) {
  __shared__ float smem[kBlock][kMaxDim + 1];
  const long long gtid = static_cast<long long>(blockIdx.x) * kBlock +
                         threadIdx.x;
  segmv_group(h, m, k, gtid, smem);
}

// blocks [0, row_blocks) reduce the row half, the rest the column half
__global__ void __launch_bounds__(kBlock)
    segmv_sym_kernel(Half rows, Half cols, long long row_blocks, int m,
                     int k) {
  __shared__ float smem[kBlock][kMaxDim + 1];
  const long long b = blockIdx.x;
  if (b < row_blocks) {
    segmv_group(rows, m, k, b * kBlock + threadIdx.x, smem);
  } else {
    segmv_group(cols, m, k, (b - row_blocks) * kBlock + threadIdx.x, smem);
  }
}

bool bad_shape(int m, int k, int group_log2) {
  return m < 1 || k < 1 || m > kMaxDim || k > kMaxDim || group_log2 < 0 ||
         (1 << group_log2) > kBlock;
}

}  // namespace

// A: (rows, m*k) float32; xi: (rows,) int32 or null; x: (n_x, k) float32,
// or (n_x, m) with `transpose`; perm: (rows,) int32 or null; offsets:
// (num_segments+1,) int32; out: (num_segments, m), or (num_segments, k)
// with `transpose`, float32. m, k <= 16; 2^group_log2 <= 256 threads per
// segment. Launches on `stream` and returns the cudaGetLastError() code.
extern "C" int gt_segmv_f32(const void* A, const void* xi, const void* x,
                            int n_x, const void* perm, const void* offsets,
                            void* out, int num_segments, int m, int k,
                            int transpose, int group_log2, void* stream) {
  if (bad_shape(m, k, group_log2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Half h{static_cast<const float*>(A), static_cast<const int*>(xi),
               static_cast<const float*>(x), n_x,
               static_cast<const int*>(perm),
               static_cast<const int*>(offsets), static_cast<float*>(out),
               num_segments, transpose, group_log2};
  const long long blocks = blocks_for(h);
  if (blocks == 0) return 0;
  segmv_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(h, m, k);
  return static_cast<int>(cudaGetLastError());
}

// S: (rows, m*k) float32 stored blocks. Row half: x_c (n_xc, k), cid
// (rows,), perm_r / off_r the row-sorted plan, y_r (ns_r, m). Column half:
// x_r (n_xr, m), rxi (rows,), perm_c (or null) / off_c, y_c (ns_c, k). Each
// half has its own threads per segment (2^glog). Returns the
// cudaGetLastError() code.
extern "C" int gt_segmv_sym_f32(const void* S, int m, int k, const void* xc,
                                int n_xc, const void* cid,
                                const void* perm_r, const void* off_r,
                                void* yr, int ns_r, int glog_r,
                                const void* xr, int n_xr, const void* rxi,
                                const void* perm_c, const void* off_c,
                                void* yc, int ns_c, int glog_c,
                                void* stream) {
  if (bad_shape(m, k, glog_r) || bad_shape(m, k, glog_c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* s = static_cast<const float*>(S);
  const Half rows{s, static_cast<const int*>(cid),
                  static_cast<const float*>(xc), n_xc,
                  static_cast<const int*>(perm_r),
                  static_cast<const int*>(off_r), static_cast<float*>(yr),
                  ns_r, 0, glog_r};
  const Half cols{s, static_cast<const int*>(rxi),
                  static_cast<const float*>(xr), n_xr,
                  static_cast<const int*>(perm_c),
                  static_cast<const int*>(off_c), static_cast<float*>(yc),
                  ns_c, 1, glog_c};
  const long long row_blocks = blocks_for(rows);
  const long long blocks = row_blocks + blocks_for(cols);
  if (blocks == 0) return 0;
  segmv_sym_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(rows, cols,
                                                          row_blocks, m, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_segmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
