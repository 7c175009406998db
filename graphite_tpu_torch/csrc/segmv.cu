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
// K5 (gt_segmv_sym_f32 and K1): the symmetric block-sparse S matvec over
// the stored upper triangle:
//   y_r[rid_b] += S_b x_c[cid_b]       for every stored block b
//   y_c[cid_b] += S_b^T x_r[rxi_b]     rxi_b = rid_b off the diagonal, and a
//                                      zero row for diagonal blocks
// The caller adds the two halves.
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
// The order: a segment is reduced by a group of G lanes (a power of two up
// to 256, chosen on the host from the mean segment length: one thread for
// the ~5 rows of a landmark, 128-256 threads for the ~900-2,800 rows of a
// pose row). Lane l of a group sums the segment's rows l, l+G, l+2G, ... in
// order; the G partial sums are then combined by a halving tree (lane l adds
// lane l+h, h = G/2, ..., 1) through shared memory down to one warp and by
// warp shuffles below. It is K1's order (segsum.cu). The order is fixed, so
// results are bitwise the same from run to run, and the plain versions
// (segmv.py, segsum.py) add in the same order, so they equal the kernels
// bitwise on the CPU. Built with -fmad=false: one rounding per product and
// per add, as the plain versions' elementwise products.
//
// Bound: device-memory bytes. K4 reads each row's m*k block once (and its x
// row, mostly from L1/L2: the pose x tables are a few hundred KB): b_schur
// and the back-substitution read 540 MB of Hpl values each at Venice-1778.
//
// K5 reads S once for both halves (the TPU kernel did too): 512 MB at
// Venice-1778. Pass 1 (sym_cols_kernel) walks the stored, column-sorted
// order: a CTA of G threads per column segment (longest segments first, an
// order built on the host) stages G blocks at a time into shared memory
// with coalesced 4-byte cp.async copies (no alignment needed for the
// 324-byte 9x9 blocks), double-buffered. Lane l takes block l of the tile
// (a stride of 81 words: no bank conflicts) and computes both products:
// S_b^T x_r[rxi_b], added to the lane's column sum in the order above, and
// p_b = S_b x_c[cid_b], written to a (rows, m) scratch P by stored block.
// Pass 2 is K1 over P with the row-sorted plan: each p_b is the value the
// old row half added, computed the same way, and K1's lanes add in the row
// half's order, so y_r is bitwise what a K4-style row half gives. P's
// round trip (2 x 57 MB at Venice-1778) is the design's own overhead.

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

// The halving tree of a group of G lanes (G consecutive threads of the
// block): lane l adds lane l + off, off = G/2, ..., 1; through shared
// memory (one row of `smem` per thread) while the partner is in another
// warp, by warp shuffles below. Every thread of the block calls it.
__device__ void lane_tree(float (&acc)[kMaxDim], int lane, int G,
                          float (*smem)[kMaxDim + 1]) {
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

}

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

  lane_tree(acc, lane, G, smem);

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

// K5's pass 1 over the stored blocks in column-sorted order.
struct SymCols {
  const float* S;       // (rows, m*k) stored blocks
  const int* perm;      // (rows,) column-sorted position -> block, or null
  const int* offsets;   // (ns + 1,) column segments over the sorted positions
  const int* order;     // (ns,) segment of each group (longest first), or null
  const float* xc;      // (n_xc, k): the row products read x_c[cid_b]
  int n_xc;
  const int* cid;       // (rows,)
  const float* xr;      // (n_xr, m): the column half reads x_r[rxi_b]
  int n_xr;
  const int* rxi;       // (rows,)
  float* yc;            // (ns, k)
  float* P;             // (rows, m): S_b x_c[cid_b] of each stored block
  int ns;
  int group_log2;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// Start copying the blocks at sorted positions [b0, b1) into `buf`: the G
// lanes copy consecutive words (lane l takes words l, l+G, ...).
__device__ void stage_blocks(const SymCols& p, int aw, int b0, int b1,
                             int lane, int G, float* buf) {
  const int n = (b1 - b0) * aw;
  if (p.perm == nullptr) {
    const float* src = p.S + static_cast<long long>(b0) * aw;
    for (int e = lane; e < n; e += G) cp_async4(buf + e, src + e);
  } else {
    for (int e = lane; e < n; e += G) {
      const int j = e / aw;
      const long long blk = __ldg(p.perm + b0 + j);
      cp_async4(buf + e, p.S + blk * aw + (e - j * aw));
    }
  }
}

// A group of G = 2^group_log2 threads per column segment (blockDim.x =
// max(G, 32)). Dynamic shared memory: two tiles of G blocks per group, and
// at least blockDim.x rows of kMaxDim + 1 floats for the lane tree. M, K
// fix the block shape at compile time (0: m, k at run time, up to kMaxDim).
template <int M, int K>
__global__ void __launch_bounds__(kBlock)
    sym_cols_kernel(SymCols p, int m_, int k_) {
  extern __shared__ float smem[];
  constexpr int MI = M ? M : kMaxDim;  // unrolled loop bounds
  constexpr int KI = K ? K : kMaxDim;
  const int m = M ? M : m_;
  const int k = K ? K : k_;
  const int aw = m * k;
  const int G = 1 << p.group_log2;
  const int lane = threadIdx.x & (G - 1);
  const int gl = threadIdx.x >> p.group_log2;
  const long long gi =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> p.group_log2) + gl;
  int s = -1, r0 = 0, r1 = 0;
  if (gi < p.ns) {
    s = p.order != nullptr ? p.order[gi] : static_cast<int>(gi);
    r0 = p.offsets[s];
    r1 = p.offsets[s + 1];
  }
  float* const buf0 = smem + gl * G * aw;
  float* const buf1 = smem + (blockDim.x + gl * G) * aw;
  const int rounds = (r1 - r0 + G - 1) >> p.group_log2;

  float acc[kMaxDim];
#pragma unroll
  for (int i = 0; i < kMaxDim; ++i) acc[i] = 0.0f;

  if (rounds > 0) stage_blocks(p, aw, r0, min(r0 + G, r1), lane, G, buf0);
  cp_async_commit();
  // the loop test is a barrier: every thread is done with the tile that
  // the next copy overwrites
  for (int i = 0; __syncthreads_or(i < rounds); ++i) {
    const float* cur = (i & 1) ? buf1 : buf0;
    if (i + 1 < rounds) {
      const int b0 = r0 + (i + 1) * G;
      stage_blocks(p, aw, b0, min(b0 + G, r1), lane, G,
                   (i & 1) ? buf0 : buf1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile i have landed
    __syncthreads();     // and every thread's
    const int r = r0 + i * G + lane;
    if (i >= rounds || r >= r1) continue;
    const int row = p.perm != nullptr ? __ldg(p.perm + r) : r;
    const float* a = cur + lane * aw;

    // column half: acc[j] += sum_i S_b[i, j] x_r[rxi_b][i]
    const int xrow = __ldg(p.rxi + row);
    const bool xr_ok = xrow >= 0 && xrow < p.n_xr;
    float xv[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      xv[i] = (xr_ok && i < m)
                  ? __ldg(p.xr + static_cast<long long>(xrow) * m + i)
                  : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      if (j < k) {
        float t = a[j] * xv[0];
#pragma unroll
        for (int i = 1; i < MI; ++i) {
          if (i < m) t = t + a[i * k + j] * xv[i];
        }
        acc[j] = acc[j] + t;
      }
    }

    // row product: P[b, i] = sum_j S_b[i, j] x_c[cid_b][j]
    const int crow = __ldg(p.cid + row);
    const bool xc_ok = crow >= 0 && crow < p.n_xc;
    float cv[KI];
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      cv[j] = (xc_ok && j < k)
                  ? __ldg(p.xc + static_cast<long long>(crow) * k + j)
                  : 0.0f;
    }
    float* out = p.P + static_cast<long long>(row) * m;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i < m) {
        float t = a[i * k] * cv[0];
#pragma unroll
        for (int j = 1; j < KI; ++j) {
          if (j < k) t = t + a[i * k + j] * cv[j];
        }
        out[i] = t;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are free: the tree reuses their memory
  lane_tree(acc, lane, G, reinterpret_cast<float (*)[kMaxDim + 1]>(smem));
  if (s >= 0 && lane == 0) {
    float* o = p.yc + static_cast<long long>(s) * k;
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      if (j < k) o[j] = acc[j];
    }
  }
}

template <int M, int K>
cudaError_t launch_sym_cols(const SymCols& p, int m, int k, unsigned blocks,
                            int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sym_cols_kernel<M, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sym_cols_kernel<M, K><<<blocks, threads, smem, stream>>>(p, m, k);
  return cudaGetLastError();
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

// K5's pass 1. S: (rows, m*k) float32 stored blocks. x_c (n_xc, k) and cid
// (rows,): P (rows, m) gets S_b x_c[cid_b]. x_r (n_xr, m) and rxi (rows,),
// perm (or null) / offsets the column-sorted plan, order (ns,) its segments
// longest first (or null), group_log2 its lanes: y_c (ns, k) gets the
// column half. Pass 2 is K1 (segsum.cu) over P with the row-sorted plan.
// Returns the cudaGetLastError() code (an error also when two tiles of the
// group's blocks do not fit in shared memory).
extern "C" int gt_segmv_sym_f32(const void* S, int m, int k, const void* xc,
                                int n_xc, const void* cid, const void* xr,
                                int n_xr, const void* rxi, const void* perm,
                                const void* offsets, const void* order,
                                void* yc, int ns, int group_log2, void* P,
                                void* stream) {
  if (bad_shape(m, k, group_log2) || ns < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ns == 0) return 0;
  const SymCols p{static_cast<const float*>(S), static_cast<const int*>(perm),
                  static_cast<const int*>(offsets),
                  static_cast<const int*>(order),
                  static_cast<const float*>(xc), n_xc,
                  static_cast<const int*>(cid), static_cast<const float*>(xr),
                  n_xr, static_cast<const int*>(rxi), static_cast<float*>(yc),
                  static_cast<float*>(P), ns, group_log2};
  const int G = 1 << group_log2;
  const int threads = G < 32 ? 32 : G;
  const int groups = threads / G;
  const size_t tiles = 2 * static_cast<size_t>(threads) * m * k;
  const size_t tree = static_cast<size_t>(threads) * (kMaxDim + 1);
  const size_t smem = (tiles > tree ? tiles : tree) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((ns + groups - 1) / groups);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (m == 9 && k == 9)
          ? launch_sym_cols<9, 9>(p, m, k, blocks, threads, smem, st)
          : launch_sym_cols<0, 0>(p, m, k, blocks, threads, smem, st);
  return static_cast<int>(err);
}

extern "C" const char* gt_segmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
