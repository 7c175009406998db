// K4 and K5: gathered block matvecs reduced over segments, on Hopper
// (sm_90a).
//
// K4 (gt_segmv_f32, gt_segmv_f64):
//   y[s] = sum over r in [offsets[s], offsets[s+1]) of op(A[row]) x[xi[row]]
//   row = perm[r] when a permutation is given (unsorted destinations), else r
//   op(A) = A (m, k) or, with `transpose`, A^T (k, m)
// A null xi means the identity (x was gathered beforehand, one row per A
// row). An x index outside [0, n_x) reads a zero row: masked and padded rows
// contribute nothing.
//
// K5 (gt_segmv_sym_f32 / _f64 and K1): the symmetric block-sparse S
// matvec over the stored upper triangle:
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
// the ~5 rows of a landmark, 256 threads for the ~2,800 rows of a pose
// row). Lane l of a group sums the segment's rows l, l+G, l+2G, ... in
// order; the G partial sums are then combined by a halving tree (lane l adds
// lane l+h, h = G/2, ..., 1) through shared memory down to one warp and by
// warp shuffles below. It is K1's order (segsum.cu). The order is fixed, so
// results are bitwise the same from run to run, and the plain versions
// (segmv.py, segsum.py) add in the same order, so they equal the kernels
// bitwise on the CPU. Built with -fmad=false: one rounding per product and
// per add, as the plain versions' elementwise products.
//
// Bound: device-memory bytes. K4 reads each row's m*k block once (and its x
// row, mostly from L1/L2: the pose x table is 64 KB, the landmark w table 12
// MB): b_schur and the back-substitution read 540 MB of Hpl values each at
// Venice-1778.
//
// K4's design: a CTA of 256 threads owns 256 / G consecutive segments, so a
// contiguous range [P0, P1) of sorted positions, and walks it in tiles of T
// blocks (128 at 9x3; segmv.py, k4_tile_blocks) on a grid aligned to 4
// blocks. Each tile is staged into shared memory by coalesced cp.async
// copies, one tile ahead: without a permutation the tile is one contiguous
// span of A, copied 16 bytes a thread (4 blocks of 9x3 are 432 bytes, a
// multiple of 16, hence the alignment; the blocks of the aligned-down start
// that belong to the previous CTA are copied and not used); through the
// permutation, 4 bytes a thread, consecutive threads on consecutive words
// of a block. The indices are staged too: each tile's slice of the
// permutation two tiles ahead, and each block's x row index (xi through
// the permutation) with its block, so no copy and no product waits on a
// chain of dependent loads (perm, then xi, then x): that chain, paid once a
// tile, had left a first staged version no faster at b_schur than the
// thread-per-block kernel before it. Then thread t computes block t's product from shared memory
// with its x row (read by index, from L2) into a product row in shared
// memory, and each lane adds the products of its own positions in the
// tile, in order. Thread-per-block products keep every thread busy when
// segments are short (one lane each) and every load of A coalesced when
// the rows come through the permutation. The products and their order are
// those of the plain version, so the redesign changed no bit.
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
//
// Float64 (the _f64 entries, the FP64 policies' Schur values and
// vectors): the same templates over T = double, the same order, sums in
// float64; pass 2 is K1's float64 instance. The bytes double (~0.35 ms
// for b_S's and the back-substitution's Hpl reads, ~0.32 ms for S); the
// float64 multiply-adds (34 TFLOP/s) stay below them. What a double
// changes is where the rows sit: K4's tiles start on a grid of 16 /
// sizeof(T) blocks (4 floats, 2 doubles: 16-byte aligned for any block
// shape) and its tile is sized by bytes on the host (segmv.py,
// k4_tile_blocks; 96 (9, 3) blocks in float64); the copies move 8 bytes
// an element; K5's two tiles of G blocks a group must fit shared memory,
// which caps its column plan's lanes on the host (segmv.py,
// sym_group_cap: 128 at 9x9 in float64, so a tile pair is 162 KB).

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kMaxDim = 16;  // largest m and k the kernels take
constexpr int kBlock = 256;  // threads per block; a group never spans blocks
constexpr int kPStride = kMaxDim + 1;  // elements per K4 product row
constexpr int kK4Stages = 2;  // K4 tiles in shared memory: one ahead

// elements of T in 16 bytes: K4's tile grid in blocks
template <typename T>
constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));

template <typename T>
struct Half {
  const T* A;           // (rows, m*k)
  const int* xi;        // (rows,) x row of each A row, or null (identity)
  const T* x;           // (n_x, m or k)
  int n_x;
  const int* perm;      // (rows,) sorted position -> A row, or null
  const int* offsets;   // (num_segments + 1,) over the sorted positions
  T* out;               // (num_segments, k or m)
  int num_segments;
  int transpose;
  int group_log2;
};

// The halving tree of a group of G lanes (G consecutive threads of the
// block): lane l adds lane l + off, off = G/2, ..., 1; through shared
// memory (one row of `smem` per thread) while the partner is in another
// warp, by warp shuffles below. Every thread of the block calls it.
template <typename T, int N>
__device__ void lane_tree(T (&acc)[N], int lane, int G,
                          T (*smem)[kMaxDim + 1]) {
  for (int off = G >> 1; off >= 32; off >>= 1) {
    if (lane >= off && lane < 2 * off) {
#pragma unroll
      for (int i = 0; i < N; ++i) smem[threadIdx.x][i] = acc[i];
    }
    __syncthreads();
    if (lane < off) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = acc[i] + smem[threadIdx.x + off][i];
      }
    }
    __syncthreads();
  }
  const int width = G < 32 ? G : 32;
  const int wl = lane & (width - 1);
  for (int off = width >> 1; off >= 1; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T other = __shfl_down_sync(0xffffffffu, acc[i], off, width);
      if (wl < off) acc[i] = acc[i] + other;
    }
  }
}

// K4. CTA c owns segments [c * spc, c * spc + spc), spc = kBlock / G, and
// so the sorted positions [P0, P1). Tile i covers [A0 + i*T, A0 + (i+1)*T)
// clipped to [P0, P1), A0 = P0 rounded down to a multiple of kPer16<E>
// blocks (tests/test_torch_segmv.py walks the same tiles). Tile i's copies
// are one cp.async group, issued kK4Stages - 1 tiles ahead: its blocks,
// the x row index of each block (xi through the permutation), and the
// permutation of tile i + kK4Stages (so a copy never waits on a load of
// the permutation). Dynamic shared memory (sized in segmv below):
// kK4Stages tiles of T blocks, each rounded up to 16 bytes; T product rows
// of kPStride elements; kK4Stages + 1 tiles of the permutation and
// kK4Stages of x row indices. The lane tree reuses it. E is the element
// type; M, K fix the block shape at compile time (0: m, k at run time, up
// to kMaxDim).
template <typename E>
__host__ __device__ inline int k4_tile_elems(int T, int aw) {
  return (T * aw + kPer16<E> - 1) & ~(kPer16<E> - 1);
}

template <typename E, int M, int K>
__global__ void __launch_bounds__(kBlock)
    segmv_kernel(Half<E> h, int m_, int k_, int T) {
  // one buffer for both element types, viewed as E
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  E* const smem = reinterpret_cast<E*>(smem_bytes);
  constexpr int kAlign = kPer16<E>;
  constexpr int MI = M ? M : kMaxDim;  // unrolled loop bounds
  constexpr int KI = K ? K : kMaxDim;
  constexpr int DI = MI > KI ? MI : KI;
  constexpr int S = kK4Stages;
  const int m = M ? M : m_;
  const int k = K ? K : k_;
  const int aw = m * k;
  const int d = h.transpose ? k : m;   // outputs per block
  const int xd = h.transpose ? m : k;  // x row width
  const int tile_elems = k4_tile_elems<E>(T, aw);
  E* const prod = smem + S * tile_elems;
  int* const pring = reinterpret_cast<int*>(prod + T * kPStride);
  int* const xring = pring + (S + 1) * T;

  const int G = 1 << h.group_log2;
  const int seg0 = blockIdx.x * (kBlock >> h.group_log2);
  const int seg_end = min(seg0 + (kBlock >> h.group_log2), h.num_segments);
  const int P0 = h.offsets[seg0];
  const int P1 = h.offsets[seg_end];
  const int A0 = P0 & ~(kAlign - 1);
  const int tiles = P1 > P0 ? (P1 - A0 + T - 1) / T : 0;
  const int t = threadIdx.x;
  const int lane = t & (G - 1);
  const int s = seg0 + (t >> h.group_log2);
  const bool live = s < h.num_segments;
  const int r0 = live ? h.offsets[s] : 0;
  const int r1 = live ? h.offsets[s + 1] : 0;
  const bool vec =
      h.perm == nullptr && (reinterpret_cast<size_t>(h.A) & 15) == 0;

  auto tile_lo = [&](int i) { return max(A0 + i * T, P0); };
  auto tile_hi = [&](int i) { return min(A0 + (i + 1) * T, P1); };
  auto blocks = [&](int i) { return smem + (i % S) * tile_elems; };
  // the permutation of tile i: pring[(i % (S+1)) * T + (r - tile start)]
  auto stage_perm = [&](int i) {
    if (h.perm == nullptr || i >= tiles) return;
    const int t0 = A0 + i * T;
    const int r = t0 + t;
    if (t < T && r >= tile_lo(i) && r < tile_hi(i)) {
      cp_async4(reinterpret_cast<float*>(pring + (i % (S + 1)) * T + t),
                reinterpret_cast<const float*>(h.perm + r));
    }
  };
  // tile i's blocks (the block at sorted position r lands at blocks(i) +
  // (r - tile start) * aw) and x row indices (at xring, the same offset)
  auto stage = [&](int i) {
    const int t0 = A0 + i * T;
    const int lo = tile_lo(i);
    const int hi = tile_hi(i);
    const int* pm = pring + (i % (S + 1)) * T - t0;  // pm[r], r in [lo, hi)
    E* buf = blocks(i);
    if (vec) {  // one span from t0, on the kAlign-block grid: 16-byte aligned
      const E* src = h.A + static_cast<long long>(t0) * aw;
      const int n = (hi - t0) * aw;
      for (int e = kAlign * t; e + kAlign <= n; e += kAlign * kBlock) {
        cp_async16(reinterpret_cast<float*>(buf + e),
                   reinterpret_cast<const float*>(src + e));
      }
      for (int e = (n & ~(kAlign - 1)) + t; e < n; e += kBlock) {
        cp_async_elem(buf + e, src + e);
      }
    } else {
      E* dst = buf + (lo - t0) * aw;
      const int n = (hi - lo) * aw;
      for (int e = t; e < n; e += kBlock) {
        const int j = e / aw;
        const long long blk = h.perm != nullptr ? pm[lo + j] : lo + j;
        cp_async_elem(dst + e, h.A + blk * aw + (e - j * aw));
      }
    }
    const int r = t0 + t;
    if (t < T && r >= lo && r < hi) {
      const int row = h.perm != nullptr ? pm[r] : r;
      int* xr = xring + (i % S) * T + t;
      if (h.xi != nullptr) {
        cp_async4(reinterpret_cast<float*>(xr),
                  reinterpret_cast<const float*>(h.xi + row));
      } else {
        *xr = row;
      }
    }
  };

  E acc[DI];
#pragma unroll
  for (int i = 0; i < DI; ++i) acc[i] = static_cast<E>(0);

  // the permutation of the first S tiles, then the first S - 1 groups
#pragma unroll
  for (int i = 0; i < S; ++i) stage_perm(i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    // stage_perm(i + S) overwrites the permutation stage(i - 1) read
    if (i > 0) __syncthreads();
    if (i < tiles) stage(i);
    stage_perm(i + S);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<S - 2>();  // this thread's copies of tile it
    __syncthreads();  // every thread's; every thread is done with tile it-1
    if (it + S - 1 < tiles) stage(it + S - 1);
    stage_perm(it + 2 * S - 1);
    cp_async_commit();
    const E* cur = blocks(it);
    const int t0 = A0 + it * T;
    const int hi = tile_hi(it);

    // the product of block t of the tile, by thread t
    const int r = t0 + t;
    if (t < T && r >= P0 && r < hi) {
      const int xrow = xring[(it % S) * T + t];
      const bool valid = xrow >= 0 && xrow < h.n_x;
      const E* xp = h.x + static_cast<long long>(xrow) * xd;
      E xv[DI];
#pragma unroll
      for (int j = 0; j < DI; ++j) {
        xv[j] = (valid && j < xd) ? __ldg(xp + j) : static_cast<E>(0);
      }
      const E* a = cur + t * aw;
      E* pr = prod + t * kPStride;
      if (!h.transpose) {
        // p[i] = sum_j A[i, j] x[j]
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i < m) {
            E p = a[i * k] * xv[0];
#pragma unroll
            for (int j = 1; j < KI; ++j) {
              if (j < k) p = p + a[i * k + j] * xv[j];
            }
            pr[i] = p;
          }
        }
      } else {
        // p[j] = sum_i A[i, j] x[i]
#pragma unroll
        for (int j = 0; j < KI; ++j) {
          if (j < k) {
            E p = a[j] * xv[0];
#pragma unroll
            for (int i = 1; i < MI; ++i) {
              if (i < m) p = p + a[i * k + j] * xv[i];
            }
            pr[j] = p;
          }
        }
      }
    }
    __syncthreads();

    // lane l adds the products of its positions r0 + l + n*G in the tile
    if (live) {
      const int lo = max(r0, t0);
      const int top = min(r1, hi);
      int p = r0 + lane;
      if (p < lo) p += ((lo - p + G - 1) >> h.group_log2) << h.group_log2;
      for (; p < top; p += G) {
        const E* pr = prod + (p - t0) * kPStride;
#pragma unroll
        for (int i = 0; i < DI; ++i) {
          if (i < d) acc[i] = acc[i] + pr[i];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are free: the tree reuses their memory
  lane_tree(acc, lane, G, reinterpret_cast<E (*)[kMaxDim + 1]>(smem));

  if (live && lane == 0) {
    E* o = h.out + static_cast<long long>(s) * d;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      if (i < d) o[i] = acc[i];
    }
  }
}

template <typename E, int M, int K>
cudaError_t launch_segmv(const Half<E>& h, int m, int k, int T,
                         unsigned blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      segmv_kernel<E, M, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  segmv_kernel<E, M, K><<<blocks, kBlock, smem, stream>>>(h, m, k, T);
  return cudaGetLastError();
}

// K5's pass 1 over the stored blocks in column-sorted order.
template <typename E>
struct SymCols {
  const E* S;           // (rows, m*k) stored blocks
  const int* perm;      // (rows,) column-sorted position -> block, or null
  const int* offsets;   // (ns + 1,) column segments over the sorted positions
  const int* order;     // (ns,) segment of each group (longest first), or null
  const E* xc;          // (n_xc, k): the row products read x_c[cid_b]
  int n_xc;
  const int* cid;       // (rows,)
  const E* xr;          // (n_xr, m): the column half reads x_r[rxi_b]
  int n_xr;
  const int* rxi;       // (rows,)
  E* yc;                // (ns, k)
  E* P;                 // (rows, m): S_b x_c[cid_b] of each stored block
  int ns;
  int group_log2;
};

// Start copying the blocks at sorted positions [b0, b1) into `buf`: the G
// lanes copy consecutive elements (lane l takes elements l, l+G, ...).
template <typename E>
__device__ void stage_blocks(const SymCols<E>& p, int aw, int b0, int b1,
                             int lane, int G, E* buf) {
  const int n = (b1 - b0) * aw;
  if (p.perm == nullptr) {
    const E* src = p.S + static_cast<long long>(b0) * aw;
    for (int e = lane; e < n; e += G) cp_async_elem(buf + e, src + e);
  } else {
    for (int e = lane; e < n; e += G) {
      const int j = e / aw;
      const long long blk = __ldg(p.perm + b0 + j);
      cp_async_elem(buf + e, p.S + blk * aw + (e - j * aw));
    }
  }
}

// A group of G = 2^group_log2 threads per column segment (blockDim.x =
// max(G, 32)). Dynamic shared memory: two tiles of G blocks per group, and
// at least blockDim.x rows of kMaxDim + 1 elements for the lane tree. E is
// the element type; M, K fix the block shape at compile time (0: m, k at
// run time, up to kMaxDim).
template <typename E, int M, int K>
__global__ void __launch_bounds__(kBlock)
    sym_cols_kernel(SymCols<E> p, int m_, int k_) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  E* const smem = reinterpret_cast<E*>(smem_bytes);
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
  E* const buf0 = smem + gl * G * aw;
  E* const buf1 = smem + (blockDim.x + gl * G) * aw;
  const int rounds = (r1 - r0 + G - 1) >> p.group_log2;

  E acc[kMaxDim];
#pragma unroll
  for (int i = 0; i < kMaxDim; ++i) acc[i] = static_cast<E>(0);

  if (rounds > 0) stage_blocks(p, aw, r0, min(r0 + G, r1), lane, G, buf0);
  cp_async_commit();
  // the loop test is a barrier: every thread is done with the tile that
  // the next copy overwrites
  for (int i = 0; __syncthreads_or(i < rounds); ++i) {
    const E* cur = (i & 1) ? buf1 : buf0;
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
    const E* a = cur + lane * aw;

    // column half: acc[j] += sum_i S_b[i, j] x_r[rxi_b][i]
    const int xrow = __ldg(p.rxi + row);
    const bool xr_ok = xrow >= 0 && xrow < p.n_xr;
    E xv[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      xv[i] = (xr_ok && i < m)
                  ? __ldg(p.xr + static_cast<long long>(xrow) * m + i)
                  : static_cast<E>(0);
    }
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      if (j < k) {
        E t = a[j] * xv[0];
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
    E cv[KI];
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      cv[j] = (xc_ok && j < k)
                  ? __ldg(p.xc + static_cast<long long>(crow) * k + j)
                  : static_cast<E>(0);
    }
    E* out = p.P + static_cast<long long>(row) * m;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i < m) {
        E t = a[i * k] * cv[0];
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
  lane_tree(acc, lane, G, reinterpret_cast<E (*)[kMaxDim + 1]>(smem));
  if (s >= 0 && lane == 0) {
    E* o = p.yc + static_cast<long long>(s) * k;
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      if (j < k) o[j] = acc[j];
    }
  }
}

template <typename E, int M, int K>
cudaError_t launch_sym_cols(const SymCols<E>& p, int m, int k,
                            unsigned blocks, int threads, size_t smem,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sym_cols_kernel<E, M, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sym_cols_kernel<E, M, K><<<blocks, threads, smem, stream>>>(p, m, k);
  return cudaGetLastError();
}

bool bad_shape(int m, int k, int group_log2) {
  return m < 1 || k < 1 || m > kMaxDim || k > kMaxDim || group_log2 < 0 ||
         (1 << group_log2) > kBlock;
}

template <typename E>
int segmv(const void* A, const void* xi, const void* x, int n_x,
          const void* perm, const void* offsets, void* out,
          int num_segments, int m, int k, int transpose, int group_log2,
          int tile_blocks, void* stream) {
  if (bad_shape(m, k, group_log2) || num_segments < 0 || tile_blocks < 4 ||
      tile_blocks > kBlock || tile_blocks % kPer16<E> != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
  const Half<E> h{static_cast<const E*>(A), static_cast<const int*>(xi),
                  static_cast<const E*>(x), n_x,
                  static_cast<const int*>(perm),
                  static_cast<const int*>(offsets), static_cast<E*>(out),
                  num_segments, transpose, group_log2};
  const int spc = kBlock >> group_log2;
  const unsigned blocks =
      static_cast<unsigned>((num_segments + spc - 1) / spc);
  const size_t staged =
      sizeof(E) * (static_cast<size_t>(kK4Stages) *
                       k4_tile_elems<E>(tile_blocks, m * k) +
                   static_cast<size_t>(tile_blocks) * kPStride) +
      sizeof(int) * static_cast<size_t>(tile_blocks) * (2 * kK4Stages + 1);
  const size_t tree = sizeof(E) * static_cast<size_t>(kBlock) * (kMaxDim + 1);
  const size_t smem = staged > tree ? staged : tree;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (m == 9 && k == 3)
          ? launch_segmv<E, 9, 3>(h, m, k, tile_blocks, blocks, smem, st)
          : launch_segmv<E, 0, 0>(h, m, k, tile_blocks, blocks, smem, st);
  return static_cast<int>(err);
}

template <typename E>
int segmv_sym(const void* S, int m, int k, const void* xc, int n_xc,
              const void* cid, const void* xr, int n_xr, const void* rxi,
              const void* perm, const void* offsets, const void* order,
              void* yc, int ns, int group_log2, void* P, void* stream) {
  if (bad_shape(m, k, group_log2) || ns < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ns == 0) return 0;
  const SymCols<E> p{static_cast<const E*>(S), static_cast<const int*>(perm),
                     static_cast<const int*>(offsets),
                     static_cast<const int*>(order),
                     static_cast<const E*>(xc), n_xc,
                     static_cast<const int*>(cid), static_cast<const E*>(xr),
                     n_xr, static_cast<const int*>(rxi), static_cast<E*>(yc),
                     static_cast<E*>(P), ns, group_log2};
  const int G = 1 << group_log2;
  const int threads = G < 32 ? 32 : G;
  const int groups = threads / G;
  const size_t tiles = 2 * static_cast<size_t>(threads) * m * k;
  const size_t tree = static_cast<size_t>(threads) * (kMaxDim + 1);
  const size_t smem = (tiles > tree ? tiles : tree) * sizeof(E);
  const unsigned blocks = static_cast<unsigned>((ns + groups - 1) / groups);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (m == 9 && k == 9)
          ? launch_sym_cols<E, 9, 9>(p, m, k, blocks, threads, smem, st)
          : launch_sym_cols<E, 0, 0>(p, m, k, blocks, threads, smem, st);
  return static_cast<int>(err);
}

}  // namespace

// K4. A: (rows, m*k) float32 (gt_segmv_f32) or float64 (gt_segmv_f64);
// xi: (rows,) int32 or null; x: (n_x, k), or (n_x, m) with `transpose`, of
// A's type; perm: (rows,) int32 or null; offsets: (num_segments+1,) int32;
// out: (num_segments, m), or (num_segments, k) with `transpose`, of A's
// type. m, k <= 16; 2^group_log2 <= 256 threads per segment; tile_blocks
// (T) in [4, 256], a multiple of 16 bytes' elements (4 in float32, 2 in
// float64). Launches on `stream` and returns the cudaGetLastError() code.
extern "C" int gt_segmv_f32(const void* A, const void* xi, const void* x,
                            int n_x, const void* perm, const void* offsets,
                            void* out, int num_segments, int m, int k,
                            int transpose, int group_log2, int tile_blocks,
                            void* stream) {
  return segmv<float>(A, xi, x, n_x, perm, offsets, out, num_segments, m, k,
                      transpose, group_log2, tile_blocks, stream);
}

extern "C" int gt_segmv_f64(const void* A, const void* xi, const void* x,
                            int n_x, const void* perm, const void* offsets,
                            void* out, int num_segments, int m, int k,
                            int transpose, int group_log2, int tile_blocks,
                            void* stream) {
  return segmv<double>(A, xi, x, n_x, perm, offsets, out, num_segments, m, k,
                       transpose, group_log2, tile_blocks, stream);
}

// K5's pass 1. S: (rows, m*k) float32 (gt_segmv_sym_f32) or float64
// (gt_segmv_sym_f64) stored blocks. x_c (n_xc, k) and cid (rows,): P
// (rows, m) gets S_b x_c[cid_b]. x_r (n_xr, m) and rxi (rows,), perm (or
// null) / offsets the column-sorted plan, order (ns,) its segments longest
// first (or null), group_log2 its lanes: y_c (ns, k) gets the column half.
// Every value array of S's type. Pass 2 is K1 (segsum.cu) over P with the
// row-sorted plan. Returns the cudaGetLastError() code (an error also when
// two tiles of the group's blocks do not fit in shared memory).
extern "C" int gt_segmv_sym_f32(const void* S, int m, int k, const void* xc,
                                int n_xc, const void* cid, const void* xr,
                                int n_xr, const void* rxi, const void* perm,
                                const void* offsets, const void* order,
                                void* yc, int ns, int group_log2, void* P,
                                void* stream) {
  return segmv_sym<float>(S, m, k, xc, n_xc, cid, xr, n_xr, rxi, perm,
                          offsets, order, yc, ns, group_log2, P, stream);
}

extern "C" int gt_segmv_sym_f64(const void* S, int m, int k, const void* xc,
                                int n_xc, const void* cid, const void* xr,
                                int n_xr, const void* rxi, const void* perm,
                                const void* offsets, const void* order,
                                void* yc, int ns, int group_log2, void* P,
                                void* stream) {
  return segmv_sym<double>(S, m, k, xc, n_xc, cid, xr, n_xr, rxi, perm,
                           offsets, order, yc, ns, group_log2, P, stream);
}

extern "C" const char* gt_segmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
