// K3: gathered triple product reduced over sorted segments, on Hopper
// (sm_90a).
//
//   out[s] = sum over r in [offsets[s], offsets[s+1]) of L[li[r]] R[ri[r]]^T
//
// L rows are flat row-major (m, k) blocks, R rows (n, k) blocks and out rows
// (m, n) blocks. A null li (ri) means the identity: the rows were gathered
// beforehand, one per r.
//
// With a base, the store writes the Schur complement's update itself,
//
//   out[s] = base_row(s) - sum,
//
// The store's mode is read from bi first, then base:
// - bi given: base_row(s) = base[bi[s]] where bi[s] >= 0 (the Schur
//   complement's first product group: the Hpp block copied into S block
//   s) and +0.0 where bi[s] = -1 or base is null (an S block with no Hpp
//   block, or an S group with no Hpp group at all: 0.0f - sum, which keeps
//   +0.0 where the sum is +0.0, as the zero-filled S minus the sums did);
// - bi null, base given: base_row(s) = base[s] (a later group into the
//   same S group, in place: base and out the same array). One thread
//   reads each output element's base and then writes it, so in place is
//   safe;
// - both null: the sums themselves.
//
// Replaces two TPU kernels that compute this same function:
// graphite_tpu/ops/pallas/segsum_stream.py _kernel_prod
// (streaming_segment_product_sum; both operands pre-gathered streams) and
// _kernel_prod_rtbl (streaming_segment_product_sum_rtbl; the right operand
// read from a rolling window of a packed table). On the TPU the per-row
// product ran on the MXU through expansion one-hots and the reduction was a
// windowed one-hot matmul with a host flush schedule, all to fit VMEM. Here
// the Schur complement's S = Hpp - sum W_left R_right^T reads W and the
// Hessian's Hpl rows straight from their tables by index, no (K, m*n)
// product is ever written to memory, and S is written once, by the store.
//
// The order (K1's, with a group per segment): segment s is summed by g_s
// lanes, g_s = K1's group rule on the segment's own length (a power of two
// leaving ~8 rows per lane, at most 256; segsum_stream.py, product_lanes).
// Lane l sums the products of the segment's rows l, l+g_s, ... in order,
// each product p_ab = sum_j L[a, j] R[b, j] with j in order; a halving tree
// (lane l += lane l+h, h = g_s/2, ..., 1) combines the lanes. Built with
// -fmad=false: one rounding per product and per add. No atomics and a fixed
// order, so results are bitwise the same from run to run, and the plain
// version (segsum_stream.py) adds in the same order, so it equals the
// kernel bitwise on the CPU. A one-lane segment (up to 8 rows) is summed in
// row order. The lanes are the cure
// for Venice-1778's 1,778 diagonal S blocks (~2,810 rows each): summed in
// row order they made ~2,810 dependent steps while most of the card idled.
//
// Design: the host (segsum_stream.py, plan_products) sorts the segments by
// (g_s, length), longest first, and cuts that order into CTAs of 64 slots:
// 64 segments of up to 4 lanes, or 256 / g_s segments of g_s / 4 slots
// each. A thread owns (slot q, block row a) and keeps L = min(g_s, 4) lanes
// of its row of the output in registers: slot q holds lanes q, q+Q, ...,
// q+(L-1)Q of its segment (Q = g_s / L slots per segment), as in K1. Round
// i takes row i*Q + q of each slot's segment: the CTA stages those 64 rows
// of L and R (gathered by li / ri) into shared memory with coalesced
// cp.async copies of one element each (4 bytes; 8 in double),
// consecutive threads on consecutive elements of a row, two rounds
// ahead, and the rounds' li / ri entries themselves three rounds ahead,
// so that no copy waits on a load of its index (a wait a round on
// dependent index loads had made a first version of this design ~1.4x
// slower); each row is read from device memory once, and each thread
// computes its 9 (n) products from shared memory. Length-sorted CTAs keep
// a warp's segments of one length, so no warp waits on a longer segment,
// and put the long segments first on the card. The tree runs in registers
// for the levels h >= Q and through shared memory below.
//
// Bound: at BAL Venice-1778, 17,048,613 rows into 1,580,797 segments of
// (9, 9) blocks. The tables once and S once are 1.73 GB (0.52 ms at 3.35
// TB/s; the base adds the 1,779 Hpp blocks, 0.6 MB); the rows gathered by
// index, each read once, are 3.7 GB (plus the indices and 512 MB of S):
// ~1.3 ms, the floor of this design. 243 multiply-adds a row are 8.3
// GFLOP (0.12 ms at float32's peak). The base store replaces a zero fill,
// a copy and a subtraction over S (1.54 GB more, ~0.65 ms on the card).
//
// Float64 (gt_segprod_f64, the FP64 policies' Schur values): the same
// sums in float64 in the same order (the same lanes, rows, j and tree),
// so the bytes above double (~1.04 ms for the tables and S; 8.3 GFLOP at
// the 34 TFLOP/s float64 rate, 0.25 ms, stays below them). Its own design
// (segprod64_cta), since the float32 one in T = double held 4 x 9 double
// accumulators a thread (96 registers at (9, 3, 9): one 576-thread CTA an
// SM) and copied a 216-byte row as 27 8-byte pieces:
// - at most 2 lanes a thread (L = min(g_s, 2), Q = g_s / L slots a
//   segment), 18 accumulators at (9, 3, 9), so two 576-thread CTAs sit
//   on an SM (__launch_bounds__(576, 2): 56 registers) with 3 staged
//   rounds each (89 KB);
// - a 256-lane segment takes 128 slots: two CTAs of a cluster, CTA
//   `part` holding slots [64 part, 64 part + 64). Each sums its lanes'
//   rows and its register level; then part 1 stores its 64 slot sums into
//   part 0's shared memory (distributed shared memory, between two
//   cluster barriers) and part 0 adds them: the tree's level h = 64, then
//   the rest in part 0 as before. The host plan (segsum_stream.py,
//   product_ctas_f64) gives each CTA (first, count, log2 g, part), a
//   spanning segment's two CTAs at the start of a cluster of 2, and pads
//   the grid to whole clusters with empty CTAs;
// - rows are copied in 16-byte cp.async pieces: a row of W doubles at an
//   address 8h mod 16 (h = 0 or 1) lands at offset h of its region of
//   pad2(W + 1) doubles, so its pieces [2u - h, 2u - h + 2) fall on
//   16-byte boundaries on both sides, with an 8-byte piece at either end
//   (a (9, 3) row: 13 pieces of 16 bytes and one of 8, not 27 of 8).
//   Each staged row's h is kept beside it for the products.
// A block shape whose two padded rounds do not fit in a CTA's shared
// memory ((m + n) k near 224) keeps the float32 design's instance in
// double (segprod_kernel<double, ...>, the float32 plan).
// At Venice-1778 it takes ~4.9 ms on an H100 (the float32 design in
// double ~5.9), ~5x its bytes bound: built without its copies and
// products, the round skeleton (index loads, a barrier a round, the
// store) alone takes ~2.9 ms, ~3.5 us a round whatever the round moves.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 16;  // largest m, k and n the kernel takes
constexpr int kSlots = 64;   // rows staged per round
constexpr int kStages = 3;   // rounds in shared memory: two ahead (at most)
constexpr int kRegLanesLog2 = 2;  // at most 4 lanes a thread in registers

template <typename T>
struct Prod {
  const T* L;
  const int* li;       // (rows,) or null
  const T* R;
  const int* ri;       // (rows,) or null
  const int* offsets;  // (num_segments + 1,) over the destination-sorted rows
  const int* order;    // (num_segments,) segments by (lanes, length), desc.
  const int* ctas;     // (n_cta, 3): first index into order, segments, log2 g
  T* out;              // (num_segments, m*n)
  const T* base;       // base rows, or null (+0.0, or the sums: no bi)
  const int* bi;       // (num_segments,) base row or -1; null: row s
};

// A CTA's slot table and its ring of row indices: idx[i % (kStages + 1)]
// holds round i's L and R table rows of each slot.
struct Slots {
  int r0[kSlots];  // each slot's first row (its lane q) ...
  int r1[kSlots];  // ... and its segment's end
  int rounds;
  int idx[kStages + 1][2][kSlots];
};

// One CTA with L = 2^l_log2 lanes a thread. Threads: kSlots * m, thread
// (slot, a) = (t / m, t % m). Dynamic shared memory: S rounds of kSlots
// rows of (m + n) * k elements; the tree reuses it. Round i's copies are
// one cp.async group, issued S - 1 rounds ahead: its rows, and the row
// indices of round i + S (so no copy waits on an index). S is kStages,
// or 2 where kStages rounds of the block shape's rows do not fit (float64
// at 9x9x9): the same sums, one round ahead.
template <typename T, int S, int LANES, int M, int K, int N>
__device__ void segprod_cta(const Prod<T>& p, int m_, int k_, int n_,
                            int first, int count, int g_log2, T* smem,
                            Slots& slots) {
  static_assert(S >= 2 && S <= kStages, "stages");
  constexpr int KI = K ? K : kMaxDim;  // unrolled loop bounds
  constexpr int NI = N ? N : kMaxDim;
  constexpr int l_log2 = LANES == 4 ? 2 : LANES == 2 ? 1 : 0;
  const int m = M ? M : m_;
  const int k = K ? K : k_;
  const int n = N ? N : n_;
  const int lw = m * k;
  const int row_w = (m + n) * k;
  const int q_log2 = g_log2 - l_log2;
  const int Q = 1 << q_log2;
  const int t = threadIdx.x;
  const int slot = t / m;
  const int a = t - slot * m;
  const int sl = slot >> q_log2;  // segment of the slot in the CTA
  const int q = slot & (Q - 1);

  if (t == 0) slots.rounds = 0;
  __syncthreads();
  if (t < kSlots) {
    int r0 = 0, r1 = 0;
    if ((t >> q_log2) < count) {
      const int s = p.order[first + (t >> q_log2)];
      r0 = p.offsets[s] + (t & (Q - 1));
      r1 = p.offsets[s + 1];
    }
    slots.r0[t] = r0;
    slots.r1[t] = r1;
    if (r1 > r0) atomicMax(&slots.rounds, (r1 - r0 + Q - 1) >> q_log2);
  }
  __syncthreads();
  const int rounds = slots.rounds;
  const int my_r0 = slots.r0[slot];
  const int my_r1 = slots.r1[slot];

  // round i's table rows: slot j's row slots.r0[j] + i*Q, by li and ri
  auto stage_idx = [&](int i) {
    if (i >= rounds) return;
    for (int u = t; u < 2 * kSlots; u += blockDim.x) {
      const int j = u & (kSlots - 1);
      const int which = u / kSlots;
      const int r = slots.r0[j] + (i << q_log2);
      if (r >= slots.r1[j]) continue;
      int* dst = &slots.idx[i % (S + 1)][which][j];
      const int* src = which ? p.ri : p.li;
      if (src != nullptr) {
        cp_async4(reinterpret_cast<float*>(dst),
                  reinterpret_cast<const float*>(src + r));
      } else {
        *dst = r;
      }
    }
  };
  auto buffer = [&](int i) { return smem + (i % S) * kSlots * row_w; };
  // round i's rows into its buffer: consecutive threads on consecutive
  // elements of a row
  auto stage = [&](int i) {
    const int(*idx)[kSlots] = slots.idx[i % (S + 1)];
    T* buf = buffer(i);
    const int words = kSlots * row_w;
    for (int e = t; e < words; e += blockDim.x) {
      const int j = e / row_w;
      const int w = e - j * row_w;
      if (slots.r0[j] + (i << q_log2) < slots.r1[j]) {
        const T* src =
            w < lw ? p.L + static_cast<long long>(idx[0][j]) * lw + w
                   : p.R + static_cast<long long>(idx[1][j]) * (row_w - lw) +
                         (w - lw);
        cp_async_elem(buf + e, src);
      }
    }
  };

  T acc[LANES][NI];
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
#pragma unroll
    for (int b = 0; b < NI; ++b) acc[j][b] = static_cast<T>(0);
  }

  // the indices of the first S rounds, then the first S - 1 groups
#pragma unroll
  for (int i = 0; i < S; ++i) stage_idx(i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    // stage_idx(i + S) overwrites the indices stage(i - 1) read
    if (i > 0) __syncthreads();
    if (i < rounds) stage(i);
    stage_idx(i + S);
    cp_async_commit();
  }
  for (int i0 = 0; i0 < rounds; i0 += LANES) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) {  // round i feeds lane q + j*Q
      const int i = i0 + j;
      cp_async_wait<S - 2>();  // this thread's copies of round i
      __syncthreads();  // every thread's; all are done with round i-1
      if (i + S - 1 < rounds) stage(i + S - 1);
      stage_idx(i + 2 * S - 1);
      cp_async_commit();
      const int r = my_r0 + (i << q_log2);
      if (i < rounds && r < my_r1) {
        const T* row = buffer(i) + slot * row_w;
        T lv[KI];
#pragma unroll
        for (int c = 0; c < KI; ++c) {
          lv[c] = c < k ? row[a * k + c] : static_cast<T>(0);
        }
        const T* rb = row + lw;
#pragma unroll
        for (int b = 0; b < NI; ++b) {
          if (b < n) {
            T v = lv[0] * rb[b * k];
#pragma unroll
            for (int c = 1; c < KI; ++c) {
              if (c < k) v = v + lv[c] * rb[b * k + c];
            }
            acc[j][b] = acc[j][b] + v;
          }
        }
      }
    }
  }

  // the tree's levels h = g/2, ..., Q: lane q + j*Q += lane q + (j+h/Q)*Q,
  // both in this thread
#pragma unroll
  for (int h = LANES / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
#pragma unroll
      for (int b = 0; b < NI; ++b) acc[j][b] = acc[j][b] + acc[j + h][b];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the buffers are free: the tree reuses them
  // levels h = Q/2, ..., 1: slot q += slot q+h, through shared memory
  T* mine = smem + (slot * m + a) * n;
  for (int h = Q >> 1; h >= 1; h >>= 1) {
    if (q >= h && q < 2 * h) {
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) mine[b] = acc[0][b];
      }
    }
    __syncthreads();
    if (q < h) {
      const T* other = mine + h * m * n;
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) acc[0][b] = acc[0][b] + other[b];
      }
    }
    __syncthreads();
  }
  if (q == 0 && sl < count) {
    const int s = p.order[first + sl];
    T* o = p.out + (static_cast<long long>(s) * m + a) * n;
    if (p.base == nullptr && p.bi == nullptr) {
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) o[b] = acc[0][b];
      }
    } else {
      const int h = p.bi == nullptr ? s : p.bi[s];
      const T* base =
          (h < 0 || p.base == nullptr)
              ? nullptr
              : p.base + (static_cast<long long>(h) * m + a) * n;
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) {
          o[b] = (base == nullptr ? static_cast<T>(0) : base[b]) - acc[0][b];
        }
      }
    }
  }
}

// M, K, N fix the block shapes at compile time (0: at run time, up to
// kMaxDim).
template <typename T, int S, int M, int K, int N>
__global__ void __launch_bounds__(M ? kSlots * M : 1024)
    segprod_kernel(Prod<T> p, int m, int k, int n) {
  // one buffer for both element types, viewed as T
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  __shared__ Slots slots;
  const int* cta = p.ctas + 3 * blockIdx.x;
  const int first = cta[0], count = cta[1], g_log2 = cta[2];
  switch (g_log2 < kRegLanesLog2 ? g_log2 : kRegLanesLog2) {
    case 0:
      segprod_cta<T, S, 1, M, K, N>(p, m, k, n, first, count, g_log2, smem,
                                    slots);
      break;
    case 1:
      segprod_cta<T, S, 2, M, K, N>(p, m, k, n, first, count, g_log2, smem,
                                    slots);
      break;
    default:
      segprod_cta<T, S, 4, M, K, N>(p, m, k, n, first, count, g_log2, smem,
                                    slots);
  }
}

// Dynamic shared memory of S rounds of (m, k, n) rows of T, or of the
// tree where that is larger.
template <typename T>
size_t segprod_smem(int S, int m, int k, int n) {
  const size_t staged = static_cast<size_t>(S) * kSlots * (m + n) * k;
  const size_t tree = static_cast<size_t>(kSlots) * m * n;
  return (staged > tree ? staged : tree) * sizeof(T);
}

// ---- the float64 design ----

constexpr int kLanes64 = 2;  // at most 2 lanes a thread in registers

// segprod64's slot table: Slots' fields, and each staged row's phase h
// (its first double at offset h of its region) by stage, operand, slot.
struct Slots64 {
  int r0[kSlots];
  int r1[kSlots];
  int rounds, first, count;  // first and count: read again at the store
  int idx[kStages + 1][2][kSlots];
  unsigned char h[kStages][2][kSlots];
};

// A region of a row of W doubles: room for W at offset 0 or 1, even.
__host__ __device__ constexpr int region64(int w) { return (w + 2) & ~1; }

// A slot's staged row: the L region, the R region and 2 doubles more, so
// that consecutive slots start 16 bytes apart in bank order.
__host__ __device__ constexpr int row64(int m, int k, int n) {
  return region64(m * k) + region64(n * k) + 2;
}

__device__ __forceinline__ void cp_async16_f64(double* dst,
                                               const double* src) {
  cp_async16(reinterpret_cast<float*>(dst),
             reinterpret_cast<const float*>(src));
}

// Adds the products of a staged row pair into a lane, row a of L R^T:
// acc[b] += sum over j in order of L[a, j] R[b, j].
template <int K, int N>
__device__ __forceinline__ void add_products(
    const double* l, const double* rb, int k, int n,
    double (&acc)[N ? N : kMaxDim]) {
  constexpr int KI = K ? K : kMaxDim;
  constexpr int NI = N ? N : kMaxDim;
  double lv[KI];
#pragma unroll
  for (int c = 0; c < KI; ++c) lv[c] = c < k ? l[c] : 0.0;
#pragma unroll
  for (int b = 0; b < NI; ++b) {
    if (b < n) {
      double x = lv[0] * rb[b * k];
#pragma unroll
      for (int c = 1; c < KI; ++c) {
        if (c < k) x = x + lv[c] * rb[b * k + c];
      }
      acc[b] = acc[b] + x;
    }
  }
}

// One CTA of the float64 design with L = LANES lanes a thread. Threads:
// kSlots * m, thread (slot, a). The CTA's slots are slots [part * kSlots,
// ...) of each of its segments' Q = g / L; round i takes row q + i * Q of
// slot q's segment and feeds its lane j = i % L. S rounds of kSlots rows
// of row64 doubles in shared memory, in 16-byte pieces, S - 1 rounds
// ahead; the row indices S rounds ahead of those.
template <int S, int LANES, int M, int K, int N>
__device__ void segprod64_cta(const Prod<double>& p, int m_, int k_, int n_,
                              int first, int count, int g_log2, int part,
                              double* smem, Slots64& slots) {
  static_assert(S >= 2 && S <= kStages, "stages");
  constexpr int NI = N ? N : kMaxDim;
  constexpr int l_log2 = LANES == 2 ? 1 : 0;
  const int m = M ? M : m_;
  const int k = K ? K : k_;
  const int n = N ? N : n_;
  const int lw = m * k;
  const int rw = n * k;
  const int reg_l = region64(lw);
  const int rs = row64(m, k, n);
  const int pieces_l = reg_l >> 1;
  const int pieces = pieces_l + (region64(rw) >> 1);
  const int q_log2 = g_log2 - l_log2;  // Q = g / L slots a segment
  // slots a segment in this CTA: Q, or kSlots where it spans CTAs
  const int qc_log2 = q_log2 < 6 ? q_log2 : 6;
  const int Qc = 1 << qc_log2;
  const int t = threadIdx.x;
  const int slot = t / m;
  const int a = t - slot * m;
  const int sl = slot >> qc_log2;
  const int q = slot & (Qc - 1);

  if (t == 0) {
    slots.rounds = 0;
    slots.first = first;
    slots.count = count;
  }
  __syncthreads();
  if (t < kSlots) {
    int r0 = 0, r1 = 0;
    if ((t >> qc_log2) < count) {
      const int s = p.order[first + (t >> qc_log2)];
      r0 = p.offsets[s] + part * kSlots + (t & (Qc - 1));
      r1 = p.offsets[s + 1];
    }
    slots.r0[t] = r0;
    slots.r1[t] = r1;
    if (r1 > r0) {
      atomicMax(&slots.rounds, (r1 - r0 + (1 << q_log2) - 1) >> q_log2);
    }
  }
  __syncthreads();
  // (a thread's own slot bounds are read from shared memory each round,
  // and first and count again at the store: fewer registers live)
  const int rounds = slots.rounds;

  auto stage_idx = [&](int i) {
    if (i >= rounds) return;
    for (int u = t; u < 2 * kSlots; u += blockDim.x) {
      const int j = u & (kSlots - 1);
      const int which = u / kSlots;
      const int r = slots.r0[j] + (i << q_log2);
      if (r >= slots.r1[j]) continue;
      int* dst = &slots.idx[i % (S + 1)][which][j];
      const int* src = which ? p.ri : p.li;
      if (src != nullptr) {
        cp_async4(reinterpret_cast<float*>(dst),
                  reinterpret_cast<const float*>(src + r));
      } else {
        *dst = r;
      }
    }
  };
  auto buffer = [&](int i) { return smem + (i % S) * kSlots * rs; };
  // round i's rows into its buffer in 16-byte pieces: consecutive threads
  // on consecutive pieces of a row
  auto stage = [&](int i) {
    const int(*idx)[kSlots] = slots.idx[i % (S + 1)];
    double* buf = buffer(i);
    for (int e = t; e < kSlots * pieces; e += blockDim.x) {
      const int j = e / pieces;
      const int u0 = e - j * pieces;
      if (slots.r0[j] + (i << q_log2) >= slots.r1[j]) continue;
      const int right = u0 >= pieces_l;
      const int u = right ? u0 - pieces_l : u0;
      const int w = right ? rw : lw;
      const double* src =
          right ? p.R + static_cast<long long>(idx[1][j]) * rw
                : p.L + static_cast<long long>(idx[0][j]) * lw;
      const int h = static_cast<int>(reinterpret_cast<size_t>(src) >> 3) & 1;
      double* dst = buf + j * rs + (right ? reg_l : 0) + 2 * u;
      if (u == 0) slots.h[i % S][right][j] = static_cast<unsigned char>(h);
      const int c0 = 2 * u - h;  // the piece's first double in the row
      if (c0 >= 0 && c0 + 1 < w) {
        cp_async16_f64(dst, src + c0);
      } else if (c0 == -1) {
        cp_async8(dst + 1, src);
      } else if (c0 == w - 1) {
        cp_async8(dst, src + c0);
      }
    }
  };

  double acc[LANES][NI];
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
#pragma unroll
    for (int b = 0; b < NI; ++b) acc[j][b] = 0.0;
  }

#pragma unroll
  for (int i = 0; i < S; ++i) stage_idx(i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i > 0) __syncthreads();
    if (i < rounds) stage(i);
    stage_idx(i + S);
    cp_async_commit();
  }
  for (int i0 = 0; i0 < rounds; i0 += LANES) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) {  // round i feeds lane q + j*Q
      const int i = i0 + j;
      cp_async_wait<S - 2>();
      __syncthreads();
      if (i + S - 1 < rounds) stage(i + S - 1);
      stage_idx(i + 2 * S - 1);
      cp_async_commit();
      if (i < rounds && slots.r0[slot] + (i << q_log2) < slots.r1[slot]) {
        const double* row = buffer(i) + slot * rs;
        add_products<K, N>(row + slots.h[i % S][0][slot] + a * k,
                           row + reg_l + slots.h[i % S][1][slot], k, n,
                           acc[j]);
      }
    }
  }

  // the register level h = Q: lane q += lane q + Q, both in this thread
  if (LANES == 2) {
#pragma unroll
    for (int b = 0; b < NI; ++b) acc[0][b] = acc[0][b] + acc[LANES - 1][b];
  }
  cp_async_wait<0>();
  double* mine = smem + (slot * m + a) * n;
  if (q_log2 > 6) {
    // a 256-lane segment over the two CTAs of a cluster: the level h = 64
    // (slot q of part 0 += slot q of part 1) through part 0's shared
    // memory. The first barrier frees part 0's buffers, the second lands
    // part 1's sums.
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (part == 1) {
      double* dst = cl.map_shared_rank(mine, 0);
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) dst[b] = acc[0][b];
      }
    }
    cl.sync();
    if (part == 1) return;
#pragma unroll
    for (int b = 0; b < NI; ++b) {
      if (b < n) acc[0][b] = acc[0][b] + mine[b];
    }
  }
  __syncthreads();  // the buffers are free: the tree reuses them
  // levels h = Qc/2, ..., 1: slot q += slot q+h, through shared memory
  for (int h = Qc >> 1; h >= 1; h >>= 1) {
    if (q >= h && q < 2 * h) {
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) mine[b] = acc[0][b];
      }
    }
    __syncthreads();
    if (q < h) {
      const double* other = mine + h * m * n;
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) acc[0][b] = acc[0][b] + other[b];
      }
    }
    __syncthreads();
  }
  if (q == 0 && sl < slots.count) {
    const int s = p.order[slots.first + sl];
    double* o = p.out + (static_cast<long long>(s) * m + a) * n;
    if (p.base == nullptr && p.bi == nullptr) {
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) o[b] = acc[0][b];
      }
    } else {
      const int h = p.bi == nullptr ? s : p.bi[s];
      const double* base =
          (h < 0 || p.base == nullptr)
              ? nullptr
              : p.base + (static_cast<long long>(h) * m + a) * n;
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        if (b < n) o[b] = (base == nullptr ? 0.0 : base[b]) - acc[0][b];
      }
    }
  }
}

// The float64 design's kernel: p.ctas rows of 4 (first, count, log2 g,
// part). Two CTAs an SM at (9, 3, 9).
template <int S, int M, int K, int N>
__global__ void __launch_bounds__(M ? kSlots * M : 1024, M ? 2 : 1)
    segprod64_kernel(Prod<double> p, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  double* const smem = reinterpret_cast<double*>(smem_bytes);
  __shared__ Slots64 slots;
  const int* cta = p.ctas + 4 * blockIdx.x;
  const int first = cta[0], count = cta[1], g_log2 = cta[2], part = cta[3];
  if (g_log2 == 0) {
    segprod64_cta<S, 1, M, K, N>(p, m, k, n, first, count, g_log2, part,
                                 smem, slots);
  } else {
    segprod64_cta<S, kLanes64, M, K, N>(p, m, k, n, first, count, g_log2,
                                        part, smem, slots);
  }
}

// Dynamic shared memory of the float64 design: S rounds of padded rows,
// or the tree where that is larger.
size_t segprod64_smem(int S, int m, int k, int n) {
  const size_t staged = static_cast<size_t>(S) * kSlots * row64(m, k, n);
  const size_t tree = static_cast<size_t>(kSlots) * m * n;
  return (staged > tree ? staged : tree) * sizeof(double);
}

template <int S, int M, int K, int N>
const void* segprod64_fn() {
  return reinterpret_cast<const void*>(segprod64_kernel<S, M, K, N>);
}

// The opt-in limit of a CTA, less each design's static slot table.
constexpr size_t kSmemOptIn = 232448;

// Which instance a call takes, and its launch: the kernel and its
// dynamic shared memory (the float64 design where its two rounds fit,
// else the float32 design in T).
struct Pick {
  const void* fn;
  size_t smem;
  bool design64;
};

template <typename T>
Pick pick_segprod(int m, int k, int n) {
  constexpr size_t kMax = kSmemOptIn - sizeof(Slots);
  const bool nine = m == 9 && k == 3 && n == 9;
  if constexpr (sizeof(T) == 8) {
    constexpr size_t kMax64 = kSmemOptIn - sizeof(Slots64);
    if (segprod64_smem(kStages, m, k, n) <= kMax64) {
      return {nine ? segprod64_fn<kStages, 9, 3, 9>()
                   : segprod64_fn<kStages, 0, 0, 0>(),
              segprod64_smem(kStages, m, k, n), true};
    }
    if (segprod64_smem(2, m, k, n) <= kMax64) {
      return {segprod64_fn<2, 0, 0, 0>(), segprod64_smem(2, m, k, n), true};
    }
  }
  const bool three = segprod_smem<T>(kStages, m, k, n) <= kMax;
  if (!three && segprod_smem<T>(2, m, k, n) > kMax) {
    return {nullptr, 0, false};
  }
  const void* fn;
  if constexpr (sizeof(T) == 4) {
    if (nine) {
      return {reinterpret_cast<const void*>(
                  segprod_kernel<T, kStages, 9, 3, 9>),
              segprod_smem<T>(kStages, m, k, n), false};
    }
  }
  if (three) {
    fn = reinterpret_cast<const void*>(segprod_kernel<T, kStages, 0, 0, 0>);
  } else {
    fn = reinterpret_cast<const void*>(segprod_kernel<T, 2, 0, 0, 0>);
  }
  return {fn, segprod_smem<T>(three ? kStages : 2, m, k, n), false};
}

template <typename T>
int segprod(const void* L, const void* li, const void* R, const void* ri,
            const void* offsets, const void* order, const void* ctas,
            int n_cta, const void* ctas64, int n_cta64, int cluster64,
            void* out, const void* base, const void* bi, int m, int k, int n,
            void* stream) {
  if (m < 1 || k < 1 || n < 1 || m > kMaxDim || k > kMaxDim ||
      n > kMaxDim || n_cta < 0 || n_cta64 < 0 || cluster64 < 1 ||
      cluster64 > 2 || n_cta64 % cluster64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pick pk = pick_segprod<T>(m, k, n);
  if (pk.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = pk.design64 ? n_cta64 : n_cta;
  if (blocks == 0) return 0;
  const Prod<T> p{static_cast<const T*>(L), static_cast<const int*>(li),
                  static_cast<const T*>(R), static_cast<const int*>(ri),
                  static_cast<const int*>(offsets),
                  static_cast<const int*>(order),
                  static_cast<const int*>(pk.design64 ? ctas64 : ctas),
                  static_cast<T*>(out), static_cast<const T*>(base),
                  static_cast<const int*>(bi)};
  cudaError_t err = cudaFuncSetAttribute(
      pk.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pk.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(kSlots * m, 1, 1);
  cfg.dynamicSmemBytes = pk.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pk.design64 ? cluster64 : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pk.design64 ? 1 : 0;
  void* args[] = {const_cast<Prod<T>*>(&p), &m, &k, &n};
  err = cudaLaunchKernelExC(&cfg, pk.fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: (*, m*k) float32 (gt_segprod_f32) or float64 (gt_segprod_f64); li:
// (rows,) int32 or null; R: (*, n*k) of L's type; ri: (rows,) int32 or
// null; offsets: (num_segments+1,) int32 over the destination-sorted rows;
// order (num_segments,) int32 and ctas (n_cta, 3) int32 the host plan
// (segsum_stream.py, plan_products); out: (num_segments, m*n) of L's
// type; base and bi as in the store's modes above: bi (num_segments,)
// int32 base rows (-1: base +0.0) with base rows of m*n of L's type or
// null (every base +0.0); bi null: base null (out = the sums) or base row
// s (out's own, in place). m, k, n <= 16, with 3 (else 2) rounds of 64
// rows of (m + n) * k elements in at most 227 KB of shared memory.
// Launches on `stream` and returns the cudaGetLastError() code.
extern "C" int gt_segprod_f32(const void* L, const void* li, const void* R,
                              const void* ri, const void* offsets,
                              const void* order, const void* ctas, int n_cta,
                              void* out, const void* base, const void* bi,
                              int m, int k, int n, void* stream) {
  return segprod<float>(L, li, R, ri, offsets, order, ctas, n_cta, nullptr,
                        0, 1, out, base, bi, m, k, n, stream);
}

// The same in float64, with the float64 design's plan beside the float32
// one: ctas64 (n_cta64, 4) int32 (first, count, log2 g, part) in clusters
// of cluster64 CTAs (1 or 2; product_ctas_f64). The float32 plan serves
// the shapes the float64 design does not take.
extern "C" int gt_segprod_f64(const void* L, const void* li, const void* R,
                              const void* ri, const void* offsets,
                              const void* order, const void* ctas, int n_cta,
                              const void* ctas64, int n_cta64, int cluster64,
                              void* out, const void* base, const void* bi,
                              int m, int k, int n, void* stream) {
  return segprod<double>(L, li, R, ri, offsets, order, ctas, n_cta, ctas64,
                         n_cta64, cluster64, out, base, bi, m, k, n, stream);
}

// The instance a call of (f64, m, k, n) takes: out[0..5] = registers a
// thread, local memory a thread in bytes (spills and stack), resident
// CTAs an SM at its launch's threads and shared memory, threads a CTA,
// dynamic shared memory in bytes, 1 for the float64 design (else 0).
extern "C" int gt_segprod_instance(int f64, int m, int k, int n, int* out) {
  if (m < 1 || k < 1 || n < 1 || m > kMaxDim || k > kMaxDim ||
      n > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pick pk = f64 ? pick_segprod<double>(m, k, n)
                      : pick_segprod<float>(m, k, n);
  if (pk.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pk.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pk.smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pk.fn);
  int ctas = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, pk.fn,
                                                        kSlots * m, pk.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = ctas;
  out[3] = kSlots * m;
  out[4] = static_cast<int>(pk.smem);
  out[5] = pk.design64 ? 1 : 0;
  return 0;
}

extern "C" const char* gt_segprod_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
