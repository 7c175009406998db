// K6: a whole matrix-free preconditioned CG solve in one launch, on one
// thread-block cluster of a Hopper card (sm_90a).
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
// Design: one cluster of C <= 16 CTAs of 512 threads (C from the
// wrapper), one CTA per SM. The N = n*d vector entries are cut into
// 1024-entry chunks; CTA c owns ceil(chunks / C) consecutive chunks, so
// the rows holding them and their incidences (the row CSR of (factor,
// slot) pairs). Its eight vectors (x, r and r_new, z and z_new, p of this
// step and the next, H p) live in its shared memory where they fit (one
// decision for the whole cluster; else in a global scratch buffer), and
// so does what does not change over the solve, each piece where it still
// fits (else it is read from global memory): the CSR slice, each
// incidence's block, J' row and slot rows, the rows' inverse blocks and
// each incidence's factor row of J'. A CG step:
//   1. v = J'_f p for the factor of every own incidence (a factor whose
//      two slots are both own rows is computed twice, the same bits), one
//      thread per incidence: p gathered at the slot rows from the CTAs
//      that own them (distributed shared memory), then each residual row,
//      slots then columns in order. p is not stored for the gathers: p_0
//      is z_0, and after that each gather forms z + beta p from the
//      owner's z and last p, the bits of the owner's own update;
//   2. Hp[i] = damp * p + sum over the row's incidences, in CSR order, of
//      J'_{f,s}^T v: one thread per entry, no atomics;
//   3. the dots p.Hp, r_new.r_new and r_new.z_new in pcg_loop.tree_sum's
//      order: a CTA sums each of its chunks by groups of 32 entries (a
//      shuffle-down halving tree) and the chunk's 32 group sums the same
//      way (tree_sum's first two levels) and stores the chunk sum into
//      every CTA's shared memory; then every warp of every CTA finishes
//      the tree over the chunk sums in the same order. p.Hp and
//      r_new.r_new travel as st.async stores counted on the receiver's
//      mbarrier (cluster.cuh: no fence), r_new.r_new with the entries of
//      r_new in the rows a CTA shares with its neighbours (a halo); r_new
//      .z_new as plain stores and a release/acquire cluster barrier, which
//      also publishes z_new and p for the next step's gathers. Every
//      thread of the cluster holds the same sums, so rz, rz_min and done,
//      the loop and its branches are uniform across the cluster (a CTA
//      leaving the loop early would leave the others waiting);
//   4. the vector updates, one thread per entry;
//   5. z = M_row (r / ||r||), the products taken in column order (each
//      r / ||r|| divided once).
// One cluster barrier and two fence-free exchanges per step. No sum
// depends on C: every sum has one order, and the work is split only
// between whole outputs and whole dot chunks. All arithmetic is IEEE fp32
// and the file is built with -fmad=false, so the plain version
// (ops/cuda/pcg_mf.py, solve_pcg_mf_plain), which takes every product,
// sum and dot in this order, gives the same bits.
//
// Bound: a 50-step solve does ~60 MFLOP and moves ~1.4 MB at sphere2500
// (~1 us at the card's rates); a serial CG cannot reach that. Its floor is
// the chain of dependent steps: per CG step one cluster barrier, two
// exchanges, the gathers of p, and the in-order sums. The barriers and
// exchanges alone take ~0.06 ms a solve on an H100 (kernel_sweep.py); the
// rest is each thread's index work and dependent loads (J' staged in
// shared memory saves a fifth against J' read from L2).
//
// The float64 instance (gt_pcg_mf_f64) has a design of its own,
// pcg_mf64_kernel below: the same sums in the same order on 256 threads
// with no spills, J' p once a factor, J' staged by slot block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 1024;  // entries per dot chunk: tree_sum's levels 1-2
constexpr int kMaxChunks = 1024;  // finish_tree folds 32 x 32 chunk sums
constexpr int kDesc = 6;          // jbase, vbase, rbase, F, E, arity
constexpr int kVecs = 8;          // x, r (2), z (2), p (2), Hp

// Kernel arguments. T: the vectors' and every sum's type (float, or
// double in the float64 instance); JT: J''s (float, or double / float
// there); MT: the inverse blocks' (likewise).
template <class T, class JT, class MT>
struct Args {
  const JT* jf;
  const int* rows;
  const int* desc;
  int nb;
  const int* csr_off;
  const int* inc_j;
  const int* inc_e;
  const T* b;
  const T* damp;
  const MT* minv;
  T* work;
  T* x_out;
  int* iters_out;
  int n, d, max_iter;
  T tol, ratio;
  int stage_j;     // 0: J' is always read from global memory
  int smem_bytes;  // the launch's dynamic shared memory
};

// This CTA's share; the same in all its threads.
struct Share {
  int C, rank;
  int N, nch, per, ch0, nown;  // chunks [ch0, ch0 + nown) of nch, per CTA
  int e0, e1;                  // their entries [e0, e1)
};

// The CG vectors. Buffer b of this CTA's entries is own(b)[i - e0], in
// shared memory where all eight fit (the same decision in every CTA), else
// in the global buffer glob (b * N + i).
template <class T>
struct Vecs {
  T* base;  // own(b) = base + b * stride
  int stride;
  T* glob;  // null when the vectors are in shared memory
  __device__ T* own(int b) const {
    return base + static_cast<long long>(b) * stride;
  }
  // Entry idx of buffer b, whichever CTA owns it (visible after the last
  // release/acquire cluster barrier); owner[chunk] is the chunk's CTA.
  __device__ T at(const cg::cluster_group& cl, const Share& sh,
                  const unsigned char* owner, int b, int idx) const {
    if (glob != nullptr) {
      return __ldcg(glob + static_cast<long long>(b) * sh.N + idx);
    }
    const int o = owner[idx >> 10];
    return *(cl.map_shared_rank(own(b), o) + (idx - o * sh.per * kChunk));
  }
};

// IEEE division and square root, correctly rounded in T (no fast math)
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// A shuffle of a double is two 32-bit shuffles (CUDA's own overloads).
template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// tree_sum's levels 3, 4 over the m chunk sums (m <= 1024); with one
// chunk its sum is the total (tree_sum takes at least two levels). Every
// warp computes it, so every thread gets the value with no barrier.
template <class T>
__device__ T finish_tree(const T* part, int m) {
  if (m == 1) return part[0];
  const int lane = threadIdx.x & 31;
  const int k = (m + 31) >> 5;
  T held = 0;  // lane g: the sum of chunk sums 32g .. 32g + 31
  for (int g = 0; g < k; ++g) {
    const int i = (g << 5) + lane;
    const T v = __shfl_sync(0xffffffffu,
                            warp_sum(i < m ? part[i] : static_cast<T>(0)), 0);
    if (lane == g) held = v;
  }
  const T total = k == 1 ? held : warp_sum(held);
  return __shfl_sync(0xffffffffu, total, 0);
}

// The sum over i < N of val(i) in pcg_loop.tree_sum's order, the same
// value in every thread of the cluster. `part` is this dot's nch slots (at
// the same offset in every CTA's shared memory), `grp` 32 entries per own
// chunk. Entry i of an own chunk is taken by the thread that owns it in
// the strided loops (i = e0 + threadIdx.x + 1024 m), so val may read what
// that thread just wrote. With `bar`, the chunk sums travel as st.async
// stores (sizeof(T) bytes each) counted on each CTA's mbarrier, which
// expects `bytes` (its chunk sums and any halo stored in the same phase;
// no fence); without, as plain stores followed by a release/acquire
// cluster barrier, which also publishes every earlier write of the
// cluster.
template <class T, class Val, int THREADS = kThreads>
__device__ T cluster_sum(const cg::cluster_group& cl, const Share& sh,
                         Val val, T* part, T* grp, unsigned long long* bar,
                         unsigned bytes, unsigned& parity) {
  constexpr int kW = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < (sh.nown << 5); q += kW) {
    const int i = sh.e0 + (q << 5) + lane;  // chunk q / 32, group q % 32
    const T v = warp_sum(i < sh.N ? val(i) : static_cast<T>(0));
    if (lane == 0) grp[q] = v;
  }
  __syncthreads();
  for (int c = warp; c < sh.nown; c += kW) {
    const T v = __shfl_sync(0xffffffffu, warp_sum(grp[(c << 5) + lane]), 0);
    if (lane < sh.C) {
      if (bar != nullptr) {
        st_async(part + sh.ch0 + c, v, bar, lane);
      } else {
        *cl.map_shared_rank(part + sh.ch0 + c, lane) = v;
      }
    }
  }
  if (bar != nullptr) {
    if (threadIdx.x == 0) mbar_expect(bar, bytes);
    mbar_wait(bar, parity);
    parity ^= 1;
  } else {
    cl.sync();
  }
  return finish_tree(part, sh.nch);
}

// A bump allocator over the CTA's dynamic shared memory: a piece is
// placed only if it fits (16-byte aligned pieces, sized in bytes of their
// own element type).
struct Bump {
  unsigned char* base;
  size_t used, cap;
  template <class E>
  __device__ E* take(long long count) {
    const size_t bytes = (static_cast<size_t>(count) * sizeof(E) + 15) & ~15;
    if (used + bytes > cap) return nullptr;
    E* p = reinterpret_cast<E*>(base + used);
    used += bytes;
    return p;
  }
};

// The bytes of the fixed head of a CTA's shared memory: the two mbarriers
// (16), the three dots' chunk slots, the halo and the group sums (T), the
// descriptors (int) and the chunk owners (a byte each), rounded up to 16.
template <class T>
__host__ __device__ inline size_t head_bytes(long long nch, long long per,
                                             int d, int nb) {
  return (16 + static_cast<size_t>(3 * nch + 2LL * d + 32 * per) * sizeof(T) +
          static_cast<size_t>(nb) * kDesc * 4 + static_cast<size_t>(nch) +
          15) &
         ~static_cast<size_t>(15);
}

// The block and factor of the incidence whose J' slot block starts at
// jslot (the blocks' J' ranges are consecutive).
__device__ __forceinline__ int2 factor_of(const int* desc, int nb, int d,
                                          int jslot) {
  int bi = 0;
  while (bi + 1 < nb && jslot >= desc[(bi + 1) * kDesc]) ++bi;
  const int* ds = desc + bi * kDesc;
  const int W = ds[5] * ds[4] * d;
  return make_int2(bi, (jslot - ds[0]) / W);
}

// Every product of J' or of an inverse block with a vector entry takes
// the J' or block entry in T first (a float widened exactly to double),
// as PyTorch promotes a float32 tensor times a float64 one.
template <class T, class JT, class MT>
__global__ void __launch_bounds__(kThreads, 1)
    pcg_mf_kernel(const Args<T, JT, MT> a) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n = a.n, d = a.d, nb = a.nb;
  Share sh;
  sh.C = static_cast<int>(gridDim.x);  // the grid is one cluster
  sh.rank = static_cast<int>(cl.block_rank());
  sh.N = n * d;
  sh.nch = (sh.N + kChunk - 1) / kChunk;
  sh.per = (sh.nch + sh.C - 1) / sh.C;
  sh.ch0 = min(sh.rank * sh.per, sh.nch);
  sh.nown = min(sh.per, sh.nch - sh.ch0);
  sh.e0 = min(sh.ch0 * kChunk, sh.N);
  sh.e1 = min(sh.e0 + sh.nown * kChunk, sh.N);
  const int N = sh.N;
  const int e0 = sh.e0, e1 = sh.e1;
  const int own_cap = sh.per * kChunk;

  // Shared memory, the same layout in every CTA up to the vectors: the
  // mbarriers of the two fence-free exchanges, the three dots' chunk slots
  // (stored by every CTA), the halo of the rows this CTA shares with its
  // neighbours (stored by them), the own chunks' group sums, the
  // descriptors, the vectors if they fit; then the staged pieces. Every
  // size is in bytes of its own type, so the float64 instance places what
  // fits of its 8-byte entries by the same rule.
  unsigned long long* bar_ph = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* bar_rr = bar_ph + 1;
  T* part_ph = reinterpret_cast<T*>(smem + 16);
  T* part_rr = part_ph + sh.nch;
  T* part_rz = part_rr + sh.nch;
  T* halo_lo = part_rz + sh.nch;  // entries [row0 d, e0) of r_new
  T* halo_hi = halo_lo + d;       // entries [e1, row1 d)
  T* grp = halo_hi + d;
  int* desc = reinterpret_cast<int*>(grp + 32 * sh.per);
  unsigned char* owner = reinterpret_cast<unsigned char*>(desc + nb * kDesc);
  Bump bump{smem, head_bytes<T>(sh.nch, sh.per, d, nb),
            static_cast<size_t>(a.smem_bytes)};
  Vecs<T> vec;
  T* vs = bump.take<T>(static_cast<long long>(kVecs) * own_cap);
  vec.base = vs != nullptr ? vs : a.work + e0;
  vec.stride = vs != nullptr ? own_cap : N;
  vec.glob = vs != nullptr ? nullptr : a.work;
  T* X = vec.own(0);
  T* HP = vec.own(7);
  for (int i = tid; i < nb * kDesc; i += kThreads) desc[i] = a.desc[i];
  for (int c = tid; c < sh.nch; c += kThreads) owner[c] = c / sh.per;
  if (tid == 0) {
    mbar_init(bar_ph);
    mbar_init(bar_rr);
    fence_mbar_init();
  }
  int emax = 1, amax = 1, wmax = 1;
  for (int bi = 0; bi < nb; ++bi) {
    const int* ds = a.desc + bi * kDesc;
    emax = max(emax, ds[4]);
    amax = max(amax, ds[5]);
    wmax = max(wmax, ds[5] * ds[4] * d);
  }
  __syncthreads();

  // the own rows (those holding an own entry) and their incidences
  const int row0 = e0 / d;
  const int row1 = (e1 + d - 1) / d;
  const int nr = row1 - row0;
  const int t0 = a.csr_off[row0];
  const int ninc = a.csr_off[row1] - t0;
  const int n_lo = e0 - row0 * d;  // halo entries this CTA receives
  const int n_hi = row1 * d - e1;
  // the pieces, each staged where it fits: the CSR slice and the
  // incidences' J' slot offsets and residual dims; per incidence its
  // block and factor row and slot rows; the gathered p and the products
  // J' p per incidence (global scratch otherwise); the inverse blocks;
  // J' per incidence (its factor's whole row)
  int* s_csr = bump.take<int>(nr + 1 + 2LL * ninc);
  int* s_fac = bump.take<int>((2LL + amax) * ninc);
  T* pg = bump.take<T>(1LL * ninc * amax * d);
  T* vt = bump.take<T>(1LL * ninc * emax);
  MT* s_minv =
      a.minv == nullptr ? nullptr
                        : bump.take<MT>(static_cast<long long>(nr) * d * d);
  JT* s_j = a.stage_j ? bump.take<JT>(1LL * ninc * wmax) : nullptr;
  T* scratch = a.work + static_cast<long long>(kVecs) * N;
  if (pg == nullptr) pg = scratch + 1LL * t0 * amax * d;
  if (vt == nullptr) {
    vt = scratch + static_cast<long long>(a.csr_off[n]) * amax * d +
         1LL * t0 * emax;
  }

  if (s_csr != nullptr) {
    for (int i = tid; i <= nr; i += kThreads) s_csr[i] = a.csr_off[row0 + i];
    for (int t = tid; t < ninc; t += kThreads) {
      s_csr[nr + 1 + t] = a.inc_j[t0 + t];
      s_csr[nr + 1 + ninc + t] = a.inc_e[t0 + t];
    }
  }
  // co[row - row0]: the row's first incidence; ij / ie[t - t0]
  const int* co = s_csr != nullptr ? s_csr : a.csr_off + row0;
  const int* ij = s_csr != nullptr ? s_csr + nr + 1 : a.inc_j + t0;
  const int* ie = s_csr != nullptr ? s_csr + nr + 1 + ninc : a.inc_e + t0;
  if (s_fac != nullptr) {  // block, factor row in J', slot rows
    for (int t = tid; t < ninc; t += kThreads) {
      const int2 bf = factor_of(desc, nb, d, a.inc_j[t0 + t]);
      const int* ds = desc + bf.x * kDesc;
      s_fac[t] = bf.x;
      s_fac[ninc + t] = ds[0] + bf.y * ds[5] * ds[4] * d;
      for (int s = 0; s < ds[5]; ++s) {
        s_fac[2 * ninc + t * amax + s] = a.rows[ds[2] + s * ds[3] + bf.y];
      }
    }
  }
  if (s_minv != nullptr) {
    const MT* src = a.minv + static_cast<long long>(row0) * d * d;
    for (long long q = tid; q < static_cast<long long>(nr) * d * d;
         q += kThreads) {
      s_minv[q] = src[q];
    }
  }
  if (s_j != nullptr) {
    for (long long q = tid; q < 1LL * ninc * wmax; q += kThreads) {
      const int t = static_cast<int>(q / wmax);
      const int k = static_cast<int>(q - 1LL * t * wmax);
      const int2 bf = factor_of(desc, nb, d, a.inc_j[t0 + t]);
      const int* ds = desc + bf.x * kDesc;
      const int W = ds[5] * ds[4] * d;
      if (k < W) s_j[q] = a.jf[ds[0] + static_cast<long long>(bf.y) * W + k];
    }
  }
  const MT* mv =
      a.minv == nullptr
          ? nullptr
          : (s_minv != nullptr ? s_minv
                               : a.minv + static_cast<long long>(row0) * d * d);
  // incidence t's block, J' factor row and slot-s row (t local)
  auto inc_factor = [&](int t, int& bi, int& frow) {
    if (s_fac != nullptr) {
      bi = s_fac[t];
      frow = s_fac[ninc + t];
      return;
    }
    const int2 bf = factor_of(desc, nb, d, ij[t]);
    bi = bf.x;
    frow = desc[bi * kDesc] + bf.y * desc[bi * kDesc + 5] *
                                  desc[bi * kDesc + 4] * d;
  };
  auto slot_row = [&](int t, int bi, int frow, int s) {
    if (s_fac != nullptr) return s_fac[2 * ninc + t * amax + s];
    const int* ds = desc + bi * kDesc;
    const int f = (frow - ds[0]) / (ds[5] * ds[4] * d);
    return a.rows[ds[2] + s * ds[3] + f];
  };

  const T zero = 0;
  for (int i = e0 + tid; i < e1; i += kThreads) {
    X[i - e0] = zero;
    vec.own(1)[i - e0] = a.b[i];
  }
  cl.sync();  // the mbarriers initialized in every CTA

  // z = M_row (r / s) on the own entries (the identity when mv is null):
  // y = r / s once per own entry (into y, then a CTA barrier), r's entries
  // outside [e0, e1) from the halo (or from b, at the start)
  auto precondition = [&](const T* r, T* y, T* z, T s, bool start) {
    if (mv == nullptr) {
      for (int i = e0 + tid; i < e1; i += kThreads) {
        z[i - e0] = div_rn(r[i - e0], s);
      }
      return;
    }
    for (int i = e0 + tid; i < e1; i += kThreads) {
      y[i - e0] = div_rn(r[i - e0], s);
    }
    __syncthreads();
    for (int i = e0 + tid; i < e1; i += kThreads) {
      const int row = i / d;
      const int c = i - row * d;
      const MT* m =
          mv + static_cast<long long>(row - row0) * d * d + c * d;
      T acc = zero;
      for (int j = 0; j < d; ++j) {
        const int q = row * d + j;
        const T yq =
            q >= e0 && q < e1
                ? y[q - e0]
                : div_rn(start    ? a.b[q]
                         : q < e0 ? halo_lo[q - row0 * d]
                                  : halo_hi[q - e1],
                         s);
        acc += static_cast<T>(m[j]) * yq;
      }
      z[i - e0] = acc;
    }
  };

  unsigned par_ph = 0, par_rr = 0, par_rz = 0;
  constexpr unsigned kBytes = sizeof(T);
  const unsigned chunk_bytes = kBytes * sh.nch;
  const unsigned halo_bytes = chunk_bytes + kBytes * (n_lo + n_hi);
  int ri = 1, zi = 3;  // r: own[ri], r_new: own[3 - ri]; z: 3 / 4
  {
    const T* b = a.b;
    const T s0 = sqrt_rn(cluster_sum(
        cl, sh, [=](int i) { return b[i] * b[i]; }, part_rr, grp, bar_rr,
        chunk_bytes, par_rr));
    precondition(vec.own(ri), HP, vec.own(zi),
                 s0 == zero ? static_cast<T>(1) : s0, true);
  }
  T* P0 = vec.own(5);
  for (int i = e0 + tid; i < e1; i += kThreads) {
    P0[i - e0] = vec.own(zi)[i - e0];
  }
  T rz;
  {
    const T* r = vec.own(ri);
    const T* z = vec.own(zi);
    // a release barrier: p reaches the first step's gathers
    rz = cluster_sum(
        cl, sh, [=](int i) { return r[i - e0] * z[i - e0]; }, part_rz, grp,
        nullptr, 0, par_rz);
  }
  T rz_min = INFINITY;
  T beta_prev = zero;
  int k = 0;
  bool done = false;
  while (k < a.max_iter && !done && rz != zero) {
    // p of this step: p_0 = z_0; then z + beta p of the last step, formed
    // here from the owners' z and p (the same bits as the owner's update)
    const int pi = 5 + (k & 1);
    T* p = vec.own(pi);
    // 1. per own incidence (one thread each): gather p at its factor's
    // slot rows, then v = J'_f p, slots then columns in order
    for (int t = tid; t < ninc; t += kThreads) {
      int bi, frow;
      inc_factor(t, bi, frow);
      const int E = ie[t];
      const int arity = desc[bi * kDesc + 5];
      T* pr = pg + static_cast<long long>(t) * amax * d;
      for (int s = 0; s < arity; ++s) {
        const int row = slot_row(t, bi, frow, s);
        for (int j = 0; j < d; ++j) {
          T val = zero;  // the zero row of a fixed vertex
          if (row < n) {
            const int idx = row * d + j;
            val = k == 0 ? vec.at(cl, sh, owner, 5, idx)
                         : vec.at(cl, sh, owner, zi, idx) +
                               beta_prev * vec.at(cl, sh, owner, 11 - pi, idx);
          }
          pr[s * d + j] = val;
        }
      }
      const JT* jr = s_j != nullptr
                         ? s_j + static_cast<long long>(t) * wmax
                         : a.jf + frow;
      for (int e = 0; e < E; ++e) {
        T acc = zero;
        for (int s = 0; s < arity; ++s) {
          for (int j = 0; j < d; ++j) {
            acc += static_cast<T>(jr[(s * E + e) * d + j]) * pr[s * d + j];
          }
        }
        vt[static_cast<long long>(t) * emax + e] = acc;
      }
    }
    __syncthreads();
    // 2. Hp = damp * p + J'^T v on the own entries, incidences in CSR order
    for (int i = e0 + tid; i < e1; i += kThreads) {
      const int row = i / d;
      const int c = i - row * d;
      T acc = zero;
      const int ta = co[row - row0] - t0, tb = co[row - row0 + 1] - t0;
      for (int t = ta; t < tb; ++t) {
        const int E = ie[t];
        const JT* jc;
        if (s_j != nullptr) {
          int bi, frow;
          inc_factor(t, bi, frow);
          jc = s_j + static_cast<long long>(t) * wmax + (ij[t] - frow) + c;
        } else {
          jc = a.jf + ij[t] + c;
        }
        const T* vf = vt + static_cast<long long>(t) * emax;
        T g = zero;
        for (int e = 0; e < E; ++e) g += static_cast<T>(jc[e * d]) * vf[e];
        acc += g;
      }
      HP[i - e0] = a.damp[i] * p[i - e0] + acc;
    }
    const T alpha = div_rn(
        rz, cluster_sum(
                cl, sh,
                [=](int i) { return p[i - e0] * HP[i - e0]; }, part_ph, grp,
                bar_ph, chunk_bytes, par_ph));
    T* r = vec.own(ri);
    T* rn = vec.own(3 - ri);
    const int lo_end = min(e1, (e0 / d + 1) * d);  // the first row's part
    const int hi_start = max(e0, (e1 / d) * d);    // the last row's part
    for (int i = e0 + tid; i < e1; i += kThreads) {
      const T v = r[i - e0] - alpha * HP[i - e0];
      rn[i - e0] = v;
      // a row shared with a neighbour: store this CTA's part in its halo
      if (e0 % d != 0 && i < lo_end) {
        st_async(halo_hi + (i - e0), v, bar_rr, sh.rank - 1);
      }
      if (e1 % d != 0 && e1 < N && i >= hi_start) {
        st_async(halo_lo + (i - hi_start), v, bar_rr, sh.rank + 1);
      }
    }
    const T rnorm = sqrt_rn(cluster_sum(
        cl, sh, [=](int i) { return rn[i - e0] * rn[i - e0]; }, part_rr,
        grp, bar_rr, halo_bytes, par_rr));
    T* zn = vec.own(7 - zi);
    precondition(rn, HP, zn, rnorm == zero ? static_cast<T>(1) : rnorm,
                 false);
    // a release barrier: z_new (and p) reach the next step's gathers
    const T rz_new = cluster_sum(
        cl, sh, [=](int i) { return rn[i - e0] * zn[i - e0]; }, part_rz,
        grp, nullptr, 0, par_rz);

    const bool reject = fabs(rz_new) > a.ratio * rz_min || isnan(rz_new);
    const T aa = fabs(rz_new);
    rz_min = (isnan(aa) || isnan(rz_min)) ? static_cast<T>(NAN)
                                          : fmin(rz_min, aa);
    const T beta = div_rn(rz_new, rz);
    const bool converged = fabs(rz_new) < a.tol;
    ++k;
    if (!reject) {
      T* pn = vec.own(11 - pi);
      for (int i = e0 + tid; i < e1; i += kThreads) {
        X[i - e0] = X[i - e0] + alpha * p[i - e0];
        pn[i - e0] = zn[i - e0] + beta * p[i - e0];
      }
      ri = 3 - ri;
      zi = 7 - zi;
      rz = rz_new;
      beta_prev = beta;
    }
    done = reject || converged;
  }
  for (int i = e0 + tid; i < e1; i += kThreads) a.x_out[i] = X[i - e0];
  if (sh.rank == 0 && tid == 0) *a.iters_out = k;
  cl.sync();  // no CTA leaves while another may still read its vectors
}

// ---- the float64 design ----
//
// pcg_mf64_kernel<JT, MT, D>: the float64 instance's own design, the same
// sums in the same order as pcg_mf_kernel (so the same bits). What it
// changes, for a double CG step whose chain the float design in T =
// double made 1.8x longer (512 threads capped at 128 registers spilled;
// J' per incidence, 211 KB at sphere2500, read from L2):
// - 256 threads a CTA (kThreads64), capped at 255 registers: no spills;
//   the vertex dim D a template argument (6: SE3; 0: any), so the short
//   loops over a row's entries unroll and their loads overlap;
// - v = J'_f p once per factor and CTA: by the incidence of the factor's
//   lowest slot whose row is this CTA's, one thread per (incidence,
//   residual row); the factor's other own incidences read its v. So J'
//   is staged once per incidence as its own slot block (E x d, 105 KB in
//   double at sphere2500), which J'^T v reads, and v reads each slot's
//   block from the incidence that holds it (from L2 where the slot's row
//   is another CTA's);
// - p is gathered once per step only at the rows that are not this
//   CTA's ("ghost" rows, one per (factor, slot) that needs one: z + beta
//   p from the owner's shared memory, as before), the own rows read from
//   the CTA's own p; the gathers of a thread are issued four at a time;
// - the inverse blocks are staged after J' (they go to L2 under FP64_FP64
//   with block-Jacobi) and read a row's D entries at once, four rows at a
//   time.
// The dots, exchanges and barriers are pcg_mf_kernel's (cluster_sum on
// 256 threads). Each CTA's table (below), ghost rows and v must fit in
// its shared memory beside the vectors (need64, checked by the host);
// where they do not, the float design in double runs instead.
constexpr int kThreads64 = 256;

// Per own incidence t: [0] block, [1] J' offset of its factor's row, [2]
// its slot, [3] the local incidence that computes its factor's v, [4] its
// first ghost row (set-up only); per slot s < amax: [5 + s] where p is
// read (>= 0: offset into the own vector; -1: a fixed vertex, zeros; <=
// -2: ghost row -2 - value), [5 + amax + s] the local incidence of slot s
// (-1: not this CTA's).
__host__ __device__ inline int tab_ints(int amax) { return 5 + 2 * amax; }

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// The shared memory the float64 design needs beyond the head, for a CTA
// of `nr` rows and `ninc` incidences: the vectors, the CSR slice, the
// table, the ghost rows (at most one per incidence and slot) and v per
// incidence. J' and the inverse blocks are staged where the rest allows.
__host__ __device__ inline size_t need64(long long per, long long nr,
                                         long long ninc, int d, int amax,
                                         int emax) {
  return round16(8ull * kVecs * per * kChunk) +
         round16(4ull * (nr + 1 + 2 * ninc)) +
         round16(4ull * ninc * tab_ints(amax)) +
         round16(8ull * ninc * amax * d) + round16(4ull * ninc * amax) +
         round16(8ull * ninc * emax);
}

template <class JT, class MT, int D>
__global__ void __launch_bounds__(kThreads64, 1)
    pcg_mf64_kernel(const Args<double, JT, MT> a) {
  using T = double;
  constexpr int TH = kThreads64;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n, d = D ? D : a.d, nb = a.nb;
  Share sh;
  sh.C = static_cast<int>(gridDim.x);
  sh.rank = static_cast<int>(cl.block_rank());
  sh.N = n * d;
  sh.nch = (sh.N + kChunk - 1) / kChunk;
  sh.per = (sh.nch + sh.C - 1) / sh.C;
  sh.ch0 = min(sh.rank * sh.per, sh.nch);
  sh.nown = min(sh.per, sh.nch - sh.ch0);
  sh.e0 = min(sh.ch0 * kChunk, sh.N);
  sh.e1 = min(sh.e0 + sh.nown * kChunk, sh.N);
  const int N = sh.N;
  const int e0 = sh.e0, e1 = sh.e1;
  const int own_cap = sh.per * kChunk;

  // the head, as pcg_mf_kernel's
  unsigned long long* bar_ph = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* bar_rr = bar_ph + 1;
  T* part_ph = reinterpret_cast<T*>(smem + 16);
  T* part_rr = part_ph + sh.nch;
  T* part_rz = part_rr + sh.nch;
  T* halo_lo = part_rz + sh.nch;
  T* halo_hi = halo_lo + d;
  T* grp = halo_hi + d;
  int* desc = reinterpret_cast<int*>(grp + 32 * sh.per);
  unsigned char* owner = reinterpret_cast<unsigned char*>(desc + nb * kDesc);
  Bump bump{smem, head_bytes<T>(sh.nch, sh.per, d, nb),
            static_cast<size_t>(a.smem_bytes)};
  Vecs<T> vec;
  vec.base = bump.take<T>(static_cast<long long>(kVecs) * own_cap);
  vec.stride = own_cap;
  vec.glob = nullptr;
  T* X = vec.own(0);
  T* HP = vec.own(7);
  for (int i = tid; i < nb * kDesc; i += TH) desc[i] = a.desc[i];
  for (int c = tid; c < sh.nch; c += TH) owner[c] = c / sh.per;
  if (tid == 0) {
    mbar_init(bar_ph);
    mbar_init(bar_rr);
    fence_mbar_init();
  }
  int emax = 1, amax = 1;
  for (int bi = 0; bi < nb; ++bi) {
    emax = max(emax, a.desc[bi * kDesc + 4]);
    amax = max(amax, a.desc[bi * kDesc + 5]);
  }
  __syncthreads();

  const int row0 = e0 / d;
  const int row1 = (e1 + d - 1) / d;
  const int nr = row1 - row0;
  const int t0 = a.csr_off[row0];
  const int ninc = a.csr_off[row1] - t0;
  const int n_lo = e0 - row0 * d;
  const int n_hi = row1 * d - e1;
  const int ti = tab_ints(amax);
  int* s_csr = bump.take<int>(nr + 1 + 2LL * ninc);
  int* tab = bump.take<int>(1LL * ninc * ti);
  if (vec.base == nullptr || s_csr == nullptr || tab == nullptr) __trap();
  for (int i = tid; i <= nr; i += TH) s_csr[i] = a.csr_off[row0 + i];
  for (int t = tid; t < ninc; t += TH) {
    s_csr[nr + 1 + t] = a.inc_j[t0 + t];
    s_csr[nr + 1 + ninc + t] = a.inc_e[t0 + t];
  }
  const int* co = s_csr;
  const int* ij = s_csr + nr + 1;
  const int* ie = s_csr + nr + 1 + ninc;
  __syncthreads();
  // the table, and each incidence's count of ghost rows (if it computes v)
  auto slot_row = [&](const int* ds, int f, int s) {
    return a.rows[ds[2] + s * ds[3] + f];
  };
  for (int t = tid; t < ninc; t += TH) {
    const int2 bf = factor_of(desc, nb, d, ij[t]);
    const int* ds = desc + bf.x * kDesc;
    const int E = ds[4], ar = ds[5];
    const int frow = ds[0] + bf.y * ar * E * d;
    const int mine = (ij[t] - frow) / (E * d);
    int* tt = tab + static_cast<long long>(t) * ti;
    int vsrc = -1, ghosts = 0;
    for (int s = 0; s < amax; ++s) {
      int loc = -1, src = -1;
      if (s < ar) {
        const int r = slot_row(ds, bf.y, s);
        if (s == mine) {
          loc = t;
        } else if (r < n && r >= row0 && r < row1) {
          const int want = frow + s * E * d;
          for (int u = co[r - row0] - t0; u < co[r - row0 + 1] - t0; ++u) {
            if (ij[u] == want) {
              loc = u;
              break;
            }
          }
        }
        if (r < n) src = r * d >= e0 && r * d + d <= e1 ? r * d - e0 : -2;
      }
      if (vsrc < 0 && loc >= 0) vsrc = loc;
      tt[5 + s] = src;
      tt[5 + amax + s] = loc;
    }
    if (vsrc == t) {
      for (int s = 0; s < amax; ++s) ghosts += tt[5 + s] == -2;
    }
    tt[0] = bf.x;
    tt[1] = frow;
    tt[2] = mine;
    tt[3] = vsrc;
    tt[4] = ghosts;
  }
  __syncthreads();
  // the ghost rows numbered in incidence order (a block-wide scan; its
  // warp sums in the group sums' slots, free until the first dot)
  int* wsum = reinterpret_cast<int*>(grp);
  int n_ghost = 0;
  for (int b0 = 0; b0 < ninc; b0 += TH) {
    const int t = b0 + tid;
    const int c = t < ninc ? tab[static_cast<long long>(t) * ti + 4] : 0;
    int x = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = n_ghost;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    int total = 0;
    for (int w = 0; w < TH / 32; ++w) total += wsum[w];
    if (t < ninc) tab[static_cast<long long>(t) * ti + 4] = before + x - c;
    n_ghost += total;
    __syncthreads();
  }
  T* ghost = bump.take<T>(1LL * n_ghost * d);
  int* gh_row = bump.take<int>(n_ghost);
  T* vt = bump.take<T>(1LL * ninc * emax);
  if ((n_ghost > 0 && (ghost == nullptr || gh_row == nullptr)) ||
      vt == nullptr) {
    __trap();
  }
  for (int t = tid; t < ninc; t += TH) {
    int* tt = tab + static_cast<long long>(t) * ti;
    if (tt[3] != t) continue;
    const int* ds = desc + tt[0] * kDesc;
    const int f = (tt[1] - ds[0]) / (ds[5] * ds[4] * d);
    int g = tt[4];
    for (int s = 0; s < amax; ++s) {
      if (tt[5 + s] != -2) continue;
      gh_row[g] = slot_row(ds, f, s);
      tt[5 + s] = -2 - g;
      ++g;
    }
  }
  // J' of each incidence's own slot block, then the inverse blocks, where
  // they fit
  const int jw = emax * d;
  JT* s_j = a.stage_j ? bump.take<JT>(1LL * ninc * jw) : nullptr;
  MT* s_minv = a.minv == nullptr
                   ? nullptr
                   : bump.take<MT>(static_cast<long long>(nr) * d * d);
  if (s_j != nullptr) {
    for (long long q = tid; q < 1LL * ninc * jw; q += TH) {
      const int t = static_cast<int>(q / jw);
      const int k = static_cast<int>(q - 1LL * t * jw);
      if (k < ie[t] * d) s_j[q] = a.jf[ij[t] + k];
    }
  }
  if (s_minv != nullptr) {
    const MT* src = a.minv + static_cast<long long>(row0) * d * d;
    for (long long q = tid; q < static_cast<long long>(nr) * d * d;
         q += TH) {
      s_minv[q] = src[q];
    }
  }
  const MT* mv =
      a.minv == nullptr
          ? nullptr
          : (s_minv != nullptr ? s_minv
                               : a.minv + static_cast<long long>(row0) * d * d);

  const T zero = 0;
  for (int i = e0 + tid; i < e1; i += TH) {
    X[i - e0] = zero;
    vec.own(1)[i - e0] = a.b[i];
  }
  cl.sync();  // the mbarriers initialized in every CTA

  // z = M_row (r / s) on the own entries, as pcg_mf_kernel's; a thread
  // loads the inverse block rows of four entries before their products
  auto precondition = [&](const T* r, T* y, T* z, T s, bool start) {
    if (mv == nullptr) {
      for (int i = e0 + tid; i < e1; i += TH) z[i - e0] = div_rn(r[i - e0], s);
      return;
    }
    for (int i = e0 + tid; i < e1; i += TH) y[i - e0] = div_rn(r[i - e0], s);
    __syncthreads();
    constexpr int DM = D ? D : 1;
    for (int i0 = e0 + tid; i0 < e1; i0 += 4 * TH) {
      MT mr[4][DM];
      if (D) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * TH;
          if (i < e1) {
            const int row = i / d;
            const MT* m = mv + static_cast<long long>(row - row0) * d * d +
                          (i - row * d) * d;
#pragma unroll
            for (int j = 0; j < DM; ++j) mr[u][j] = m[j];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * TH;
        if (i >= e1) break;
        const int row = i / d;
        const MT* m = mv + static_cast<long long>(row - row0) * d * d +
                      (i - row * d) * d;
        T acc = zero;
#pragma unroll
        for (int j = 0; j < (D ? D : d); ++j) {
          const int q = row * d + j;
          const T yq = q >= e0 && q < e1
                           ? y[q - e0]
                           : div_rn(start    ? a.b[q]
                                    : q < e0 ? halo_lo[q - row0 * d]
                                             : halo_hi[q - e1],
                                    s);
          acc += static_cast<T>(D ? mr[u][D ? j : 0] : m[j]) * yq;
        }
        z[i - e0] = acc;
      }
    }
  };

  unsigned par_ph = 0, par_rr = 0, par_rz = 0;
  constexpr unsigned kBytes = sizeof(T);
  const unsigned chunk_bytes = kBytes * sh.nch;
  const unsigned halo_bytes = chunk_bytes + kBytes * (n_lo + n_hi);
  int ri = 1, zi = 3;
  {
    const T* b = a.b;
    auto val = [=](int i) { return b[i] * b[i]; };
    const T s0 = sqrt_rn(cluster_sum<T, decltype(val), TH>(
        cl, sh, val, part_rr, grp, bar_rr, chunk_bytes, par_rr));
    precondition(vec.own(ri), HP, vec.own(zi),
                 s0 == zero ? static_cast<T>(1) : s0, true);
  }
  T* P0 = vec.own(5);
  for (int i = e0 + tid; i < e1; i += TH) P0[i - e0] = vec.own(zi)[i - e0];
  T rz;
  {
    const T* r = vec.own(ri);
    const T* z = vec.own(zi);
    auto val = [=](int i) { return r[i - e0] * z[i - e0]; };
    rz = cluster_sum<T, decltype(val), TH>(cl, sh, val, part_rz, grp,
                                           nullptr, 0, par_rz);
  }
  T rz_min = INFINITY;
  T beta_prev = zero;
  int k = 0;
  bool done = false;
  const int gtot = n_ghost * d;
  while (k < a.max_iter && !done && rz != zero) {
    const int pi = 5 + (k & 1);
    T* p = vec.own(pi);
    // 1. the ghost rows of p, four gathers a thread at a time
    for (int q0 = tid; q0 < gtot; q0 += 4 * TH) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * TH;
        v[u] = zero;
        if (q < gtot) {
          const int g = q / d;
          const int idx = gh_row[g] * d + (q - g * d);
          v[u] = k == 0 ? vec.at(cl, sh, owner, 5, idx)
                        : vec.at(cl, sh, owner, zi, idx) +
                              beta_prev * vec.at(cl, sh, owner, 11 - pi, idx);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u * TH < gtot) ghost[q0 + u * TH] = v[u];
      }
    }
    __syncthreads();  // the ghosts, and the own p of the last update
    // 2. v = J'_f p, one thread per (incidence computing v, residual row),
    // slots then columns in order
    for (int q = tid; q < ninc * emax; q += TH) {
      const int t = q / emax;
      const int e = q - t * emax;
      const int* tt = tab + static_cast<long long>(t) * ti;
      if (tt[3] != t) continue;
      const int* ds = desc + tt[0] * kDesc;
      const int E = ds[4], ar = ds[5];
      if (e >= E) continue;
      T acc = zero;
      for (int s = 0; s < ar; ++s) {
        const int src = tt[5 + s];
        const int loc = tt[5 + amax + s];
        const JT* jr = s_j != nullptr && loc >= 0
                           ? s_j + static_cast<long long>(loc) * jw + e * d
                           : a.jf + tt[1] + (s * E + e) * d;
        const T* pv = src >= 0 ? p + src : ghost + (-2 - src) * d;
#pragma unroll
        for (int j = 0; j < (D ? D : d); ++j) {
          acc += static_cast<T>(jr[j]) * (src == -1 ? zero : pv[j]);
        }
      }
      vt[static_cast<long long>(t) * emax + e] = acc;
    }
    __syncthreads();
    // 3. Hp = damp * p + J'^T v on the own entries, incidences in CSR order
    for (int i = e0 + tid; i < e1; i += TH) {
      const int row = i / d;
      const int c = i - row * d;
      T acc = zero;
      const int ta = co[row - row0] - t0, tb = co[row - row0 + 1] - t0;
      for (int t = ta; t < tb; ++t) {
        const int E = ie[t];
        const JT* jc = s_j != nullptr
                           ? s_j + static_cast<long long>(t) * jw + c
                           : a.jf + ij[t] + c;
        const T* vf =
            vt + static_cast<long long>(tab[static_cast<long long>(t) * ti +
                                            3]) *
                     emax;
        T g = zero;
        for (int e = 0; e < E; ++e) g += static_cast<T>(jc[e * d]) * vf[e];
        acc += g;
      }
      HP[i - e0] = a.damp[i] * p[i - e0] + acc;
    }
    T alpha;
    {
      auto val = [=](int i) { return p[i - e0] * HP[i - e0]; };
      alpha = div_rn(rz, cluster_sum<T, decltype(val), TH>(
                             cl, sh, val, part_ph, grp, bar_ph, chunk_bytes,
                             par_ph));
    }
    T* r = vec.own(ri);
    T* rn = vec.own(3 - ri);
    const int lo_end = min(e1, (e0 / d + 1) * d);
    const int hi_start = max(e0, (e1 / d) * d);
    for (int i = e0 + tid; i < e1; i += TH) {
      const T v = r[i - e0] - alpha * HP[i - e0];
      rn[i - e0] = v;
      if (e0 % d != 0 && i < lo_end) {
        st_async(halo_hi + (i - e0), v, bar_rr, sh.rank - 1);
      }
      if (e1 % d != 0 && e1 < N && i >= hi_start) {
        st_async(halo_lo + (i - hi_start), v, bar_rr, sh.rank + 1);
      }
    }
    T rnorm;
    {
      auto val = [=](int i) { return rn[i - e0] * rn[i - e0]; };
      rnorm = sqrt_rn(cluster_sum<T, decltype(val), TH>(
          cl, sh, val, part_rr, grp, bar_rr, halo_bytes, par_rr));
    }
    T* zn = vec.own(7 - zi);
    precondition(rn, HP, zn, rnorm == zero ? static_cast<T>(1) : rnorm,
                 false);
    T rz_new;
    {
      auto val = [=](int i) { return rn[i - e0] * zn[i - e0]; };
      rz_new = cluster_sum<T, decltype(val), TH>(cl, sh, val, part_rz, grp,
                                                 nullptr, 0, par_rz);
    }
    const bool reject = fabs(rz_new) > a.ratio * rz_min || isnan(rz_new);
    const T aa = fabs(rz_new);
    rz_min = (isnan(aa) || isnan(rz_min)) ? static_cast<T>(NAN)
                                          : fmin(rz_min, aa);
    const T beta = div_rn(rz_new, rz);
    const bool converged = fabs(rz_new) < a.tol;
    ++k;
    if (!reject) {
      T* pn = vec.own(11 - pi);
      for (int i = e0 + tid; i < e1; i += TH) {
        X[i - e0] = X[i - e0] + alpha * p[i - e0];
        pn[i - e0] = zn[i - e0] + beta * p[i - e0];
      }
      ri = 3 - ri;
      zi = 7 - zi;
      rz = rz_new;
      beta_prev = beta;
    }
    done = reject || converged;
  }
  for (int i = e0 + tid; i < e1; i += TH) a.x_out[i] = X[i - e0];
  if (sh.rank == 0 && tid == 0) *a.iters_out = k;
  cl.sync();
}

__global__ void __launch_bounds__(1024, 1) cluster_barriers_kernel(int reps) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < reps; ++i) cl.sync();
}

// `reps` fence-free exchanges as K6's and K2's dots take them: each CTA
// stores one float into every CTA's shared memory (st.async) and waits
// for the C floats stored into its own.
__global__ void __launch_bounds__(1024, 1) cluster_exchanges_kernel(int reps) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ unsigned long long bar;
  __shared__ float slot[kMaxCluster];
  const int C = static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    fence_mbar_init();
  }
  cl.sync();
  unsigned parity = 0;
  for (int i = 0; i < reps; ++i) {
    if (threadIdx.x < C) {
      st_async(slot + cl.block_rank(), static_cast<float>(i), &bar,
               threadIdx.x);
    }
    if (threadIdx.x == 0) mbar_expect(&bar, 4u * C);
    mbar_wait(&bar, parity);
    parity ^= 1;
  }
  cl.sync();
}

// The kernel of a solve: the float64 design for a float64 solve whose
// pieces fit (design64), else pcg_mf_kernel; its threads in `threads`.
template <class T, class JT, class MT>
auto mf_kernel(bool design64, int d, int& threads) {
  void (*fn)(const Args<T, JT, MT>) = pcg_mf_kernel<T, JT, MT>;
  threads = kThreads;
  if constexpr (sizeof(T) == 8) {
    if (design64) {
      fn = d == 6 ? pcg_mf64_kernel<JT, MT, 6> : pcg_mf64_kernel<JT, MT, 0>;
      threads = kThreads64;
    }
  }
  return fn;
}

// Shape64: the most rows and incidences a CTA of this cluster size owns,
// and the largest arity and E, for the float64 design's shared memory.
struct Shape64 {
  long long nr_max, ninc_max;
  int amax, emax;
};

// Whether the float64 design's pieces fit beside the head in a CTA's
// shared memory (`smem` bytes) for a solve of n rows of dim d on `cluster`
// CTAs.
inline bool fits64(long long n, int d, int nb, int cluster,
                   const Shape64& shape, int smem) {
  const long long nch = (n * d + kChunk - 1) / kChunk;
  const long long per = (nch + cluster - 1) / cluster;
  return head_bytes<double>(nch, per, d, nb) +
             need64(per, shape.nr_max, shape.ninc_max, d, shape.amax,
                    shape.emax) <=
         static_cast<size_t>(smem);
}

template <class T, class JT, class MT>
int solve(const void* jf, const void* rows, const void* desc, int nb,
          const void* csr_off, const void* inc_j, const void* inc_e,
          const void* b, const void* damp, const void* minv, void* work,
          void* x, void* iters, int n, int d, int max_iter, T tol,
          T rejection_ratio, int cluster, int stage_j, const Shape64* shape,
          void* stream) {
  const long long N = static_cast<long long>(n) * d;
  if (nb < 1 || n < 1 || d < 1 || cluster < 1 || cluster > kMaxCluster ||
      N > static_cast<long long>(kMaxChunks) * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = max_dynamic_smem();
  const long long nch = (N + kChunk - 1) / kChunk;
  const long long per = (nch + cluster - 1) / cluster;
  const size_t head = head_bytes<T>(nch, per, d, nb);
  if (head > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  const bool design64 =
      shape != nullptr && fits64(n, d, nb, cluster, *shape, smem);
  Args<T, JT, MT> a;
  a.jf = static_cast<const JT*>(jf);
  a.rows = static_cast<const int*>(rows);
  a.desc = static_cast<const int*>(desc);
  a.nb = nb;
  a.csr_off = static_cast<const int*>(csr_off);
  a.inc_j = static_cast<const int*>(inc_j);
  a.inc_e = static_cast<const int*>(inc_e);
  a.b = static_cast<const T*>(b);
  a.damp = static_cast<const T*>(damp);
  a.minv = static_cast<const MT*>(minv);
  a.work = static_cast<T*>(work);
  a.x_out = static_cast<T*>(x);
  a.iters_out = static_cast<int*>(iters);
  a.n = n;
  a.d = d;
  a.max_iter = max_iter;
  a.tol = tol;
  a.ratio = rejection_ratio;
  a.stage_j = stage_j;
  a.smem_bytes = smem;
  int threads;
  auto fn = mf_kernel<T, JT, MT>(design64, d, threads);
  return static_cast<int>(launch_cluster(fn, cluster, threads, smem,
                                         static_cast<cudaStream_t>(stream),
                                         a));
}

}  // namespace

// jf: folded J' of every factor block, block b at desc[b][0], row-major
// (F, arity*E*d); rows: per block and slot the (F,) vertex rows (n for a
// fixed vertex), block b's slot s at desc[b][2] + s*F; desc: (nb, 6) int32
// (jbase, vbase, rbase, F, E, arity); csr_off (n+1), inc_j / inc_e
// (incidences): the J' offset of (f, s) and E, sorted by row then by
// (block, slot, factor); b, damp, x: (n*d,); minv: (n, d*d) row-major or
// null; work: 8*n*d + n_inc*(amax*d + emax) entries of the vectors' type
// (amax, emax: the largest arity and E of a block); iters: (1,) int32;
// cluster: the CTAs (1-16); stage_j: 0 reads J' from global memory only.
// Launches on `stream` and returns the CUDA error code
// (cudaErrorLaunchOutOfResources when one cluster of that size does not
// fit on the card, or the chunk sums, descriptors and halo exceed a CTA's
// shared memory).
//
// gt_pcg_mf_f32: everything float32 (a float32 graph).
extern "C" int gt_pcg_mf_f32(const void* jf, const void* rows,
                             const void* desc, int nb, const void* csr_off,
                             const void* inc_j, const void* inc_e,
                             const void* b, const void* damp,
                             const void* minv, void* work, void* x,
                             void* iters, int n, int d, int max_iter,
                             float tol, float rejection_ratio, int cluster,
                             int stage_j, void* stream) {
  return solve<float, float, float>(jf, rows, desc, nb, csr_off, inc_j,
                                    inc_e, b, damp, minv, work, x, iters, n,
                                    d, max_iter, tol, rejection_ratio,
                                    cluster, stage_j, nullptr, stream);
}

// gt_pcg_mf_f64: a float64 graph: b, damp, x, work, tol and the ratio in
// float64, the whole solve in double; jf and minv as the three FP64
// policies give them: both float64 (FP64_FP64), both float32 (jf_f32 and
// minv_f32 1: FP64_FP32's float32 fold and inverse blocks), or a float32
// fold with float64 inverse blocks (jf_f32 1, minv_f32 0: FP64_BF16);
// float64 jf with float32 minv is refused (cudaErrorInvalidValue).
// nr_max, ninc_max: the most rows and incidences a CTA of this cluster
// size owns (pcg_mf.py, cta_shape), amax, emax the largest arity and E:
// the float64 design runs where its pieces fit beside the vectors
// (need64), else pcg_mf_kernel in double.
extern "C" int gt_pcg_mf_f64(const void* jf, int jf_f32, const void* rows,
                             const void* desc, int nb, const void* csr_off,
                             const void* inc_j, const void* inc_e,
                             const void* b, const void* damp,
                             const void* minv, int minv_f32, void* work,
                             void* x, void* iters, int n, int d,
                             int max_iter, double tol,
                             double rejection_ratio, int cluster,
                             int stage_j, int nr_max, int ninc_max, int amax,
                             int emax, void* stream) {
  const Shape64 shape{nr_max, ninc_max, amax, emax};
#define GT_PCG_MF_F64(JT, MT)                                              \
  return solve<double, JT, MT>(jf, rows, desc, nb, csr_off, inc_j, inc_e, \
                               b, damp, minv, work, x, iters, n, d,       \
                               max_iter, tol, rejection_ratio, cluster,   \
                               stage_j, &shape, stream)
  if (jf_f32) {
    if (minv_f32) GT_PCG_MF_F64(float, float);
    GT_PCG_MF_F64(float, double);
  }
  if (minv_f32) return static_cast<int>(cudaErrorInvalidValue);
  GT_PCG_MF_F64(double, double);
#undef GT_PCG_MF_F64
}

// 1 where gt_pcg_mf_f64 with these arguments takes the float64 design.
extern "C" int gt_pcg_mf_design64(int n, int d, int nb, int cluster,
                                  int nr_max, int ninc_max, int amax,
                                  int emax) {
  return fits64(n, d, nb, cluster, Shape64{nr_max, ninc_max, amax, emax},
                max_dynamic_smem())
             ? 1
             : 0;
}

// The instance a solve takes (f64 0: gt_pcg_mf_f32's; else the float64
// one of (jf_f32, minv_f32), design64 1 for the float64 design with
// vertex dim d): out[0..3] = registers a thread, local memory a thread in
// bytes (spills and stack), resident CTAs an SM at its threads and the
// shared memory the launch asks for, threads a CTA.
extern "C" int gt_pcg_mf_instance(int f64, int jf_f32, int minv_f32,
                                  int design64, int d, int* out) {
  int threads = 0;
  const void* fn;
  if (!f64) {
    fn = reinterpret_cast<const void*>(
        mf_kernel<float, float, float>(false, d, threads));
  } else if (jf_f32 && minv_f32) {
    fn = reinterpret_cast<const void*>(
        mf_kernel<double, float, float>(design64, d, threads));
  } else if (jf_f32) {
    fn = reinterpret_cast<const void*>(
        mf_kernel<double, float, double>(design64, d, threads));
  } else {
    fn = reinterpret_cast<const void*>(
        mf_kernel<double, double, double>(design64, d, threads));
  }
  const int smem = max_dynamic_smem();
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                        smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = ctas;
  out[3] = threads;
  return 0;
}

// `reps` back-to-back cluster barriers (release / acquire, as K6's r.z
// exchange takes them) in one cluster of `cluster` CTAs of `threads` (at
// most 1024) threads, for timing one barrier.
extern "C" int gt_pcg_mf_cluster_barriers(int cluster, int threads, int reps,
                                          void* stream) {
  if (threads < 32 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_cluster(cluster_barriers_kernel, cluster,
                                         threads, 0,
                                         static_cast<cudaStream_t>(stream),
                                         reps));
}

// The same for `reps` fence-free exchanges.
extern "C" int gt_pcg_mf_cluster_exchanges(int cluster, int threads, int reps,
                                           void* stream) {
  if (threads < 32 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_cluster(cluster_exchanges_kernel, cluster,
                                         threads, 0,
                                         static_cast<cudaStream_t>(stream),
                                         reps));
}

extern "C" const char* gt_pcg_mf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
