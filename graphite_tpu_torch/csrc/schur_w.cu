// K10: the landmark inverses Hll^-1 and W = Hpl Hll^-1 of the Schur
// complement, one launch per Hpl group (dp, dl), on Hopper (sm_90a).
//
// Replaces no pl.pallas_call: the JAX package computes both as plain jnp
// that XLA fuses, spd_inverse_flat on the Hll rows
// (graphite_tpu/schur.py:499-508) and flat_block_mm_nn of the Hpl rows
// with the jnp.repeat-expanded inverse (graphite_tpu/schur.py:543-599).
// The port ran them as ~35 PyTorch ops a group (schur_w.hll_inverse_plain
// and hpl_w_plain): ~30 on (L,) columns for a 3x3 inverse, a
// repeat_interleave of the inverse to one row per Hpl block, then dl
// products and dl - 1 adds over (K, dp, dl) temporaries; ~3.1 ms of a
// Venice-1778 LM iteration (K = 4,995,188 (9, 3) blocks, L = 993,923).
//
// The arithmetic, op by op as those plain versions (-fmad=false,
// ops/cuda/build.py; IEEE division): the inverse is spd_inverse_flat's
// closed form for dl = 1, 2, 3 (the cofactors, each a product difference;
// inv_det = 1 / ((m0 c00 + m1 c01) + m2 c02); each adjugate entry times
// inv_det, row-major, transposed); W's entry (i, c) is
// ((a_i0 b_0c + a_i1 b_1c) + a_i2 b_2c), each product rounded on its own
// and the terms added left to right over j (ops/blockfmt.py).
//
// Bound: bytes. Each Hpl row read once and each W row written once (108
// bytes each at (9, 3)), each Hll row read and each inverse written once
// (36 bytes): 1.15 GB at Venice, ~0.345 ms at 3.35 TB/s; ~4.5 operations
// a byte of W.
//
// Design. Hpl is sorted by landmark, so the blocks of a run of consecutive
// landmarks are one contiguous span of rows: landmark l's rows are
// [offsets[l], offsets[l + 1]). A CTA owns kTileLm consecutive landmarks.
// It stages their Hll rows (one contiguous span) in shared memory with
// 16-byte cp.async, and one thread per landmark inverts its block in place
// there; the tile of inverses goes out in 16-byte stores. The CTA then
// walks its landmarks' Hpl span in chunks of at most kThreads rows: each
// chunk staged the same way, one thread per row finds its landmark by a
// binary search of the tile's offsets (in shared memory) and writes its W
// row over its Hpl row in place, and the chunk goes out in 16-byte stores.
// So a warp's loads and stores are contiguous 16-byte pieces, not one
// 108-byte row a thread (one warp store touching 32 rows ran at ~0.19
// TB/s in K7's first design). The tiles are fixed by landmark count and
// need no host plan beyond the offsets: a landmark with many blocks makes
// its CTA walk more chunks. A landmark with no Hpl block still gets its
// inverse. A span starts wherever its first row does: its first and last
// few floats, up to the next or from the last 16-byte boundary, move as
// 4-byte pieces, and the staged copy sits at the same offset from a 16-byte
// boundary as the span, so every 16-byte piece is aligned on both sides
// (stage_span and store_span, csrc/staging.cuh, shared with K7).
// Several Hpl groups of one dl (mixed pose dims) each launch K10; only the
// first writes the inverses (hll_inv null in the others), all compute
// them.
//
// Float64 (gt_schur_w_f64, the FP64_FP64 and FP64_BF16 inverses): the
// same template over T = double, the closed forms in float64 as the plain
// version's float64 PyTorch ops round them (1.0 / x is an IEEE division
// in double too). The bytes double (2.3 GB at Venice, ~0.69 ms); a chunk
// is kChunkBytes of rows (151 (9, 3) rows in float64, 256 in float32)
// and the 8-byte ends of a span move as 8-byte copies.
//
// K13, in the same library since it reads the inverses K10 writes:
// w = Hll^-1 (t - sub) per landmark row, one launch a landmark type
// (schur.SchurOps._hll_solve_rows: b_S's w = Hll^-1 b_l and the
// back-substitution's dx_l = Hll^-1 (b_l - Hpl^T dx_p), the last product
// set's subtraction fused). Replaces no pl.pallas_call: the JAX package's
// flat_block_mv of the (gathered) inverses (graphite_tpu/schur.py:1595),
// which XLA fuses; the port ran it as dl products and dl - 1 adds over
// (L, dl) temporaries, and the subtraction, ~0.19 ms a Venice iteration.
// Arithmetic as ops/blockfmt.flat_block_mv: t - sub in the vectors' dtype,
// cast to the inverses' (float32 or float64, w's too), entry i =
// ((a_i0 y_0 + a_i1 y_1) + a_i2 y_2), each product rounded on its own.
// One thread an output entry in a grid-stride loop; the inverse row by
// gidx (null: the identity, Venice's case); dl 1-3 unrolled, any other dl
// in a loop.
// Bound: bytes, the inverses (36 B a 3x3 row), t, sub and w read or
// written once: 71.6 MB at Venice with sub, ~0.021 ms at 3.35 TB/s.
//
// The kernels allocate nothing, never synchronise with the host and
// launch on the given stream: they run inside a captured CUDA graph and
// its conditional nodes.

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileLm = 256;  // landmarks a CTA
// shared bytes for a chunk of Hpl rows (32 KB): kThreads rows up to 32
// floats (16 doubles) a row, fewer rows above
constexpr int kChunkBytes = 32768;

// spd_inverse_flat's closed forms (ops/batched_linalg.py), in place on a
// row-major DL x DL block of T (float or double); 1 / x is exact
// division, as PyTorch's reciprocal(x) * 1.0.
template <typename T, int DL>
__device__ __forceinline__ void invert(T* m) {
  constexpr T one = static_cast<T>(1);
  if constexpr (DL == 1) {
    m[0] = one / m[0];
  } else if constexpr (DL == 2) {
    const T a = m[0], b = m[1], c = m[2], e = m[3];
    const T inv_det = one / (a * e - b * c);
    m[0] = e * inv_det;
    m[1] = (-b) * inv_det;
    m[2] = (-c) * inv_det;
    m[3] = a * inv_det;
  } else {
    const T c00 = m[4] * m[8] - m[5] * m[7];
    const T c01 = m[5] * m[6] - m[3] * m[8];
    const T c02 = m[3] * m[7] - m[4] * m[6];
    const T c10 = m[2] * m[7] - m[1] * m[8];
    const T c11 = m[0] * m[8] - m[2] * m[6];
    const T c12 = m[1] * m[6] - m[0] * m[7];
    const T c20 = m[1] * m[5] - m[2] * m[4];
    const T c21 = m[2] * m[3] - m[0] * m[5];
    const T c22 = m[0] * m[4] - m[1] * m[3];
    const T inv_det = one / ((m[0] * c00 + m[1] * c01) + m[2] * c02);
    m[0] = c00 * inv_det;
    m[1] = c10 * inv_det;
    m[2] = c20 * inv_det;
    m[3] = c01 * inv_det;
    m[4] = c11 * inv_det;
    m[5] = c21 * inv_det;
    m[6] = c02 * inv_det;
    m[7] = c12 * inv_det;
    m[8] = c22 * inv_det;
  }
}

// hll: (L, DL DL); hpl, w: (K, dp DL); offsets: (L + 1,) int32, landmark
// l's Hpl rows [offsets[l], offsets[l + 1]), or null for no Hpl rows;
// hll_inv: (L, DL DL) or null (not written); chunk: Hpl rows a chunk.
// Dynamic shared memory: the inverse tile, the row chunk, the offsets.
template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    schur_w_kernel(const T* __restrict__ hll, const T* __restrict__ hpl,
                   const int* __restrict__ offsets, T* __restrict__ hll_inv,
                   T* __restrict__ w, int dp, int L, int chunk) {
  constexpr int DD = DL * DL;
  // one buffer for both element types, viewed as T
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  T* t_inv = smem;                        // 4 + kTileLm DD elements
  T* t_rows = smem + 4 + kTileLm * DD;    // 4 + chunk dp DL elements
  const int width = dp * DL;
  int* t_off = reinterpret_cast<int*>(t_rows + 4 + chunk * width);
  const int l0 = blockIdx.x * kTileLm;
  const int nl = min(kTileLm, L - l0);
  const int mi = stage_span<kThreads>(
      t_inv, hll + static_cast<long long>(l0) * DD, nl * DD);
  cp_async_commit();
  if (offsets != nullptr) {
    for (int i = threadIdx.x; i <= nl; i += kThreads) {
      t_off[i] = offsets[l0 + i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  T* inv = t_inv + mi;
  if (threadIdx.x < nl) {
    T m[DD];
#pragma unroll
    for (int k = 0; k < DD; ++k) m[k] = inv[DD * threadIdx.x + k];
    invert<T, DL>(m);
#pragma unroll
    for (int k = 0; k < DD; ++k) inv[DD * threadIdx.x + k] = m[k];
  }
  __syncthreads();
  if (hll_inv != nullptr) {
    store_span<kThreads>(hll_inv + static_cast<long long>(l0) * DD, inv,
                         nl * DD);
  }
  if (offsets == nullptr) return;
  const int r0 = t_off[0], r1 = t_off[nl];
  for (int c0 = r0; c0 < r1; c0 += chunk) {
    const int nr = min(chunk, r1 - c0);
    const long long e0 = static_cast<long long>(c0) * width;
    const int mr = stage_span<kThreads>(t_rows, hpl + e0, nr * width);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    T* rows = t_rows + mr;
    if (threadIdx.x < nr) {
      const int r = c0 + threadIdx.x;
      // the landmark lo with t_off[lo] <= r < t_off[lo + 1]
      int lo = 0, hi = nl;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (t_off[mid] <= r) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const T* b = inv + DD * lo;
      T* row = rows + width * threadIdx.x;
      for (int i = 0; i < dp; ++i) {
        T a[DL];
#pragma unroll
        for (int j = 0; j < DL; ++j) a[j] = row[DL * i + j];
#pragma unroll
        for (int c = 0; c < DL; ++c) {
          T s = a[0] * b[c];
#pragma unroll
          for (int j = 1; j < DL; ++j) s = s + a[j] * b[DL * j + c];
          row[DL * i + c] = s;
        }
      }
    }
    __syncthreads();
    store_span<kThreads>(w + e0, rows, nr * width);
    __syncthreads();  // the chunk is out before the next one lands
  }
}

template <typename T, int DL>
cudaError_t launch(const T* hll, const T* hpl, const int* offsets,
                   T* hll_inv, T* w, int dp, int L, int chunk,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * (8 + kTileLm * DL * DL + chunk * dp * DL) +
      sizeof(int) * (kTileLm + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        schur_w_kernel<T, DL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>((L + kTileLm - 1) / kTileLm);
  schur_w_kernel<T, DL><<<grid, kThreads, smem, stream>>>(
      hll, hpl, offsets, hll_inv, w, dp, L, chunk);
  return cudaGetLastError();
}

template <typename T>
int schur_w(const void* hll, const void* hpl, const void* offsets,
            void* hll_inv, void* w, int dp, int dl, int L, void* stream) {
  const bool rows = offsets != nullptr;
  if (L < 0 || dl < 1 || dl > 3 || rows != (hpl != nullptr) ||
      rows != (w != nullptr) || (rows && dp < 1) ||
      (!rows && hll_inv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[] = {hll, hpl, hll_inv, w};
  for (const void* p : ptrs) {
    if (reinterpret_cast<unsigned long long>(p) & 15) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  if (L == 0) return 0;
  const int width = rows ? dp * dl : 1;
  const int per_chunk = kChunkBytes / static_cast<int>(sizeof(T)) / width;
  const int chunk = per_chunk < kThreads ? per_chunk : kThreads;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto h = static_cast<const T*>(hll);
  const auto p = static_cast<const T*>(hpl);
  const auto o = static_cast<const int*>(offsets);
  const auto inv = static_cast<T*>(hll_inv);
  const auto out = static_cast<T*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  const int d = rows ? dp : 0;
  cudaError_t err;
  if (dl == 1) {
    err = launch<T, 1>(h, p, o, inv, out, d, L, chunk, s);
  } else if (dl == 2) {
    err = launch<T, 2>(h, p, o, inv, out, d, L, chunk, s);
  } else {
    err = launch<T, 3>(h, p, o, inv, out, d, L, chunk, s);
  }
  return static_cast<int>(err);
}

constexpr int kSolveThreads = 256;
constexpr long long kSolveCtas = 132 * 16;

// D > 0: dl = D, unrolled; D = 0: dl from the argument
template <typename T, typename A, int D>
__global__ void __launch_bounds__(kSolveThreads)
    hll_solve_kernel(const A* __restrict__ inv,
                     const long long* __restrict__ gidx,
                     const T* __restrict__ t, const T* __restrict__ sub,
                     A* __restrict__ w, long long n, int dl) {
  const int d = D > 0 ? D : dl;
  const long long total = n * d;
  for (long long e = blockIdx.x * static_cast<long long>(kSolveThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kSolveThreads) {
    const long long row = e / d;
    const int i = static_cast<int>(e - row * d);
    const long long g = gidx == nullptr ? row : gidx[row];
    const A* a = inv + (g * d + i) * d;
    A acc = static_cast<A>(0);
#pragma unroll
    for (int j = 0; j < d; ++j) {
      const T y = sub == nullptr ? t[row * d + j]
                                 : t[row * d + j] - sub[row * d + j];
      const A term = a[j] * static_cast<A>(y);
      acc = j == 0 ? term : acc + term;
    }
    w[e] = acc;
  }
}

template <typename T, typename A>
int hll_solve(const void* inv, const void* gidx, const void* t,
              const void* sub, void* w, long long n, int dl, void* stream) {
  if (n < 0 || dl < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long ctas = (n * dl + kSolveThreads - 1) / kSolveThreads;
  const unsigned grid =
      static_cast<unsigned>(ctas < kSolveCtas ? ctas : kSolveCtas);
  const auto a = static_cast<const A*>(inv);
  const auto g = static_cast<const long long*>(gidx);
  const auto tt = static_cast<const T*>(t);
  const auto ss = static_cast<const T*>(sub);
  const auto out = static_cast<A*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dl == 1) {
    hll_solve_kernel<T, A, 1><<<grid, kSolveThreads, 0, s>>>(a, g, tt, ss,
                                                            out, n, dl);
  } else if (dl == 2) {
    hll_solve_kernel<T, A, 2><<<grid, kSolveThreads, 0, s>>>(a, g, tt, ss,
                                                            out, n, dl);
  } else if (dl == 3) {
    hll_solve_kernel<T, A, 3><<<grid, kSolveThreads, 0, s>>>(a, g, tt, ss,
                                                            out, n, dl);
  } else {
    hll_solve_kernel<T, A, 0><<<grid, kSolveThreads, 0, s>>>(a, g, tt, ss,
                                                            out, n, dl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K13. inv: (>= L, dl dl) inverses in float32 or float64 (dtype A), row
// gidx[i] (int64, or null: row i) for landmark row i; t, sub: (n, dl) in
// float32 or float64 (dtype T), sub null for none; w: (n, dl) out, dtype
// A. Suffix: T then A. Launches on `stream` and returns a cudaError_t code
// (0 on success).
#define GT_HLL_SOLVE(TS, AS, T, A)                                          \
  extern "C" int gt_hll_solve_##TS##_##AS(                                  \
      const void* inv, const void* gidx, const void* t, const void* sub,   \
      void* w, long long n, int dl, void* stream) {                        \
    return hll_solve<T, A>(inv, gidx, t, sub, w, n, dl, stream);           \
  }
GT_HLL_SOLVE(f32, f32, float, float)
GT_HLL_SOLVE(f32, f64, float, double)
GT_HLL_SOLVE(f64, f32, double, float)
GT_HLL_SOLVE(f64, f64, double, double)
#undef GT_HLL_SOLVE

// hll: (L, dl dl) float32 (gt_schur_w_f32) or float64 (gt_schur_w_f64);
// hpl: (K, dp dl) of hll's type, sorted by landmark, landmark l's rows
// [offsets[l], offsets[l + 1]) (offsets: (L + 1,) int32, offsets[L] = K);
// hll_inv: (L, dl dl) out, or null to compute the inverses without
// writing them; w: (K, dp dl) out; both of hll's type. hpl, offsets and
// w all null (with dp 0): the inverses only. Every pointer 16-byte
// aligned. Launches on `stream` and returns a cudaError_t code (0 on
// success).
extern "C" int gt_schur_w_f32(const void* hll, const void* hpl,
                              const void* offsets, void* hll_inv, void* w,
                              int dp, int dl, int L, void* stream) {
  return schur_w<float>(hll, hpl, offsets, hll_inv, w, dp, dl, L, stream);
}

extern "C" int gt_schur_w_f64(const void* hll, const void* hpl,
                              const void* offsets, void* hll_inv, void* w,
                              int dp, int dl, int L, void* stream) {
  return schur_w<double>(hll, hpl, offsets, hll_inv, w, dp, dl, L, stream);
}

extern "C" const char* gt_schur_w_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
