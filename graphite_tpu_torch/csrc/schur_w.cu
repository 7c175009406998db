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
// The kernel allocates nothing, never synchronises with the host and
// launches on the given stream: it runs inside a captured CUDA graph and
// its conditional nodes.

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileLm = 256;  // landmarks a CTA
// shared floats for a chunk of Hpl rows (32 KB): kThreads rows up to 32
// floats a row, fewer rows above
constexpr int kChunkFloats = 8192;

// spd_inverse_flat's closed forms (ops/batched_linalg.py), in place on a
// row-major DL x DL block; 1 / x is exact division, as PyTorch's
// reciprocal(x) * 1.0.
template <int DL>
__device__ __forceinline__ void invert(float* m) {
  if constexpr (DL == 1) {
    m[0] = 1.0f / m[0];
  } else if constexpr (DL == 2) {
    const float a = m[0], b = m[1], c = m[2], e = m[3];
    const float inv_det = 1.0f / (a * e - b * c);
    m[0] = e * inv_det;
    m[1] = (-b) * inv_det;
    m[2] = (-c) * inv_det;
    m[3] = a * inv_det;
  } else {
    const float c00 = m[4] * m[8] - m[5] * m[7];
    const float c01 = m[5] * m[6] - m[3] * m[8];
    const float c02 = m[3] * m[7] - m[4] * m[6];
    const float c10 = m[2] * m[7] - m[1] * m[8];
    const float c11 = m[0] * m[8] - m[2] * m[6];
    const float c12 = m[1] * m[6] - m[0] * m[7];
    const float c20 = m[1] * m[5] - m[2] * m[4];
    const float c21 = m[2] * m[3] - m[0] * m[5];
    const float c22 = m[0] * m[4] - m[1] * m[3];
    const float inv_det = 1.0f / ((m[0] * c00 + m[1] * c01) + m[2] * c02);
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
template <int DL>
__global__ void __launch_bounds__(kThreads)
    schur_w_kernel(const float* __restrict__ hll,
                   const float* __restrict__ hpl,
                   const int* __restrict__ offsets,
                   float* __restrict__ hll_inv, float* __restrict__ w,
                   int dp, int L, int chunk) {
  constexpr int DD = DL * DL;
  extern __shared__ __align__(16) float smem[];
  float* t_inv = smem;                        // 4 + kTileLm DD floats
  float* t_rows = smem + 4 + kTileLm * DD;    // 4 + chunk dp DL floats
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
  float* inv = t_inv + mi;
  if (threadIdx.x < nl) {
    float m[DD];
#pragma unroll
    for (int k = 0; k < DD; ++k) m[k] = inv[DD * threadIdx.x + k];
    invert<DL>(m);
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
    float* rows = t_rows + mr;
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
      const float* b = inv + DD * lo;
      float* row = rows + width * threadIdx.x;
      for (int i = 0; i < dp; ++i) {
        float a[DL];
#pragma unroll
        for (int j = 0; j < DL; ++j) a[j] = row[DL * i + j];
#pragma unroll
        for (int c = 0; c < DL; ++c) {
          float s = a[0] * b[c];
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

template <int DL>
cudaError_t launch(const float* hll, const float* hpl, const int* offsets,
                   float* hll_inv, float* w, int dp, int L, int chunk,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (8 + kTileLm * DL * DL + chunk * dp * DL) +
      sizeof(int) * (kTileLm + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        schur_w_kernel<DL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>((L + kTileLm - 1) / kTileLm);
  schur_w_kernel<DL><<<grid, kThreads, smem, stream>>>(
      hll, hpl, offsets, hll_inv, w, dp, L, chunk);
  return cudaGetLastError();
}

}  // namespace

// hll: (L, dl dl) float32; hpl: (K, dp dl) float32 sorted by landmark,
// landmark l's rows [offsets[l], offsets[l + 1]) (offsets: (L + 1,)
// int32, offsets[L] = K); hll_inv: (L, dl dl) out, or null to compute
// the inverses without writing them; w: (K, dp dl) out. hpl, offsets and
// w all null (with dp 0): the inverses only. Every pointer 16-byte
// aligned. Launches on `stream` and returns a cudaError_t code (0 on
// success).
extern "C" int gt_schur_w_f32(const void* hll, const void* hpl,
                              const void* offsets, void* hll_inv, void* w,
                              int dp, int dl, int L, void* stream) {
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
  const int chunk = kChunkFloats / width < kThreads ? kChunkFloats / width
                                                    : kThreads;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto h = static_cast<const float*>(hll);
  const auto p = static_cast<const float*>(hpl);
  const auto o = static_cast<const int*>(offsets);
  const auto inv = static_cast<float*>(hll_inv);
  const auto out = static_cast<float*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  const int d = rows ? dp : 0;
  cudaError_t err;
  if (dl == 1) {
    err = launch<1>(h, p, o, inv, out, d, L, chunk, s);
  } else if (dl == 2) {
    err = launch<2>(h, p, o, inv, out, d, L, chunk, s);
  } else {
    err = launch<3>(h, p, o, inv, out, d, L, chunk, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* gt_schur_w_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
