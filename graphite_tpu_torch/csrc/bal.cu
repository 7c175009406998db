// K7: the BAL reprojection factor's linearization and Hessian values on
// Hopper (sm_90a).
//
// Replaces no pl.pallas_call but one: it is the port's counterpart of what
// XLA fuses for the JAX package out of plain jnp code: the reprojection
// residual (graphite_tpu/models/bal.py, reprojection_residual), its
// analytic Jacobian (reprojection_jacobian), the per-factor part of
// linearize (graphite_tpu/linearize.py: chi2 and the robust loss, the
// masked Jacobians, the Jacobi diagonal's rows, the column scaling, the
// storage cast, b's rows) and the products of compute_hessian_values
// (graphite_tpu/hessian.py: J_s^T dL J_t per slot pair); and of the
// Pallas streaming_segment_sum that sums those products into their
// blocks there (graphite_tpu/ops/pallas/segsum_stream.py). Eager PyTorch
// runs the chain as ~200 kernels, each reading and writing (F, ...)
// tensors; here each factor's chain stays in registers. The per-vertex
// sums of linearize's rows stay on kernel K1 (segsum.cu), on the same
// plans, so they are added in the same order as before.
//
// Four entries (ops/cuda/bal.py holds the wrappers and the plain PyTorch
// version of each, which follows the generic code op by op):
//   gt_bal_residual      camera[ids0], point[ids1], obs, factor_mask,
//                        loss_params -> masked robust chi2 (F)
//   gt_bal_linearize     the same and slot_mask -> r (F,2), the masked
//                        unscaled J (F,18) and (F,6), chi2 (F), dL (F), the
//                        Jacobi diagonal's rows (F,9) and (F,3)
//   gt_bal_scale_b_*     J, r, dL, the padded scale rows at rows0 / rows1 ->
//                        the stored J in the storage type S (float, bf16 or
//                        fp16) and b's rows (F,9) and (F,3)
//   gt_bal_hessian_sum_* the stored J (S), dL, one Hessian site's K1 plan
//                        (perm, offsets, lanes per segment) and its slot
//                        pair -> the site's block group, float32: each
//                        block the sum of its factors' J_s^T dL J_t
// The loss (default, Huber, Cauchy) is a template parameter; the gate
// (bal.py, gate) sends every other factor set to the generic code.
//
// Bound: memory. Per factor the entries move about 35, 195, 268 and, over
// Venice's three Hessian sites, ~330 bytes (J and dL once a site, the
// plan, the blocks once), and do a few hundred float32 operations and two
// float64 cos / sin (linearize) or one (residual).
//
// bal_residual and bal_linearize run one thread per factor, the camera and
// point rows gathered straight from global memory. bal_linearize writes
// its 40 floats a factor (r 2, Jc 18, Jp 6, chi2 1, dL 1, diag_c 9, diag_p
// 3) into a shared tile of its CTA's 128 factors (20 KB), one span per
// output; after a __syncthreads() the CTA copies each span to its output,
// whose rows [128 b, 128 b + 128) are one contiguous range, in float4
// stores: a warp's store is 512 contiguous bytes, where a thread's own
// rows made it touch 32 rows. bal_scale_b runs tiles of 128 factors both
// ways: its CTA stages the tile's J, r and dL rows in shared memory with
// 16-byte cp.async copies, each thread reads its factor's two row indices
// and gathers its 12 scales once, forms the stored J and b's rows into a
// shared output tile, and the CTA copies each span out in 16-byte stores.
//
// bal_hessian_sum: one launch per Hessian site (slot pair (s, t), and
// whether the site's blocks are the transposed (t, s) ones) forms each
// product where it is summed. The site's rows would be (F, 81), (F, 27) or
// (F, 9) float32, 2.34 GB at Venice; none is written. It keeps K1's
// summation order on the same plan (segsum.cu: lane l of a segment sums
// its sorted rows l, l+G, ... from +0.0, then the halving tree), so a
// block's bits are those of K1 over the product rows:
// - G = 1 (the destination-sorted point sites, ~1-5 rows a block): K1's
//   thread per (block, column), grouped: a CTA of (256 / D) D threads owns
//   8 (256 / D) consecutive blocks, stages their rows' J_s, J_t and dL in
//   shared memory once (three contiguous copies where the plan has no
//   permutation; 16 KB a pass), and each thread keeps one column and sums
//   it over 8 of the blocks, each over its staged rows in row order. A
//   warp's store is 32 consecutive floats. (Float4 stores of 4 and 16
//   neighbouring floats a thread were no faster.)
// - G > 1 (the camera sites: ~2,800 rows a block through the
//   permutation): K1's CTA, (slot q, column c) threads each holding L =
//   G / Q lanes of C columns. Each round stages the next 4 / L of K1's
//   rounds (at least 4 rows a thread) of gathered J rows and dL in shared
//   memory, double-buffered: the next round's loads are in flight while
//   this one is summed. Each thread forms its own entries (its C columns
//   share J_t's column, read once a row) and adds each to its lane, round
//   by round in K1's order; then K1's halving tree, in registers, then
//   through shared memory.
// First writer of a group: the sums are stored, every row of the group
// (the plan covers the trash row too). This is the zero fill and the add
// of the generic branch, bitwise: each lane starts from +0.0, and +0.0
// plus anything is never -0.0, so no sum is -0.0 and 0.0 + sum == sum.
// A later writer (a second factor set) adds: out = out + sum, as
// values[g] + reduce_rows(...). No float atomics.
//
// The bits. Each entry equals its plain version on the card bitwise, so
// every expression is the plain version's, rounded where it rounds:
// - nvcc's -fmad=false (build.py): no multiply-add contraction; every
//   product and sum is rounded on its own, as one PyTorch op each.
// - Sums run left to right as Python writes them: a*b + c*d + e*f is
//   (a*b + c*d) + e*f (_dot3, sum_in_order, flat_block_mm_tn's two
//   residual rows, flat_block_mv_t). A product with dL comes after the
//   sum it scales.
// - Division follows PyTorch's CUDA semantics. tensor / tensor is the IEEE
//   quotient (rvec / theta, -P / P.z, sin / th, the Taylor guards' exact
//   ratios, Huber's p / sqrt, Cauchy's x / c^2). 1.0 / x is
//   Tensor.__rtruediv__, reciprocal(x) * 1.0: the IEEE 1.0f / x. The model
//   writes no tensor / Python scalar (PyTorch's CUDA op would multiply by
//   the reciprocal), and Python constants such as 1/24 reach the op as
//   float32: static_cast<float>(1.0 / 24.0).
// - Comparisons with a Python scalar (th2 < 0.01, < 1e-24) compare with
//   its float32 value.
// - Transcendentals: sqrt_rn and _cos_sin take float64 and round
//   (precision.py, models/bal.py): the float64 sqrt is IEEE, and cos / sin
//   are CUDA's double functions, which PyTorch's CUDA cos / sin call.
//   Huber uses sqrt_rn. Cauchy's float32 log1pf is the function PyTorch's
//   CUDA log1p calls.
// - torch.maximum, clamp_min and clamp are PyTorch's CUDA ops: a NaN
//   operand is returned, else fmaxf / fminf.
// - The residual's rotation is not the Jacobian's: rodrigues_rotate
//   divides rvec by theta and forms X cth + (a x X) sth + a (a.X)(1 - cth);
//   the Jacobian's v is c X + alpha (w x X) + beta (w.X) w. Each is
//   computed in its own order, with its own branches: the residual's tiny
//   branch (theta^2 < 1e-24), the Jacobian's Taylor (th^2 < 0.01) and tiny
//   branches, and the guarded denominators (th2_g = 1 where unselected).
// - torch.where is a select, but the slot mask is a multiply by 1.0 or 0.0
//   (linearize.py), so a masked negative entry is -0.0, and so is the
//   factor mask on chi2.
// - The storage cast: fp16 clamped to +-65504 first (clamp_to_storage),
//   then __float2half_rn; bf16 __float2bfloat16_rn. b and H read the
//   rounded value, widened exactly to float32.
// - Capture: the entries launch on the given stream, allocate nothing and
//   never synchronise, so they run inside the captured LM iteration and
//   its conditional regions.
// - Registers: bal_linearize keeps about 100 floats live per thread; nvcc
//   gives it 48-56 registers and spills nothing (-Xptxas -v in the build
//   log, which chip_smoke.py's [build] lines print); its tile is shared
//   memory, not registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "robust.cuh"
#include "staging.cuh"

namespace {

constexpr int kThreads = 128;

// Python constants as float32, as PyTorch hands them to the op
constexpr float kInv6 = static_cast<float>(1.0 / 6.0);
constexpr float kInv24 = static_cast<float>(1.0 / 24.0);
constexpr float kInv30 = static_cast<float>(1.0 / 30.0);
constexpr float kInv120 = static_cast<float>(1.0 / 120.0);
constexpr float kInv180 = static_cast<float>(1.0 / 180.0);
constexpr float kInv720 = static_cast<float>(1.0 / 720.0);
constexpr float kInv840 = static_cast<float>(1.0 / 840.0);
constexpr float kInv6720 = static_cast<float>(1.0 / 6720.0);
constexpr float kMinusThird = static_cast<float>(-1.0 / 3.0);
constexpr float kMinusTwelfth = static_cast<float>(-1.0 / 12.0);
constexpr float kTiny = static_cast<float>(1e-24);
constexpr float kSmall = static_cast<float>(0.01);

__device__ __forceinline__ float cos_rn(float x) {
  return static_cast<float>(cos(static_cast<double>(x)));
}

__device__ __forceinline__ float sin_rn(float x) {
  return static_cast<float>(sin(static_cast<double>(x)));
}

// reprojection_residual (models/bal.py): rodrigues_rotate, then project,
// minus the observation. cam: 9 floats; X: 3.
__device__ __forceinline__ void residual(const float* cam, const float* X,
                                         const float* obs, float* r) {
  const float w0 = cam[0], w1 = cam[1], w2 = cam[2];
  const float X0 = X[0], X1 = X[1], X2 = X[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool tiny = theta2 < kTiny;
  const float theta = sqrt_rn(tiny ? 1.0f : theta2);
  const float a0 = w0 / theta, a1 = w1 / theta, a2 = w2 / theta;
  const float cth = cos_rn(theta), sth = sin_rn(theta);
  const float axx0 = a1 * X2 - a2 * X1;
  const float axx1 = a2 * X0 - a0 * X2;
  const float axx2 = a0 * X1 - a1 * X0;
  const float adx = a0 * X0 + a1 * X1 + a2 * X2;
  const float omc = 1.0f - cth;
  float v0, v1, v2;
  if (tiny) {
    v0 = X0 + (w1 * X2 - w2 * X1);
    v1 = X1 + (w2 * X0 - w0 * X2);
    v2 = X2 + (w0 * X1 - w1 * X0);
  } else {
    v0 = X0 * cth + axx0 * sth + a0 * adx * omc;
    v1 = X1 * cth + axx1 * sth + a1 * adx * omc;
    v2 = X2 * cth + axx2 * sth + a2 * adx * omc;
  }
  const float P0 = v0 + cam[3], P1 = v1 + cam[4], P2 = v2 + cam[5];
  const float px = -P0 / P2, py = -P1 / P2;
  const float r2 = px * px + py * py;
  const float k1 = cam[7], k2 = cam[8];
  const float distortion = 1.0f + k1 * r2 + k2 * r2 * r2;
  r[0] = cam[6] * distortion * px - obs[0];
  r[1] = cam[6] * distortion * py - obs[1];
}

// reprojection_jacobian (models/bal.py): the (2, 9) and (2, 3) blocks,
// row-major, unmasked.
__device__ __forceinline__ void jacobian(const float* cam, const float* X,
                                         float* Jc, float* Jp) {
  const float w0 = cam[0], w1 = cam[1], w2 = cam[2];
  const float f = cam[6], k1 = cam[7], k2 = cam[8];
  const float X0 = X[0], X1 = X[1], X2 = X[2];

  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < kSmall;
  const float th2_g = small ? 1.0f : th2;
  const float th = sqrt_rn(th2_g);
  const float cos_th = cos_rn(th), sin_th = sin_rn(th);
  const float th4 = th2 * th2;
  const float c = small ? 1.0f - th2 * 0.5f + th4 * kInv24
                              - th4 * th2 * kInv720
                        : cos_th;
  const float alpha = small ? 1.0f - th2 * kInv6 + th4 * kInv120
                            : sin_th / th;
  const float beta = small ? 0.5f - th2 * kInv24 + th4 * kInv720
                           : (1.0f - c) / th2_g;
  const float gamma = small ? kMinusThird + th2 * kInv30 - th4 * kInv840
                            : (c - alpha) / th2_g;
  const float delta = small ? kMinusTwelfth + th2 * kInv180
                                  - th4 * kInv6720
                            : (alpha - 2.0f * beta) / th2_g;

  const float wxX0 = w1 * X2 - w2 * X1;
  const float wxX1 = w2 * X0 - w0 * X2;
  const float wxX2 = w0 * X1 - w1 * X0;
  const float wdX = w0 * X0 + w1 * X1 + w2 * X2;

  const bool tiny = th2 < kTiny;
  const float v0 = tiny ? X0 + wxX0 : c * X0 + alpha * wxX0 + beta * wdX * w0;
  const float v1 = tiny ? X1 + wxX1 : c * X1 + alpha * wxX1 + beta * wdX * w1;
  const float v2 = tiny ? X2 + wxX2 : c * X2 + alpha * wxX2 + beta * wdX * w2;

  const float P0 = v0 + cam[3], P1 = v1 + cam[4], P2 = v2 + cam[5];
  const float iz = t_recip(P2);
  const float px = -P0 * iz;
  const float py = -P1 * iz;
  const float r2 = px * px + py * py;
  const float dist = 1.0f + k1 * r2 + k2 * r2 * r2;

  const float dd = 2.0f * (k1 + 2.0f * k2 * r2);
  const float A00 = f * (dist + dd * px * px);
  const float A01 = f * dd * px * py;
  const float A11 = f * (dist + dd * py * py);
  const float niz = -iz;
  const float G00 = niz * A00;
  const float G01 = niz * A01;
  const float G02 = niz * (A00 * px + A01 * py);
  const float G10 = niz * A01;
  const float G11 = niz * A11;
  const float G12 = niz * (A01 * px + A11 * py);

  const float c0 = gamma * wxX0 - alpha * X0 + delta * wdX * w0;
  const float c1 = gamma * wxX1 - alpha * X1 + delta * wdX * w1;
  const float c2 = gamma * wxX2 - alpha * X2 + delta * wdX * w2;
  const float ag = tiny ? 1.0f : alpha;
  const float bg = tiny ? 0.0f : beta;
  const float zg = tiny ? 0.0f : 1.0f;
  const float nag = -ag;
  const float D00 = bg * wdX + bg * w0 * X0 + zg * c0 * w0;
  const float D01 = ag * X2 + bg * w0 * X1 + zg * c0 * w1;
  const float D02 = nag * X1 + bg * w0 * X2 + zg * c0 * w2;
  const float D10 = nag * X2 + bg * w1 * X0 + zg * c1 * w0;
  const float D11 = bg * wdX + bg * w1 * X1 + zg * c1 * w1;
  const float D12 = ag * X0 + bg * w1 * X2 + zg * c1 * w2;
  const float D20 = ag * X1 + bg * w2 * X0 + zg * c2 * w0;
  const float D21 = nag * X0 + bg * w2 * X1 + zg * c2 * w1;
  const float D22 = bg * wdX + bg * w2 * X2 + zg * c2 * w2;

  const float nal = -alpha;
  const float R00 = c + beta * w0 * w0;
  const float R01 = nal * w2 + beta * w0 * w1;
  const float R02 = alpha * w1 + beta * w0 * w2;
  const float R10 = alpha * w2 + beta * w1 * w0;
  const float R11 = c + beta * w1 * w1;
  const float R12 = nal * w0 + beta * w1 * w2;
  const float R20 = nal * w1 + beta * w2 * w0;
  const float R21 = alpha * w0 + beta * w2 * w1;
  const float R22 = c + beta * w2 * w2;

  Jc[0] = G00 * D00 + G01 * D10 + G02 * D20;
  Jc[1] = G00 * D01 + G01 * D11 + G02 * D21;
  Jc[2] = G00 * D02 + G01 * D12 + G02 * D22;
  Jc[3] = G00;
  Jc[4] = G01;
  Jc[5] = G02;
  Jc[6] = dist * px;
  Jc[7] = f * r2 * px;
  Jc[8] = f * r2 * r2 * px;
  Jc[9] = G10 * D00 + G11 * D10 + G12 * D20;
  Jc[10] = G10 * D01 + G11 * D11 + G12 * D21;
  Jc[11] = G10 * D02 + G11 * D12 + G12 * D22;
  Jc[12] = G10;
  Jc[13] = G11;
  Jc[14] = G12;
  Jc[15] = dist * py;
  Jc[16] = f * r2 * py;
  Jc[17] = f * r2 * r2 * py;

  Jp[0] = G00 * R00 + G01 * R10 + G02 * R20;
  Jp[1] = G00 * R01 + G01 * R11 + G02 * R21;
  Jp[2] = G00 * R02 + G01 * R12 + G02 * R22;
  Jp[3] = G10 * R00 + G11 * R10 + G12 * R20;
  Jp[4] = G10 * R01 + G11 * R11 + G12 * R21;
  Jp[5] = G10 * R02 + G11 * R12 + G12 * R22;
}

__device__ __forceinline__ void load_rows(const float* __restrict__ cams,
                                          const float* __restrict__ pts,
                                          const long long* __restrict__ ids0,
                                          const long long* __restrict__ ids1,
                                          long long f, float* cam, float* X) {
  const float* c = cams + ids0[f] * 9;
  const float* p = pts + ids1[f] * 3;
#pragma unroll
  for (int i = 0; i < 9; ++i) cam[i] = c[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) X[i] = p[i];
}

template <int LOSS>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(const float* __restrict__ cams,
                    const float* __restrict__ pts,
                    const long long* __restrict__ ids0,
                    const long long* __restrict__ ids1,
                    const float* __restrict__ obs,
                    const bool* __restrict__ fmask,
                    const float* __restrict__ loss_params,
                    float* __restrict__ chi2, long long F) {
  const long long f = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (f >= F) return;
  float cam[9], X[3], r[2];
  load_rows(cams, pts, ids0, ids1, f, cam, X);
  residual(cam, X, obs + 2 * f, r);
  const float raw = r[0] * r[0] + r[1] * r[1];
  float value, deriv;
  robust<LOSS>(raw, loss_params[f], &value, &deriv);
  chi2[f] = value * (fmask[f] ? 1.0f : 0.0f);
}

// The floats a factor writes: r 2, Jc 18, Jp 6, chi2 1, dL 1, diag_c 9,
// diag_p 3.
constexpr int kLinFloats = 40;

template <int LOSS>
__global__ void __launch_bounds__(kThreads)
    linearize_kernel(const float* __restrict__ cams,
                     const float* __restrict__ pts,
                     const long long* __restrict__ ids0,
                     const long long* __restrict__ ids1,
                     const float* __restrict__ obs,
                     const bool* __restrict__ smask,
                     const bool* __restrict__ fmask,
                     const float* __restrict__ loss_params,
                     float* __restrict__ r_out, float* __restrict__ jc_out,
                     float* __restrict__ jp_out, float* __restrict__ chi2,
                     float* __restrict__ dl_out, float* __restrict__ diag_c,
                     float* __restrict__ diag_p, long long F) {
  // one span per output, each kThreads rows of its width
  __shared__ __align__(16) float tile[kThreads * kLinFloats];
  float* t_r = tile;
  float* t_jc = t_r + 2 * kThreads;
  float* t_jp = t_jc + 18 * kThreads;
  float* t_chi2 = t_jp + 6 * kThreads;
  float* t_dl = t_chi2 + kThreads;
  float* t_dc = t_dl + kThreads;
  float* t_dp = t_dc + 9 * kThreads;
  const long long f0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nf = static_cast<int>(F - f0 < kThreads ? F - f0 : kThreads);
  const int i = threadIdx.x;
  if (i < nf) {
    const long long f = f0 + i;
    float cam[9], X[3], r[2], Jc[18], Jp[6];
    load_rows(cams, pts, ids0, ids1, f, cam, X);
    residual(cam, X, obs + 2 * f, r);
    jacobian(cam, X, Jc, Jp);
    const float m0 = smask[2 * f] ? 1.0f : 0.0f;
    const float m1 = smask[2 * f + 1] ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < 18; ++k) Jc[k] = Jc[k] * m0;
#pragma unroll
    for (int k = 0; k < 6; ++k) Jp[k] = Jp[k] * m1;
    const float raw = r[0] * r[0] + r[1] * r[1];
    float value, dL;
    robust<LOSS>(raw, loss_params[f], &value, &dL);

    t_r[2 * i] = r[0];
    t_r[2 * i + 1] = r[1];
#pragma unroll
    for (int k = 0; k < 18; ++k) t_jc[18 * i + k] = Jc[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) t_jp[6 * i + k] = Jp[k];
    t_chi2[i] = value * (fmask[f] ? 1.0f : 0.0f);
    t_dl[i] = dL;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      t_dc[9 * i + c] = (Jc[c] * Jc[c] + Jc[9 + c] * Jc[9 + c]) * dL;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t_dp[3 * i + c] = (Jp[c] * Jp[c] + Jp[3 + c] * Jp[3 + c]) * dL;
    }
  }
  __syncthreads();
  // rows [f0, f0 + nf) of each output: f0 * width floats in, a multiple of
  // 4 (f0 is one of 128), so every span starts 16-byte aligned
  store_span<kThreads>(r_out + 2 * f0, t_r, 2 * nf);
  store_span<kThreads>(jc_out + 18 * f0, t_jc, 18 * nf);
  store_span<kThreads>(jp_out + 6 * f0, t_jp, 6 * nf);
  store_span<kThreads>(chi2 + f0, t_chi2, nf);
  store_span<kThreads>(dl_out + f0, t_dl, nf);
  store_span<kThreads>(diag_c + 9 * f0, t_dc, 9 * nf);
  store_span<kThreads>(diag_p + 3 * f0, t_dp, 3 * nf);
}

// bal_scale_b: a CTA owns a tile of kThreads consecutive factors. It
// stages the tile's Jc, Jp, r and dL rows in shared memory, each one
// contiguous range (16-byte cp.async copies), while each thread reads its
// factor's rows0 / rows1 once and gathers the factor's camera (9) and point
// (3) scale rows into registers. Thread i then forms factor i's stored J
// (each entry scaled by its column's scale and cast to storage) into a
// shared output tile and b's rows from the stored (rounded) values:
// b[c] = -(Js[0, c] (r0 dL) + Js[1, c] (r1 dL)). The CTA copies each
// output span out in 16-byte stores (a tile of bf16 Jc rows is 128 x 36
// contiguous bytes). Each input is read once, with no 64-bit division.
template <typename S, int D>
__device__ __forceinline__ void scale_b_slot(const float* __restrict__ J,
                                             const float* scale, bool scaled,
                                             float w0, float w1,
                                             S* __restrict__ out,
                                             float* __restrict__ b) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float x0 = J[c], x1 = J[D + c];
    if (scaled) {
      x0 = x0 * scale[c];
      x1 = x1 * scale[c];
    }
    const S a0 = Storage<S>::store(x0), a1 = Storage<S>::store(x1);
    out[c] = a0;
    out[D + c] = a1;
    b[c] = -(Storage<S>::load(a0) * w0 + Storage<S>::load(a1) * w1);
  }
}

// sc, sp: the padded (n_rows + 1, d) scale rows of the two slots, or both
// null when the Jacobians are not scaled (Graph.scale_system(False)).
template <typename S>
__global__ void __launch_bounds__(kThreads)
    scale_b_kernel(const float* __restrict__ jc, const float* __restrict__ jp,
                   const float* __restrict__ r, const float* __restrict__ dl,
                   const float* __restrict__ sc, const float* __restrict__ sp,
                   const long long* __restrict__ rows0,
                   const long long* __restrict__ rows1,
                   S* __restrict__ jc_out, S* __restrict__ jp_out,
                   float* __restrict__ b_c, float* __restrict__ b_p,
                   long long F) {
  // the staged inputs: Jc 18, Jp 6, r 2 and dL 1 floats a factor
  __shared__ __align__(16) float t_in[kThreads * 27];
  // the outputs: the stored Jc 18 and Jp 6 (S), b's rows 9 and 3 (float)
  __shared__ __align__(16) unsigned char t_j[kThreads * 24 * sizeof(S)];
  __shared__ __align__(16) float t_b[kThreads * 12];
  float* t_jc = t_in;
  float* t_jp = t_jc + 18 * kThreads;
  float* t_r = t_jp + 6 * kThreads;
  float* t_dl = t_r + 2 * kThreads;
  S* o_jc = reinterpret_cast<S*>(t_j);
  S* o_jp = o_jc + 18 * kThreads;
  float* o_bc = t_b;
  float* o_bp = t_b + 9 * kThreads;
  const long long f0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nf = static_cast<int>(F - f0 < kThreads ? F - f0 : kThreads);
  // rows [f0, f0 + nf) of each input: f0 * width floats in, a multiple of
  // 4, so every span starts 16-byte aligned
  stage_span<kThreads>(t_jc, jc + 18 * f0, 18 * nf);
  stage_span<kThreads>(t_jp, jp + 6 * f0, 6 * nf);
  stage_span<kThreads>(t_r, r + 2 * f0, 2 * nf);
  stage_span<kThreads>(t_dl, dl + f0, nf);
  cp_async_commit();
  const int i = threadIdx.x;
  const bool scaled = sc != nullptr;
  float scale[12];  // the camera's 9 column scales, then the point's 3
  if (scaled && i < nf) {
    const float* c = sc + rows0[f0 + i] * 9;
    const float* p = sp + rows1[f0 + i] * 3;
#pragma unroll
    for (int k = 0; k < 9; ++k) scale[k] = c[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) scale[9 + k] = p[k];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (i < nf) {
    const float dL = t_dl[i];
    const float w0 = t_r[2 * i] * dL, w1 = t_r[2 * i + 1] * dL;
    scale_b_slot<S, 9>(t_jc + 18 * i, scale, scaled, w0, w1, o_jc + 18 * i,
                       o_bc + 9 * i);
    scale_b_slot<S, 3>(t_jp + 6 * i, scale + 9, scaled, w0, w1,
                       o_jp + 6 * i, o_bp + 3 * i);
  }
  __syncthreads();
  // the output tiles' rows [f0, f0 + nf): 16-byte aligned as above (a
  // bf16 or fp16 Jc tile starts at 36 f0 bytes, f0 a multiple of 128)
  store_span<kThreads>(jc_out + 18 * f0, o_jc, 18 * nf);
  store_span<kThreads>(jp_out + 6 * f0, o_jp, 6 * nf);
  store_span<kThreads>(b_c + 9 * f0, o_bc, 9 * nf);
  store_span<kThreads>(b_p + 3 * f0, o_bp, 3 * nf);
}

// ---- bal_hessian_sum ------------------------------------------------------

constexpr int kSumThreads = 256;    // most threads of a group-1 CTA
constexpr int kSumSteps = 8;        // outputs a group-1 thread sums
constexpr int kStageFloats = 4096;  // J / dL floats a group-1 pass stages
constexpr int kLaneThreads = 512;   // most threads of a lane CTA (K1's)
constexpr int kLaneMinThreads = 256;  // short segments share a CTA up to this
constexpr int kLaneMaxSpc = kLaneMinThreads / 9 + 1;  // segments a CTA

// One slot pair's products. A factor's block is (DS, DT) row-major, or its
// transpose (DT, DS) when TRANS (a trans_idx site: element (k, i) of the
// transposed row). SAME: s == t, so Jt is Js. A staged row holds Js (2 DS
// floats), Jt (2 DT, unless SAME) and dL, widened from storage.
template <typename S, int DS, int DT, bool SAME, bool TRANS>
struct HPair {
  static constexpr int D = DS * DT;
  static constexpr int WS = 2 * DS;
  static constexpr int WT = SAME ? 0 : 2 * DT;
  static constexpr int W = WS + WT + 1;
  // column c of an output block -> (i, k): J_s column i, J_t column k
  static __device__ __forceinline__ void cols(int c, int* i, int* k) {
    if (TRANS) {
      *k = c / DS;
      *i = c - *k * DS;
    } else {
      *i = c / DT;
      *k = c - *i * DT;
    }
  }
  // float w of the staged row of value row v
  static __device__ __forceinline__ float load(const S* __restrict__ js,
                                               const S* __restrict__ jt,
                                               const float* __restrict__ dl,
                                               long long v, int w) {
    if (w < WS) return Storage<S>::load(js[v * WS + w]);
    if (w < WS + WT) return Storage<S>::load(jt[v * (2 * DT) + (w - WS)]);
    return dl[v];
  }
  // (Js[0, i] Jt[0, k] + Js[1, i] Jt[1, k]) dL, each operation rounded
  static __device__ __forceinline__ float entry(const float* row, int i,
                                                int k) {
    const float* t = row + (SAME ? 0 : WS);
    return (row[i] * t[k] + row[DS + i] * t[DT + k]) * row[W - 1];
  }
};

// G = 1: K1's row kernel (segsum.cu, segsum_rows_kernel) with the rows
// staged. A CTA of T = (256 / D) D threads owns SPC = (T / D) kSumSteps
// consecutive segments; thread x keeps column x % D and sums the segments
// x / D + j T / D (j < kSumSteps), each over its rows in row order, so a
// warp's store is 32 consecutive floats. The rows of the CTA's segments
// are staged kStageFloats / W at a time: J_s, J_t and dL in three arrays,
// each a contiguous copy where the plan has no permutation.
template <typename S, int DS, int DT, bool SAME, bool TRANS>
struct RowsShape {
  using P = HPair<S, DS, DT, SAME, TRANS>;
  static constexpr int kSegsPerStep = kSumThreads / P::D;
  static constexpr int kThreads = kSegsPerStep * P::D;
  static constexpr int kSegs = kSegsPerStep * kSumSteps;
  static constexpr int kRows = kStageFloats / P::W;
};

template <typename S, int DS, int DT, bool SAME, bool TRANS>
__global__ void __launch_bounds__(kSumThreads)
    hsum_rows_kernel(const S* __restrict__ js, const S* __restrict__ jt,
                     const float* __restrict__ dl,
                     const int* __restrict__ perm,
                     const int* __restrict__ offsets,
                     float* __restrict__ out, int num_segments,
                     int accumulate) {
  using P = HPair<S, DS, DT, SAME, TRANS>;
  using R = RowsShape<S, DS, DT, SAME, TRANS>;
  constexpr int WT = SAME ? P::WS : P::WT;  // J_t floats a row
  __shared__ float s_js[R::kRows * P::WS];
  __shared__ float s_jt[SAME ? 1 : R::kRows * P::WT];
  __shared__ float s_dl[R::kRows];
  __shared__ int soff[R::kSegs + 1];
  const long long s0 = static_cast<long long>(blockIdx.x) * R::kSegs;
  const int ns = static_cast<int>(
      num_segments - s0 < R::kSegs ? num_segments - s0 : R::kSegs);
  for (int x = threadIdx.x; x <= ns; x += R::kThreads) {
    soff[x] = offsets[s0 + x];
  }
  __syncthreads();
  const int sq = threadIdx.x / P::D;
  const int c = threadIdx.x - sq * P::D;
  int i, k;
  P::cols(c, &i, &k);
  const float* tj = SAME ? s_js : s_jt;
  float acc[kSumSteps];
#pragma unroll
  for (int j = 0; j < kSumSteps; ++j) acc[j] = 0.0f;
  const int r0 = soff[0], r1 = soff[ns];
  for (int c0 = r0; c0 < r1; c0 += R::kRows) {
    const int nr = r1 - c0 < R::kRows ? r1 - c0 : R::kRows;
    if (perm == nullptr) {
      const S* a = js + static_cast<long long>(c0) * P::WS;
      for (int x = threadIdx.x; x < nr * P::WS; x += R::kThreads) {
        s_js[x] = Storage<S>::load(a[x]);
      }
      if (!SAME) {
        const S* b = jt + static_cast<long long>(c0) * P::WT;
        for (int x = threadIdx.x; x < nr * P::WT; x += R::kThreads) {
          s_jt[x] = Storage<S>::load(b[x]);
        }
      }
      for (int x = threadIdx.x; x < nr; x += R::kThreads) {
        s_dl[x] = dl[c0 + x];
      }
    } else {
      for (int x = threadIdx.x; x < nr * P::WS; x += R::kThreads) {
        const int rr = x / P::WS;
        const long long v = __ldg(perm + c0 + rr);
        s_js[x] = Storage<S>::load(js[v * P::WS + (x - rr * P::WS)]);
      }
      if (!SAME) {
        for (int x = threadIdx.x; x < nr * P::WT; x += R::kThreads) {
          const int rr = x / P::WT;
          const long long v = __ldg(perm + c0 + rr);
          s_jt[x] = Storage<S>::load(jt[v * P::WT + (x - rr * P::WT)]);
        }
      }
      for (int x = threadIdx.x; x < nr; x += R::kThreads) {
        s_dl[x] = dl[__ldg(perm + c0 + x)];
      }
    }
    __syncthreads();
    const int c1 = c0 + nr;
#pragma unroll
    for (int j = 0; j < kSumSteps; ++j) {
      const int ls = sq + j * R::kSegsPerStep;
      if (ls >= ns) continue;
      const int a = soff[ls] > c0 ? soff[ls] : c0;
      const int b = soff[ls + 1] < c1 ? soff[ls + 1] : c1;
      for (int r = a - c0; r < b - c0; ++r) {
        const float* sa = s_js + r * P::WS;
        const float* sb = tj + r * WT;
        acc[j] = acc[j] + (sa[i] * sb[k] + sa[DS + i] * sb[DT + k]) * s_dl[r];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kSumSteps; ++j) {
    const int ls = sq + j * R::kSegsPerStep;
    if (ls >= ns) continue;
    float* dst = out + (s0 + ls) * P::D + c;
    *dst = accumulate ? *dst + acc[j] : acc[j];
  }
}

// K1's lane rounds staged at once by a CTA of L lanes a thread: 4 / L (4
// rows a thread and round at least), so that a round's gather latency is
// paid for several lane rounds.
template <int L>
__host__ __device__ constexpr int lane_rounds() {
  return L >= 4 ? 1 : 4 / L;
}

// G > 1: K1's lane CTA (segsum.cu, segsum_lanes_kernel) with the value
// rows formed from staged J rows. C columns per thread, CT threads per
// slot, Q = 2^q_log2 slots, L lanes per thread: G = Q L. The CTA sums
// segments blockIdx.x * spc + [0, spc); each round stages, per segment,
// its next KR G sorted rows (KR = lane_rounds<L>(): KR of K1's rounds),
// which the lanes take round by round. Dynamic shared memory: two stage
// buffers of spc KR G W floats, then the lane tree (blockDim.x C).
template <typename S, int DS, int DT, bool SAME, bool TRANS, int L>
__global__ void __launch_bounds__(kLaneThreads)
    hsum_lanes_kernel(const S* __restrict__ js, const S* __restrict__ jt,
                      const float* __restrict__ dl,
                      const int* __restrict__ perm,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int num_segments, int q_log2,
                      int spc, int accumulate) {
  using P = HPair<S, DS, DT, SAME, TRANS>;
  constexpr int C = (P::D + 31) / 32;
  constexpr int CT = (P::D + C - 1) / C;
  constexpr int KR = lane_rounds<L>();
  // a (DS, DT) block's columns c + u CT share J_t's column k when CT is a
  // multiple of DT
  constexpr bool kSharedK = !TRANS && CT % DT == 0;
  // staged floats per thread and round: spc KR G W / (spc Q CT)
  constexpr int NP = (KR * L * P::W + CT - 1) / CT;
  extern __shared__ float lane_smem[];
  __shared__ int soff[kLaneMaxSpc + 1];
  const int Q = 1 << q_log2;
  const int G = Q * L;
  const int RG = KR * G;  // a segment's rows a round
  const int per_seg = Q * CT;
  const int nthreads = spc * per_seg;
  const int n_stage = spc * RG * P::W;
  float* tree = lane_smem + 2 * n_stage;
  const int sub = threadIdx.x / per_seg;
  const int t = threadIdx.x - sub * per_seg;
  const int q = t / CT;
  const int c = t - q * CT;
  const long long s0 = static_cast<long long>(blockIdx.x) * spc;
  const int ns = static_cast<int>(
      num_segments - s0 < spc ? num_segments - s0 : spc);
  for (int x = threadIdx.x; x <= ns; x += nthreads) soff[x] = offsets[s0 + x];
  __syncthreads();
  int rounds = 0;
  for (int b = 0; b < ns; ++b) {
    const int n = (soff[b + 1] - soff[b] + RG - 1) / RG;
    rounds = n > rounds ? n : rounds;
  }
  const bool live = sub < ns;
  int ii[C], kk[C];
  bool has[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    has[u] = c + u * CT < P::D;
    ii[u] = kk[u] = 0;
    if (has[u]) P::cols(c + u * CT, &ii[u], &kk[u]);
  }

  // this thread's share of round rnd's staged floats: float x of the
  // stage is float w of the row at sorted position soff[b] + rnd RG + j
  // of segment b (x = (b RG + j) W + w)
  float pre[NP];
  auto fetch = [&](int rnd) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int x = threadIdx.x + p * nthreads;
      pre[p] = 0.0f;
      if (x < n_stage) {
        const int slot = x / P::W;
        const int b = slot / RG;
        const int pos = soff[b] + rnd * RG + (slot - b * RG);
        if (b < ns && pos < soff[b + 1]) {
          const long long v = perm != nullptr ? __ldg(perm + pos) : pos;
          pre[p] = P::load(js, jt, dl, v, x - slot * P::W);
        }
      }
    }
  };
  auto put = [&](float* buf) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int x = threadIdx.x + p * nthreads;
      if (x < n_stage) buf[x] = pre[p];
    }
  };

  float acc[L][C];
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int u = 0; u < C; ++u) acc[j][u] = 0.0f;
  }
  if (rounds > 0) {
    fetch(0);
    put(lane_smem);
  }
  __syncthreads();
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool more = rnd + 1 < rounds;
    if (more) fetch(rnd + 1);  // in flight while this round is summed
    if (live) {
      const float* cur = lane_smem + (rnd & 1) * n_stage + sub * RG * P::W;
      const int first = soff[sub] + rnd * RG;
      const int left = soff[sub + 1] - first;
      // K1's round k of the KR: lane q + j Q takes its row k G + q + j Q
#pragma unroll
      for (int k = 0; k < KR; ++k) {
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const int jj = k * G + q + j * Q;
          if (jj >= left) continue;
          const float* row = cur + jj * P::W;
          if constexpr (kSharedK) {
            // one J_t column for the thread's C columns: its two values
            // and dL read once
            const float* tr = row + (SAME ? 0 : P::WS);
            const float b0 = tr[kk[0]], b1 = tr[DT + kk[0]];
            const float d = row[P::W - 1];
#pragma unroll
            for (int u = 0; u < C; ++u) {
              if (has[u]) {
                acc[j][u] = acc[j][u] +
                            (row[ii[u]] * b0 + row[DS + ii[u]] * b1) * d;
              }
            }
          } else {
#pragma unroll
            for (int u = 0; u < C; ++u) {
              if (has[u]) {
                acc[j][u] = acc[j][u] + P::entry(row, ii[u], kk[u]);
              }
            }
          }
        }
      }
    }
    if (more) put(lane_smem + ((rnd + 1) & 1) * n_stage);
    __syncthreads();
  }

  // K1's tree: levels h = G/2, ..., Q in registers (lane q + j Q += lane
  // q + (j + h/Q) Q), then h = Q/2, ..., 1 through shared memory
#pragma unroll
  for (int h = L / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
#pragma unroll
      for (int u = 0; u < C; ++u) acc[j][u] = acc[j][u] + acc[j + h][u];
    }
  }
  float* mine = tree + (sub * per_seg + c) * C;
  for (int h = Q >> 1; h >= 1; h >>= 1) {
    if (q >= h && q < 2 * h) {
#pragma unroll
      for (int u = 0; u < C; ++u) mine[q * CT * C + u] = acc[0][u];
    }
    __syncthreads();
    if (q < h) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        acc[0][u] = acc[0][u] + mine[(q + h) * CT * C + u];
      }
    }
    __syncthreads();
  }
  if (live && q == 0) {
    float* dst = out + (s0 + sub) * P::D;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (!has[u]) continue;
      const int col = c + u * CT;
      dst[col] = accumulate ? dst[col] + acc[0][u] : acc[0][u];
    }
  }
}

struct HSumArgs {
  const void* js;
  const void* jt;
  const void* dl;
  const int* perm;
  const int* offsets;
  float* out;
  int num_segments, group_log2, accumulate;
  cudaStream_t stream;
};

template <typename S, int DS, int DT, bool SAME, bool TRANS, int L>
cudaError_t launch_hsum_lanes(const HSumArgs& a, int q_log2, int spc) {
  using P = HPair<S, DS, DT, SAME, TRANS>;
  constexpr int C = (P::D + 31) / 32;
  constexpr int CT = (P::D + C - 1) / C;
  const int threads = spc * (CT << q_log2);
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(spc) * lane_rounds<L>() * (L << q_log2) *
           P::W + threads * C);
  auto kernel = hsum_lanes_kernel<S, DS, DT, SAME, TRANS, L>;
  if (smem > 48 * 1024) {
    // only a forced group of 256 lanes asks this much
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>((a.num_segments + spc - 1) / spc), threads,
           smem, a.stream>>>(
      static_cast<const S*>(a.js), static_cast<const S*>(a.jt),
      static_cast<const float*>(a.dl), a.perm, a.offsets, a.out,
      a.num_segments, q_log2, spc, a.accumulate);
  return cudaGetLastError();
}

template <typename S, int DS, int DT, bool SAME, bool TRANS>
cudaError_t launch_hsum(const HSumArgs& a) {
  using P = HPair<S, DS, DT, SAME, TRANS>;
  if (a.group_log2 == 0) {
    using R = RowsShape<S, DS, DT, SAME, TRANS>;
    hsum_rows_kernel<S, DS, DT, SAME, TRANS>
        <<<static_cast<unsigned>((a.num_segments + R::kSegs - 1) / R::kSegs),
           R::kThreads, 0, a.stream>>>(
            static_cast<const S*>(a.js), static_cast<const S*>(a.jt),
            static_cast<const float*>(a.dl), a.perm, a.offsets, a.out,
            a.num_segments, a.accumulate);
    return cudaGetLastError();
  }
  // K1's CTA shape (segsum.cu, segsum): the most slots that fit, at most G
  constexpr int C = (P::D + 31) / 32;
  constexpr int CT = (P::D + C - 1) / C;
  int q_log2 = 0;
  while (q_log2 < a.group_log2 && (CT << (q_log2 + 1)) <= kLaneThreads) {
    ++q_log2;
  }
  const int per_seg = CT << q_log2;
  const int spc = per_seg >= kLaneMinThreads ? 1 : kLaneMinThreads / per_seg;
  switch (a.group_log2 - q_log2) {
    case 0: return launch_hsum_lanes<S, DS, DT, SAME, TRANS, 1>(a, q_log2, spc);
    case 1: return launch_hsum_lanes<S, DS, DT, SAME, TRANS, 2>(a, q_log2, spc);
    case 2: return launch_hsum_lanes<S, DS, DT, SAME, TRANS, 4>(a, q_log2, spc);
    case 3: return launch_hsum_lanes<S, DS, DT, SAME, TRANS, 8>(a, q_log2, spc);
    case 4:
      return launch_hsum_lanes<S, DS, DT, SAME, TRANS, 16>(a, q_log2, spc);
    default: return cudaErrorInvalidValue;
  }
}

// pair: the index of (s, t) in (0, 0), (0, 1), (1, 1) (bal.py, PAIRS);
// transposed: the site's blocks are (t, s) (only (0, 1) has such sites)
template <typename S>
int hessian_sum(const void* jc, const void* jp, const void* dl,
                const void* perm, const void* offsets, void* out,
                int num_segments, int pair, int transposed, int group_log2,
                int accumulate, void* stream) {
  if (num_segments < 0 || group_log2 < 0 || group_log2 > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
  HSumArgs a{jc, jc, dl, static_cast<const int*>(perm),
             static_cast<const int*>(offsets), static_cast<float*>(out),
             num_segments, group_log2, accumulate,
             static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (pair * 2 + (transposed ? 1 : 0)) {
    case 0: err = launch_hsum<S, 9, 9, true, false>(a); break;
    case 2:
      a.jt = jp;
      err = launch_hsum<S, 9, 3, false, false>(a);
      break;
    case 3:
      a.jt = jp;
      err = launch_hsum<S, 9, 3, false, true>(a);
      break;
    case 4:
      a.js = a.jt = jp;
      err = launch_hsum<S, 3, 3, true, false>(a);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <int LOSS>
cudaError_t launch_residual(const void* cams, const void* pts,
                            const void* ids0, const void* ids1,
                            const void* obs, const void* fmask,
                            const void* loss_params, void* chi2, long long F,
                            cudaStream_t stream) {
  residual_kernel<LOSS><<<blocks_for(F), kThreads, 0, stream>>>(
      static_cast<const float*>(cams), static_cast<const float*>(pts),
      static_cast<const long long*>(ids0),
      static_cast<const long long*>(ids1), static_cast<const float*>(obs),
      static_cast<const bool*>(fmask),
      static_cast<const float*>(loss_params), static_cast<float*>(chi2), F);
  return cudaGetLastError();
}

template <int LOSS>
cudaError_t launch_linearize(const void* cams, const void* pts,
                             const void* ids0, const void* ids1,
                             const void* obs, const void* smask,
                             const void* fmask, const void* loss_params,
                             void* r, void* jc, void* jp, void* chi2,
                             void* dl, void* diag_c, void* diag_p,
                             long long F, cudaStream_t stream) {
  linearize_kernel<LOSS><<<blocks_for(F), kThreads, 0, stream>>>(
      static_cast<const float*>(cams), static_cast<const float*>(pts),
      static_cast<const long long*>(ids0),
      static_cast<const long long*>(ids1), static_cast<const float*>(obs),
      static_cast<const bool*>(smask), static_cast<const bool*>(fmask),
      static_cast<const float*>(loss_params), static_cast<float*>(r),
      static_cast<float*>(jc), static_cast<float*>(jp),
      static_cast<float*>(chi2), static_cast<float*>(dl),
      static_cast<float*>(diag_c), static_cast<float*>(diag_p), F);
  return cudaGetLastError();
}

template <typename S>
int scale_b(const void* jc, const void* jp, const void* r, const void* dl,
            const void* sc, const void* sp, const void* rows0,
            const void* rows1, void* jc_out, void* jp_out, void* b_c,
            void* b_p, long long F, void* stream) {
  if (F < 0 || (sc == nullptr) != (sp == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  // the tiles are staged in and copied out in 16-byte pieces
  const void* spans[] = {jc, jp, r, dl, jc_out, jp_out, b_c, b_p};
  for (const void* p : spans) {
    if (reinterpret_cast<unsigned long long>(p) & 15) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  scale_b_kernel<S><<<blocks_for(F), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(jc), static_cast<const float*>(jp),
      static_cast<const float*>(r), static_cast<const float*>(dl),
      static_cast<const float*>(sc), static_cast<const float*>(sp),
      static_cast<const long long*>(rows0),
      static_cast<const long long*>(rows1), static_cast<S*>(jc_out),
      static_cast<S*>(jp_out), static_cast<float*>(b_c),
      static_cast<float*>(b_p), F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cams (Nc, 9), pts (Np, 3), obs (F, 2), loss_params (F,): float32; ids0,
// ids1 (F,) int64; fmask (F,) bool; chi2 (F,) float32 out. loss: 0
// default, 1 Huber, 2 Cauchy. Launches on `stream` and returns the
// cudaGetLastError() code (0 on success).
extern "C" int gt_bal_residual(const void* cams, const void* pts,
                               const void* ids0, const void* ids1,
                               const void* obs, const void* fmask,
                               const void* loss_params, void* chi2,
                               long long F, int loss, void* stream) {
  if (F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (loss) {
    case kDefault:
      err = launch_residual<kDefault>(cams, pts, ids0, ids1, obs, fmask,
                                      loss_params, chi2, F, s);
      break;
    case kHuber:
      err = launch_residual<kHuber>(cams, pts, ids0, ids1, obs, fmask,
                                    loss_params, chi2, F, s);
      break;
    case kCauchy:
      err = launch_residual<kCauchy>(cams, pts, ids0, ids1, obs, fmask,
                                     loss_params, chi2, F, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The same inputs and smask (F, 2) bool; out: r (F, 2), jc (F, 18), jp
// (F, 6), chi2 (F,), dl (F,), diag_c (F, 9), diag_p (F, 3), all float32
// and 16-byte aligned.
extern "C" int gt_bal_linearize(const void* cams, const void* pts,
                                const void* ids0, const void* ids1,
                                const void* obs, const void* smask,
                                const void* fmask, const void* loss_params,
                                void* r, void* jc, void* jp, void* chi2,
                                void* dl, void* diag_c, void* diag_p,
                                long long F, int loss, void* stream) {
  if (F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  // the tile goes out in float4 stores
  const void* outs[] = {r, jc, jp, chi2, dl, diag_c, diag_p};
  for (const void* p : outs) {
    if (reinterpret_cast<unsigned long long>(p) & 15) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (loss) {
    case kDefault:
      err = launch_linearize<kDefault>(cams, pts, ids0, ids1, obs, smask,
                                       fmask, loss_params, r, jc, jp, chi2,
                                       dl, diag_c, diag_p, F, s);
      break;
    case kHuber:
      err = launch_linearize<kHuber>(cams, pts, ids0, ids1, obs, smask,
                                     fmask, loss_params, r, jc, jp, chi2, dl,
                                     diag_c, diag_p, F, s);
      break;
    case kCauchy:
      err = launch_linearize<kCauchy>(cams, pts, ids0, ids1, obs, smask,
                                      fmask, loss_params, r, jc, jp, chi2,
                                      dl, diag_c, diag_p, F, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// jc (F, 18), jp (F, 6), r (F, 2), dl (F,): float32; sc (n0 + 1, 9), sp
// (n1 + 1, 3) float32 scale rows, both null for no scaling; rows0, rows1
// (F,) int64. Out: jc_out, jp_out in the storage type, b_c (F, 9), b_p
// (F, 3) float32. jc, jp, r, dl and the outputs 16-byte aligned.
extern "C" int gt_bal_scale_b_f32(const void* jc, const void* jp,
                                  const void* r, const void* dl,
                                  const void* sc, const void* sp,
                                  const void* rows0, const void* rows1,
                                  void* jc_out, void* jp_out, void* b_c,
                                  void* b_p, long long F, void* stream) {
  return scale_b<float>(jc, jp, r, dl, sc, sp, rows0, rows1, jc_out, jp_out,
                        b_c, b_p, F, stream);
}

extern "C" int gt_bal_scale_b_bf16(const void* jc, const void* jp,
                                   const void* r, const void* dl,
                                   const void* sc, const void* sp,
                                   const void* rows0, const void* rows1,
                                   void* jc_out, void* jp_out, void* b_c,
                                   void* b_p, long long F, void* stream) {
  return scale_b<__nv_bfloat16>(jc, jp, r, dl, sc, sp, rows0, rows1, jc_out,
                                jp_out, b_c, b_p, F, stream);
}

extern "C" int gt_bal_scale_b_f16(const void* jc, const void* jp,
                                  const void* r, const void* dl,
                                  const void* sc, const void* sp,
                                  const void* rows0, const void* rows1,
                                  void* jc_out, void* jp_out, void* b_c,
                                  void* b_p, long long F, void* stream) {
  return scale_b<__half>(jc, jp, r, dl, sc, sp, rows0, rows1, jc_out, jp_out,
                         b_c, b_p, F, stream);
}

// jc (F, 18), jp (F, 6) in the storage type, dl (F,) float32; perm (K,)
// int32 or null and offsets (num_segments + 1,) int32: the site's K1 plan
// (K = F rows), 2^group_log2 lanes per segment; out (num_segments, D)
// float32, D = 81, 27 (pair 1; its transpose when transposed) or 9. With
// accumulate 0 the sums are stored, else added to out. Launches on
// `stream` and returns the cudaGetLastError() code (0 on success).
extern "C" int gt_bal_hessian_sum_f32(const void* jc, const void* jp,
                                      const void* dl, const void* perm,
                                      const void* offsets, void* out,
                                      int num_segments, int pair,
                                      int transposed, int group_log2,
                                      int accumulate, void* stream) {
  return hessian_sum<float>(jc, jp, dl, perm, offsets, out, num_segments,
                            pair, transposed, group_log2, accumulate, stream);
}

extern "C" int gt_bal_hessian_sum_bf16(const void* jc, const void* jp,
                                       const void* dl, const void* perm,
                                       const void* offsets, void* out,
                                       int num_segments, int pair,
                                       int transposed, int group_log2,
                                       int accumulate, void* stream) {
  return hessian_sum<__nv_bfloat16>(jc, jp, dl, perm, offsets, out,
                                    num_segments, pair, transposed,
                                    group_log2, accumulate, stream);
}

extern "C" int gt_bal_hessian_sum_f16(const void* jc, const void* jp,
                                      const void* dl, const void* perm,
                                      const void* offsets, void* out,
                                      int num_segments, int pair,
                                      int transposed, int group_log2,
                                      int accumulate, void* stream) {
  return hessian_sum<__half>(jc, jp, dl, perm, offsets, out, num_segments,
                             pair, transposed, group_log2, accumulate,
                             stream);
}

extern "C" const char* gt_bal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
