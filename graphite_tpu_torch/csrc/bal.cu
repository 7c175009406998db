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
// version of each, which follows the generic code op by op), each an
// instance of the graph's element type T, float (FP32_* policies) or
// double (FP64_*, the entries ending _f64):
//   gt_bal_residual      camera[ids0], point[ids1], obs, factor_mask,
//                        loss_params -> masked robust chi2 (F)
//   gt_bal_linearize     the same and slot_mask -> r (F,2), the masked
//                        unscaled J (F,18) and (F,6), chi2 (F), dL (F), the
//                        Jacobi diagonal's rows (F,9) and (F,3)
//   gt_bal_scale_b_*     J, r, dL, the padded scale rows at rows0 / rows1 ->
//                        the stored J in the storage type S (double, float,
//                        bf16 or fp16) and b's rows (F,9) and (F,3) in T
//   gt_bal_hessian_sum_* the stored J (S), dL, one Hessian site's K1 plan
//                        (perm, offsets, lanes per segment) and its slot
//                        pair -> the site's block group in the Hessian
//                        values' dtype O (inv_dtype): each block the sum of
//                        its factors' J_s^T dL J_t
// Inputs and outputs other than the stored J are in T. The loss (default,
// Huber, Cauchy) is a template parameter; the gate (bal.py, gate) sends
// every other factor set to the generic code.
//
// Bound: memory. Per factor the float32 entries move about 35, 195, 268
// and, over Venice's three Hessian sites, ~330 bytes (J and dL once a
// site, the plan, the blocks once), and do a few hundred float32
// operations and two float64 cos / sin (linearize) or one (residual); the
// double entries move about twice the bytes and do the same operations in
// float64.
//
// bal_residual and bal_linearize run one thread per factor, the camera and
// point rows gathered straight from global memory. bal_linearize writes
// its 40 values a factor (r 2, Jc 18, Jp 6, chi2 1, dL 1, diag_c 9, diag_p
// 3) into a shared tile of its CTA's 128 factors (20 KB in float, 40 KB in
// double), one span per output; after a __syncthreads() the CTA copies
// each span to its output, whose rows [128 b, 128 b + 128) are one
// contiguous range, in 16-byte stores: a warp's store is 512 contiguous
// bytes, where a thread's own rows made it touch 32 rows. bal_scale_b runs
// tiles of 128 factors (64 in double: the staged tiles are 32 KB either
// way) both ways: its CTA stages the tile's J, r and dL rows in shared
// memory with 16-byte cp.async copies, each thread reads its factor's two
// row indices and gathers its 12 scales once, forms the stored J and b's
// rows into a shared output tile, and the CTA copies each span out in
// 16-byte stores.
//
// bal_hessian_sum: one launch per Hessian site (slot pair (s, t), and
// whether the site's blocks are the transposed (t, s) ones) forms each
// product where it is summed. The site's rows would be (F, 81), (F, 27) or
// (F, 9) values, 2.34 GB at Venice in float32; none is written. It keeps
// K1's summation order on the same plan (segsum.cu: lane l of a segment
// sums its sorted rows l, l+G, ... from +0.0, then the halving tree), so a
// block's bits are those of K1 over the product rows. Each product is
// formed in T from J widened from S, rounded to O, and summed in O, as the
// generic branch forms its rows in acc_dtype and casts them to inv_dtype.
// Rows are staged widened to T; every staging area is sized in bytes, so a
// double stage holds half the rows of a float one.
// - G = 1 (the destination-sorted point sites, ~1-5 rows a block): K1's
//   thread per (block, column), grouped: a CTA of (256 / D) D threads owns
//   8 (256 / D) consecutive blocks, stages their rows' J_s, J_t and dL in
//   shared memory once (three contiguous copies where the plan has no
//   permutation; 16 KB a pass), and each thread keeps one column and sums
//   it over 8 of the blocks, each over its staged rows in row order. A
//   warp's store is 32 consecutive values. (Float4 stores of 4 and 16
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
//   Tensor.__rtruediv__, reciprocal(x) * 1.0: the IEEE 1 / x. The model
//   writes no tensor / Python scalar (PyTorch's CUDA op would multiply by
//   the reciprocal).
// - Python constants such as 1/24 reach the op in the tensor's dtype:
//   rounded to float in a float32 graph, the double itself in a float64
//   one (Real<T>: static_cast<T>(1.0 / 24.0), never an f-suffixed
//   literal). Comparisons with a Python scalar (th2 < 0.01, < 1e-24)
//   compare with its value in T.
// - Transcendentals: in float, sqrt_rn and _cos_sin take float64 and round
//   (precision.py, models/bal.py): the float64 sqrt is IEEE, and cos / sin
//   are CUDA's double functions, which PyTorch's CUDA cos / sin call. In
//   double, the same double functions with no rounding, as PyTorch's
//   float64 ops call them. Huber uses sqrt_rn. Cauchy's log1pf / log1p is
//   the function PyTorch's CUDA log1p calls for the dtype.
// - torch.maximum, clamp_min and clamp are PyTorch's CUDA ops: a NaN
//   operand is returned, else fmax / fmin.
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
//   then __float2half_rn; bf16 __float2bfloat16_rn; a double goes to
//   float first (robust.cuh, Storage). b and H read the rounded value,
//   widened exactly to T.
// - Capture: the entries launch on the given stream, allocate nothing and
//   never synchronise, so they run inside the captured LM iteration and
//   its conditional regions.
// - Registers: bal_linearize keeps about 100 values live per thread; nvcc
//   gives the float instance 48-56 registers and spills nothing (-Xptxas -v
//   in the build log, which chip_smoke.py's [build] lines print; the
//   double instances' counts are in PERF.md); its tile is shared memory,
//   not registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "robust.cuh"
#include "staging.cuh"

namespace {

constexpr int kThreads = 128;

// Python constants in the graph's element type, as PyTorch hands them to
// the op: rounded to float in a float32 graph, the double itself in a
// float64 graph
template <typename T>
struct Real {
  static constexpr T kInv6 = static_cast<T>(1.0 / 6.0);
  static constexpr T kInv24 = static_cast<T>(1.0 / 24.0);
  static constexpr T kInv30 = static_cast<T>(1.0 / 30.0);
  static constexpr T kInv120 = static_cast<T>(1.0 / 120.0);
  static constexpr T kInv180 = static_cast<T>(1.0 / 180.0);
  static constexpr T kInv720 = static_cast<T>(1.0 / 720.0);
  static constexpr T kInv840 = static_cast<T>(1.0 / 840.0);
  static constexpr T kInv6720 = static_cast<T>(1.0 / 6720.0);
  static constexpr T kMinusThird = static_cast<T>(-1.0 / 3.0);
  static constexpr T kMinusTwelfth = static_cast<T>(-1.0 / 12.0);
  static constexpr T kTiny = static_cast<T>(1e-24);
  static constexpr T kSmall = static_cast<T>(0.01);
  static constexpr T kZero = static_cast<T>(0);
  static constexpr T kHalf = static_cast<T>(0.5);
  static constexpr T kOne = static_cast<T>(1);
  static constexpr T kTwo = static_cast<T>(2);
};

// _cos_sin (models/bal.py): float, the double functions rounded; double,
// the double functions themselves
__device__ __forceinline__ float cos_rn(float x) {
  return static_cast<float>(cos(static_cast<double>(x)));
}

__device__ __forceinline__ float sin_rn(float x) {
  return static_cast<float>(sin(static_cast<double>(x)));
}

__device__ __forceinline__ double cos_rn(double x) { return cos(x); }
__device__ __forceinline__ double sin_rn(double x) { return sin(x); }

// reprojection_residual (models/bal.py): rodrigues_rotate, then project,
// minus the observation. cam: 9 values; X: 3.
template <typename T>
__device__ __forceinline__ void residual(const T* cam, const T* X,
                                         const T* obs, T* r) {
  using R = Real<T>;
  const T w0 = cam[0], w1 = cam[1], w2 = cam[2];
  const T X0 = X[0], X1 = X[1], X2 = X[2];
  const T theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool tiny = theta2 < R::kTiny;
  const T theta = sqrt_rn(tiny ? R::kOne : theta2);
  const T a0 = w0 / theta, a1 = w1 / theta, a2 = w2 / theta;
  const T cth = cos_rn(theta), sth = sin_rn(theta);
  const T axx0 = a1 * X2 - a2 * X1;
  const T axx1 = a2 * X0 - a0 * X2;
  const T axx2 = a0 * X1 - a1 * X0;
  const T adx = a0 * X0 + a1 * X1 + a2 * X2;
  const T omc = R::kOne - cth;
  T v0, v1, v2;
  if (tiny) {
    v0 = X0 + (w1 * X2 - w2 * X1);
    v1 = X1 + (w2 * X0 - w0 * X2);
    v2 = X2 + (w0 * X1 - w1 * X0);
  } else {
    v0 = X0 * cth + axx0 * sth + a0 * adx * omc;
    v1 = X1 * cth + axx1 * sth + a1 * adx * omc;
    v2 = X2 * cth + axx2 * sth + a2 * adx * omc;
  }
  const T P0 = v0 + cam[3], P1 = v1 + cam[4], P2 = v2 + cam[5];
  const T px = -P0 / P2, py = -P1 / P2;
  const T r2 = px * px + py * py;
  const T k1 = cam[7], k2 = cam[8];
  const T distortion = R::kOne + k1 * r2 + k2 * r2 * r2;
  r[0] = cam[6] * distortion * px - obs[0];
  r[1] = cam[6] * distortion * py - obs[1];
}

// reprojection_jacobian (models/bal.py): the (2, 9) and (2, 3) blocks,
// row-major, unmasked.
template <typename T>
__device__ __forceinline__ void jacobian(const T* cam, const T* X, T* Jc,
                                         T* Jp) {
  using R = Real<T>;
  const T w0 = cam[0], w1 = cam[1], w2 = cam[2];
  const T f = cam[6], k1 = cam[7], k2 = cam[8];
  const T X0 = X[0], X1 = X[1], X2 = X[2];

  const T th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < R::kSmall;
  const T th2_g = small ? R::kOne : th2;
  const T th = sqrt_rn(th2_g);
  const T cos_th = cos_rn(th), sin_th = sin_rn(th);
  const T th4 = th2 * th2;
  const T c = small ? R::kOne - th2 * R::kHalf + th4 * R::kInv24
                          - th4 * th2 * R::kInv720
                    : cos_th;
  const T alpha = small ? R::kOne - th2 * R::kInv6 + th4 * R::kInv120
                        : sin_th / th;
  const T beta = small ? R::kHalf - th2 * R::kInv24 + th4 * R::kInv720
                       : (R::kOne - c) / th2_g;
  const T gamma = small ? R::kMinusThird + th2 * R::kInv30 - th4 * R::kInv840
                        : (c - alpha) / th2_g;
  const T delta = small ? R::kMinusTwelfth + th2 * R::kInv180
                              - th4 * R::kInv6720
                        : (alpha - R::kTwo * beta) / th2_g;

  const T wxX0 = w1 * X2 - w2 * X1;
  const T wxX1 = w2 * X0 - w0 * X2;
  const T wxX2 = w0 * X1 - w1 * X0;
  const T wdX = w0 * X0 + w1 * X1 + w2 * X2;

  const bool tiny = th2 < R::kTiny;
  const T v0 = tiny ? X0 + wxX0 : c * X0 + alpha * wxX0 + beta * wdX * w0;
  const T v1 = tiny ? X1 + wxX1 : c * X1 + alpha * wxX1 + beta * wdX * w1;
  const T v2 = tiny ? X2 + wxX2 : c * X2 + alpha * wxX2 + beta * wdX * w2;

  const T P0 = v0 + cam[3], P1 = v1 + cam[4], P2 = v2 + cam[5];
  const T iz = t_recip(P2);
  const T px = -P0 * iz;
  const T py = -P1 * iz;
  const T r2 = px * px + py * py;
  const T dist = R::kOne + k1 * r2 + k2 * r2 * r2;

  const T dd = R::kTwo * (k1 + R::kTwo * k2 * r2);
  const T A00 = f * (dist + dd * px * px);
  const T A01 = f * dd * px * py;
  const T A11 = f * (dist + dd * py * py);
  const T niz = -iz;
  const T G00 = niz * A00;
  const T G01 = niz * A01;
  const T G02 = niz * (A00 * px + A01 * py);
  const T G10 = niz * A01;
  const T G11 = niz * A11;
  const T G12 = niz * (A01 * px + A11 * py);

  const T c0 = gamma * wxX0 - alpha * X0 + delta * wdX * w0;
  const T c1 = gamma * wxX1 - alpha * X1 + delta * wdX * w1;
  const T c2 = gamma * wxX2 - alpha * X2 + delta * wdX * w2;
  const T ag = tiny ? R::kOne : alpha;
  const T bg = tiny ? R::kZero : beta;
  const T zg = tiny ? R::kZero : R::kOne;
  const T nag = -ag;
  const T D00 = bg * wdX + bg * w0 * X0 + zg * c0 * w0;
  const T D01 = ag * X2 + bg * w0 * X1 + zg * c0 * w1;
  const T D02 = nag * X1 + bg * w0 * X2 + zg * c0 * w2;
  const T D10 = nag * X2 + bg * w1 * X0 + zg * c1 * w0;
  const T D11 = bg * wdX + bg * w1 * X1 + zg * c1 * w1;
  const T D12 = ag * X0 + bg * w1 * X2 + zg * c1 * w2;
  const T D20 = ag * X1 + bg * w2 * X0 + zg * c2 * w0;
  const T D21 = nag * X0 + bg * w2 * X1 + zg * c2 * w1;
  const T D22 = bg * wdX + bg * w2 * X2 + zg * c2 * w2;

  const T nal = -alpha;
  const T R00 = c + beta * w0 * w0;
  const T R01 = nal * w2 + beta * w0 * w1;
  const T R02 = alpha * w1 + beta * w0 * w2;
  const T R10 = alpha * w2 + beta * w1 * w0;
  const T R11 = c + beta * w1 * w1;
  const T R12 = nal * w0 + beta * w1 * w2;
  const T R20 = nal * w1 + beta * w2 * w0;
  const T R21 = alpha * w0 + beta * w2 * w1;
  const T R22 = c + beta * w2 * w2;

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

template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ cams,
                                          const T* __restrict__ pts,
                                          const long long* __restrict__ ids0,
                                          const long long* __restrict__ ids1,
                                          long long f, T* cam, T* X) {
  const T* c = cams + ids0[f] * 9;
  const T* p = pts + ids1[f] * 3;
#pragma unroll
  for (int i = 0; i < 9; ++i) cam[i] = c[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) X[i] = p[i];
}

template <typename T>
__device__ __forceinline__ T mask_value(bool m) {
  return m ? Real<T>::kOne : Real<T>::kZero;
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(const T* __restrict__ cams, const T* __restrict__ pts,
                    const long long* __restrict__ ids0,
                    const long long* __restrict__ ids1,
                    const T* __restrict__ obs, const bool* __restrict__ fmask,
                    const T* __restrict__ loss_params, T* __restrict__ chi2,
                    long long F) {
  const long long f = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (f >= F) return;
  T cam[9], X[3], r[2];
  load_rows(cams, pts, ids0, ids1, f, cam, X);
  residual(cam, X, obs + 2 * f, r);
  const T raw = r[0] * r[0] + r[1] * r[1];
  T value, deriv;
  robust<LOSS>(raw, loss_params[f], &value, &deriv);
  chi2[f] = value * mask_value<T>(fmask[f]);
}

// The values a factor writes: r 2, Jc 18, Jp 6, chi2 1, dL 1, diag_c 9,
// diag_p 3.
constexpr int kLinValues = 40;

template <typename T, int LOSS>
__global__ void __launch_bounds__(kThreads)
    linearize_kernel(const T* __restrict__ cams, const T* __restrict__ pts,
                     const long long* __restrict__ ids0,
                     const long long* __restrict__ ids1,
                     const T* __restrict__ obs,
                     const bool* __restrict__ smask,
                     const bool* __restrict__ fmask,
                     const T* __restrict__ loss_params, T* __restrict__ r_out,
                     T* __restrict__ jc_out, T* __restrict__ jp_out,
                     T* __restrict__ chi2, T* __restrict__ dl_out,
                     T* __restrict__ diag_c, T* __restrict__ diag_p,
                     long long F) {
  // one span per output, each kThreads rows of its width
  __shared__ __align__(16) T tile[kThreads * kLinValues];
  T* t_r = tile;
  T* t_jc = t_r + 2 * kThreads;
  T* t_jp = t_jc + 18 * kThreads;
  T* t_chi2 = t_jp + 6 * kThreads;
  T* t_dl = t_chi2 + kThreads;
  T* t_dc = t_dl + kThreads;
  T* t_dp = t_dc + 9 * kThreads;
  const long long f0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nf = static_cast<int>(F - f0 < kThreads ? F - f0 : kThreads);
  const int i = threadIdx.x;
  if (i < nf) {
    const long long f = f0 + i;
    T cam[9], X[3], r[2], Jc[18], Jp[6];
    load_rows(cams, pts, ids0, ids1, f, cam, X);
    residual(cam, X, obs + 2 * f, r);
    jacobian(cam, X, Jc, Jp);
    const T m0 = mask_value<T>(smask[2 * f]);
    const T m1 = mask_value<T>(smask[2 * f + 1]);
#pragma unroll
    for (int k = 0; k < 18; ++k) Jc[k] = Jc[k] * m0;
#pragma unroll
    for (int k = 0; k < 6; ++k) Jp[k] = Jp[k] * m1;
    const T raw = r[0] * r[0] + r[1] * r[1];
    T value, dL;
    robust<LOSS>(raw, loss_params[f], &value, &dL);

    t_r[2 * i] = r[0];
    t_r[2 * i + 1] = r[1];
#pragma unroll
    for (int k = 0; k < 18; ++k) t_jc[18 * i + k] = Jc[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) t_jp[6 * i + k] = Jp[k];
    t_chi2[i] = value * mask_value<T>(fmask[f]);
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
  // rows [f0, f0 + nf) of each output: f0 * width values in, a multiple of
  // 128 (f0 is one of 128), so every span starts 16-byte aligned
  store_span<kThreads>(r_out + 2 * f0, t_r, 2 * nf);
  store_span<kThreads>(jc_out + 18 * f0, t_jc, 18 * nf);
  store_span<kThreads>(jp_out + 6 * f0, t_jp, 6 * nf);
  store_span<kThreads>(chi2 + f0, t_chi2, nf);
  store_span<kThreads>(dl_out + f0, t_dl, nf);
  store_span<kThreads>(diag_c + 9 * f0, t_dc, 9 * nf);
  store_span<kThreads>(diag_p + 3 * f0, t_dp, 3 * nf);
}

// bal_scale_b: a CTA owns a tile of scale_tile<T>() consecutive factors. It
// stages the tile's Jc, Jp, r and dL rows in shared memory, each one
// contiguous range (16-byte cp.async copies), while each thread reads its
// factor's rows0 / rows1 once and gathers the factor's camera (9) and point
// (3) scale rows into registers. Thread i then forms factor i's stored J
// (each entry scaled by its column's scale and cast to storage) into a
// shared output tile and b's rows from the stored (rounded) values, widened
// to T: b[c] = -(Js[0, c] (r0 dL) + Js[1, c] (r1 dL)). The CTA copies each
// output span out in 16-byte stores (a tile of bf16 Jc rows is 128 x 36
// contiguous bytes). Each input is read once, with no 64-bit division.
template <typename T>
__host__ __device__ constexpr int scale_tile() {
  return sizeof(T) == 8 ? 64 : 128;  // 32 KB of tiles either way
}

template <typename T, typename S, int D>
__device__ __forceinline__ void scale_b_slot(const T* __restrict__ J,
                                             const T* scale, bool scaled,
                                             T w0, T w1, S* __restrict__ out,
                                             T* __restrict__ b) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    T x0 = J[c], x1 = J[D + c];
    if (scaled) {
      x0 = x0 * scale[c];
      x1 = x1 * scale[c];
    }
    const S a0 = Storage<S>::store(x0), a1 = Storage<S>::store(x1);
    out[c] = a0;
    out[D + c] = a1;
    b[c] = -(static_cast<T>(Storage<S>::load(a0)) * w0 +
             static_cast<T>(Storage<S>::load(a1)) * w1);
  }
}

// sc, sp: the padded (n_rows + 1, d) scale rows of the two slots, or both
// null when the Jacobians are not scaled (Graph.scale_system(False)).
template <typename T, typename S>
__global__ void __launch_bounds__(scale_tile<T>())
    scale_b_kernel(const T* __restrict__ jc, const T* __restrict__ jp,
                   const T* __restrict__ r, const T* __restrict__ dl,
                   const T* __restrict__ sc, const T* __restrict__ sp,
                   const long long* __restrict__ rows0,
                   const long long* __restrict__ rows1,
                   S* __restrict__ jc_out, S* __restrict__ jp_out,
                   T* __restrict__ b_c, T* __restrict__ b_p, long long F) {
  constexpr int kTile = scale_tile<T>();
  // the staged inputs: Jc 18, Jp 6, r 2 and dL 1 values a factor
  __shared__ __align__(16) T t_in[kTile * 27];
  // the outputs: the stored Jc 18 and Jp 6 (S), b's rows 9 and 3 (T)
  __shared__ __align__(16) unsigned char t_j[kTile * 24 * sizeof(S)];
  __shared__ __align__(16) T t_b[kTile * 12];
  T* t_jc = t_in;
  T* t_jp = t_jc + 18 * kTile;
  T* t_r = t_jp + 6 * kTile;
  T* t_dl = t_r + 2 * kTile;
  S* o_jc = reinterpret_cast<S*>(t_j);
  S* o_jp = o_jc + 18 * kTile;
  T* o_bc = t_b;
  T* o_bp = t_b + 9 * kTile;
  const long long f0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nf = static_cast<int>(F - f0 < kTile ? F - f0 : kTile);
  // rows [f0, f0 + nf) of each input: f0 * width values in, a multiple of
  // 64, so every span starts 16-byte aligned
  stage_span<kTile>(t_jc, jc + 18 * f0, 18 * nf);
  stage_span<kTile>(t_jp, jp + 6 * f0, 6 * nf);
  stage_span<kTile>(t_r, r + 2 * f0, 2 * nf);
  stage_span<kTile>(t_dl, dl + f0, nf);
  cp_async_commit();
  const int i = threadIdx.x;
  const bool scaled = sc != nullptr;
  T scale[12];  // the camera's 9 column scales, then the point's 3
  if (scaled && i < nf) {
    const T* c = sc + rows0[f0 + i] * 9;
    const T* p = sp + rows1[f0 + i] * 3;
#pragma unroll
    for (int k = 0; k < 9; ++k) scale[k] = c[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) scale[9 + k] = p[k];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (i < nf) {
    const T dL = t_dl[i];
    const T w0 = t_r[2 * i] * dL, w1 = t_r[2 * i + 1] * dL;
    scale_b_slot<T, S, 9>(t_jc + 18 * i, scale, scaled, w0, w1,
                          o_jc + 18 * i, o_bc + 9 * i);
    scale_b_slot<T, S, 3>(t_jp + 6 * i, scale + 9, scaled, w0, w1,
                          o_jp + 6 * i, o_bp + 3 * i);
  }
  __syncthreads();
  // the output tiles' rows [f0, f0 + nf): 16-byte aligned as above (a
  // bf16 or fp16 Jc tile starts at 36 f0 bytes, f0 a multiple of 64)
  store_span<kTile>(jc_out + 18 * f0, o_jc, 18 * nf);
  store_span<kTile>(jp_out + 6 * f0, o_jp, 6 * nf);
  store_span<kTile>(b_c + 9 * f0, o_bc, 9 * nf);
  store_span<kTile>(b_p + 3 * f0, o_bp, 3 * nf);
}

// ---- bal_hessian_sum ------------------------------------------------------

constexpr int kSumThreads = 256;    // most threads of a group-1 CTA
constexpr int kSumSteps = 8;        // outputs a group-1 thread sums
constexpr int kStageBytes = 16384;  // J / dL bytes a group-1 pass stages
constexpr int kLaneThreads = 512;   // most threads of a lane CTA (K1's)
constexpr int kLaneMinThreads = 256;  // short segments share a CTA up to this
constexpr int kLaneMaxSpc = kLaneMinThreads / 9 + 1;  // segments a CTA

// One slot pair's products. A factor's block is (DS, DT) row-major, or its
// transpose (DT, DS) when TRANS (a trans_idx site: element (k, i) of the
// transposed row). SAME: s == t, so Jt is Js. A staged row holds Js (2 DS
// values), Jt (2 DT, unless SAME) and dL, widened from storage to T. An
// entry is formed in T and rounded to the output type O.
template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS>
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
  static __device__ __forceinline__ T widen(S x) {
    return static_cast<T>(Storage<S>::load(x));
  }
  // value w of the staged row of value row v
  static __device__ __forceinline__ T load(const S* __restrict__ js,
                                           const S* __restrict__ jt,
                                           const T* __restrict__ dl,
                                           long long v, int w) {
    if (w < WS) return widen(js[v * WS + w]);
    if (w < WS + WT) return widen(jt[v * (2 * DT) + (w - WS)]);
    return dl[v];
  }
  // (Js[0, i] Jt[0, k] + Js[1, i] Jt[1, k]) dL, each operation rounded,
  // then rounded to O
  static __device__ __forceinline__ O entry(const T* row, int i, int k) {
    const T* t = row + (SAME ? 0 : WS);
    return static_cast<O>((row[i] * t[k] + row[DS + i] * t[DT + k]) *
                          row[W - 1]);
  }
};

// G = 1: K1's row kernel (segsum.cu, segsum_rows_kernel) with the rows
// staged. A CTA of T = (256 / D) D threads owns SPC = (T / D) kSumSteps
// consecutive segments; thread x keeps column x % D and sums the segments
// x / D + j T / D (j < kSumSteps), each over its rows in row order, so a
// warp's store is 32 consecutive values. The rows of the CTA's segments
// are staged kStageBytes / (W sizeof(T)) at a time: J_s, J_t and dL in
// three arrays, each a contiguous copy where the plan has no permutation.
template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS>
struct RowsShape {
  using P = HPair<T, S, O, DS, DT, SAME, TRANS>;
  static constexpr int kSegsPerStep = kSumThreads / P::D;
  static constexpr int kThreads = kSegsPerStep * P::D;
  static constexpr int kSegs = kSegsPerStep * kSumSteps;
  static constexpr int kRows =
      kStageBytes / (P::W * static_cast<int>(sizeof(T)));
};

template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS>
__global__ void __launch_bounds__(kSumThreads)
    hsum_rows_kernel(const S* __restrict__ js, const S* __restrict__ jt,
                     const T* __restrict__ dl, const int* __restrict__ perm,
                     const int* __restrict__ offsets, O* __restrict__ out,
                     int num_segments, int accumulate) {
  using P = HPair<T, S, O, DS, DT, SAME, TRANS>;
  using R = RowsShape<T, S, O, DS, DT, SAME, TRANS>;
  constexpr int WT = SAME ? P::WS : P::WT;  // J_t values a row
  __shared__ T s_js[R::kRows * P::WS];
  __shared__ T s_jt[SAME ? 1 : R::kRows * P::WT];
  __shared__ T s_dl[R::kRows];
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
  const T* tj = SAME ? s_js : s_jt;
  O acc[kSumSteps];
#pragma unroll
  for (int j = 0; j < kSumSteps; ++j) acc[j] = static_cast<O>(0);
  const int r0 = soff[0], r1 = soff[ns];
  for (int c0 = r0; c0 < r1; c0 += R::kRows) {
    const int nr = r1 - c0 < R::kRows ? r1 - c0 : R::kRows;
    if (perm == nullptr) {
      const S* a = js + static_cast<long long>(c0) * P::WS;
      for (int x = threadIdx.x; x < nr * P::WS; x += R::kThreads) {
        s_js[x] = P::widen(a[x]);
      }
      if (!SAME) {
        const S* b = jt + static_cast<long long>(c0) * P::WT;
        for (int x = threadIdx.x; x < nr * P::WT; x += R::kThreads) {
          s_jt[x] = P::widen(b[x]);
        }
      }
      for (int x = threadIdx.x; x < nr; x += R::kThreads) {
        s_dl[x] = dl[c0 + x];
      }
    } else {
      for (int x = threadIdx.x; x < nr * P::WS; x += R::kThreads) {
        const int rr = x / P::WS;
        const long long v = __ldg(perm + c0 + rr);
        s_js[x] = P::widen(js[v * P::WS + (x - rr * P::WS)]);
      }
      if (!SAME) {
        for (int x = threadIdx.x; x < nr * P::WT; x += R::kThreads) {
          const int rr = x / P::WT;
          const long long v = __ldg(perm + c0 + rr);
          s_jt[x] = P::widen(jt[v * P::WT + (x - rr * P::WT)]);
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
        const T* sa = s_js + r * P::WS;
        const T* sb = tj + r * WT;
        acc[j] = acc[j] + static_cast<O>((sa[i] * sb[k] +
                                          sa[DS + i] * sb[DT + k]) *
                                         s_dl[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kSumSteps; ++j) {
    const int ls = sq + j * R::kSegsPerStep;
    if (ls >= ns) continue;
    O* dst = out + (s0 + ls) * P::D + c;
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
// buffers of spc KR G W values of T, then the lane tree (blockDim.x C
// values of O).
template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS, int L>
__global__ void __launch_bounds__(kLaneThreads)
    hsum_lanes_kernel(const S* __restrict__ js, const S* __restrict__ jt,
                      const T* __restrict__ dl, const int* __restrict__ perm,
                      const int* __restrict__ offsets, O* __restrict__ out,
                      int num_segments, int q_log2, int spc, int accumulate) {
  using P = HPair<T, S, O, DS, DT, SAME, TRANS>;
  constexpr int C = (P::D + 31) / 32;
  constexpr int CT = (P::D + C - 1) / C;
  constexpr int KR = lane_rounds<L>();
  // a (DS, DT) block's columns c + u CT share J_t's column k when CT is a
  // multiple of DT
  constexpr bool kSharedK = !TRANS && CT % DT == 0;
  // staged values per thread and round: spc KR G W / (spc Q CT)
  constexpr int NP = (KR * L * P::W + CT - 1) / CT;
  extern __shared__ __align__(16) unsigned char lane_smem[];
  __shared__ int soff[kLaneMaxSpc + 1];
  T* stage = reinterpret_cast<T*>(lane_smem);
  const int Q = 1 << q_log2;
  const int G = Q * L;
  const int RG = KR * G;  // a segment's rows a round
  const int per_seg = Q * CT;
  const int nthreads = spc * per_seg;
  const int n_stage = spc * RG * P::W;
  O* tree = reinterpret_cast<O*>(stage + 2 * n_stage);
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

  // this thread's share of round rnd's staged values: value x of the
  // stage is value w of the row at sorted position soff[b] + rnd RG + j
  // of segment b (x = (b RG + j) W + w)
  T pre[NP];
  auto fetch = [&](int rnd) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int x = threadIdx.x + p * nthreads;
      pre[p] = static_cast<T>(0);
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
  auto put = [&](T* buf) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int x = threadIdx.x + p * nthreads;
      if (x < n_stage) buf[x] = pre[p];
    }
  };

  O acc[L][C];
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int u = 0; u < C; ++u) acc[j][u] = static_cast<O>(0);
  }
  if (rounds > 0) {
    fetch(0);
    put(stage);
  }
  __syncthreads();
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool more = rnd + 1 < rounds;
    if (more) fetch(rnd + 1);  // in flight while this round is summed
    if (live) {
      const T* cur = stage + (rnd & 1) * n_stage + sub * RG * P::W;
      const int first = soff[sub] + rnd * RG;
      const int left = soff[sub + 1] - first;
      // K1's round k of the KR: lane q + j Q takes its row k G + q + j Q
#pragma unroll
      for (int k = 0; k < KR; ++k) {
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const int jj = k * G + q + j * Q;
          if (jj >= left) continue;
          const T* row = cur + jj * P::W;
          if constexpr (kSharedK) {
            // one J_t column for the thread's C columns: its two values
            // and dL read once
            const T* tr = row + (SAME ? 0 : P::WS);
            const T b0 = tr[kk[0]], b1 = tr[DT + kk[0]];
            const T d = row[P::W - 1];
#pragma unroll
            for (int u = 0; u < C; ++u) {
              if (has[u]) {
                acc[j][u] = acc[j][u] + static_cast<O>(
                    (row[ii[u]] * b0 + row[DS + ii[u]] * b1) * d);
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
    if (more) put(stage + ((rnd + 1) & 1) * n_stage);
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
  O* mine = tree + (sub * per_seg + c) * C;
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
    O* dst = out + (s0 + sub) * P::D;
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
  void* out;
  int num_segments, group_log2, accumulate;
  cudaStream_t stream;
};

template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS, int L>
cudaError_t launch_hsum_lanes(const HSumArgs& a, int q_log2, int spc) {
  using P = HPair<T, S, O, DS, DT, SAME, TRANS>;
  constexpr int C = (P::D + 31) / 32;
  constexpr int CT = (P::D + C - 1) / C;
  const int threads = spc * (CT << q_log2);
  const size_t smem =
      sizeof(T) * 2 * static_cast<size_t>(spc) * lane_rounds<L>() *
          (L << q_log2) * P::W +
      sizeof(O) * static_cast<size_t>(threads) * C;
  auto kernel = hsum_lanes_kernel<T, S, O, DS, DT, SAME, TRANS, L>;
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
      static_cast<const T*>(a.dl), a.perm, a.offsets,
      static_cast<O*>(a.out), a.num_segments, q_log2, spc, a.accumulate);
  return cudaGetLastError();
}

template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS>
cudaError_t launch_hsum(const HSumArgs& a) {
  using P = HPair<T, S, O, DS, DT, SAME, TRANS>;
  if (a.group_log2 == 0) {
    using R = RowsShape<T, S, O, DS, DT, SAME, TRANS>;
    hsum_rows_kernel<T, S, O, DS, DT, SAME, TRANS>
        <<<static_cast<unsigned>((a.num_segments + R::kSegs - 1) / R::kSegs),
           R::kThreads, 0, a.stream>>>(
            static_cast<const S*>(a.js), static_cast<const S*>(a.jt),
            static_cast<const T*>(a.dl), a.perm, a.offsets,
            static_cast<O*>(a.out), a.num_segments, a.accumulate);
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
    case 0:
      return launch_hsum_lanes<T, S, O, DS, DT, SAME, TRANS, 1>(a, q_log2,
                                                                spc);
    case 1:
      return launch_hsum_lanes<T, S, O, DS, DT, SAME, TRANS, 2>(a, q_log2,
                                                                spc);
    case 2:
      return launch_hsum_lanes<T, S, O, DS, DT, SAME, TRANS, 4>(a, q_log2,
                                                                spc);
    case 3:
      return launch_hsum_lanes<T, S, O, DS, DT, SAME, TRANS, 8>(a, q_log2,
                                                                spc);
    case 4:
      return launch_hsum_lanes<T, S, O, DS, DT, SAME, TRANS, 16>(a, q_log2,
                                                                 spc);
    default: return cudaErrorInvalidValue;
  }
}

// pair: the index of (s, t) in (0, 0), (0, 1), (1, 1) (bal.py, PAIRS);
// transposed: the site's blocks are (t, s) (only (0, 1) has such sites)
template <typename T, typename S, typename O>
int run_hessian_sum(const void* jc, const void* jp, const void* dl,
                const void* perm, const void* offsets, void* out,
                int num_segments, int pair, int transposed, int group_log2,
                int accumulate, void* stream) {
  if (num_segments < 0 || group_log2 < 0 || group_log2 > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments == 0) return 0;
  HSumArgs a{jc, jc, dl, static_cast<const int*>(perm),
             static_cast<const int*>(offsets), out, num_segments, group_log2,
             accumulate, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (pair * 2 + (transposed ? 1 : 0)) {
    case 0: err = launch_hsum<T, S, O, 9, 9, true, false>(a); break;
    case 2:
      a.jt = jp;
      err = launch_hsum<T, S, O, 9, 3, false, false>(a);
      break;
    case 3:
      a.jt = jp;
      err = launch_hsum<T, S, O, 9, 3, false, true>(a);
      break;
    case 4:
      a.js = a.jt = jp;
      err = launch_hsum<T, S, O, 3, 3, true, false>(a);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

template <typename T>
int run_residual(const void* cams, const void* pts, const void* ids0,
             const void* ids1, const void* obs, const void* fmask,
             const void* loss_params, void* chi2, long long F, int loss,
             void* stream) {
  if (F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  auto kernel = residual_kernel<T, kDefault>;
  switch (loss) {
    case kDefault: break;
    case kHuber: kernel = residual_kernel<T, kHuber>; break;
    case kCauchy: kernel = residual_kernel<T, kCauchy>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks_for(F, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cams), static_cast<const T*>(pts),
      static_cast<const long long*>(ids0),
      static_cast<const long long*>(ids1), static_cast<const T*>(obs),
      static_cast<const bool*>(fmask), static_cast<const T*>(loss_params),
      static_cast<T*>(chi2), F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_linearize(const void* cams, const void* pts, const void* ids0,
              const void* ids1, const void* obs, const void* smask,
              const void* fmask, const void* loss_params, void* r, void* jc,
              void* jp, void* chi2, void* dl, void* diag_c, void* diag_p,
              long long F, int loss, void* stream) {
  if (F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return 0;
  // the tile goes out in 16-byte stores
  const void* outs[] = {r, jc, jp, chi2, dl, diag_c, diag_p};
  for (const void* p : outs) {
    if (reinterpret_cast<unsigned long long>(p) & 15) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  auto kernel = linearize_kernel<T, kDefault>;
  switch (loss) {
    case kDefault: break;
    case kHuber: kernel = linearize_kernel<T, kHuber>; break;
    case kCauchy: kernel = linearize_kernel<T, kCauchy>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks_for(F, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cams), static_cast<const T*>(pts),
      static_cast<const long long*>(ids0),
      static_cast<const long long*>(ids1), static_cast<const T*>(obs),
      static_cast<const bool*>(smask), static_cast<const bool*>(fmask),
      static_cast<const T*>(loss_params), static_cast<T*>(r),
      static_cast<T*>(jc), static_cast<T*>(jp), static_cast<T*>(chi2),
      static_cast<T*>(dl), static_cast<T*>(diag_c), static_cast<T*>(diag_p),
      F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int run_scale_b(const void* jc, const void* jp, const void* r, const void* dl,
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
  constexpr int kTile = scale_tile<T>();
  scale_b_kernel<T, S><<<blocks_for(F, kTile), kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(jc), static_cast<const T*>(jp),
      static_cast<const T*>(r), static_cast<const T*>(dl),
      static_cast<const T*>(sc), static_cast<const T*>(sp),
      static_cast<const long long*>(rows0),
      static_cast<const long long*>(rows1), static_cast<S*>(jc_out),
      static_cast<S*>(jp_out), static_cast<T*>(b_c), static_cast<T*>(b_p),
      F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entries. An entry without a suffix takes a float32 graph, one
// ending _f64 a float64 graph (T = double); scale_b and hessian_sum then
// name the storage type S of the stored J.

// cams (Nc, 9), pts (Np, 3), obs (F, 2), loss_params (F,): T; ids0, ids1
// (F,) int64; fmask (F,) bool; chi2 (F,) T out. loss: 0 default, 1 Huber,
// 2 Cauchy. Launches on `stream` and returns the cudaGetLastError() code
// (0 on success).
#define GT_BAL_RESIDUAL(NAME, T)                                            \
  extern "C" int NAME(const void* cams, const void* pts, const void* ids0, \
                      const void* ids1, const void* obs, const void* fmask, \
                      const void* loss_params, void* chi2, long long F,    \
                      int loss, void* stream) {                            \
    return run_residual<T>(cams, pts, ids0, ids1, obs, fmask, loss_params,     \
                       chi2, F, loss, stream);                             \
  }
GT_BAL_RESIDUAL(gt_bal_residual, float)
GT_BAL_RESIDUAL(gt_bal_residual_f64, double)

// The same inputs and smask (F, 2) bool; out: r (F, 2), jc (F, 18), jp
// (F, 6), chi2 (F,), dl (F,), diag_c (F, 9), diag_p (F, 3), all T and
// 16-byte aligned.
#define GT_BAL_LINEARIZE(NAME, T)                                           \
  extern "C" int NAME(const void* cams, const void* pts, const void* ids0, \
                      const void* ids1, const void* obs, const void* smask, \
                      const void* fmask, const void* loss_params, void* r,  \
                      void* jc, void* jp, void* chi2, void* dl,            \
                      void* diag_c, void* diag_p, long long F, int loss,   \
                      void* stream) {                                      \
    return run_linearize<T>(cams, pts, ids0, ids1, obs, smask, fmask,          \
                        loss_params, r, jc, jp, chi2, dl, diag_c, diag_p,  \
                        F, loss, stream);                                  \
  }
GT_BAL_LINEARIZE(gt_bal_linearize, float)
GT_BAL_LINEARIZE(gt_bal_linearize_f64, double)

// jc (F, 18), jp (F, 6), r (F, 2), dl (F,): T; sc (n0 + 1, 9), sp
// (n1 + 1, 3) T scale rows, both null for no scaling; rows0, rows1 (F,)
// int64. Out: jc_out, jp_out in the storage type S, b_c (F, 9), b_p
// (F, 3) T. jc, jp, r, dl and the outputs 16-byte aligned.
#define GT_BAL_SCALE_B(NAME, T, S)                                          \
  extern "C" int NAME(const void* jc, const void* jp, const void* r,       \
                      const void* dl, const void* sc, const void* sp,      \
                      const void* rows0, const void* rows1, void* jc_out,  \
                      void* jp_out, void* b_c, void* b_p, long long F,     \
                      void* stream) {                                      \
    return run_scale_b<T, S>(jc, jp, r, dl, sc, sp, rows0, rows1, jc_out,      \
                         jp_out, b_c, b_p, F, stream);                     \
  }
GT_BAL_SCALE_B(gt_bal_scale_b_f32, float, float)
GT_BAL_SCALE_B(gt_bal_scale_b_bf16, float, __nv_bfloat16)
GT_BAL_SCALE_B(gt_bal_scale_b_f16, float, __half)
GT_BAL_SCALE_B(gt_bal_scale_b_f64_f64, double, double)
GT_BAL_SCALE_B(gt_bal_scale_b_f64_f32, double, float)
GT_BAL_SCALE_B(gt_bal_scale_b_f64_bf16, double, __nv_bfloat16)
GT_BAL_SCALE_B(gt_bal_scale_b_f64_f16, double, __half)

// jc (F, 18), jp (F, 6) in the storage type S, dl (F,) T; perm (K,)
// int32 or null and offsets (num_segments + 1,) int32: the site's K1 plan
// (K = F rows), 2^group_log2 lanes per segment; out (num_segments, D) in
// the Hessian values' type O (float in a float32 graph; in a float64
// graph float where S is float, as FP64_FP32's inv_dtype, else double),
// D = 81, 27 (pair 1; its transpose when transposed) or 9. With
// accumulate 0 the sums are stored, else added to out. Launches on
// `stream` and returns the cudaGetLastError() code (0 on success).
#define GT_BAL_HESSIAN_SUM(NAME, T, S, O)                                   \
  extern "C" int NAME(const void* jc, const void* jp, const void* dl,      \
                      const void* perm, const void* offsets, void* out,    \
                      int num_segments, int pair, int transposed,          \
                      int group_log2, int accumulate, void* stream) {      \
    return run_hessian_sum<T, S, O>(jc, jp, dl, perm, offsets, out,            \
                                num_segments, pair, transposed,            \
                                group_log2, accumulate, stream);           \
  }
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_f32, float, float, float)
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_bf16, float, __nv_bfloat16, float)
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_f16, float, __half, float)
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_f64_f64, double, double, double)
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_f64_f32, double, float, float)
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_f64_bf16, double, __nv_bfloat16,
                   double)
GT_BAL_HESSIAN_SUM(gt_bal_hessian_sum_f64_f16, double, __half, double)

extern "C" const char* gt_bal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
