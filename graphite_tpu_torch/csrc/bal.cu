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
// A symmetric site (s == t: Hpp, Hll) forms only its distinct entries, i
// <= k (45 of 81, 6 of 9), and stores each to (i, k) and (k, i): the two
// are the same products with their factors swapped, so the same bits at
// every step (Block). Each lane's entries stay in one thread's registers.
// - G = 1 (the destination-sorted point sites, ~1-5 rows a block): one
//   thread a block. A CTA owns 128 consecutive blocks (fewer for 81-wide
//   ones), stages their rows' J_s, J_t and dL in shared memory with
//   cp.async (bf16 / fp16 J widened through registers instead; three
//   contiguous copies where the plan has no permutation;
//   32 KB a pass, one or two a CTA at Venice), and each thread
//   sums its block's rows in row order; the blocks go out through a shared
//   tile in 16-byte stores.
// - G > 1 (the camera sites: ~2,800 rows a block through the permutation):
//   lane l of a segment is one thread's for the whole segment. It reads its
//   rows l, l + G, ... straight from device memory through the plan in
//   vector loads (a float32 camera row in six), the next row in flight
//   while one is summed, with no shared staging and no barrier a round;
//   then K1's halving tree, by warp shuffles below 32 lanes (through shared
//   memory above), and the blocks out through a shared tile.
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

#include <type_traits>

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

constexpr int kLaneCta = 128;   // threads of a lane CTA below 256 lanes
constexpr int kRowsCta = 128;   // most blocks (one thread each) of a rows CTA
constexpr int kRowsStageBytes = 32768;  // J / dL bytes a rows pass stages

// What a launch computes: the sums (kWhole), or, for kernel_sweep's split
// of a site's time, the same kernel with its loads alone (kLoadsOnly: each
// row's values added up, no product) or its products alone
// (kProductsOnly: values made from the row's position, nothing loaded).
// Only the sweep's entry (gt_bal_hessian_sum_probe*) launches the last two.
enum HSumMode { kWhole = 0, kLoadsOnly = 1, kProductsOnly = 2 };

// One slot pair's block. A factor's product is (DS, DT) row-major, or its
// transpose (DT, DS) when TRANS (a trans_idx site). SAME: s == t, so J_t
// is J_s and the block is symmetric: entry (i, k) is (Js[0, i] Js[0, k] +
// Js[1, i] Js[1, k]) dL and (k, i) the same two products with their
// factors swapped, which IEEE multiplication rounds to the same bits; so
// (k, i)'s lane sums and tree are the same operations on the same values
// as (i, k)'s. Only i <= k is formed (E of the D entries: 45 of 81, 6 of
// 9) and stored to both places.
template <int DS, int DT, bool SAME, bool TRANS>
struct Block {
  static constexpr int D = DS * DT;
  static constexpr int E = SAME ? DS * (DS + 1) / 2 : D;
  // where entry (i, k) goes in the output block
  static __host__ __device__ constexpr int at(int i, int k) {
    return TRANS ? k * DS + i : i * DT + k;
  }
};

template <typename S, typename T>
__device__ __forceinline__ T widen(S x) {
  return static_cast<T>(Storage<S>::load(x));
}

// Adds one row's entries to a lane's sums acc[0, E): entry (i, k), i <= k
// when SAME, in row-major order, is (x[i] y[k] + x[DS + i] y[DT + k]) d in
// T, rounded to O: J_s's two rows in x, J_t's in y (x itself when SAME).
template <typename T, typename O, int DS, int DT, bool SAME>
__device__ __forceinline__ void add_products(const T* x, const T* y, T d,
                                             O* acc) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
#pragma unroll
    for (int k = SAME ? i : 0; k < DT; ++k, ++e) {
      acc[e] = acc[e] + static_cast<O>((x[i] * y[k] + x[DS + i] * y[DT + k]) *
                                       d);
    }
  }
}

// The E sums of one block into its D places of a shared tile: (i, k), and
// (k, i) too when SAME.
template <typename O, int DS, int DT, bool SAME, bool TRANS>
__device__ __forceinline__ void put_block(const O* acc, O* tile) {
  using B = Block<DS, DT, SAME, TRANS>;
  int e = 0;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
#pragma unroll
    for (int k = SAME ? i : 0; k < DT; ++k, ++e) {
      tile[B::at(i, k)] = acc[e];
      if (SAME && k != i) tile[B::at(k, i)] = acc[e];
    }
  }
}

template <typename S>
__device__ S from_bits(unsigned short b);
template <>
__device__ __forceinline__ __half from_bits<__half>(unsigned short b) {
  return __ushort_as_half(b);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(
    unsigned short b) {
  return __ushort_as_bfloat16(b);
}

// Row v of an (n, N) array of S, loaded into registers by one thread, from
// an array that starts 16-byte aligned (run_hessian_sum checks it), in the
// fewest loads the rows' alignment allows, so that a warp's gather of 32
// scattered rows costs few load instructions: float64 rows (16 N bytes)
// in 16-byte loads, float32 rows of 6 (24 bytes) in 8-byte ones, bf16 /
// fp16 rows in 4-byte pairs, and a float32 row of 18 (72 bytes, 8-byte
// aligned) in four 16-byte loads and one or two 8-byte ones from the
// 16-byte boundary at or below it (RowLoad<float, 18>). get(i) is value i.
template <typename S, int N>
struct RowLoad;

template <int N>
struct RowLoad<double, N> {
  double2 x[N / 2];
  __device__ __forceinline__ void load(const double* __restrict__ a,
                                       long long v) {
    const double2* p = reinterpret_cast<const double2*>(a + v * N);
#pragma unroll
    for (int c = 0; c < N / 2; ++c) x[c] = __ldg(p + c);
  }
  __device__ __forceinline__ double get(int i) const {
    return (i & 1) ? x[i >> 1].y : x[i >> 1].x;
  }
};

template <int N>
struct RowLoad<float, N> {
  float2 x[N / 2];
  __device__ __forceinline__ void load(const float* __restrict__ a,
                                       long long v) {
    const float2* p = reinterpret_cast<const float2*>(a + v * N);
#pragma unroll
    for (int c = 0; c < N / 2; ++c) x[c] = __ldg(p + c);
  }
  __device__ __forceinline__ float get(int i) const {
    return (i & 1) ? x[i >> 1].y : x[i >> 1].x;
  }
};

// A row of 18 floats starts at 72 v bytes: 16-byte aligned for an even v,
// 8 past a boundary for an odd one. The 4-byte words [0, 20) from that
// boundary hold it at word 0 or 2: four 16-byte loads, the 8 bytes of
// words 16-17, and those of words 18-19 for an odd v only, so nothing
// outside the row's own 16-byte pieces is read.
template <>
struct RowLoad<float, 18> {
  float4 q[4];
  float2 t0, t1;
  bool odd;
  __device__ __forceinline__ void load(const float* __restrict__ a,
                                       long long v) {
    odd = (v & 1) != 0;
    const float4* p = reinterpret_cast<const float4*>(a + 18 * v -
                                                      (odd ? 2 : 0));
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = __ldg(p + c);
    const float2* t = reinterpret_cast<const float2*>(p + 4);
    t0 = __ldg(t);
    t1 = odd ? __ldg(t + 1) : make_float2(0.0f, 0.0f);
  }
  __device__ __forceinline__ float word(int j) const {
    if (j >= 16) {
      return j == 16 ? t0.x : j == 17 ? t0.y : j == 18 ? t1.x : t1.y;
    }
    const float4& c = q[j >> 2];
    return (j & 3) == 0 ? c.x : (j & 3) == 1 ? c.y : (j & 3) == 2 ? c.z : c.w;
  }
  __device__ __forceinline__ float get(int i) const {
    return odd ? word(i + 2) : word(i);
  }
};

// bf16 / fp16 rows of an even N (2 N bytes, 4-byte aligned): N / 2 pairs
template <typename S, int N>
struct PairRow {
  unsigned x[N / 2];
  __device__ __forceinline__ void load(const S* __restrict__ a, long long v) {
    const unsigned* p = reinterpret_cast<const unsigned*>(a + v * N);
#pragma unroll
    for (int c = 0; c < N / 2; ++c) x[c] = __ldg(p + c);
  }
  __device__ __forceinline__ S get(int i) const {
    const unsigned w = x[i >> 1];
    return from_bits<S>(static_cast<unsigned short>((i & 1) ? w >> 16
                                                            : w & 0xffffu));
  }
};
template <int N>
struct RowLoad<__half, N> : PairRow<__half, N> {};
template <int N>
struct RowLoad<__nv_bfloat16, N> : PairRow<__nv_bfloat16, N> {};

// One factor's row of a site in registers: J_s (2 DS values of S), J_t (2
// DT, not loaded when SAME) and dL (T).
template <typename T, typename S, int DS, int DT, bool SAME>
struct SiteRow {
  RowLoad<S, 2 * DS> a;
  RowLoad<S, 2 * DT> b;
  T d;
  __device__ __forceinline__ void load(const S* __restrict__ js,
                                       const S* __restrict__ jt,
                                       const T* __restrict__ dl,
                                       long long v) {
    a.load(js, v);
    if (!SAME) b.load(jt, v);
    d = __ldg(dl + v);
  }
  // adds the row's entries (kWhole), or its values (kLoadsOnly), to acc
  template <typename O, int MODE>
  __device__ __forceinline__ void add(O* acc) const {
    T x[2 * DS], y[SAME ? 1 : 2 * DT];
#pragma unroll
    for (int i = 0; i < 2 * DS; ++i) x[i] = widen<S, T>(a.get(i));
    if (!SAME) {
#pragma unroll
      for (int i = 0; i < 2 * DT; ++i) y[i] = widen<S, T>(b.get(i));
    }
    if (MODE == kLoadsOnly) {
      T sum = d;
#pragma unroll
      for (int i = 0; i < 2 * DS; ++i) sum = sum + x[i];
      if (!SAME) {
#pragma unroll
        for (int i = 0; i < 2 * DT; ++i) sum = sum + y[i];
      }
      acc[0] = acc[0] + static_cast<O>(sum);
      return;
    }
    add_products<T, O, DS, DT, SAME>(x, SAME ? x : y, d, acc);
  }
};

// kProductsOnly's row: values made from the row's position p
template <typename T, typename O, int DS, int DT, bool SAME>
__device__ __forceinline__ void add_made_row(int p, O* acc) {
  T x[2 * DS], y[2 * DT];
#pragma unroll
  for (int i = 0; i < 2 * DS; ++i) x[i] = static_cast<T>(p + i);
#pragma unroll
  for (int i = 0; i < 2 * DT; ++i) y[i] = static_cast<T>(p - i);
  add_products<T, O, DS, DT, SAME>(x, SAME ? x : y, static_cast<T>(1), acc);
}

// G > 1 (the camera sites: ~2,800 rows a block through the permutation).
// Each lane of a segment is one thread's for the whole segment: thread l of
// segment s sums its sorted rows l, l + G, ... from +0.0, each read
// straight from device memory through the plan (the next row's loads and
// the row after's index in flight while a row is summed), into its E
// distinct entries, held in registers: no shared staging, no barrier a
// round. A CTA of max(G, 128) threads holds max(1, 128 / G) segments,
// consecutive, so a warp holds whole segments or 32 lanes of one. Then
// K1's halving tree, lane q += lane q + h for h = G/2, ..., 1: through
// shared memory while h >= 32 (a barrier a level), then in the warp by
// __shfl_down_sync. Lane 0 puts the block, mirrored when SAME, into a
// shared tile, and the CTA stores its segments' blocks, one contiguous
// range, value by value. Dynamic shared memory: the tile (segments x D
// values of O), or for G >= 64 the tree's (threads / 2) E values if more.
template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS, int MODE>
__global__ void __launch_bounds__(256)
    hsum_lanes_kernel(const S* __restrict__ js, const S* __restrict__ jt,
                      const T* __restrict__ dl, const int* __restrict__ perm,
                      const int* __restrict__ offsets, O* __restrict__ out,
                      int num_segments, int g_log2, int accumulate) {
  using B = Block<DS, DT, SAME, TRANS>;
  using Row = SiteRow<T, S, DS, DT, SAME>;
  extern __shared__ __align__(16) unsigned char lane_smem[];
  O* shared = reinterpret_cast<O*>(lane_smem);
  const int G = 1 << g_log2;
  const int spc = blockDim.x >> g_log2;
  const int sub = threadIdx.x >> g_log2;
  const int l = threadIdx.x & (G - 1);
  const long long s0 = static_cast<long long>(blockIdx.x) * spc;
  const long long s = s0 + sub;
  int pos = 0, end = 0;
  if (s < num_segments) {
    pos = offsets[s] + l;
    end = offsets[s + 1];
  }
  O acc[B::E];
#pragma unroll
  for (int e = 0; e < B::E; ++e) acc[e] = static_cast<O>(0);
  auto index = [&](int p) -> long long {
    if (MODE == kProductsOnly || perm == nullptr) return p;
    return __ldg(perm + p);
  };
  Row next;
  if (MODE != kProductsOnly && pos < end) next.load(js, jt, dl, index(pos));
  long long ahead = pos + G < end ? index(pos + G) : 0;
  while (pos < end) {
    const int p1 = pos + G;
    if (MODE == kProductsOnly) {
      add_made_row<T, O, DS, DT, SAME>(pos, acc);
    } else {
      const Row cur = next;
      if (p1 < end) next.load(js, jt, dl, ahead);
      if (p1 + G < end) ahead = index(p1 + G);
      cur.template add<O, MODE>(acc);
    }
    pos = p1;
  }

  const int half = blockDim.x >> 1;
  for (int h = G >> 1; h >= 32; h >>= 1) {
    O* red = shared + sub * (G >> 1);
    if (l >= h && l < 2 * h) {
#pragma unroll
      for (int e = 0; e < B::E; ++e) red[e * half + l - h] = acc[e];
    }
    __syncthreads();
    if (l < h) {
#pragma unroll
      for (int e = 0; e < B::E; ++e) acc[e] = acc[e] + red[e * half + l];
    }
    __syncthreads();
  }
  for (int h = (G < 32 ? G : 32) >> 1; h >= 1; h >>= 1) {
#pragma unroll
    for (int e = 0; e < B::E; ++e) {
      acc[e] = acc[e] + __shfl_down_sync(0xffffffffu, acc[e], h);
    }
  }
  if (l == 0 && s < num_segments) {
    put_block<O, DS, DT, SAME, TRANS>(acc, shared + sub * B::D);
  }
  __syncthreads();
  const long long left = num_segments - s0;
  const int n = static_cast<int>((left < spc ? left : spc) * B::D);
  O* dst = out + s0 * B::D;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    dst[x] = accumulate ? dst[x] + shared[x] : shared[x];
  }
}

// The two bf16 / fp16 values of the word w, the lower first, widened
// exactly to float.
template <typename E>
__device__ __forceinline__ float2 widen_pair(unsigned w) {
  return make_float2(
      Storage<E>::load(from_bits<E>(static_cast<unsigned short>(w & 0xffffu))),
      Storage<E>::load(from_bits<E>(static_cast<unsigned short>(w >> 16))));
}

// stage_span for the n bf16 / fp16 values at src, widened exactly to V
// (float or double) on their way through registers: each 16-byte piece
// of src between its first and last 16-byte boundary (8 values) in four
// 4-byte loads, value loads before and after. (One 16-byte load instead
// held the float32 graph's fp16 Hll instance to 80 registers with a
// spill, and was slower at Venice's Hpl.) The span starts at an offset m
// (returned) that puts each piece's first value on a 16-byte boundary of
// dst, so it goes out in 16-byte stores (two float4 or four double2); m <
// 16 / sizeof(V), within the 16 bytes RowsShape leaves a span to spare.
template <int kThreads, typename V, typename E>
__device__ __forceinline__ int stage_span_widened(V* dst,
                                                  const E* __restrict__ src,
                                                  int n) {
  constexpr int kPerV = 16 / sizeof(V);
  const int a = static_cast<int>(
      (reinterpret_cast<unsigned long long>(src) / sizeof(E)) & 7);
  const int head = min(n, (8 - a) & 7);
  const int nv = (n - head) / 8;
  const int m = (kPerV - head % kPerV) % kPerV;
  V* d = dst + m;
  for (int x = threadIdx.x; x < nv; x += kThreads) {
    const unsigned* wp = reinterpret_cast<const unsigned*>(src + head) + 4 * x;
    const uint4 w = make_uint4(__ldg(wp), __ldg(wp + 1), __ldg(wp + 2),
                               __ldg(wp + 3));
    const float2 a0 = widen_pair<E>(w.x), a1 = widen_pair<E>(w.y),
                 a2 = widen_pair<E>(w.z), a3 = widen_pair<E>(w.w);
    V* o = d + head + 8 * x;
    if constexpr (sizeof(V) == 4) {
      reinterpret_cast<float4*>(o)[0] = make_float4(a0.x, a0.y, a1.x, a1.y);
      reinterpret_cast<float4*>(o)[1] = make_float4(a2.x, a2.y, a3.x, a3.y);
    } else {
      double2* o2 = reinterpret_cast<double2*>(o);
      o2[0] = make_double2(a0.x, a0.y);
      o2[1] = make_double2(a1.x, a1.y);
      o2[2] = make_double2(a2.x, a2.y);
      o2[3] = make_double2(a3.x, a3.y);
    }
  }
  for (int x = threadIdx.x; x < head; x += kThreads) {
    d[x] = widen<E, V>(src[x]);
  }
  for (int x = head + 8 * nv + threadIdx.x; x < n; x += kThreads) {
    d[x] = widen<E, V>(src[x]);
  }
  return m;
}

// Stages values [c0 W, (c0 + nr) W) of an (n, W) array of E (rows [c0,
// c0 + nr) of the plan's sorted order, gathered through perm if any) into
// the shared span dst of V; returns the offset in elements at which the
// span starts. Float32 and float64 values go by cp.async (V is E), bf16 /
// fp16 ones through registers, widened exactly to V; where the rows are
// contiguous in 16-byte pieces (stage_span, stage_span_widened). The
// caller commits and waits.
template <int kThreads, typename V, typename E>
__device__ __forceinline__ int stage_rows(V* dst, const E* __restrict__ src,
                                          const int* __restrict__ perm,
                                          int c0, int nr, int W) {
  if (perm == nullptr) {
    const E* rows = src + static_cast<long long>(c0) * W;
    if constexpr (sizeof(E) >= 4) {
      return stage_span<kThreads>(dst, rows, nr * W);
    } else {
      return stage_span_widened<kThreads>(dst, rows, nr * W);
    }
  }
  for (int x = threadIdx.x; x < nr * W; x += kThreads) {
    const int rr = x / W;
    const E* a = src + static_cast<long long>(__ldg(perm + c0 + rr)) * W +
                 (x - rr * W);
    if constexpr (sizeof(E) >= 4) {
      cp_async_elem(dst + x, a);
    } else {
      dst[x] = widen<E, V>(*a);
    }
  }
  return 0;
}

// The rows kernel's shape: blocks a CTA (one thread each; the largest
// power of two up to kRowsCta whose tile of D values of O fits the stage)
// and rows a pass (J_s, J_t as V and dL in T, each span with 16 bytes to
// spare for stage_rows' offset). V, the staged J's type: S where
// cp.async copies it (float32, float64), else (bf16, fp16) S widened to
// T, so that the loop over the staged rows is the float32 or float64
// storage's own.
template <typename T, typename S, typename O, int DS, int DT, bool SAME>
struct RowsShape {
  using V = std::conditional_t<(sizeof(S) >= 4), S, T>;
  static constexpr int WS = 2 * DS;
  static constexpr int WT = SAME ? 0 : 2 * DT;
  static constexpr int kTileBytes = DS * DT * static_cast<int>(sizeof(O));
  static constexpr int NB = kTileBytes * kRowsCta + 16 <= kRowsStageBytes
                                ? kRowsCta
                            : kTileBytes * kRowsCta / 2 + 16 <= kRowsStageBytes
                                ? kRowsCta / 2
                                : kRowsCta / 4;
  static constexpr int kRows =
      (kRowsStageBytes - 96) /
      ((WS + WT) * static_cast<int>(sizeof(V)) + static_cast<int>(sizeof(T)));
  static constexpr int kJsBytes = (kRows * WS * sizeof(V) + 16 + 15) / 16 * 16;
  static constexpr int kJtBytes =
      SAME ? 0 : (kRows * WT * sizeof(V) + 16 + 15) / 16 * 16;
};

// G = 1 (the destination-sorted point sites: ~1-5 rows a block). One
// thread a block: a CTA of NB threads owns NB consecutive blocks and
// stages their rows, one contiguous range where the plan has no
// permutation, kRows at a time (16-byte cp.async copies, or bf16 / fp16
// J widened on the way, stage_span_widened; one or two passes a CTA at
// Venice), J_s, J_t and dL in three spans; thread j sums its block's
// staged rows in row order into the block's E distinct entries in
// registers. The blocks go out through a shared tile (the stage's
// memory) in 16-byte stores (value by value when added).
template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS, int MODE>
__global__ void __launch_bounds__(kRowsCta)
    hsum_rows_kernel(const S* __restrict__ js, const S* __restrict__ jt,
                     const T* __restrict__ dl, const int* __restrict__ perm,
                     const int* __restrict__ offsets, O* __restrict__ out,
                     int num_segments, int accumulate) {
  using B = Block<DS, DT, SAME, TRANS>;
  using R = RowsShape<T, S, O, DS, DT, SAME>;
  constexpr int NB = R::NB;
  __shared__ __align__(16) unsigned char stage[kRowsStageBytes];
  __shared__ int soff[NB + 1];
  using V = typename R::V;
  V* s_js = reinterpret_cast<V*>(stage);
  V* s_jt = reinterpret_cast<V*>(stage + R::kJsBytes);
  T* s_dl = reinterpret_cast<T*>(stage + R::kJsBytes + R::kJtBytes);
  const long long b0 = static_cast<long long>(blockIdx.x) * NB;
  const int nb = static_cast<int>(num_segments - b0 < NB ? num_segments - b0
                                                        : NB);
  for (int x = threadIdx.x; x <= nb; x += NB) soff[x] = offsets[b0 + x];
  __syncthreads();
  const int j = threadIdx.x;
  const int mine0 = j < nb ? soff[j] : 0, mine1 = j < nb ? soff[j + 1] : 0;
  O acc[B::E];
#pragma unroll
  for (int e = 0; e < B::E; ++e) acc[e] = static_cast<O>(0);
  const int r1 = soff[nb];
  for (int c0 = soff[0]; c0 < r1; c0 += R::kRows) {
    const int nr = r1 - c0 < R::kRows ? r1 - c0 : R::kRows;
    int ms = 0, mt = 0, md = 0;
    if (MODE != kProductsOnly) {
      ms = stage_rows<NB>(s_js, js, perm, c0, nr, R::WS);
      if (!SAME) mt = stage_rows<NB>(s_jt, jt, perm, c0, nr, R::WT);
      md = stage_rows<NB>(s_dl, dl, perm, c0, nr, 1);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int a = mine0 > c0 ? mine0 : c0;
    const int b = mine1 < c0 + nr ? mine1 : c0 + nr;
    for (int r = a - c0; r < b - c0; ++r) {
      if (MODE == kProductsOnly) {
        add_made_row<T, O, DS, DT, SAME>(c0 + r, acc);
        continue;
      }
      T x[R::WS], y[SAME ? 1 : R::WT];
      const V* ps = s_js + ms + r * R::WS;
#pragma unroll
      for (int i = 0; i < R::WS; ++i) x[i] = widen<V, T>(ps[i]);
      if (!SAME) {
        const V* pt = s_jt + mt + r * R::WT;
#pragma unroll
        for (int i = 0; i < R::WT; ++i) y[i] = widen<V, T>(pt[i]);
      }
      const T d = s_dl[md + r];
      if (MODE == kLoadsOnly) {
        T sum = d;
#pragma unroll
        for (int i = 0; i < R::WS; ++i) sum = sum + x[i];
        if (!SAME) {
#pragma unroll
          for (int i = 0; i < R::WT; ++i) sum = sum + y[i];
        }
        acc[0] = acc[0] + static_cast<O>(sum);
        continue;
      }
      add_products<T, O, DS, DT, SAME>(x, SAME ? x : y, d, acc);
    }
    __syncthreads();
  }
  // the tile at the output's offset from a 16-byte boundary (store_span)
  O* dst = out + b0 * B::D;
  const int m = static_cast<int>(
      (reinterpret_cast<unsigned long long>(dst) / sizeof(O)) &
      (16 / sizeof(O) - 1));
  O* tile = reinterpret_cast<O*>(stage) + m;
  if (j < nb) put_block<O, DS, DT, SAME, TRANS>(acc, tile + j * B::D);
  __syncthreads();
  if (accumulate) {
    for (int x = threadIdx.x; x < nb * B::D; x += NB) {
      dst[x] = dst[x] + tile[x];
    }
  } else {
    store_span<NB>(dst, tile, nb * B::D);
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
          bool TRANS, int MODE>
cudaError_t launch_hsum_rows(const HSumArgs& a) {
  constexpr int NB = RowsShape<T, S, O, DS, DT, SAME>::NB;
  hsum_rows_kernel<T, S, O, DS, DT, SAME, TRANS, MODE>
      <<<static_cast<unsigned>((a.num_segments + NB - 1) / NB), NB, 0,
         a.stream>>>(static_cast<const S*>(a.js), static_cast<const S*>(a.jt),
                     static_cast<const T*>(a.dl), a.perm, a.offsets,
                     static_cast<O*>(a.out), a.num_segments, a.accumulate);
  return cudaGetLastError();
}

template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS, int MODE>
cudaError_t launch_hsum_lanes(const HSumArgs& a) {
  using B = Block<DS, DT, SAME, TRANS>;
  const int G = 1 << a.group_log2;
  const int threads = G > kLaneCta ? G : kLaneCta;
  const int spc = threads / G;
  size_t smem = sizeof(O) * static_cast<size_t>(spc) * B::D;
  if (G >= 64) {
    const size_t tree = sizeof(O) * static_cast<size_t>(threads / 2) * B::E;
    smem = tree > smem ? tree : smem;
  }
  hsum_lanes_kernel<T, S, O, DS, DT, SAME, TRANS, MODE>
      <<<static_cast<unsigned>((a.num_segments + spc - 1) / spc), threads,
         smem, a.stream>>>(
          static_cast<const S*>(a.js), static_cast<const S*>(a.jt),
          static_cast<const T*>(a.dl), a.perm, a.offsets,
          static_cast<O*>(a.out), a.num_segments, a.group_log2, a.accumulate);
  return cudaGetLastError();
}

template <typename T, typename S, typename O, int DS, int DT, bool SAME,
          bool TRANS>
cudaError_t launch_hsum(const HSumArgs& a) {
  if (a.group_log2 == 0) {
    return launch_hsum_rows<T, S, O, DS, DT, SAME, TRANS, kWhole>(a);
  }
  return launch_hsum_lanes<T, S, O, DS, DT, SAME, TRANS, kWhole>(a);
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
  // the lanes kernel reads J's rows in vector loads (RowLoad); J as
  // bal_scale_b stores it starts 16-byte aligned
  if ((reinterpret_cast<unsigned long long>(jc) |
       reinterpret_cast<unsigned long long>(jp)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
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

// kernel_sweep's split of Venice's three sites: the kernel a site takes
// there (Hpp (0, 0) on lanes; Hpl (0, 1) and Hll (1, 1)
// on one lane, not transposed), storage and sums in T, with its loads
// alone (mode 1) or its products alone (mode 2).
template <typename T, int MODE>
cudaError_t launch_probe(HSumArgs& a, int pair, const void* jp) {
  switch (pair) {
    case 0:
      if (a.group_log2 == 0) return cudaErrorInvalidValue;
      return launch_hsum_lanes<T, T, T, 9, 9, true, false, MODE>(a);
    case 1:
      if (a.group_log2 != 0) return cudaErrorInvalidValue;
      a.jt = jp;
      return launch_hsum_rows<T, T, T, 9, 3, false, false, MODE>(a);
    case 2:
      if (a.group_log2 != 0) return cudaErrorInvalidValue;
      a.js = a.jt = jp;
      return launch_hsum_rows<T, T, T, 3, 3, true, false, MODE>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run_probe(const void* jc, const void* jp, const void* dl,
              const void* perm, const void* offsets, void* out,
              int num_segments, int pair, int group_log2, int mode,
              void* stream) {
  if (num_segments <= 0 || group_log2 < 0 || group_log2 > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<unsigned long long>(jc) |
       reinterpret_cast<unsigned long long>(jp)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  HSumArgs a{jc, jc, dl, static_cast<const int*>(perm),
             static_cast<const int*>(offsets), out, num_segments, group_log2,
             0, static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case kLoadsOnly:
      return static_cast<int>(launch_probe<T, kLoadsOnly>(a, pair, jp));
    case kProductsOnly:
      return static_cast<int>(launch_probe<T, kProductsOnly>(a, pair, jp));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// kernel_sweep's split of a Venice site's time: the arguments of
// gt_bal_hessian_sum (no transposed site, no accumulate; jc 16-byte
// aligned), storage and sums in the graph's type, and mode 1 (the loads
// alone) or 2 (the products alone). The output is not the sums.
#define GT_BAL_HESSIAN_SUM_PROBE(NAME, T)                                   \
  extern "C" int NAME(const void* jc, const void* jp, const void* dl,      \
                      const void* perm, const void* offsets, void* out,    \
                      int num_segments, int pair, int group_log2,          \
                      int mode, void* stream) {                            \
    return run_probe<T>(jc, jp, dl, perm, offsets, out, num_segments, pair, \
                        group_log2, mode, stream);                         \
  }
GT_BAL_HESSIAN_SUM_PROBE(gt_bal_hessian_sum_probe, float)
GT_BAL_HESSIAN_SUM_PROBE(gt_bal_hessian_sum_probe_f64, double)

extern "C" const char* gt_bal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
