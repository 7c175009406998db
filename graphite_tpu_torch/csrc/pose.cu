// K11: the SE(3) pose-graph factors' linearization and chi2, and the SE(3)
// retraction of the LM update, on Hopper (sm_90a).
//
// Replaces no pl.pallas_call: it is the port's counterpart of what XLA
// fuses for the JAX package out of plain jnp code: linearize's AUTO branch
// for a factor type without jacobian_fn, "a vmapped jax.jacfwd trace per
// factor type, one fused XLA computation" (graphite_tpu/linearize.py,
// :129-153) over se3_between_residual / se3_prior_residual
// (graphite_tpu/models/pose_graph.py) and the SE(3) group operations
// (graphite_tpu/models/lie.py); chi2, the robust loss, the Jacobi
// diagonal's rows, the column scaling, the storage cast and b's rows
// around it; and apply_update's retraction of the SE(3) vertices. Eager
// PyTorch runs the AUTO branch as torch.func.jvp over the whole block:
// ~1,600 kernels a linearization, ~270-300 a trial chi2, ~170 an update.
//
// Four entries (ops/cuda/pose.py holds the wrappers and the plain PyTorch
// version of each, which is the generic code):
//   gt_pose_residual     poses[ids_s], obs, precision, factor_mask,
//                        loss_params -> masked robust chi2 (F)
//   gt_pose_linearize    the same and slot_mask -> r (F,6), the masked
//                        unscaled J (F,36) of each slot, chi2 (F), dL (F),
//                        the Jacobi diagonal's rows (F,6) of each slot
//   gt_pose_scale_b_*    J, r, dL, precision, the padded scale rows at
//                        rows_s -> the stored J in the storage type S
//                        and b's rows (F,6) a slot
//   gt_pose_update       poses, delta_x, scales, the type's segment and
//                        active rows -> the retracted poses (V,7)
// Each has an instance per graph dtype, the element type T of every value
// but the precision and the stored J: float (a float32 graph; S float,
// bf16 or fp16) and double (a float64 graph, the entries named *_f64; S
// double, float, bf16 or fp16). A float64 graph's precision is in its
// storage dtype (double, float or bf16) and is widened to double, as
// flat_block_mv's .to(acc) widens it; everything is accumulated in T.
// A factor has one slot (se3_prior) or two (se3_between); the loss
// (default, Huber, Cauchy) and the precision's storage type are uniform
// run-time switches. The gate (pose.py, gate) sends every other factor
// set to the generic code.
//
// The derivative. se3_dual.cuh evaluates the residual of each slot's
// se3_retract(x, delta) at delta = 0 over dual numbers, a value and its
// tangent along one direction of the factor's stacked deltas, with
// PyTorch's forward-mode rule for each operation: the jvp branch's bits
// (its header says how). linearize and scale_b run one thread per
// (factor, direction): K = 6 per slot threads a factor, 16 factors a CTA.
// Thread (i, k) computes the residual (each thread of the factor the same
// value, as the jvp's batch of K directions does) and its tangent, which
// is column c = k % 6 of slot k / 6's Jacobian; the diagonal's entry and,
// in scale_b, the stored column and b's entry of that column need only
// that column. Thread k = 0 writes r, chi2 and dL.
//
// The bits. Each entry equals its plain version on the card bitwise: the
// rules of K7 (bal.cu; robust.cuh): -fmad=false, sums left to right as
// Python writes them (flat_block_mv's P r, then r . P r; flat_block_mm_nn's
// P J, then J . P J, then times dL; flat_block_mv_t's J^T w, negated),
// Python constants in T, IEEE division, the transcendentals in float64
// (rounded in float; the double functions themselves in double, so CUDA's
// double sin / cos / atan2 on the card, as PyTorch's CUDA float64 ops call
// them), the slot mask a multiply by 1.0 or 0.0 (-0.0 stays), the storage
// cast clamp_to_storage's (a double to bf16 / fp16 through float, as
// PyTorch casts it), b from the stored (rounded) J.
//
// Stores: each CTA forms its outputs in a shared tile, one span per
// output, and copies each span out in 16-byte stores (K7's design:
// a thread writing its own rows makes a warp's store touch many rows).
// scale_b stages its J, r and dL rows with cp.async. The entries launch
// on the given stream, allocate nothing and never synchronise, so they run
// inside the captured LM iteration and its conditional regions.
//
// Bound: memory or launch latency. At sphere2500 (2,744 factors, 2,499
// poses) the entries move 0.09-0.8 MB (twice that in double), well under
// a microsecond at 3.35 TB/s; a launch is a few microseconds. A double
// thread of linearize holds twice the registers of a float one (its P
// and its duals); nvcc's -Xptxas -v counts are in the build log.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "robust.cuh"
#include "se3_dual.cuh"
#include "staging.cuh"

namespace {

constexpr int kFactors = 16;   // factors a linearize / scale_b CTA owns
constexpr int kThreads = 128;  // threads of a residual / update CTA
constexpr int kE = 6;          // residual rows
constexpr int kD = 6;          // tangent columns of a slot
constexpr int kBlock = kE * kD;

enum PrecKind { kPrecF32 = 0, kPrecBF16 = 1, kPrecF16 = 2, kPrecF64 = 3 };

// Factor f's (6, 6) precision, widened to T (flat_block_mv's and
// flat_block_mm_nn's .to(acc)); prec null: the identity.
template <typename T>
__device__ __forceinline__ void load_precision(const void* prec, int kind,
                                               long long f, T* P) {
  if (kind == kPrecBF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = __bfloat162float(p[i]);
  } else if (kind == kPrecF16) {
    const __half* p = static_cast<const __half*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = __half2float(p[i]);
  } else if (kind == kPrecF64) {
    const double* p = static_cast<const double*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = static_cast<T>(p[i]);
  } else {
    const float* p = static_cast<const float*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = p[i];
  }
}

// out = P v (flat_block_mv: row e is sum_j P[e, j] v[j], left to right)
template <typename T>
__device__ __forceinline__ void block_mv(const T* P, const T* v, T* out) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    T acc = P[kE * e] * v[0];
#pragma unroll
    for (int j = 1; j < kE; ++j) acc = acc + P[kE * e + j] * v[j];
    out[e] = acc;
  }
}

// sum_e a[e] b[e], left to right
template <typename T>
__device__ __forceinline__ T dot6(const T* a, const T* b) {
  T acc = a[0] * b[0];
#pragma unroll
  for (int e = 1; e < kE; ++e) acc = acc + a[e] * b[e];
  return acc;
}

// r^T P r (compute_chi2_block's raw) with P r in wr; P null: r^T r
template <typename T>
__device__ __forceinline__ T weighted(const T* r, const T* P, bool has_prec,
                                      T* wr) {
  if (has_prec) {
    block_mv(P, r, wr);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) wr[e] = r[e];
  }
  return dot6(r, wr);
}

template <typename T>
__device__ __forceinline__ void robust_rt(int loss, T x, T p, T* value,
                                          T* deriv) {
  if (loss == kHuber) {
    robust<kHuber>(x, p, value, deriv);
  } else if (loss == kCauchy) {
    robust<kCauchy>(x, p, value, deriv);
  } else {
    robust<kDefault>(x, p, value, deriv);
  }
}

// the slot mask's and the factor mask's multiplier: 1.0 or 0.0
template <typename T>
__device__ __forceinline__ T mask(bool m) {
  return m ? se3::Real<T>::kOne : se3::Real<T>::kZero;
}

template <typename T>
struct FactorInputs {
  const T* poses;                     // (V, 7)
  const long long* ids[2];            // (F,) a slot
  const T* obs;                       // (F, 7)
  const void* prec;                   // (F, 36) or null
  int prec_kind;
  const bool* fmask;                  // (F,)
  const T* loss_params;               // (F,)
};

template <int NSLOT, typename T>
__device__ __forceinline__ void slot_rows(const FactorInputs<T>& in,
                                          long long f, const T** x) {
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) x[s] = in.poses + 7 * in.ids[s][f];
}

template <int NSLOT, typename T>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(FactorInputs<T> in, int loss, T* __restrict__ chi2,
                    long long F) {
  const long long f = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (f >= F) return;
  const T* x[2];
  slot_rows<NSLOT>(in, f, x);
  T r[kE], wr[kE], P[kBlock];
  se3::residual<NSLOT>(x, in.obs + 7 * f, r);
  const bool has_prec = in.prec != nullptr;
  if (has_prec) load_precision(in.prec, in.prec_kind, f, P);
  const T raw = weighted(r, P, has_prec, wr);
  T value, deriv;
  robust_rt(loss, raw, in.loss_params[f], &value, &deriv);
  chi2[f] = value * mask<T>(in.fmask[f]);
}

template <typename T>
struct LinearizeOutputs {
  T* r;        // (F, 6)
  T* j[2];     // (F, 36) a slot
  T* chi2;     // (F,)
  T* dl;       // (F,)
  T* diag[2];  // (F, 6) a slot
};

// Thread (i, k) of a CTA of kFactors * K: factor f0 + i, direction k.
template <int NSLOT, typename T>
__global__ void __launch_bounds__(kFactors * 6 * NSLOT)
    linearize_kernel(FactorInputs<T> in, const bool* __restrict__ smask,
                     int loss, LinearizeOutputs<T> out, long long F) {
  constexpr int K = kD * NSLOT;
  // one span per output: r, J a slot, chi2, dL, the diagonal a slot
  __shared__ __align__(16) T tile[kFactors * (kE + NSLOT * (kBlock + kD) + 2)];
  T* t_r = tile;
  T* t_j = t_r + kFactors * kE;
  T* t_chi2 = t_j + NSLOT * kFactors * kBlock;
  T* t_dl = t_chi2 + kFactors;
  T* t_diag = t_dl + kFactors;
  const long long f0 = static_cast<long long>(blockIdx.x) * kFactors;
  const int nf = static_cast<int>(F - f0 < kFactors ? F - f0 : kFactors);
  const int i = threadIdx.x / K;
  const int k = threadIdx.x - i * K;
  if (i < nf) {
    const long long f = f0 + i;
    const T* x[2];
    slot_rows<NSLOT>(in, f, x);
    T r[kE], J[kE], wr[kE], P[kBlock];
    se3::residual_jvp<NSLOT>(x, in.obs + 7 * f, k, r, J);
    const int s = k / kD, c = k - s * kD;
    const T m = mask<T>(smask[NSLOT * f + s]);
#pragma unroll
    for (int e = 0; e < kE; ++e) J[e] = J[e] * m;
    const bool has_prec = in.prec != nullptr;
    if (has_prec) load_precision(in.prec, in.prec_kind, f, P);
    const T raw = weighted(r, P, has_prec, wr);
    T value, dL;
    robust_rt(loss, raw, in.loss_params[f], &value, &dL);
    // the diagonal's entry of this column: (J . P J) dL
    T pj[kE];
    if (has_prec) {
      block_mv(P, J, pj);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) pj[e] = J[e];
    }
    T* tj = t_j + s * kFactors * kBlock + kBlock * i;
#pragma unroll
    for (int e = 0; e < kE; ++e) tj[kD * e + c] = J[e];
    t_diag[s * kFactors * kD + kD * i + c] = dot6(J, pj) * dL;
    if (k == 0) {
#pragma unroll
      for (int e = 0; e < kE; ++e) t_r[kE * i + e] = r[e];
      t_chi2[i] = value * mask<T>(in.fmask[f]);
      t_dl[i] = dL;
    }
  }
  __syncthreads();
  // rows [f0, f0 + nf) of each output: f0 a multiple of 16, so every span
  // starts 16-byte aligned
  constexpr int TH = kFactors * K;
  store_span<TH>(out.r + kE * f0, t_r, kE * nf);
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    store_span<TH>(out.j[s] + kBlock * f0, t_j + s * kFactors * kBlock,
                   kBlock * nf);
    store_span<TH>(out.diag[s] + kD * f0, t_diag + s * kFactors * kD,
                   kD * nf);
  }
  store_span<TH>(out.chi2 + f0, t_chi2, nf);
  store_span<TH>(out.dl + f0, t_dl, nf);
}

template <typename T, typename S>
struct ScaleBArgs {
  const T* j[2];          // (F, 36) a slot
  const T* r;             // (F, 6)
  const T* dl;            // (F,)
  const void* prec;       // (F, 36) or null
  int prec_kind;
  const T* scale[2];      // (n_s + 1, 6) padded scale rows, or null
  const long long* rows[2];
  S* j_out[2];            // (F, 36) a slot, the storage type
  T* b[2];                // (F, 6) a slot
};

// scale_b: thread (i, k) forms column c of slot s's stored J (each entry
// times the column's scale, cast to storage) and b's entry of that column,
// -sum_e Js[e, c] (P r dL)[e], from the staged J, r and dL rows.
template <typename T, typename S, int NSLOT>
__global__ void __launch_bounds__(kFactors * 6 * NSLOT)
    scale_b_kernel(ScaleBArgs<T, S> a, long long F) {
  constexpr int K = kD * NSLOT;
  constexpr int TH = kFactors * K;
  __shared__ __align__(16) T t_in[kFactors * (NSLOT * kBlock + kE + 1)];
  // the stored J (S) and b's rows (T) a slot
  __shared__ __align__(16) unsigned char t_jo_raw[NSLOT * kFactors * kBlock * sizeof(S)];
  __shared__ __align__(16) T t_b[NSLOT * kFactors * kD];
  S* t_jo = reinterpret_cast<S*>(t_jo_raw);
  T* t_j = t_in;
  T* t_r = t_j + NSLOT * kFactors * kBlock;
  T* t_dl = t_r + kFactors * kE;
  const long long f0 = static_cast<long long>(blockIdx.x) * kFactors;
  const int nf = static_cast<int>(F - f0 < kFactors ? F - f0 : kFactors);
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    stage_span<TH>(t_j + s * kFactors * kBlock, a.j[s] + kBlock * f0,
                   kBlock * nf);
  }
  stage_span<TH>(t_r, a.r + kE * f0, kE * nf);
  stage_span<TH>(t_dl, a.dl + f0, nf);
  cp_async_commit();
  const int i = threadIdx.x / K;
  const int k = threadIdx.x - i * K;
  const int s = k / kD, c = k - s * kD;
  const bool scaled = a.scale[0] != nullptr;
  const bool has_prec = a.prec != nullptr;
  T scale = se3::Real<T>::kOne;
  T P[kBlock];
  if (i < nf) {
    if (scaled) scale = a.scale[s][kD * a.rows[s][f0 + i] + c];
    if (has_prec) load_precision(a.prec, a.prec_kind, f0 + i, P);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (i < nf) {
    T r[kE], w[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) r[e] = t_r[kE * i + e];
    weighted(r, P, has_prec, w);
    const T dL = t_dl[i];
#pragma unroll
    for (int e = 0; e < kE; ++e) w[e] = w[e] * dL;
    const T* tj = t_j + s * kFactors * kBlock + kBlock * i;
    S* to = t_jo + s * kFactors * kBlock + kBlock * i;
    T acc = se3::Real<T>::kZero;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      T x = tj[kD * e + c];
      if (scaled) x = x * scale;
      const S st = Storage<S>::store(x);
      to[kD * e + c] = st;
      const T term = static_cast<T>(Storage<S>::load(st)) * w[e];
      acc = e == 0 ? term : acc + term;
    }
    t_b[s * kFactors * kD + kD * i + c] = -acc;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NSLOT; ++q) {
    store_span<TH>(a.j_out[q] + kBlock * f0, t_jo + q * kFactors * kBlock,
                   kBlock * nf);
    store_span<TH>(a.b[q] + kD * f0, t_b + q * kFactors * kD, kD * nf);
  }
}

// apply_update for one SE(3) vertex type: vertex v active takes
// se3_retract(x_v, delta) with delta its row of delta_x * scales (the
// trash row n_rows: +0.0), an inactive one keeps x_v.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const T* __restrict__ poses, const T* __restrict__ dx,
                  const T* __restrict__ sc, long long start,
                  long long n_rows, const long long* __restrict__ active_row,
                  const bool* __restrict__ active, T* __restrict__ out,
                  long long V) {
  __shared__ __align__(16) T tile[kThreads * 7];
  const long long v0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nv = static_cast<int>(V - v0 < kThreads ? V - v0 : kThreads);
  const int i = threadIdx.x;
  if (i < nv) {
    const long long v = v0 + i;
    const T* x = poses + 7 * v;
    T* o = tile + 7 * i;
    if (active[v]) {
      const long long row = active_row[v];
      T delta[kD];
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        const long long at = start + kD * row + c;
        delta[c] = row < n_rows ? dx[at] * sc[at] : se3::Real<T>::kZero;
      }
      const se3::Pose<T> y = se3::se3_retract(se3::load_pose(x), delta);
      o[0] = y.t.x;
      o[1] = y.t.y;
      o[2] = y.t.z;
      o[3] = y.q.x;
      o[4] = y.q.y;
      o[5] = y.q.z;
      o[6] = y.q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 7; ++c) o[c] = x[c];
    }
  }
  __syncthreads();
  store_span<kThreads>(out + 7 * v0, tile, 7 * nv);
}

long long blocks_for(long long n, int per_block) {
  return (n + per_block - 1) / per_block;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T>
FactorInputs<T> factor_inputs(const void* poses, const void* ids0,
                              const void* ids1, const void* obs,
                              const void* prec, int prec_kind,
                              const void* fmask, const void* loss_params) {
  FactorInputs<T> in;
  in.poses = static_cast<const T*>(poses);
  in.ids[0] = static_cast<const long long*>(ids0);
  in.ids[1] = static_cast<const long long*>(ids1);
  in.obs = static_cast<const T*>(obs);
  in.prec = prec;
  in.prec_kind = prec_kind;
  in.fmask = static_cast<const bool*>(fmask);
  in.loss_params = static_cast<const T*>(loss_params);
  return in;
}

// one slot, or two with the second slot's array given; a precision
// storage type of the graph dtype's instance (float: float32, bf16, fp16;
// double: those and float64)
template <typename T>
bool valid(int nslot, const void* second, int prec_kind) {
  const int top = sizeof(T) == 8 ? kPrecF64 : kPrecF16;
  return (nslot == 1 || (nslot == 2 && second != nullptr)) &&
         prec_kind >= kPrecF32 && prec_kind <= top;
}

bool valid_loss(int loss) { return loss >= kDefault && loss <= kCauchy; }

template <typename T>
int residual(const void* poses, const void* ids0, const void* ids1,
             const void* obs, const void* prec, int prec_kind,
             const void* fmask, const void* loss_params, void* chi2,
             long long F, int nslot, int loss, void* stream) {
  if (F < 0 || !valid<T>(nslot, ids1, prec_kind) || !valid_loss(loss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  const FactorInputs<T> in = factor_inputs<T>(
      poses, ids0, ids1, obs, prec, prec_kind, fmask, loss_params);
  const auto s = static_cast<cudaStream_t>(stream);
  T* out = static_cast<T*>(chi2);
  if (nslot == 2) {
    residual_kernel<2, T><<<blocks_for(F, kThreads), kThreads, 0, s>>>(
        in, loss, out, F);
  } else {
    residual_kernel<1, T><<<blocks_for(F, kThreads), kThreads, 0, s>>>(
        in, loss, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int linearize(const void* poses, const void* ids0, const void* ids1,
              const void* obs, const void* prec, int prec_kind,
              const void* smask, const void* fmask, const void* loss_params,
              void* r, void* j0, void* j1, void* chi2, void* dl, void* d0,
              void* d1, long long F, int nslot, int loss, void* stream) {
  if (F < 0 || !valid<T>(nslot, ids1, prec_kind) || !valid_loss(loss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  const void* outs[] = {r, j0, chi2, dl, d0, nslot == 2 ? j1 : j0,
                        nslot == 2 ? d1 : d0};
  for (const void* p : outs) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const FactorInputs<T> in = factor_inputs<T>(
      poses, ids0, ids1, obs, prec, prec_kind, fmask, loss_params);
  LinearizeOutputs<T> out;
  out.r = static_cast<T*>(r);
  out.j[0] = static_cast<T*>(j0);
  out.j[1] = static_cast<T*>(j1);
  out.chi2 = static_cast<T*>(chi2);
  out.dl = static_cast<T*>(dl);
  out.diag[0] = static_cast<T*>(d0);
  out.diag[1] = static_cast<T*>(d1);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool* sm = static_cast<const bool*>(smask);
  if (nslot == 2) {
    linearize_kernel<2, T><<<blocks_for(F, kFactors), kFactors * 12, 0, s>>>(
        in, sm, loss, out, F);
  } else {
    linearize_kernel<1, T><<<blocks_for(F, kFactors), kFactors * 6, 0, s>>>(
        in, sm, loss, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int scale_b(const void* j0, const void* j1, const void* r, const void* dl,
            const void* prec, int prec_kind, const void* sc0,
            const void* sc1, const void* rows0, const void* rows1,
            void* j0_out, void* j1_out, void* b0, void* b1, long long F,
            int nslot, void* stream) {
  if (F < 0 || !valid<T>(nslot, j1, prec_kind) ||
      (nslot == 2 && (sc0 == nullptr) != (sc1 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  // the tiles are staged in and copied out in 16-byte pieces
  const void* spans[] = {j0, r, dl, j0_out, b0, nslot == 2 ? j1 : j0,
                         nslot == 2 ? j1_out : j0_out, nslot == 2 ? b1 : b0};
  for (const void* p : spans) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  ScaleBArgs<T, S> a;
  a.j[0] = static_cast<const T*>(j0);
  a.j[1] = static_cast<const T*>(j1);
  a.r = static_cast<const T*>(r);
  a.dl = static_cast<const T*>(dl);
  a.prec = prec;
  a.prec_kind = prec_kind;
  a.scale[0] = static_cast<const T*>(sc0);
  a.scale[1] = static_cast<const T*>(sc1);
  a.rows[0] = static_cast<const long long*>(rows0);
  a.rows[1] = static_cast<const long long*>(rows1);
  a.j_out[0] = static_cast<S*>(j0_out);
  a.j_out[1] = static_cast<S*>(j1_out);
  a.b[0] = static_cast<T*>(b0);
  a.b[1] = static_cast<T*>(b1);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nslot == 2) {
    scale_b_kernel<T, S, 2><<<blocks_for(F, kFactors), kFactors * 12, 0, s>>>(
        a, F);
  } else {
    scale_b_kernel<T, S, 1><<<blocks_for(F, kFactors), kFactors * 6, 0, s>>>(
        a, F);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update(const void* poses, const void* dx, const void* sc,
           long long start, long long n_rows, const void* active_row,
           const void* active, void* out, long long V, void* stream) {
  if (V < 0 || start < 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (V == 0) return 0;
  if (!aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  update_kernel<T><<<blocks_for(V, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(poses), static_cast<const T*>(dx),
      static_cast<const T*>(sc), start, n_rows,
      static_cast<const long long*>(active_row),
      static_cast<const bool*>(active), static_cast<T*>(out), V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry has a float32 graph's instance (gt_pose_<entry>, every value
// float) and a float64 graph's (gt_pose_<entry>_f64, every value double);
// below, "real" is the instance's type. Each launches on `stream` and
// returns the cudaGetLastError() code (0 on success).
//
// residual: poses (V, 7), obs (F, 7), loss_params (F,): real; ids0, ids1
// (F,) int64 (ids1 null for one slot); prec (F, 36) of prec_kind (0
// float32, 1 bf16, 2 fp16, 3 float64 (the float64 instance only)) or
// null; fmask (F,) bool; chi2 (F,) real out. loss: 0 default, 1 Huber, 2
// Cauchy.
#define GT_POSE_RESIDUAL(NAME, TYPE)                                         \
  extern "C" int NAME(const void* poses, const void* ids0, const void* ids1, \
                      const void* obs, const void* prec, int prec_kind,      \
                      const void* fmask, const void* loss_params,            \
                      void* chi2, long long F, int nslot, int loss,          \
                      void* stream) {                                        \
    return residual<TYPE>(poses, ids0, ids1, obs, prec, prec_kind, fmask,    \
                          loss_params, chi2, F, nslot, loss, stream);        \
  }
GT_POSE_RESIDUAL(gt_pose_residual, float)
GT_POSE_RESIDUAL(gt_pose_residual_f64, double)
#undef GT_POSE_RESIDUAL

// linearize: the same inputs and smask (F, nslot) bool; out: r (F, 6), j0,
// j1 (F, 36), chi2 (F,), dl (F,), d0, d1 (F, 6), all real and 16-byte
// aligned (j1, d1 null for one slot).
#define GT_POSE_LINEARIZE(NAME, TYPE)                                        \
  extern "C" int NAME(const void* poses, const void* ids0, const void* ids1, \
                      const void* obs, const void* prec, int prec_kind,      \
                      const void* smask, const void* fmask,                  \
                      const void* loss_params, void* r, void* j0, void* j1,  \
                      void* chi2, void* dl, void* d0, void* d1, long long F, \
                      int nslot, int loss, void* stream) {                   \
    return linearize<TYPE>(poses, ids0, ids1, obs, prec, prec_kind, smask,   \
                           fmask, loss_params, r, j0, j1, chi2, dl, d0, d1,  \
                           F, nslot, loss, stream);                          \
  }
GT_POSE_LINEARIZE(gt_pose_linearize, float)
GT_POSE_LINEARIZE(gt_pose_linearize_f64, double)
#undef GT_POSE_LINEARIZE

// scale_b: j0, j1 (F, 36), r (F, 6), dl (F,): real; prec as above; sc0,
// sc1 (n_s + 1, 6) real padded scale rows, all null for no scaling; rows0,
// rows1 (F,) int64. Out: j0_out, j1_out in the storage type (the entry's
// last suffix), b0, b1 (F, 6) real. j, r, dl and the outputs 16-byte
// aligned; the second slot's pointers null for one slot.
#define GT_POSE_SCALE_B(NAME, TYPE, STORAGE)                                 \
  extern "C" int NAME(const void* j0, const void* j1, const void* r,         \
                      const void* dl, const void* prec, int prec_kind,       \
                      const void* sc0, const void* sc1, const void* rows0,   \
                      const void* rows1, void* j0_out, void* j1_out,         \
                      void* b0, void* b1, long long F, int nslot,            \
                      void* stream) {                                        \
    return scale_b<TYPE, STORAGE>(j0, j1, r, dl, prec, prec_kind, sc0, sc1,  \
                                  rows0, rows1, j0_out, j1_out, b0, b1, F,   \
                                  nslot, stream);                            \
  }
GT_POSE_SCALE_B(gt_pose_scale_b_f32, float, float)
GT_POSE_SCALE_B(gt_pose_scale_b_bf16, float, __nv_bfloat16)
GT_POSE_SCALE_B(gt_pose_scale_b_f16, float, __half)
GT_POSE_SCALE_B(gt_pose_scale_b_f64_f64, double, double)
GT_POSE_SCALE_B(gt_pose_scale_b_f64_f32, double, float)
GT_POSE_SCALE_B(gt_pose_scale_b_f64_bf16, double, __nv_bfloat16)
GT_POSE_SCALE_B(gt_pose_scale_b_f64_f16, double, __half)
#undef GT_POSE_SCALE_B

// update: poses (V, 7), dx, sc (dim_x,) real; the type's rows start at
// dx[start], n_rows of 6; active_row (V,) int64 (n_rows: the trash row),
// active (V,) bool; out (V, 7) real, 16-byte aligned.
#define GT_POSE_UPDATE(NAME, TYPE)                                           \
  extern "C" int NAME(const void* poses, const void* dx, const void* sc,     \
                      long long start, long long n_rows,                     \
                      const void* active_row, const void* active, void* out, \
                      long long V, void* stream) {                           \
    return update<TYPE>(poses, dx, sc, start, n_rows, active_row, active,    \
                        out, V, stream);                                     \
  }
GT_POSE_UPDATE(gt_pose_update, float)
GT_POSE_UPDATE(gt_pose_update_f64, double)
#undef GT_POSE_UPDATE

extern "C" const char* gt_pose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
