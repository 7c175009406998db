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
//                        (float, bf16 or fp16) and b's rows (F,6) a slot
//   gt_pose_update       poses, delta_x, scales, the type's segment and
//                        active rows -> the retracted poses (V,7)
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
// Python constants as float32, IEEE division, float64 transcendentals
// rounded, the slot mask a multiply by 1.0 or 0.0 (-0.0 stays), the
// storage cast clamp_to_storage's, b from the stored (rounded) J.
//
// Stores: each CTA forms its outputs in a shared tile, one span per
// output, and copies each span out in 16-byte stores (K7's design:
// a thread writing its own rows makes a warp's store touch many rows).
// scale_b stages its J, r and dL rows with cp.async. The entries launch
// on the given stream, allocate nothing and never synchronise, so they run
// inside the captured LM iteration and its conditional regions.
//
// Bound: memory or launch latency. At sphere2500 (2,744 factors, 2,499
// poses) the entries move 0.09-0.8 MB, well under a microsecond at
// 3.35 TB/s; a launch is a few microseconds.

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

enum PrecKind { kPrecF32 = 0, kPrecBF16 = 1, kPrecF16 = 2 };

// Factor f's (6, 6) precision, widened to float32 (flat_block_mv's and
// flat_block_mm_nn's .to(acc)); prec null: the identity.
__device__ __forceinline__ void load_precision(const void* prec, int kind,
                                               long long f, float* P) {
  if (kind == kPrecBF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = __bfloat162float(p[i]);
  } else if (kind == kPrecF16) {
    const __half* p = static_cast<const __half*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = __half2float(p[i]);
  } else {
    const float* p = static_cast<const float*>(prec) + kBlock * f;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) P[i] = p[i];
  }
}

// out = P v (flat_block_mv: row e is sum_j P[e, j] v[j], left to right)
__device__ __forceinline__ void block_mv(const float* P, const float* v,
                                         float* out) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    float acc = P[kE * e] * v[0];
#pragma unroll
    for (int j = 1; j < kE; ++j) acc = acc + P[kE * e + j] * v[j];
    out[e] = acc;
  }
}

// sum_e a[e] b[e], left to right
__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int e = 1; e < kE; ++e) acc = acc + a[e] * b[e];
  return acc;
}

// r^T P r (compute_chi2_block's raw) with P r in wr; P null: r^T r
__device__ __forceinline__ float weighted(const float* r, const float* P,
                                          bool has_prec, float* wr) {
  if (has_prec) {
    block_mv(P, r, wr);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) wr[e] = r[e];
  }
  return dot6(r, wr);
}

__device__ __forceinline__ void robust_rt(int loss, float x, float p,
                                          float* value, float* deriv) {
  if (loss == kHuber) {
    robust<kHuber>(x, p, value, deriv);
  } else if (loss == kCauchy) {
    robust<kCauchy>(x, p, value, deriv);
  } else {
    robust<kDefault>(x, p, value, deriv);
  }
}

struct FactorInputs {
  const float* poses;                 // (V, 7)
  const long long* ids[2];            // (F,) a slot
  const float* obs;                   // (F, 7)
  const void* prec;                   // (F, 36) or null
  int prec_kind;
  const bool* fmask;                  // (F,)
  const float* loss_params;           // (F,)
};

template <int NSLOT>
__device__ __forceinline__ void slot_rows(const FactorInputs& in, long long f,
                                          const float** x) {
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) x[s] = in.poses + 7 * in.ids[s][f];
}

template <int NSLOT>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(FactorInputs in, int loss, float* __restrict__ chi2,
                    long long F) {
  const long long f = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (f >= F) return;
  const float* x[2];
  slot_rows<NSLOT>(in, f, x);
  float r[kE], wr[kE], P[kBlock];
  se3::residual<NSLOT>(x, in.obs + 7 * f, r);
  const bool has_prec = in.prec != nullptr;
  if (has_prec) load_precision(in.prec, in.prec_kind, f, P);
  const float raw = weighted(r, P, has_prec, wr);
  float value, deriv;
  robust_rt(loss, raw, in.loss_params[f], &value, &deriv);
  chi2[f] = value * (in.fmask[f] ? 1.0f : 0.0f);
}

struct LinearizeOutputs {
  float* r;        // (F, 6)
  float* j[2];     // (F, 36) a slot
  float* chi2;     // (F,)
  float* dl;       // (F,)
  float* diag[2];  // (F, 6) a slot
};

// Thread (i, k) of a CTA of kFactors * K: factor f0 + i, direction k.
template <int NSLOT>
__global__ void __launch_bounds__(kFactors * 6 * NSLOT)
    linearize_kernel(FactorInputs in, const bool* __restrict__ smask,
                     int loss, LinearizeOutputs out, long long F) {
  constexpr int K = kD * NSLOT;
  // one span per output: r, J a slot, chi2, dL, the diagonal a slot
  __shared__ __align__(16) float tile[kFactors * (kE + NSLOT * (kBlock + kD) + 2)];
  float* t_r = tile;
  float* t_j = t_r + kFactors * kE;
  float* t_chi2 = t_j + NSLOT * kFactors * kBlock;
  float* t_dl = t_chi2 + kFactors;
  float* t_diag = t_dl + kFactors;
  const long long f0 = static_cast<long long>(blockIdx.x) * kFactors;
  const int nf = static_cast<int>(F - f0 < kFactors ? F - f0 : kFactors);
  const int i = threadIdx.x / K;
  const int k = threadIdx.x - i * K;
  if (i < nf) {
    const long long f = f0 + i;
    const float* x[2];
    slot_rows<NSLOT>(in, f, x);
    float r[kE], J[kE], wr[kE], P[kBlock];
    se3::residual_jvp<NSLOT>(x, in.obs + 7 * f, k, r, J);
    const int s = k / kD, c = k - s * kD;
    const float m = smask[NSLOT * f + s] ? 1.0f : 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) J[e] = J[e] * m;
    const bool has_prec = in.prec != nullptr;
    if (has_prec) load_precision(in.prec, in.prec_kind, f, P);
    const float raw = weighted(r, P, has_prec, wr);
    float value, dL;
    robust_rt(loss, raw, in.loss_params[f], &value, &dL);
    // the diagonal's entry of this column: (J . P J) dL
    float pj[kE];
    if (has_prec) {
      block_mv(P, J, pj);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) pj[e] = J[e];
    }
    float* tj = t_j + s * kFactors * kBlock + kBlock * i;
#pragma unroll
    for (int e = 0; e < kE; ++e) tj[kD * e + c] = J[e];
    t_diag[s * kFactors * kD + kD * i + c] = dot6(J, pj) * dL;
    if (k == 0) {
#pragma unroll
      for (int e = 0; e < kE; ++e) t_r[kE * i + e] = r[e];
      t_chi2[i] = value * (in.fmask[f] ? 1.0f : 0.0f);
      t_dl[i] = dL;
    }
  }
  __syncthreads();
  // rows [f0, f0 + nf) of each output: f0 a multiple of 16, so every span
  // starts 16-byte aligned
  constexpr int T = kFactors * K;
  store_span<T>(out.r + kE * f0, t_r, kE * nf);
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    store_span<T>(out.j[s] + kBlock * f0, t_j + s * kFactors * kBlock,
                  kBlock * nf);
    store_span<T>(out.diag[s] + kD * f0, t_diag + s * kFactors * kD,
                  kD * nf);
  }
  store_span<T>(out.chi2 + f0, t_chi2, nf);
  store_span<T>(out.dl + f0, t_dl, nf);
}

template <typename S>
struct ScaleBArgs {
  const float* j[2];      // (F, 36) a slot
  const float* r;         // (F, 6)
  const float* dl;        // (F,)
  const void* prec;       // (F, 36) or null
  int prec_kind;
  const float* scale[2];  // (n_s + 1, 6) padded scale rows, or null
  const long long* rows[2];
  S* j_out[2];            // (F, 36) a slot, the storage type
  float* b[2];            // (F, 6) a slot
};

// scale_b: thread (i, k) forms column c of slot s's stored J (each entry
// times the column's scale, cast to storage) and b's entry of that column,
// -sum_e Js[e, c] (P r dL)[e], from the staged J, r and dL rows.
template <typename S, int NSLOT>
__global__ void __launch_bounds__(kFactors * 6 * NSLOT)
    scale_b_kernel(ScaleBArgs<S> a, long long F) {
  constexpr int K = kD * NSLOT;
  constexpr int T = kFactors * K;
  __shared__ __align__(16) float t_in[kFactors * (NSLOT * kBlock + kE + 1)];
  // the stored J (S) and b's rows (float) a slot
  __shared__ __align__(16) unsigned char t_jo_raw[NSLOT * kFactors * kBlock * sizeof(S)];
  __shared__ __align__(16) float t_b[NSLOT * kFactors * kD];
  S* t_jo = reinterpret_cast<S*>(t_jo_raw);
  float* t_j = t_in;
  float* t_r = t_j + NSLOT * kFactors * kBlock;
  float* t_dl = t_r + kFactors * kE;
  const long long f0 = static_cast<long long>(blockIdx.x) * kFactors;
  const int nf = static_cast<int>(F - f0 < kFactors ? F - f0 : kFactors);
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    stage_span<T>(t_j + s * kFactors * kBlock, a.j[s] + kBlock * f0,
                  kBlock * nf);
  }
  stage_span<T>(t_r, a.r + kE * f0, kE * nf);
  stage_span<T>(t_dl, a.dl + f0, nf);
  cp_async_commit();
  const int i = threadIdx.x / K;
  const int k = threadIdx.x - i * K;
  const int s = k / kD, c = k - s * kD;
  const bool scaled = a.scale[0] != nullptr;
  const bool has_prec = a.prec != nullptr;
  float scale = 1.0f;
  float P[kBlock];
  if (i < nf) {
    if (scaled) scale = a.scale[s][kD * a.rows[s][f0 + i] + c];
    if (has_prec) load_precision(a.prec, a.prec_kind, f0 + i, P);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (i < nf) {
    float r[kE], w[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) r[e] = t_r[kE * i + e];
    weighted(r, P, has_prec, w);
    const float dL = t_dl[i];
#pragma unroll
    for (int e = 0; e < kE; ++e) w[e] = w[e] * dL;
    const float* tj = t_j + s * kFactors * kBlock + kBlock * i;
    S* to = t_jo + s * kFactors * kBlock + kBlock * i;
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float x = tj[kD * e + c];
      if (scaled) x = x * scale;
      const S st = Storage<S>::store(x);
      to[kD * e + c] = st;
      const float term = Storage<S>::load(st) * w[e];
      acc = e == 0 ? term : acc + term;
    }
    t_b[s * kFactors * kD + kD * i + c] = -acc;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NSLOT; ++q) {
    store_span<T>(a.j_out[q] + kBlock * f0, t_jo + q * kFactors * kBlock,
                  kBlock * nf);
    store_span<T>(a.b[q] + kD * f0, t_b + q * kFactors * kD, kD * nf);
  }
}

// apply_update for one SE(3) vertex type: vertex v active takes
// se3_retract(x_v, delta) with delta its row of delta_x * scales (the
// trash row n_rows: +0.0), an inactive one keeps x_v.
__global__ void __launch_bounds__(kThreads)
    update_kernel(const float* __restrict__ poses,
                  const float* __restrict__ dx,
                  const float* __restrict__ sc, long long start,
                  long long n_rows, const long long* __restrict__ active_row,
                  const bool* __restrict__ active, float* __restrict__ out,
                  long long V) {
  __shared__ __align__(16) float tile[kThreads * 7];
  const long long v0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nv = static_cast<int>(V - v0 < kThreads ? V - v0 : kThreads);
  const int i = threadIdx.x;
  if (i < nv) {
    const long long v = v0 + i;
    const float* x = poses + 7 * v;
    float* o = tile + 7 * i;
    if (active[v]) {
      const long long row = active_row[v];
      float delta[kD];
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        const long long at = start + kD * row + c;
        delta[c] = row < n_rows ? dx[at] * sc[at] : 0.0f;
      }
      const se3::Pose<float> y = se3::se3_retract(se3::load_pose(x), delta);
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

FactorInputs factor_inputs(const void* poses, const void* ids0,
                           const void* ids1, const void* obs,
                           const void* prec, int prec_kind,
                           const void* fmask, const void* loss_params) {
  FactorInputs in;
  in.poses = static_cast<const float*>(poses);
  in.ids[0] = static_cast<const long long*>(ids0);
  in.ids[1] = static_cast<const long long*>(ids1);
  in.obs = static_cast<const float*>(obs);
  in.prec = prec;
  in.prec_kind = prec_kind;
  in.fmask = static_cast<const bool*>(fmask);
  in.loss_params = static_cast<const float*>(loss_params);
  return in;
}

// one slot, or two with the second slot's array given; a known precision
// storage type
bool valid(int nslot, const void* second, int prec_kind) {
  return (nslot == 1 || (nslot == 2 && second != nullptr)) &&
         prec_kind >= kPrecF32 && prec_kind <= kPrecF16;
}

bool valid_loss(int loss) { return loss >= kDefault && loss <= kCauchy; }

template <typename S>
int scale_b(const void* j0, const void* j1, const void* r, const void* dl,
            const void* prec, int prec_kind, const void* sc0,
            const void* sc1, const void* rows0, const void* rows1,
            void* j0_out, void* j1_out, void* b0, void* b1, long long F,
            int nslot, void* stream) {
  if (F < 0 || !valid(nslot, j1, prec_kind) ||
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
  ScaleBArgs<S> a;
  a.j[0] = static_cast<const float*>(j0);
  a.j[1] = static_cast<const float*>(j1);
  a.r = static_cast<const float*>(r);
  a.dl = static_cast<const float*>(dl);
  a.prec = prec;
  a.prec_kind = prec_kind;
  a.scale[0] = static_cast<const float*>(sc0);
  a.scale[1] = static_cast<const float*>(sc1);
  a.rows[0] = static_cast<const long long*>(rows0);
  a.rows[1] = static_cast<const long long*>(rows1);
  a.j_out[0] = static_cast<S*>(j0_out);
  a.j_out[1] = static_cast<S*>(j1_out);
  a.b[0] = static_cast<float*>(b0);
  a.b[1] = static_cast<float*>(b1);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nslot == 2) {
    scale_b_kernel<S, 2><<<blocks_for(F, kFactors), kFactors * 12, 0, s>>>(a, F);
  } else {
    scale_b_kernel<S, 1><<<blocks_for(F, kFactors), kFactors * 6, 0, s>>>(a, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// poses (V, 7), obs (F, 7), loss_params (F,): float32; ids0, ids1 (F,)
// int64 (ids1 null for one slot); prec (F, 36) of prec_kind (0 float32, 1
// bf16, 2 fp16) or null; fmask (F,) bool; chi2 (F,) float32 out. loss: 0
// default, 1 Huber, 2 Cauchy. Launches on `stream` and returns the
// cudaGetLastError() code (0 on success).
extern "C" int gt_pose_residual(const void* poses, const void* ids0,
                                const void* ids1, const void* obs,
                                const void* prec, int prec_kind,
                                const void* fmask, const void* loss_params,
                                void* chi2, long long F, int nslot, int loss,
                                void* stream) {
  if (F < 0 || !valid(nslot, ids1, prec_kind) || !valid_loss(loss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  const FactorInputs in = factor_inputs(poses, ids0, ids1, obs, prec,
                                        prec_kind, fmask, loss_params);
  const auto s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(chi2);
  if (nslot == 2) {
    residual_kernel<2><<<blocks_for(F, kThreads), kThreads, 0, s>>>(
        in, loss, out, F);
  } else {
    residual_kernel<1><<<blocks_for(F, kThreads), kThreads, 0, s>>>(
        in, loss, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same inputs and smask (F, nslot) bool; out: r (F, 6), j0, j1 (F,
// 36), chi2 (F,), dl (F,), d0, d1 (F, 6), all float32 and 16-byte aligned
// (j1, d1 null for one slot).
extern "C" int gt_pose_linearize(const void* poses, const void* ids0,
                                 const void* ids1, const void* obs,
                                 const void* prec, int prec_kind,
                                 const void* smask, const void* fmask,
                                 const void* loss_params, void* r, void* j0,
                                 void* j1, void* chi2, void* dl, void* d0,
                                 void* d1, long long F, int nslot, int loss,
                                 void* stream) {
  if (F < 0 || !valid(nslot, ids1, prec_kind) || !valid_loss(loss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  const void* outs[] = {r, j0, chi2, dl, d0, nslot == 2 ? j1 : j0,
                        nslot == 2 ? d1 : d0};
  for (const void* p : outs) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const FactorInputs in = factor_inputs(poses, ids0, ids1, obs, prec,
                                        prec_kind, fmask, loss_params);
  LinearizeOutputs out;
  out.r = static_cast<float*>(r);
  out.j[0] = static_cast<float*>(j0);
  out.j[1] = static_cast<float*>(j1);
  out.chi2 = static_cast<float*>(chi2);
  out.dl = static_cast<float*>(dl);
  out.diag[0] = static_cast<float*>(d0);
  out.diag[1] = static_cast<float*>(d1);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool* sm = static_cast<const bool*>(smask);
  if (nslot == 2) {
    linearize_kernel<2><<<blocks_for(F, kFactors), kFactors * 12, 0, s>>>(
        in, sm, loss, out, F);
  } else {
    linearize_kernel<1><<<blocks_for(F, kFactors), kFactors * 6, 0, s>>>(
        in, sm, loss, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

// j0, j1 (F, 36), r (F, 6), dl (F,): float32; prec as above; sc0, sc1
// (n_s + 1, 6) float32 padded scale rows, all null for no scaling; rows0,
// rows1 (F,) int64. Out: j0_out, j1_out in the storage type, b0, b1 (F, 6)
// float32. j, r, dl and the outputs 16-byte aligned; the second slot's
// pointers null for one slot.
#define GT_POSE_SCALE_B(SUFFIX, TYPE)                                        \
  extern "C" int gt_pose_scale_b_##SUFFIX(                                   \
      const void* j0, const void* j1, const void* r, const void* dl,         \
      const void* prec, int prec_kind, const void* sc0, const void* sc1,     \
      const void* rows0, const void* rows1, void* j0_out, void* j1_out,      \
      void* b0, void* b1, long long F, int nslot, void* stream) {            \
    return scale_b<TYPE>(j0, j1, r, dl, prec, prec_kind, sc0, sc1, rows0,    \
                         rows1, j0_out, j1_out, b0, b1, F, nslot, stream);   \
  }
GT_POSE_SCALE_B(f32, float)
GT_POSE_SCALE_B(bf16, __nv_bfloat16)
GT_POSE_SCALE_B(f16, __half)
#undef GT_POSE_SCALE_B

// poses (V, 7), dx, sc (dim_x,) float32; the type's rows start at dx[start],
// n_rows of 6; active_row (V,) int64 (n_rows: the trash row), active (V,)
// bool; out (V, 7) float32, 16-byte aligned.
extern "C" int gt_pose_update(const void* poses, const void* dx,
                              const void* sc, long long start,
                              long long n_rows, const void* active_row,
                              const void* active, void* out, long long V,
                              void* stream) {
  if (V < 0 || start < 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (V == 0) return 0;
  if (!aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  update_kernel<<<blocks_for(V, kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(poses), static_cast<const float*>(dx),
      static_cast<const float*>(sc), start, n_rows,
      static_cast<const long long*>(active_row),
      static_cast<const bool*>(active), static_cast<float*>(out), V);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_pose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
