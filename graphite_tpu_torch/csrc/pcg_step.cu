// K12: the vector work of one preconditioned CG step (ops/pcg_loop.py) in
// three launches, on Hopper (sm_90a).
//
// Replaces no pl.pallas_call: the JAX package's CG step is one
// lax.while_loop body (graphite_tpu/ops/pcg_loop.py:19-70) whose vector
// updates, block-Jacobi-Schur apply (one einsum,
// graphite_tpu/preconditioners/block_jacobi_schur.py:62-74) and flags XLA
// fuses into a few loops. The port ran them as ~60 PyTorch launches a step
// on vectors of dim_p entries (16,002 at Venice-1778): the residual's
// normalisation, 2 d - 1 products and adds of the inverses per pose type,
// the concatenation into a vector, the updates, five where / copy pairs
// and the flags. The three entries:
// - bjs_apply: z = M^-1 (r / |r|) for block-Jacobi-Schur, every pose
//   type's rows at its segment of the (dim_p,) vector; |r| is the
//   correctly rounded square root of rr = r.r (K9's dot), 1 where it is 0
//   (pcg_loop.normalize); z_row = sum_j inv[:, j] y_j, each product
//   rounded on its own and the terms added left to right over j
//   (ops/blockfmt.flat_block_mv), in the inverses' dtype (y cast to it,
//   the sum cast back to the vectors').
// - cg_advance: alpha = rz / (p.v); x_new = x + alpha p, r_new = r - alpha
//   v, each product and sum rounded on its own (-fmad=false,
//   ops/cuda/build.py), as PyTorch's separate mul and add round them.
// - cg_commit: the tail of pcg_loop.run_pcg_fixed's step: reject =
//   |rz_new| > ratio rz_min or rz_new NaN; unless rejected p = z_new +
//   (rz_new / rz) p and x, r, z take x_new, r_new, z_new (a rejected step
//   keeps every value, as torch.where does); then rz_min = minimum(rz_min,
//   |rz_new|) (NaN first, as torch.minimum), k += 1, rz = rejected ? rz :
//   rz_new and done = reject | |rz| < tol | rz == 0, the ratio and tol
//   rounded to the vectors' dtype as PyTorch rounds a Python scalar.
// Every scalar is read from device memory (K9's dots, the state): no host
// read. cg_commit's CTAs all read rz and rz_min before any CTA writes
// them: each CTA's first thread reads them into shared memory, and the
// last CTA to count itself on an integer ticket (a fence, then atomicAdd,
// as K9's) writes the scalars and resets the ticket, so the next launch
// (a replayed graph's too) finds it at 0. The ticket is the caller's, one
// per CG solve (pcg_loop._cg), so two solves may run at once on two
// streams.
//
// Bound: bytes. At Venice (dim_p = 16,002, float32) bjs_apply reads the
// 1,778 9x9 inverses and r (0.64 MB), cg_advance four vectors and writes
// two (0.38 MB), cg_commit reads up to seven and writes four (0.70 MB):
// 0.1-0.2 us each at 3.35 TB/s, under a launch's ~1.2 us latency. So the
// design is one pass, one thread an output entry in a grid-stride loop,
// few enough CTAs to start at once, and no shared-memory staging (L1 holds
// a row's inverse and y for its d threads).
//
// The kernels allocate nothing, never synchronise with the host and launch
// on the given stream: they run inside a captured CUDA graph and its
// conditional and "while" nodes (the CG step of run_pcg_fixed).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 8;  // pose types of a (dim_p,) vector
constexpr long long kMaxCtas = 132 * 8;

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// The pose types' segments: type q's rows cover [start[q], start[q + 1])
// (start[count] = dim_p), dim[q] entries a row, its inverses inv[q]
// ((rows, dim dim) row-major; null: the segment is 0).
struct Segments {
  const void* inv[kMaxSegments];
  long long start[kMaxSegments + 1];
  int dim[kMaxSegments];
  int count;
};

unsigned grid_for(long long n) {
  const long long ctas = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(ctas < 1 ? 1 : ctas < kMaxCtas ? ctas
                                                                : kMaxCtas);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    bjs_apply_kernel(const T* __restrict__ r, const T* __restrict__ rr,
                     Segments s, T* __restrict__ out) {
  const T rnorm = sqrt_rn(*rr);
  const T denom = rnorm == static_cast<T>(0) ? static_cast<T>(1) : rnorm;
  const long long n = s.start[s.count];
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    int q = 0;
    while (e >= s.start[q + 1]) ++q;
    const I* inv = static_cast<const I*>(s.inv[q]);
    if (inv == nullptr) {
      out[e] = static_cast<T>(0);
      continue;
    }
    const int d = s.dim[q];
    const long long local = e - s.start[q];
    const long long row = local / d;
    const int i = static_cast<int>(local - row * d);
    const I* a = inv + (row * d + i) * d;
    const T* y = r + s.start[q] + row * d;
    I acc = static_cast<I>(0);
    for (int j = 0; j < d; ++j) {
      const I term = a[j] * static_cast<I>(y[j] / denom);
      acc = j == 0 ? term : acc + term;
    }
    out[e] = static_cast<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_advance_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ p, const T* __restrict__ v,
                      const T* __restrict__ rz, const T* __restrict__ pv,
                      T* __restrict__ x_out, T* __restrict__ r_out,
                      long long n) {
  const T alpha = *rz / *pv;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const T ap = alpha * p[e];
    const T av = alpha * v[e];
    x_out[e] = x[e] + ap;
    r_out[e] = r[e] - av;
  }
}

// torch.minimum: a NaN operand (the first one first), else the smaller
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_commit_kernel(T* __restrict__ x, T* __restrict__ r,
                     T* __restrict__ p, T* __restrict__ z,
                     const T* __restrict__ x_new, const T* __restrict__ r_new,
                     const T* __restrict__ z_new, T* __restrict__ rz,
                     const T* __restrict__ rz_new, T* __restrict__ rz_min,
                     long long* __restrict__ k, bool* __restrict__ done,
                     unsigned int* __restrict__ ticket, long long n,
                     T ratio, T tol) {
  __shared__ T scalars[3];
  __shared__ bool last;
  if (threadIdx.x == 0) {
    scalars[0] = *rz;
    scalars[1] = *rz_new;
    scalars[2] = *rz_min;
  }
  __syncthreads();
  const T rz_old = scalars[0], rzn = scalars[1], rzm = scalars[2];
  const T mag = fabs(rzn);
  const bool reject = mag > ratio * rzm || rzn != rzn;
  if (!reject) {
    const T beta = rzn / rz_old;
    for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
      const T bp = beta * p[e];
      const T zn = z_new[e];
      p[e] = zn + bp;
      x[e] = x_new[e];
      r[e] = r_new[e];
      z[e] = zn;
    }
  }
  // every CTA has read the scalars before the last one writes them
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  const T kept = reject ? rz_old : rzn;
  *rz_min = minimum(rzm, mag);
  *k += 1;
  *rz = kept;
  *done = reject || fabs(kept) < tol || kept == static_cast<T>(0);
  atomicExch(ticket, 0u);
}

template <typename T, typename I>
int bjs_apply(const void* r, const void* rr, const void* const* inv,
              const long long* starts, const int* dims, int count, void* out,
              void* stream) {
  if (count < 1 || count > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Segments s;
  s.count = count;
  for (int q = 0; q < count; ++q) {
    if (dims[q] < 1 || starts[q + 1] < starts[q]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    s.inv[q] = inv[q];
    s.start[q] = starts[q];
    s.dim[q] = dims[q];
  }
  s.start[count] = starts[count];
  if (starts[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (starts[count] == 0) return 0;
  bjs_apply_kernel<T, I><<<grid_for(starts[count]), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(rr), s,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cg_advance(const void* x, const void* r, const void* p, const void* v,
               const void* rz, const void* pv, void* x_out, void* r_out,
               long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cg_advance_kernel<T><<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(v),
      static_cast<const T*>(rz), static_cast<const T*>(pv),
      static_cast<T*>(x_out), static_cast<T*>(r_out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cg_commit(void* x, void* r, void* p, void* z, const void* x_new,
              const void* r_new, const void* z_new, void* rz,
              const void* rz_new, void* rz_min, void* k, void* done,
              void* ticket, long long n, double ratio, double tol,
              void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cg_commit_kernel<T><<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(p),
      static_cast<T*>(z), static_cast<const T*>(x_new),
      static_cast<const T*>(r_new), static_cast<const T*>(z_new),
      static_cast<T*>(rz), static_cast<const T*>(rz_new),
      static_cast<T*>(rz_min), static_cast<long long*>(k),
      static_cast<bool*>(done), static_cast<unsigned int*>(ticket), n,
      static_cast<T>(ratio),
      static_cast<T>(tol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, out: the (dim_p,) vectors (vector dtype V); rr: r.r (V); inv[q]:
// pose type q's (rows, d d) inverses (dtype I) or null; starts: count + 1
// entries, starts[0] = 0, starts[count] = dim_p; dims: count entries.
// Suffix: V then I. Launches on `stream` and returns the cudaError_t code
// (0 on success).
#define GT_BJS_APPLY(V, I, TV, TI)                                          \
  extern "C" int gt_bjs_apply_##V##_##I(                                    \
      const void* r, const void* rr, const void* const* inv,               \
      const long long* starts, const int* dims, int count, void* out,      \
      void* stream) {                                                      \
    return bjs_apply<TV, TI>(r, rr, inv, starts, dims, count, out, stream); \
  }
GT_BJS_APPLY(f32, f32, float, float)
GT_BJS_APPLY(f32, f64, float, double)
GT_BJS_APPLY(f64, f32, double, float)
GT_BJS_APPLY(f64, f64, double, double)
#undef GT_BJS_APPLY

// x, r, p, v, x_out, r_out: n entries; rz, pv: one each.
extern "C" int gt_cg_advance_f32(const void* x, const void* r, const void* p,
                                 const void* v, const void* rz,
                                 const void* pv, void* x_out, void* r_out,
                                 long long n, void* stream) {
  return cg_advance<float>(x, r, p, v, rz, pv, x_out, r_out, n, stream);
}

extern "C" int gt_cg_advance_f64(const void* x, const void* r, const void* p,
                                 const void* v, const void* rz,
                                 const void* pv, void* x_out, void* r_out,
                                 long long n, void* stream) {
  return cg_advance<double>(x, r, p, v, rz, pv, x_out, r_out, n, stream);
}

// x, r, p, z (in place), x_new, r_new, z_new: n entries; rz, rz_min (in
// place), rz_new: one each; k: one int64 (in place); done: one bool;
// ticket: one int32, 0 between launches (each launch leaves it 0).
#define GT_CG_COMMIT(S, T)                                                  \
  extern "C" int gt_cg_commit_##S(                                          \
      void* x, void* r, void* p, void* z, const void* x_new,               \
      const void* r_new, const void* z_new, void* rz, const void* rz_new,  \
      void* rz_min, void* k, void* done, void* ticket, long long n,        \
      double ratio, double tol, void* stream) {                            \
    return cg_commit<T>(x, r, p, z, x_new, r_new, z_new, rz, rz_new,       \
                        rz_min, k, done, ticket, n, ratio, tol, stream);   \
  }
GT_CG_COMMIT(f32, float)
GT_CG_COMMIT(f64, double)
#undef GT_CG_COMMIT

extern "C" const char* gt_pcg_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
