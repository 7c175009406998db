// The per-factor pieces K7 (bal.cu) and K11 (pose.cu) share: the robust
// loss on a factor's squared error (loss.py), the storage casts of the
// stored Jacobians (precision.clamp_to_storage) and PyTorch's CUDA
// semantics of the ops they go through, so that each entry's bits are its
// plain version's. Each takes float (a float32 graph) or double (a
// float64 graph, K7's float64 instances):
// - sqrt_rn: float, the float64 square root, rounded (precision.sqrt_rn);
//   double, the IEEE square root (precision.sqrt_rn is torch.sqrt there);
// - t_maximum, t_clamp_min: torch.maximum and Tensor.clamp_min (a NaN
//   operand is returned, else fmaxf / fmax);
// - t_recip: 1.0 / x is Tensor.__rtruediv__, reciprocal(x) * 1.0;
// - t_log1p: log1pf or log1p, the functions PyTorch's CUDA log1p calls;
// - Storage<S>::store: fp16 clamped to +-65504 first, then
//   __float2half_rn; bf16 __float2bfloat16_rn; from a double, the value is
//   first rounded to float, as PyTorch's double -> bf16 / fp16 casts do
//   (c10::BFloat16 and c10::Half are built from a float); load widens
//   exactly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

enum Loss { kDefault = 0, kHuber = 1, kCauchy = 2 };

constexpr double kClampMin = 1e-30;  // Huber's clamp_min(1e-30)
constexpr float kFp16Max = 65504.0f;

__device__ __forceinline__ float sqrt_rn(float x) {
  return static_cast<float>(sqrt(static_cast<double>(x)));
}

__device__ __forceinline__ double sqrt_rn(double x) { return sqrt(x); }

__device__ __forceinline__ float t_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ double t_maximum(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmax(a, b);
}

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ double t_clamp_min(double v, double lo) {
  return v != v ? v : fmax(v, lo);
}

template <typename T>
__device__ __forceinline__ T t_recip(T x) {
  return (static_cast<T>(1) / x) * static_cast<T>(1);
}

__device__ __forceinline__ float t_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double t_log1p(double x) { return log1p(x); }

// The robust loss on the squared error x = r^T P r (loss.py): its value
// and its derivative dL, in x's type (a Python constant reaches the op in
// the tensor's dtype).
template <int LOSS, typename T>
__device__ __forceinline__ void robust(T x, T p, T* value, T* deriv) {
  const T one = static_cast<T>(1);
  if (LOSS == kHuber) {
    const T d2 = p * p;
    const T safe =
        sqrt_rn(t_maximum(x, t_clamp_min(d2, static_cast<T>(kClampMin))));
    *value = x <= d2 ? x : static_cast<T>(2) * safe * p - d2;
    *deriv = x <= d2 ? one : p / safe;
  } else if (LOSS == kCauchy) {
    const T c2 = p * p;
    const T q = x / c2;
    *value = c2 * t_log1p(q);
    *deriv = t_recip(one + q);
  } else {
    *value = x;
    *deriv = one;
  }
}

template <typename S>
struct Storage;

template <>
struct Storage<double> {
  static __device__ __forceinline__ double store(double x) { return x; }
  static __device__ __forceinline__ double load(double x) { return x; }
};

template <>
struct Storage<float> {
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float store(double x) {
    return static_cast<float>(x);
  }
  static __device__ __forceinline__ float load(float x) { return x; }
};

template <>
struct Storage<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(double x) {
    return __float2bfloat16_rn(static_cast<float>(x));
  }
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <>
struct Storage<__half> {
  // clamp_to_storage: Tensor.clamp(-65504, 65504), then the cast
  static __device__ __forceinline__ __half store(float x) {
    const float c = x != x ? x : fminf(fmaxf(x, -kFp16Max), kFp16Max);
    return __float2half_rn(c);
  }
  static __device__ __forceinline__ __half store(double x) {
    const double m = kFp16Max;
    const double c = x != x ? x : fmin(fmax(x, -m), m);
    return __float2half_rn(static_cast<float>(c));
  }
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
};

}  // namespace
