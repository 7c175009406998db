// The per-factor pieces K7 (bal.cu) and K11 (pose.cu) share: the robust
// loss on a factor's squared error (loss.py), the storage casts of the
// stored Jacobians (precision.clamp_to_storage) and PyTorch's CUDA
// semantics of the ops they go through, so that each entry's bits are its
// plain version's:
// - sqrt_rn: the float64 square root, rounded (precision.sqrt_rn);
// - t_maximum, t_clamp_min: torch.maximum and Tensor.clamp_min (a NaN
//   operand is returned, else fmaxf);
// - t_recip: 1.0 / x is Tensor.__rtruediv__, reciprocal(x) * 1.0;
// - Cauchy's float32 log1pf is the function PyTorch's CUDA log1p calls;
// - Storage<S>::store: fp16 clamped to +-65504 first, then
//   __float2half_rn; bf16 __float2bfloat16_rn; load widens exactly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

enum Loss { kDefault = 0, kHuber = 1, kCauchy = 2 };

constexpr float kClampMin = static_cast<float>(1e-30);
constexpr float kFp16Max = 65504.0f;

__device__ __forceinline__ float sqrt_rn(float x) {
  return static_cast<float>(sqrt(static_cast<double>(x)));
}

__device__ __forceinline__ float t_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float t_recip(float x) { return (1.0f / x) * 1.0f; }

// The robust loss on the squared error x = r^T P r (loss.py): its value
// and its derivative dL.
template <int LOSS>
__device__ __forceinline__ void robust(float x, float p, float* value,
                                       float* deriv) {
  if (LOSS == kHuber) {
    const float d2 = p * p;
    const float safe = sqrt_rn(t_maximum(x, t_clamp_min(d2, kClampMin)));
    *value = x <= d2 ? x : 2.0f * safe * p - d2;
    *deriv = x <= d2 ? 1.0f : p / safe;
  } else if (LOSS == kCauchy) {
    const float c2 = p * p;
    const float q = x / c2;
    *value = c2 * log1pf(q);
    *deriv = t_recip(1.0f + q);
  } else {
    *value = x;
    *deriv = 1.0f;
  }
}

template <typename S>
struct Storage;

template <>
struct Storage<float> {
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float load(float x) { return x; }
};

template <>
struct Storage<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
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
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
};

}  // namespace
