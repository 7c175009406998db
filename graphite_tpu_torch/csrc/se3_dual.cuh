// The SE(3) pose-graph residuals and their forward-mode derivative, one
// factor and one tangent direction at a time, for kernel K11 (pose.cu).
//
// This is models/lie.py and models/pose_graph.py written over two number
// types: float, a value with no tangent (the vertex parameters, the
// measurement), and Dual, a float32 value with its tangent along one
// direction. Instantiated with Dual it gives what linearize's AUTO branch
// gets from torch.func.jvp: the residual of se3_retract(x, delta) at
// delta = 0 and its derivative along one basis direction of delta, bit for
// bit. So every operation is PyTorch's, with PyTorch's forward-mode rule
// for its tangent (tools/autograd/derivatives.yaml, `result:`):
//   a * b       a_t b + a b_t            a / b   (a_t - b_t q) / b, q = a / b
//   a + b, a - b  a_t + b_t, a_t - b_t   -a      -a_t
//   where(c, a, b)  where(c, a_t, b_t)   sqrt(x) x_t / (2 sqrt(x))
//   sin(x)  x_t cos(x)    cos(x)  x_t (-sin(x))
//   atan2(y, x)  (-y x_t + x y_t) / (y^2 + x^2)
//   |x|  x_t sgn(x)       sign(x)  a zero tangent (+0.0)
//   x.to(dtype)  x_t.to(dtype)
// An operand with no tangent contributes no term (PyTorch passes it an
// efficient zero tensor, which add and mul skip: c - a gives -a_t, with no
// rounding of a sum with 0), except in where, whose unselected-side zero
// is a real +0.0. A tangent that is zero but present (the other slot's
// delta, every direction but one) is carried as +0.0 and goes through
// every operation, so that each -0.0 and +0.0 comes out as it does there.
//
// The rules of the arithmetic are K7's (bal.cu): no multiply-add
// contraction (nvcc -fmad=false; the host build -ffp-contract=off), sums
// left to right as Python writes them, Python constants rounded to
// float32, IEEE division, sin / cos / atan2 / sqrt in float64 and rounded
// (lie.py's _in_f64 and sqrt_rn), comparisons with the float32 value of
// the constant. Both sides of every small-angle where are evaluated, as
// in lie.py.
//
// The header compiles for the host too (no __CUDACC__): the CPU tests
// build it with g++ and hold it bit for bit against the jvp branch.

#pragma once

#ifdef __CUDACC__
#define GT_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define GT_HD inline
#endif

namespace se3 {

struct Dual {
  float v;  // the value
  float t;  // its tangent along this thread's direction
};

// ---- arithmetic -----------------------------------------------------------

GT_HD Dual operator*(Dual a, Dual b) { return {a.v * b.v, b.t * a.v + a.t * b.v}; }
GT_HD Dual operator*(Dual a, float b) { return {a.v * b, a.t * b}; }
GT_HD Dual operator*(float a, Dual b) { return {a * b.v, b.t * a}; }
GT_HD Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.t + b.t}; }
GT_HD Dual operator+(Dual a, float b) { return {a.v + b, a.t}; }
GT_HD Dual operator+(float a, Dual b) { return {a + b.v, b.t}; }
GT_HD Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.t - b.t}; }
GT_HD Dual operator-(Dual a, float b) { return {a.v - b, a.t}; }
GT_HD Dual operator-(float a, Dual b) { return {a - b.v, -b.t}; }
GT_HD Dual operator-(Dual a) { return {-a.v, -a.t}; }
GT_HD Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.t - b.t * q) / b.v};
}
GT_HD Dual operator/(Dual a, float b) { return {a.v / b, a.t / b}; }
GT_HD Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return {q, -(b.t * q) / b.v};
}

GT_HD float value(float a) { return a; }
GT_HD float value(Dual a) { return a.v; }

// torch.where(c, a, b); a side with no tangent selects a +0.0 tangent
GT_HD float where(bool c, float a, float b) { return c ? a : b; }
GT_HD Dual where(bool c, Dual a, Dual b) { return c ? a : b; }
GT_HD Dual where(bool c, float a, Dual b) {
  return c ? Dual{a, 0.0f} : b;
}
GT_HD Dual where(bool c, Dual a, float b) {
  return c ? a : Dual{b, 0.0f};
}

// precision.sqrt_rn: the float64 square root, rounded
GT_HD float sqrt_rn(float a) {
  return static_cast<float>(sqrt(static_cast<double>(a)));
}
GT_HD Dual sqrt_rn(Dual a) {
  const double s = sqrt(static_cast<double>(a.v));
  return {static_cast<float>(s),
          static_cast<float>(static_cast<double>(a.t) / (2.0 * s))};
}

// lie._sin / lie._cos: float64, rounded
GT_HD float sin64(float a) {
  return static_cast<float>(sin(static_cast<double>(a)));
}
GT_HD Dual sin64(Dual a) {
  const double x = a.v;
  return {static_cast<float>(sin(x)),
          static_cast<float>(static_cast<double>(a.t) * cos(x))};
}
GT_HD float cos64(float a) {
  return static_cast<float>(cos(static_cast<double>(a)));
}
GT_HD Dual cos64(Dual a) {
  const double x = a.v;
  return {static_cast<float>(cos(x)),
          static_cast<float>(static_cast<double>(a.t) * -sin(x))};
}

// _in_f64(torch.atan2, y, x)
GT_HD float atan2_64(float y, float x) {
  return static_cast<float>(
      atan2(static_cast<double>(y), static_cast<double>(x)));
}
GT_HD Dual atan2_64(Dual y, Dual x) {
  const double yv = y.v, xv = x.v, yt = y.t, xt = x.t;
  return {static_cast<float>(atan2(yv, xv)),
          static_cast<float>((-yv * xt + xv * yt) / (yv * yv + xv * xv))};
}

// torch.sign and Tensor.abs
GT_HD float sgn(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : (a == 0.0f ? 0.0f : a));
}
GT_HD float sign(float a) { return sgn(a); }
GT_HD Dual sign(Dual a) { return {sgn(a.v), 0.0f}; }
GT_HD float absv(float a) { return fabsf(a); }
GT_HD Dual absv(Dual a) { return {fabsf(a.v), a.t * sgn(a.v)}; }

// ---- vectors, quaternions (x, y, z, w), poses -----------------------------

template <class T>
struct V3 {
  T x, y, z;
};

template <class T>
struct Q4 {
  T x, y, z, w;
};

template <class T>
struct Pose {  // (tx ty tz qx qy qz qw)
  V3<T> t;
  Q4<T> q;
};

// lie._dot: left to right
template <class A, class B>
GT_HD auto dot3(const V3<A>& a, const V3<B>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <class A>
GT_HD auto dot4(const Q4<A>& a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}

template <class A, class B>
GT_HD auto cross(const V3<A>& a, const V3<B>& b) {
  using T = decltype(a.x * b.x);
  return V3<T>{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
               a.x * b.y - a.y * b.x};
}

template <class A, class B>
GT_HD auto quat_mul(const Q4<A>& p, const Q4<B>& q) {
  using T = decltype(p.x * q.x);
  return Q4<T>{p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y,
               p.w * q.y - p.x * q.z + p.y * q.w + p.z * q.x,
               p.w * q.z + p.x * q.y - p.y * q.x + p.z * q.w,
               p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z};
}

// v + 2 (w (u x v) + u x (u x v))
template <class A, class B>
GT_HD auto quat_rotate(const Q4<A>& q, const V3<B>& v) {
  const V3<A> u{q.x, q.y, q.z};
  const auto uv = cross(u, v);
  const auto uuv = cross(u, uv);
  using T = decltype(uv.x);
  return V3<T>{v.x + 2.0f * (q.w * uv.x + uuv.x),
               v.y + 2.0f * (q.w * uv.y + uuv.y),
               v.z + 2.0f * (q.w * uv.z + uuv.z)};
}

template <class A>
GT_HD Q4<A> quat_normalize(const Q4<A>& q) {
  const A n = sqrt_rn(dot4(q));
  return {q.x / n, q.y / n, q.z / n, q.w / n};
}

// Python constants as float32, as PyTorch hands them to the op
constexpr float kEps2 = static_cast<float>(1e-16);
constexpr float kWTiny = static_cast<float>(1e-12);
constexpr float kInv48 = static_cast<float>(1.0 / 48.0);
constexpr float kInv8 = static_cast<float>(1.0 / 8.0);
constexpr float kInv24 = static_cast<float>(1.0 / 24.0);
constexpr float kInv6 = static_cast<float>(1.0 / 6.0);
constexpr float kInv120 = static_cast<float>(1.0 / 120.0);
constexpr float kInv12 = static_cast<float>(1.0 / 12.0);
constexpr float kInv720 = static_cast<float>(1.0 / 720.0);

// so3_exp_quat: axis-angle -> unit quaternion
template <class A>
GT_HD Q4<A> so3_exp_quat(const V3<A>& phi) {
  const A theta2 = dot3(phi, phi);
  const bool small = value(theta2) < kEps2;
  const A theta2_safe = where(small, 1.0f, theta2);
  const A theta = sqrt_rn(theta2_safe);
  const A half = 0.5f * theta;
  const A k = where(small, 0.5f - theta2 * kInv48, sin64(half) / theta);
  const A w = where(small, 1.0f - theta2 * kInv8, cos64(half));
  return {k * phi.x, k * phi.y, k * phi.z, w};
}

// so3_log: unit quaternion -> axis-angle
template <class A>
GT_HD V3<A> so3_log(const Q4<A>& q) {
  const V3<A> u{q.x, q.y, q.z};
  const A n2 = dot3(u, u);
  const bool small = value(n2) < kEps2;
  const A n = sqrt_rn(where(small, 1.0f, n2));
  const A w_abs = absv(q.w);
  const A theta = 2.0f * atan2_64(n, w_abs);
  const A k = where(small,
                    2.0f / where(value(w_abs) < kWTiny, 1.0f, q.w),
                    theta / n * sign(q.w));
  return {k * u.x, k * u.y, k * u.z};
}

template <class A, class B>
GT_HD auto se3_compose(const Pose<A>& a, const Pose<B>& b) {
  const auto r = quat_rotate(a.q, b.t);
  using T = decltype(r.x);
  return Pose<T>{{a.t.x + r.x, a.t.y + r.y, a.t.z + r.z},
                 quat_mul(a.q, b.q)};
}

template <class A>
GT_HD Pose<A> se3_inverse(const Pose<A>& x) {
  const Q4<A> qi{-x.q.x, -x.q.y, -x.q.z, x.q.w};
  const V3<A> r = quat_rotate(qi, x.t);
  return {{-r.x, -r.y, -r.z}, qi};
}

// se3_exp: tangent (rho, phi) -> pose
template <class A>
GT_HD Pose<A> se3_exp(const V3<A>& rho, const V3<A>& phi) {
  const Q4<A> q = so3_exp_quat(phi);
  const A theta2 = dot3(phi, phi);
  const bool small = value(theta2) < kEps2;
  const A theta2_safe = where(small, 1.0f, theta2);
  const A theta = sqrt_rn(theta2_safe);
  const A a = where(small, 0.5f - theta2 * kInv24,
                    (1.0f - cos64(theta)) / theta2_safe);
  const A b = where(small, kInv6 - theta2 * kInv120,
                    (theta - sin64(theta)) / (theta2_safe * theta));
  const V3<A> px = cross(phi, rho);
  const V3<A> ppx = cross(phi, px);
  return {{rho.x + a * px.x + b * ppx.x, rho.y + a * px.y + b * ppx.y,
           rho.z + a * px.z + b * ppx.z},
          q};
}

// se3_log: pose -> tangent (rho, phi), written into r[0..5]
template <class A>
GT_HD void se3_log(const Pose<A>& x, A* r) {
  const V3<A> phi = so3_log(x.q);
  const V3<A>& t = x.t;
  const A theta2 = dot3(phi, phi);
  const bool small = value(theta2) < kEps2;
  const A theta2_safe = where(small, 1.0f, theta2);
  const A theta = sqrt_rn(theta2_safe);
  const A half = 0.5f * theta;
  const A cot_term =
      where(small, kInv12 + theta2 * kInv720,
            (1.0f - half * cos64(half) / sin64(half)) / theta2_safe);
  const V3<A> px = cross(phi, t);
  const V3<A> ppx = cross(phi, px);
  r[0] = t.x - 0.5f * px.x + cot_term * ppx.x;
  r[1] = t.y - 0.5f * px.y + cot_term * ppx.y;
  r[2] = t.z - 0.5f * px.z + cot_term * ppx.z;
  r[3] = phi.x;
  r[4] = phi.y;
  r[5] = phi.z;
}

// se3_retract(x, delta) = x * Exp(delta), the quaternion re-normalized
template <class A>
GT_HD Pose<A> se3_retract(const Pose<float>& x, const A* delta) {
  const Pose<A> e = se3_exp(V3<A>{delta[0], delta[1], delta[2]},
                            V3<A>{delta[3], delta[4], delta[5]});
  const Pose<A> out = se3_compose(x, e);
  return {out.t, quat_normalize(out.q)};
}

// se3_between_residual: Log(Z^-1 (a^-1 b)); se3_prior_residual:
// Log(Z^-1 x)
template <class A>
GT_HD void between_residual(const Pose<A>& a, const Pose<A>& b,
                            const Pose<float>& z, A* r) {
  const Pose<A> rel = se3_compose(se3_inverse(a), b);
  se3_log(se3_compose(se3_inverse(z), rel), r);
}

template <class A>
GT_HD void prior_residual(const Pose<A>& x, const Pose<float>& z, A* r) {
  se3_log(se3_compose(se3_inverse(z), x), r);
}

GT_HD Pose<float> load_pose(const float* p) {
  return {{p[0], p[1], p[2]}, {p[3], p[4], p[5], p[6]}};
}

// The residual of a factor of NSLOT slots at x (the vertices' parameters,
// 7 floats each) and z (the measurement): r, float.
template <int NSLOT>
GT_HD void residual(const float* const* x, const float* z, float* r) {
  const Pose<float> zp = load_pose(z);
  if (NSLOT == 2) {
    between_residual(load_pose(x[0]), load_pose(x[1]), zp, r);
  } else {
    prior_residual(load_pose(x[0]), zp, r);
  }
}

// The same with the tangent along direction k of the factor's stacked
// deltas (k < 6: slot 0's component k, else slot 1's component k - 6),
// each slot retracted by its delta at 0: r the residual, jt its derivative
// (column k of the factor's Jacobian, before the slot mask).
template <int NSLOT>
GT_HD void residual_jvp(const float* const* x, const float* z, int k,
                        float* r, float* jt) {
  Pose<Dual> xs[NSLOT];
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    Dual delta[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      delta[c] = Dual{0.0f, k == 6 * s + c ? 1.0f : 0.0f};
    }
    xs[s] = se3_retract(load_pose(x[s]), delta);
  }
  Dual rd[6];
  const Pose<float> zp = load_pose(z);
  if (NSLOT == 2) {
    between_residual(xs[0], xs[NSLOT - 1], zp, rd);
  } else {
    prior_residual(xs[0], zp, rd);
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    r[e] = rd[e].v;
    jt[e] = rd[e].t;
  }
}

}  // namespace se3
