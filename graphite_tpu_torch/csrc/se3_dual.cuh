// The SE(3) pose-graph residuals and their forward-mode derivative, one
// factor and one tangent direction at a time, for kernel K11 (pose.cu).
//
// This is models/lie.py and models/pose_graph.py written over two number
// types of one real type T (float in a float32 graph, double in a float64
// one): T, a value with no tangent (the vertex parameters, the
// measurement), and Dual<T>, a value with its tangent along one
// direction. Instantiated with Dual<T> it gives what linearize's AUTO
// branch gets from torch.func.jvp: the residual of se3_retract(x, delta)
// at delta = 0 and its derivative along one basis direction of delta, bit
// for bit. So every operation is PyTorch's, with PyTorch's forward-mode
// rule for its tangent (tools/autograd/derivatives.yaml, `result:`):
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
// left to right as Python writes them, IEEE division. In float: Python
// constants rounded to float32, sin / cos / atan2 / sqrt in float64 and
// rounded (lie.py's _in_f64 and sqrt_rn), comparisons with the float32
// value of the constant. In double: Python constants and comparisons take
// the double itself (Real<T>: static_cast<T>(1.0 / 48.0), never an
// f-suffixed literal), and sin / cos / atan2 / sqrt are the double
// functions with nothing rounded (_in_f64 and sqrt_rn are the identity on
// float64). Both sides of every small-angle where are evaluated, as in
// lie.py.
//
// The header compiles for the host too (no __CUDACC__): the CPU tests
// build it with g++ and hold it against the jvp branch.

#pragma once

#ifdef __CUDACC__
#define GT_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define GT_HD inline
#endif

namespace se3 {

template <class T>
struct Dual {
  T v;  // the value
  T t;  // its tangent along this thread's direction
};

// The real type of a number type: T of T and of Dual<T>.
template <class A>
struct ScalarOf {
  using type = A;
};
template <class T>
struct ScalarOf<Dual<T>> {
  using type = T;
};
template <class A>
using scalar_t = typename ScalarOf<A>::type;

// Python constants in T, as PyTorch hands them to the op: rounded to
// float in a float32 graph, the double itself in a float64 graph
template <class T>
struct Real {
  static constexpr T kZero = static_cast<T>(0);
  static constexpr T kHalf = static_cast<T>(0.5);
  static constexpr T kOne = static_cast<T>(1);
  static constexpr T kTwo = static_cast<T>(2);
  static constexpr T kEps2 = static_cast<T>(1e-16);
  static constexpr T kWTiny = static_cast<T>(1e-12);
  static constexpr T kInv48 = static_cast<T>(1.0 / 48.0);
  static constexpr T kInv8 = static_cast<T>(1.0 / 8.0);
  static constexpr T kInv24 = static_cast<T>(1.0 / 24.0);
  static constexpr T kInv6 = static_cast<T>(1.0 / 6.0);
  static constexpr T kInv120 = static_cast<T>(1.0 / 120.0);
  static constexpr T kInv12 = static_cast<T>(1.0 / 12.0);
  static constexpr T kInv720 = static_cast<T>(1.0 / 720.0);
};

// ---- arithmetic -----------------------------------------------------------

template <class T>
GT_HD Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, b.t * a.v + a.t * b.v};
}
template <class T>
GT_HD Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.t * b}; }
template <class T>
GT_HD Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, b.t * a}; }
template <class T>
GT_HD Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.t + b.t};
}
template <class T>
GT_HD Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.t}; }
template <class T>
GT_HD Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.t}; }
template <class T>
GT_HD Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.t - b.t};
}
template <class T>
GT_HD Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.t}; }
template <class T>
GT_HD Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.t}; }
template <class T>
GT_HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.t}; }
template <class T>
GT_HD Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.t - b.t * q) / b.v};
}
template <class T>
GT_HD Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.t / b}; }
template <class T>
GT_HD Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  return {q, -(b.t * q) / b.v};
}

GT_HD float value(float a) { return a; }
GT_HD double value(double a) { return a; }
template <class T>
GT_HD T value(Dual<T> a) { return a.v; }

// torch.where(c, a, b); a side with no tangent selects a +0.0 tangent
GT_HD float where(bool c, float a, float b) { return c ? a : b; }
GT_HD double where(bool c, double a, double b) { return c ? a : b; }
template <class T>
GT_HD Dual<T> where(bool c, Dual<T> a, Dual<T> b) { return c ? a : b; }
template <class T>
GT_HD Dual<T> where(bool c, T a, Dual<T> b) {
  return c ? Dual<T>{a, Real<T>::kZero} : b;
}
template <class T>
GT_HD Dual<T> where(bool c, Dual<T> a, T b) {
  return c ? a : Dual<T>{b, Real<T>::kZero};
}

// The transcendentals take double: a float is widened, the results (value
// and tangent) are rounded to float (a no-op in double).

// precision.sqrt_rn: the float64 square root (rounded, in float)
GT_HD float sqrt_rn(float a) {
  return static_cast<float>(sqrt(static_cast<double>(a)));
}
GT_HD double sqrt_rn(double a) { return sqrt(a); }
template <class T>
GT_HD Dual<T> sqrt_rn(Dual<T> a) {
  const double s = sqrt(static_cast<double>(a.v));
  return {static_cast<T>(s),
          static_cast<T>(static_cast<double>(a.t) / (2.0 * s))};
}

// lie._sin / lie._cos
GT_HD float sin64(float a) {
  return static_cast<float>(sin(static_cast<double>(a)));
}
GT_HD double sin64(double a) { return sin(a); }
template <class T>
GT_HD Dual<T> sin64(Dual<T> a) {
  const double x = a.v;
  return {static_cast<T>(sin(x)),
          static_cast<T>(static_cast<double>(a.t) * cos(x))};
}
GT_HD float cos64(float a) {
  return static_cast<float>(cos(static_cast<double>(a)));
}
GT_HD double cos64(double a) { return cos(a); }
template <class T>
GT_HD Dual<T> cos64(Dual<T> a) {
  const double x = a.v;
  return {static_cast<T>(cos(x)),
          static_cast<T>(static_cast<double>(a.t) * -sin(x))};
}

// _in_f64(torch.atan2, y, x)
GT_HD float atan2_64(float y, float x) {
  return static_cast<float>(
      atan2(static_cast<double>(y), static_cast<double>(x)));
}
GT_HD double atan2_64(double y, double x) { return atan2(y, x); }
template <class T>
GT_HD Dual<T> atan2_64(Dual<T> y, Dual<T> x) {
  const double yv = y.v, xv = x.v, yt = y.t, xt = x.t;
  return {static_cast<T>(atan2(yv, xv)),
          static_cast<T>((-yv * xt + xv * yt) / (yv * yv + xv * xv))};
}

// torch.sign and Tensor.abs
template <class T>
GT_HD T sgn(T a) {
  using R = Real<T>;
  return a > R::kZero ? R::kOne
                      : (a < R::kZero ? -R::kOne : (a == R::kZero ? R::kZero
                                                                   : a));
}
GT_HD float sign(float a) { return sgn(a); }
GT_HD double sign(double a) { return sgn(a); }
template <class T>
GT_HD Dual<T> sign(Dual<T> a) { return {sgn(a.v), Real<T>::kZero}; }
GT_HD float absv(float a) { return fabsf(a); }
GT_HD double absv(double a) { return fabs(a); }
template <class T>
GT_HD Dual<T> absv(Dual<T> a) { return {absv(a.v), a.t * sgn(a.v)}; }

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
  const scalar_t<T> two = Real<scalar_t<T>>::kTwo;
  return V3<T>{v.x + two * (q.w * uv.x + uuv.x),
               v.y + two * (q.w * uv.y + uuv.y),
               v.z + two * (q.w * uv.z + uuv.z)};
}

template <class A>
GT_HD Q4<A> quat_normalize(const Q4<A>& q) {
  const A n = sqrt_rn(dot4(q));
  return {q.x / n, q.y / n, q.z / n, q.w / n};
}

// so3_exp_quat: axis-angle -> unit quaternion
template <class A>
GT_HD Q4<A> so3_exp_quat(const V3<A>& phi) {
  using R = Real<scalar_t<A>>;
  const A theta2 = dot3(phi, phi);
  const bool small = value(theta2) < R::kEps2;
  const A theta2_safe = where(small, R::kOne, theta2);
  const A theta = sqrt_rn(theta2_safe);
  const A half = R::kHalf * theta;
  const A k =
      where(small, R::kHalf - theta2 * R::kInv48, sin64(half) / theta);
  const A w = where(small, R::kOne - theta2 * R::kInv8, cos64(half));
  return {k * phi.x, k * phi.y, k * phi.z, w};
}

// so3_log: unit quaternion -> axis-angle
template <class A>
GT_HD V3<A> so3_log(const Q4<A>& q) {
  using R = Real<scalar_t<A>>;
  const V3<A> u{q.x, q.y, q.z};
  const A n2 = dot3(u, u);
  const bool small = value(n2) < R::kEps2;
  const A n = sqrt_rn(where(small, R::kOne, n2));
  const A w_abs = absv(q.w);
  const A theta = R::kTwo * atan2_64(n, w_abs);
  const A k = where(small,
                    R::kTwo / where(value(w_abs) < R::kWTiny, R::kOne, q.w),
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
  using R = Real<scalar_t<A>>;
  const Q4<A> q = so3_exp_quat(phi);
  const A theta2 = dot3(phi, phi);
  const bool small = value(theta2) < R::kEps2;
  const A theta2_safe = where(small, R::kOne, theta2);
  const A theta = sqrt_rn(theta2_safe);
  const A a = where(small, R::kHalf - theta2 * R::kInv24,
                    (R::kOne - cos64(theta)) / theta2_safe);
  const A b = where(small, R::kInv6 - theta2 * R::kInv120,
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
  using R = Real<scalar_t<A>>;
  const V3<A> phi = so3_log(x.q);
  const V3<A>& t = x.t;
  const A theta2 = dot3(phi, phi);
  const bool small = value(theta2) < R::kEps2;
  const A theta2_safe = where(small, R::kOne, theta2);
  const A theta = sqrt_rn(theta2_safe);
  const A half = R::kHalf * theta;
  const A cot_term =
      where(small, R::kInv12 + theta2 * R::kInv720,
            (R::kOne - half * cos64(half) / sin64(half)) / theta2_safe);
  const V3<A> px = cross(phi, t);
  const V3<A> ppx = cross(phi, px);
  r[0] = t.x - R::kHalf * px.x + cot_term * ppx.x;
  r[1] = t.y - R::kHalf * px.y + cot_term * ppx.y;
  r[2] = t.z - R::kHalf * px.z + cot_term * ppx.z;
  r[3] = phi.x;
  r[4] = phi.y;
  r[5] = phi.z;
}

// se3_retract(x, delta) = x * Exp(delta), the quaternion re-normalized
template <class A>
GT_HD Pose<A> se3_retract(const Pose<scalar_t<A>>& x, const A* delta) {
  const Pose<A> e = se3_exp(V3<A>{delta[0], delta[1], delta[2]},
                            V3<A>{delta[3], delta[4], delta[5]});
  const Pose<A> out = se3_compose(x, e);
  return {out.t, quat_normalize(out.q)};
}

// se3_between_residual: Log(Z^-1 (a^-1 b)); se3_prior_residual:
// Log(Z^-1 x)
template <class A>
GT_HD void between_residual(const Pose<A>& a, const Pose<A>& b,
                            const Pose<scalar_t<A>>& z, A* r) {
  const Pose<A> rel = se3_compose(se3_inverse(a), b);
  se3_log(se3_compose(se3_inverse(z), rel), r);
}

template <class A>
GT_HD void prior_residual(const Pose<A>& x, const Pose<scalar_t<A>>& z,
                          A* r) {
  se3_log(se3_compose(se3_inverse(z), x), r);
}

template <class T>
GT_HD Pose<T> load_pose(const T* p) {
  return {{p[0], p[1], p[2]}, {p[3], p[4], p[5], p[6]}};
}

// The residual of a factor of NSLOT slots at x (the vertices' parameters,
// 7 values each) and z (the measurement): r, in T.
template <int NSLOT, class T>
GT_HD void residual(const T* const* x, const T* z, T* r) {
  const Pose<T> zp = load_pose(z);
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
template <int NSLOT, class T>
GT_HD void residual_jvp(const T* const* x, const T* z, int k, T* r, T* jt) {
  using R = Real<T>;
  Pose<Dual<T>> xs[NSLOT];
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    Dual<T> delta[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      delta[c] = Dual<T>{R::kZero, k == 6 * s + c ? R::kOne : R::kZero};
    }
    xs[s] = se3_retract(load_pose(x[s]), delta);
  }
  Dual<T> rd[6];
  const Pose<T> zp = load_pose(z);
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
