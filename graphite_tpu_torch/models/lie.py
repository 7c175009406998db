"""SO(3) / SE(3) / SE(2) Lie-group operations (counterpart of
``graphite_tpu/models/lie.py``).

Quaternions are stored (x, y, z, w); an SE3 pose is 7 parameters (tx ty tz
qx qy qz qw) with a 6-dim tangent (rho, phi); an SE2 pose is (x, y,
theta). Retractions are the right perturbation X * Exp(delta).

Every function is batched over leading dimensions (``[..., i]``
indexing), so it evaluates one pose or a whole ``(F, ...)`` batch, and
``torch.func`` transforms run through it.

- Every branch around theta -> 0 uses a safe denominator and a ``where``,
  exactly as the JAX package does, so forward-mode differentiation at
  delta = 0 (the AUTO Jacobians) takes the small-angle branch and never
  sees a NaN.
- sin, cos and atan2 are evaluated in float64 and rounded, and square
  roots are correctly rounded (``precision.sqrt_rn``): the float32 CPU and
  CUDA math libraries differ by an ulp, the rounded float64 results do
  not. Constant divisions are written as products with reciprocal
  constants (PyTorch's CUDA division by a Python scalar is itself a
  reciprocal multiply).
"""

from __future__ import annotations

import torch

from ..precision import sqrt_rn

_EPS2 = 1e-16  # squared-angle cutoff of the small-angle branches


def _in_f64(fn, *xs):
    """``fn(*xs)`` evaluated in float64 and rounded to the inputs' dtype."""
    dt = xs[0].dtype
    if dt == torch.float64:
        return fn(*xs)
    return fn(*(x.to(torch.float64) for x in xs)).to(dt)


def _cos(x):
    return _in_f64(torch.cos, x)


def _sin(x):
    return _in_f64(torch.sin, x)


def _dot(a, b):
    """Dot product over the last dim, summed left to right (keeps it)."""
    out = a[..., 0:1] * b[..., 0:1]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i:i + 1] * b[..., i:i + 1]
    return out


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


# ---------------------------------------------------------------------------
# quaternion (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q):
    return q / sqrt_rn(_dot(q, q))


def quat_rotate(q, v):
    """Rotate vectors v by unit quaternions q."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def so3_exp_quat(phi):
    """Exp: axis-angle (..., 3) -> unit quaternion (..., 4)."""
    theta2 = _dot(phi, phi)
    small = theta2 < _EPS2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = sqrt_rn(theta2_safe)
    half = 0.5 * theta
    # sin(t/2)/t with the Taylor fallback 1/2 - t^2/48
    k = torch.where(small, 0.5 - theta2 * (1 / 48), _sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 * (1 / 8), _cos(half))
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q):
    """Log: unit quaternion (..., 4) -> axis-angle (..., 3)."""
    u = q[..., :3]
    w = q[..., 3:4]
    n2 = _dot(u, u)
    small = n2 < _EPS2
    one = torch.ones_like(n2)
    n = sqrt_rn(torch.where(small, one, n2))
    w_abs = w.abs()
    # theta = 2 atan2(|u|, |w|); the sign of w picks the branch
    theta = 2.0 * _in_f64(torch.atan2, n, w_abs)
    # k = theta / sin(theta/2) ~ 2/w at small angles; times sign(w)
    k = torch.where(small, (2.0 * one) / torch.where(w_abs < 1e-12, one, w),
                    theta / n * torch.sign(w))
    return k * u


# ---------------------------------------------------------------------------
# SE(3): params (tx ty tz qx qy qz qw), tangent (rho(3), phi(3))
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device=None):
    return torch.cat([torch.zeros(3, dtype=dtype, device=device),
                      quat_identity(dtype, device)])


def se3_compose(a, b):
    """a * b."""
    qa = a[..., 3:7]
    return torch.cat([a[..., :3] + quat_rotate(qa, b[..., :3]),
                      quat_mul(qa, b[..., 3:7])], dim=-1)


def se3_inverse(x):
    qi = quat_conj(x[..., 3:7])
    return torch.cat([-quat_rotate(qi, x[..., :3]), qi], dim=-1)


def se3_exp(xi):
    """Exp: tangent (rho, phi) -> SE3 params, the exact exponential with
    the V(phi) rho translation."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    theta2 = _dot(phi, phi)
    small = theta2 < _EPS2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = sqrt_rn(theta2_safe)
    # V = I + (1-cos)/t^2 [phi]x + (t - sin)/t^3 [phi]x^2
    a = torch.where(small, 0.5 - theta2 * (1 / 24),
                    (1.0 - _cos(theta)) / theta2_safe)
    b = torch.where(small, 1.0 / 6.0 - theta2 * (1 / 120),
                    (theta - _sin(theta)) / (theta2_safe * theta))
    px = _cross(phi, rho)
    ppx = _cross(phi, px)
    t = rho + a * px + b * ppx
    return torch.cat([t, q], dim=-1)


def se3_log(x):
    """Log: SE3 params -> tangent (rho, phi)."""
    phi = so3_log(x[..., 3:7])
    t = x[..., :3]
    theta2 = _dot(phi, phi)
    small = theta2 < _EPS2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = sqrt_rn(theta2_safe)
    half = 0.5 * theta
    # V^{-1} = I - 1/2 [phi]x + (1/t^2 - cot(t/2)/(2t)) [phi]x^2
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 * (1 / 720),
        (1.0 - half * _cos(half) / _sin(half)) / theta2_safe)
    px = _cross(phi, t)
    ppx = _cross(phi, px)
    rho = t - 0.5 * px + cot_term * ppx
    return torch.cat([rho, phi], dim=-1)


def se3_retract(x, delta):
    """x * Exp(delta), the quaternion re-normalized."""
    out = se3_compose(x, se3_exp(delta))
    return torch.cat([out[..., :3], quat_normalize(out[..., 3:7])], dim=-1)


# ---------------------------------------------------------------------------
# SE(2): params (x, y, theta), tangent (dx, dy, dtheta), g2o convention
# ---------------------------------------------------------------------------

def angle_wrap(theta):
    """atan2(sin(theta), cos(theta))."""
    return _in_f64(lambda t: torch.atan2(torch.sin(t), torch.cos(t)), theta)


def se2_retract(x, delta):
    """Local perturbation: t += R(theta) dt, theta += dtheta (wrapped)."""
    c, s = _cos(x[..., 2]), _sin(x[..., 2])
    dx = c * delta[..., 0] - s * delta[..., 1]
    dy = s * delta[..., 0] + c * delta[..., 1]
    theta = angle_wrap(x[..., 2] + delta[..., 2])
    return torch.stack([x[..., 0] + dx, x[..., 1] + dy, theta], dim=-1)


def se2_relative(a, b):
    """b expressed in a's frame: a^{-1} * b as (dx, dy, dtheta)."""
    c, s = _cos(a[..., 2]), _sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return torch.stack([
        c * dx + s * dy,
        -s * dx + c * dy,
        angle_wrap(b[..., 2] - a[..., 2]),
    ], dim=-1)
