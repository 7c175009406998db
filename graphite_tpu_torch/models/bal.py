"""BAL (Bundle Adjustment in the Large) camera model (counterpart of
``graphite_tpu/models/bal.py``).

- camera vertex: 9 parameters [angle-axis rvec(3), translation t(3),
  focal f, distortion k1, k2];
- point vertex: 3 parameters, additive;
- reprojection factor (E = 2): Rodrigues rotation, perspective division
  with the BAL -P/P.z convention, radial distortion, minus the observed
  pixel.

Every function is batched over leading dimensions (``[..., i]``
indexing), so it evaluates one factor or a whole ``(F, ...)`` batch.
"""

from __future__ import annotations

import torch

from ..factors import factor_type
from ..precision import sqrt_rn
from ..vertices import vertex_type

CAMERA = vertex_type("bal_camera", 9)
POINT = vertex_type("bal_point", 3)


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot3(a, b):
    """Dot product over the last dim (3), summed left to right."""
    return a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2] \
        + a[..., 2:3] * b[..., 2:3]


def _cos_sin(theta):
    """cos and sin, correctly rounded in ``theta``'s dtype on any device.

    float32 cos / sin differ by an ulp between the CPU and CUDA math
    libraries; evaluated in float64 and rounded, both devices give the
    same float32 result."""
    if theta.dtype == torch.float64:
        return torch.cos(theta), torch.sin(theta)
    t = theta.to(torch.float64)
    return torch.cos(t).to(theta.dtype), torch.sin(t).to(theta.dtype)


def rodrigues_rotate(rvec, X):
    """R(rvec) @ X by the Rodrigues formula, with the first-order
    expansion X + rvec x X below theta^2 < 1e-24."""
    theta2 = _dot3(rvec, rvec)
    tiny = theta2 < 1e-24
    theta = sqrt_rn(torch.where(tiny, torch.ones_like(theta2), theta2))
    axis = rvec / theta
    cth, sth = _cos_sin(theta)
    axx = _cross(axis, X)
    adx = _dot3(axis, X)
    rotated = X * cth + axx * sth + axis * adx * (1.0 - cth)
    return torch.where(tiny, X + _cross(rvec, X), rotated)


def project(camera, X):
    """BAL projection: pixel = f * distortion * (-P.xy / P.z)."""
    P = rodrigues_rotate(camera[..., :3], X) + camera[..., 3:6]
    p = -P[..., :2] / P[..., 2:3]
    r2 = p[..., 0:1] * p[..., 0:1] + p[..., 1:2] * p[..., 1:2]
    k1, k2 = camera[..., 7:8], camera[..., 8:9]
    distortion = 1.0 + k1 * r2 + k2 * r2 * r2
    return camera[..., 6:7] * distortion * p


def reprojection_residual(camera, point, obs):
    return project(camera, point) - obs


def reprojection_jacobian(camera, point, obs):
    """Analytic (..., 2, 9) / (..., 2, 3) reprojection Jacobian blocks.

    Chain rule through v = R(w) X, P = v + t, p = -P.xy / P.z,
    res = f * (1 + k1 r2 + k2 r2^2) * p. The Rodrigues derivative uses
    c = cos(th), a = sinc(th), b = (1-c)/th^2 with

        dv/dw = -a [X]x + b ((w.X) I + w X^T)
                + ((c - a)/th^2 (w x X) - a X + (a - 2b)/th^2 (w.X) w) w^T

    whose cancelling ratios switch to Taylor series below th < 0.1; at
    th^2 < 1e-24 it matches the residual's first-order branch.
    """
    w0, w1, w2 = camera[..., 0], camera[..., 1], camera[..., 2]
    t0, t1, t2 = camera[..., 3], camera[..., 4], camera[..., 5]
    f, k1, k2 = camera[..., 6], camera[..., 7], camera[..., 8]
    X0, X1, X2 = point[..., 0], point[..., 1], point[..., 2]

    th2 = w0 * w0 + w1 * w1 + w2 * w2
    small = th2 < 0.01  # th < 0.1
    one = torch.ones_like(th2)
    # guard the exact-form denominators so the unselected branch is finite
    th2_g = torch.where(small, one, th2)
    th = sqrt_rn(th2_g)
    cos_th, sin_th = _cos_sin(th)
    # Taylor coefficients as products with reciprocal constants: PyTorch's
    # CUDA division by a Python scalar is itself a reciprocal multiply, so
    # writing it out keeps CPU and GPU results identical.
    th4 = th2 * th2
    c = torch.where(small, 1.0 - th2 * (1 / 2) + th4 * (1 / 24)
                    - th4 * th2 * (1 / 720), cos_th)
    alpha = torch.where(small, 1.0 - th2 * (1 / 6) + th4 * (1 / 120),
                        sin_th / th)
    beta = torch.where(small, 0.5 - th2 * (1 / 24) + th4 * (1 / 720),
                       (1.0 - c) / th2_g)
    gamma = torch.where(small, -1 / 3 + th2 * (1 / 30) - th4 * (1 / 840),
                        (c - alpha) / th2_g)
    delta = torch.where(small, -1 / 12 + th2 * (1 / 180) - th4 * (1 / 6720),
                        (alpha - 2.0 * beta) / th2_g)

    wxX0 = w1 * X2 - w2 * X1
    wxX1 = w2 * X0 - w0 * X2
    wxX2 = w0 * X1 - w1 * X0
    wdX = w0 * X0 + w1 * X1 + w2 * X2

    tiny = th2 < 1e-24
    v0 = torch.where(tiny, X0 + wxX0, c * X0 + alpha * wxX0 + beta * wdX * w0)
    v1 = torch.where(tiny, X1 + wxX1, c * X1 + alpha * wxX1 + beta * wdX * w1)
    v2 = torch.where(tiny, X2 + wxX2, c * X2 + alpha * wxX2 + beta * wdX * w2)

    P0, P1, P2 = v0 + t0, v1 + t1, v2 + t2
    iz = 1.0 / P2
    px = -P0 * iz
    py = -P1 * iz
    r2 = px * px + py * py
    dist = 1.0 + k1 * r2 + k2 * r2 * r2

    # A = dres/dp (2, 2); G = A @ dp/dP = dres/dP (2, 3)
    dd = 2.0 * (k1 + 2.0 * k2 * r2)
    A00 = f * (dist + dd * px * px)
    A01 = f * dd * px * py
    A11 = f * (dist + dd * py * py)
    G00 = -iz * A00
    G01 = -iz * A01
    G02 = -iz * (A00 * px + A01 * py)
    G10 = -iz * A01
    G11 = -iz * A11
    G12 = -iz * (A01 * px + A11 * py)

    # dv/dw (3, 3)
    c0 = gamma * wxX0 - alpha * X0 + delta * wdX * w0
    c1 = gamma * wxX1 - alpha * X1 + delta * wdX * w1
    c2 = gamma * wxX2 - alpha * X2 + delta * wdX * w2
    zero = torch.zeros_like(th2)
    ag = torch.where(tiny, one, alpha)
    bg = torch.where(tiny, zero, beta)
    zg = torch.where(tiny, zero, one)
    D00 = bg * wdX + bg * w0 * X0 + zg * c0 * w0
    D01 = ag * X2 + bg * w0 * X1 + zg * c0 * w1
    D02 = -ag * X1 + bg * w0 * X2 + zg * c0 * w2
    D10 = -ag * X2 + bg * w1 * X0 + zg * c1 * w0
    D11 = bg * wdX + bg * w1 * X1 + zg * c1 * w1
    D12 = ag * X0 + bg * w1 * X2 + zg * c1 * w2
    D20 = ag * X1 + bg * w2 * X0 + zg * c2 * w0
    D21 = -ag * X0 + bg * w2 * X1 + zg * c2 * w1
    D22 = bg * wdX + bg * w2 * X2 + zg * c2 * w2

    # R (3, 3) = c I + alpha [w]x + beta w w^T
    R00 = c + beta * w0 * w0
    R01 = -alpha * w2 + beta * w0 * w1
    R02 = alpha * w1 + beta * w0 * w2
    R10 = alpha * w2 + beta * w1 * w0
    R11 = c + beta * w1 * w1
    R12 = -alpha * w0 + beta * w1 * w2
    R20 = -alpha * w1 + beta * w2 * w0
    R21 = alpha * w0 + beta * w2 * w1
    R22 = c + beta * w2 * w2

    J_cam = torch.stack([
        torch.stack([
            G00 * D00 + G01 * D10 + G02 * D20,
            G00 * D01 + G01 * D11 + G02 * D21,
            G00 * D02 + G01 * D12 + G02 * D22,
            G00, G01, G02,
            dist * px, f * r2 * px, f * r2 * r2 * px,
        ], dim=-1),
        torch.stack([
            G10 * D00 + G11 * D10 + G12 * D20,
            G10 * D01 + G11 * D11 + G12 * D21,
            G10 * D02 + G11 * D12 + G12 * D22,
            G10, G11, G12,
            dist * py, f * r2 * py, f * r2 * r2 * py,
        ], dim=-1),
    ], dim=-2)
    J_pt = torch.stack([
        torch.stack([
            G00 * R00 + G01 * R10 + G02 * R20,
            G00 * R01 + G01 * R11 + G02 * R21,
            G00 * R02 + G01 * R12 + G02 * R22,
        ], dim=-1),
        torch.stack([
            G10 * R00 + G11 * R10 + G12 * R20,
            G10 * R01 + G11 * R11 + G12 * R21,
            G10 * R02 + G11 * R12 + G12 * R22,
        ], dim=-1),
    ], dim=-2)
    return J_cam, J_pt


REPROJECTION = factor_type(
    "bal_reprojection", 2, [CAMERA, POINT], reprojection_residual,
    obs_shape=(2,), jacobian_fn=reprojection_jacobian,
)
