"""Batched small-block SPD inverses (counterpart of
``graphite_tpu/ops/batched_linalg.py``).

Blocks are J^T P J plus LM damping, hence SPD: closed forms for d <= 3,
a batched Cholesky solve against the identity above. Inversions always
run in the precision's ``inv_dtype``.
"""

from __future__ import annotations

import torch


def spd_inverse(blocks: torch.Tensor) -> torch.Tensor:
    """Invert a batch of small SPD matrices, shape (..., d, d)."""
    d = blocks.shape[-1]
    if d <= 3:
        n = blocks.shape[:-2]
        flat = spd_inverse_flat(blocks.reshape(-1, d * d), d)
        return flat.reshape(*n, d, d)
    # Factorized in float64 and rounded back: the CPU and CUDA libraries
    # order their float32 arithmetic differently, and rounding a float64
    # result gives both devices the same float32 inverse. A block that is
    # not positive definite inverts to NaN (as in the JAX package) instead
    # of raising, and the solver then rejects the LM step.
    a = blocks.to(torch.float64)
    chol, info = torch.linalg.cholesky_ex(a)
    chol = torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))
    eye = torch.eye(d, dtype=a.dtype, device=a.device).expand_as(a)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                         upper=True).to(blocks.dtype)


def spd_inverse_flat(flat: torch.Tensor, d: int) -> torch.Tensor:
    """``spd_inverse`` on flat block storage: (N, d*d) -> (N, d*d)."""
    if d == 1:
        return 1.0 / flat
    if d == 2:
        a, b, c, e = flat[:, 0], flat[:, 1], flat[:, 2], flat[:, 3]
        inv_det = 1.0 / (a * e - b * c)
        return torch.stack(
            [e * inv_det, -b * inv_det, -c * inv_det, a * inv_det], dim=1)
    if d == 3:
        m = [flat[:, i] for i in range(9)]
        c00 = m[4] * m[8] - m[5] * m[7]
        c01 = m[5] * m[6] - m[3] * m[8]
        c02 = m[3] * m[7] - m[4] * m[6]
        c10 = m[2] * m[7] - m[1] * m[8]
        c11 = m[0] * m[8] - m[2] * m[6]
        c12 = m[1] * m[6] - m[0] * m[7]
        c20 = m[1] * m[5] - m[2] * m[4]
        c21 = m[2] * m[3] - m[0] * m[5]
        c22 = m[0] * m[4] - m[1] * m[3]
        inv_det = 1.0 / (m[0] * c00 + m[1] * c01 + m[2] * c02)
        # adjugate in row-major flat order (note the transpose)
        cols = [c00, c10, c20, c01, c11, c21, c02, c12, c22]
        return torch.stack([c * inv_det for c in cols], dim=1)
    n = flat.shape[0]
    return spd_inverse(flat.reshape(n, d, d)).reshape(n, d * d)
