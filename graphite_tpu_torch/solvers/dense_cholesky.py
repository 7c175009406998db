"""Dense Cholesky direct solver on the full system (counterpart of
``graphite_tpu/solvers/dense_cholesky.py``).

``prepare`` densifies the scaled ``H = J^T dL P J`` over the active
columns; ``solve`` damps its diagonal and factors it in float64 with
``torch.linalg.cholesky_ex`` (cuSOLVER on the card, LAPACK on the CPU;
``cholesky_solve`` says why float64).

The JAX package assembles H with a flat scatter-add of the factor
products. Here H comes from ``compute_hessian_values`` (the block values,
summed by ``reduce_rows``: K1 on the card, no float atomics) through
``dense_hessian_matrix``, an indexed copy.

A failed factorization (``info != 0``) or a non-finite solution gives
``ok = False`` and a zero delta, which the LM loop rejects; ``ok`` stays
on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..hessian import (
    build_hessian_structure,
    compute_hessian_values,
    dense_hessian_matrix,
)
from ..linearize import DIAG_MAX, DIAG_MIN, Linearization
from .base import prepared


def assemble_dense_hessian(problem, lin: Linearization) -> torch.Tensor:
    """Dense (dim_h, dim_h) undamped H in ``inv_dtype``."""
    for name, J in lin.jacobians.items():
        if J is None:
            raise ValueError(
                f"dense assembly requires stored Jacobians ('{name}' is "
                "dynamic)")
    hs = build_hessian_structure(problem)
    return dense_hessian_matrix(problem, hs,
                                compute_hessian_values(problem, hs, lin))


def damp_hessian(H: torch.Tensor, damping, use_identity: bool) -> torch.Tensor:
    """A copy of H with the LM diagonal: ``d + mu`` or ``d + mu * clamp(d,
    1e-6, 1e32)`` from H's own diagonal ``d`` (added to the diagonal only,
    as the JAX package's ``H + diag(new_d - d)``)."""
    d = H.diagonal()
    mu = torch.as_tensor(damping, dtype=H.dtype, device=H.device)
    new_d = d + mu if use_identity else d + mu * d.clamp(DIAG_MIN, DIAG_MAX)
    out = H.clone()
    out.diagonal().add_(new_d - d)
    return out


def cholesky_solve(A: torch.Tensor, b: torch.Tensor):
    """x (float64) with A x = b for a symmetric positive definite A, and
    ok: the factorization succeeded and x is finite. A failed solve
    returns x = 0.

    A is factored in float64 whatever its dtype. The damped systems are
    ill-conditioned (Ladybug-49's S at damping 1e-4 has a condition
    number of ~2e4), so a float32 factor leaves ~1e-3 relative error in
    x, which cuSOLVER and LAPACK round differently: the card's and the
    CPU's first LM steps differed by 7e-4 in chi2 (PERF.md §6). In
    float64 both solve the same float32 matrix to float64 rounding."""
    A = A.to(torch.float64)
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    x = torch.cholesky_solve(b.to(A.dtype).unsqueeze(1), L).squeeze(1)
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok


def full_delta(problem, x: torch.Tensor) -> torch.Tensor:
    """The (dim_x,) graph-dtype delta of a (dim_h,) solution."""
    gdt = problem.precision.graph_dtype
    out = torch.zeros(problem.dim_x, dtype=gdt, device=problem.device)
    out[: problem.dim_h] = x.to(gdt)
    return out


@dataclasses.dataclass
class DenseCholeskyState:
    H: torch.Tensor  # (dim_h, dim_h) undamped dense Hessian


@dataclasses.dataclass(frozen=True)
class DenseCholeskySolver:
    def prepare(self, problem, lin: Linearization, params=None, out=None):
        return prepared(
            DenseCholeskyState(H=assemble_dense_hessian(problem, lin)), out)

    def solve(self, problem, lin: Linearization, state: DenseCholeskyState,
              damping, use_identity: bool, params=None):
        """Returns (delta_x (dim_x,), ok)."""
        H = damp_hessian(state.H, damping, use_identity)
        x, ok = cholesky_solve(H, lin.b[: problem.dim_h])
        return full_delta(problem, x), ok
