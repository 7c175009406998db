"""Preconditioned CG iteration (counterpart of
``graphite_tpu/ops/pcg_loop.py``), as a host loop.

Semantics: the residual is normalized before each preconditioner
application; a step with |rz_new| > rejection_ratio * rz_min (or a NaN
rz_new) is rejected, keeping the previous x, r, p, z and rz, and ends the
loop; rz_min starts at +inf and is a running minimum of |rz_new|; the loop
ends on |rz_new| < tol and never starts an iteration while rz == 0.

Every inner product is ``tree_dot``: float32 (the operands' dtype), as in
the JAX package, summed in one fixed order, so a CPU run and a CUDA run
take the same steps; that order is K2's (``ops/cuda/pcg_dense``), so every
PCG branch of the solver rounds its dots alike.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..precision import sqrt_rn


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of a vector in a fixed order, the same on every device: each
    group of 32 consecutive entries (zero-padded) by a halving tree, as a
    warp's shuffle-down reduction adds them, then the group sums the same
    way, until one is left (at least two levels). Up to 1,024 entries this
    is K2's ``block_sum`` order."""
    levels = 0
    while levels < 2 or v.shape[0] > 1:
        w = v.new_zeros(-(-v.shape[0] // 32) * 32)
        w[: v.shape[0]] = v
        w = w.reshape(-1, 32)
        for o in (16, 8, 4, 2, 1):
            w = w[:, :o] + w[:, o:2 * o]
        v = w[:, 0]
        levels += 1
    return v[0]


def tree_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u . v: the elementwise products summed by ``tree_sum``."""
    return tree_sum(u * v)


def run_pcg(b: torch.Tensor, matvec: Callable, precond: Callable,
            max_iter: int, tol: float, rejection_ratio: float
            ) -> Tuple[torch.Tensor, int]:
    """Solve ``A x = b``; returns (x, number of CG steps taken)."""
    dot = tree_dot

    def precondition(r):
        rnorm = sqrt_rn(dot(r, r))
        return precond(r / torch.where(rnorm == 0, torch.ones_like(rnorm),
                                       rnorm))

    x = torch.zeros_like(b)
    r = b
    z = precondition(r)
    p = z
    rz = dot(r, z)
    rz_min = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    k = 0
    while k < max_iter and bool(rz != 0):
        v = matvec(p)
        alpha = rz / dot(p, v)
        x_new = x + alpha * p
        r_new = r - alpha * v
        z_new = precondition(r_new)
        rz_new = dot(r_new, z_new)
        reject = bool((rz_new.abs() > rejection_ratio * rz_min)
                      | torch.isnan(rz_new))
        rz_min = torch.minimum(rz_min, rz_new.abs())
        k += 1
        if reject:
            break
        p = z_new + (rz_new / rz) * p
        x, r, z, rz = x_new, r_new, z_new, rz_new
        if bool(rz.abs() < tol):
            break
    return x, k
