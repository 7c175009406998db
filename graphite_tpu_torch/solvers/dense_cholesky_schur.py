"""Dense Cholesky on the Schur (pose) system, then the landmark
back-substitution (counterpart of
``graphite_tpu/solvers/dense_cholesky_schur.py``).

``schur_to_dense`` densifies S from its block values; the solver factors
it in float64 with ``torch.linalg.cholesky_ex`` at every size
(``dense_cholesky.cholesky_solve``). (The JAX package
switches to its recursive ``blocked_cholesky`` at dim_p >= 1024, because
XLA's Cholesky did not compile at n = 16,384 on the TPU; cuSOLVER has no
such limit.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..hessian import (
    HessianValues,
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from ..linearize import Linearization
from ..schur import SchurOps, build_schur_structure, schur_values
from .base import prepared
from .dense_cholesky import cholesky_solve


def _dense_positions(problem, ss):
    """Per S key: the flat dense positions of its blocks' entries, the
    off-diagonal blocks, and the positions of their transposes (host-built
    once, cached on the problem)."""
    cache = problem._cache
    if "schur_dense_positions" not in cache:
        n = ss.dim_p
        offsets = problem.block_offsets

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                                   dtype=torch.int64, device=problem.device)

        out = {}
        for key in ss.s_keys:
            dr, dc = key
            rows, cols = ss.s_rows[key], ss.s_cols[key]
            rr = offsets[rows][:, None, None] + np.arange(dr)[None, :, None]
            cc = offsets[cols][:, None, None] + np.arange(dc)[None, None, :]
            off = np.nonzero(rows != cols)[0]
            out[key] = (dev(rr * n + cc), dev(off), dev(cc[off] * n + rr[off]))
        cache["schur_dense_positions"] = out
    return cache["schur_dense_positions"]


def schur_to_dense(problem, ss, sv) -> torch.Tensor:
    """Dense S (dim_p x dim_p) from the upper-triangular block values,
    mirrored: S = T + (T - T_bdiag)^T. Every entry has one source, so this
    is an indexed assignment, with no sums."""
    n = ss.dim_p
    inv_dt = problem.precision.inv_dtype
    S = torch.zeros(n * n, dtype=inv_dt, device=problem.device)
    for key, (pos, off, pos_t) in _dense_positions(problem, ss).items():
        v = sv.s_vals[key].to(inv_dt)
        S.index_copy_(0, pos, v.reshape(-1))
        if off.numel():
            S.index_copy_(0, pos_t, v.index_select(0, off).reshape(-1))
    return S.reshape(n, n)


@dataclasses.dataclass
class SchurSolverState:
    hvals: HessianValues  # undamped Hessian block values


def schur_system(problem, lin: Linearization, state: SchurSolverState,
                 damping, use_identity: bool):
    """The damped Schur system of one solve: (SchurOps, b_S). The Schur
    complement cancels catastrophically at reduced matmul precision, so
    every float32 product from here on stays IEEE float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                       use_identity)
    ops = SchurOps(problem, ss, hv, schur_values(problem, ss, hv))
    return ops, ops.b_schur(lin.b)


def schur_delta(ops: SchurOps, lin: Linearization, dx_p: torch.Tensor,
                ok: torch.Tensor) -> torch.Tensor:
    """The full delta of a pose solution: landmarks back-substituted; all
    zero when the solve failed."""
    dx_p = dx_p.to(ops.problem.precision.graph_dtype)
    delta = ops.compose_delta(dx_p, ops.landmark_update(lin.b, dx_p))
    return torch.where(ok, delta, torch.zeros_like(delta))


def prepare_schur(problem, lin: Linearization) -> SchurSolverState:
    hs = build_hessian_structure(problem)
    build_schur_structure(problem)
    return SchurSolverState(hvals=compute_hessian_values(problem, hs, lin))


@dataclasses.dataclass(frozen=True)
class DenseCholeskySchurSolver:
    def prepare(self, problem, lin: Linearization, params=None, out=None):
        return prepared(prepare_schur(problem, lin), out)

    def solve(self, problem, lin: Linearization, state: SchurSolverState,
              damping, use_identity: bool, params=None):
        """Returns (delta_x (dim_x,), ok)."""
        ops, b_s = schur_system(problem, lin, state, damping, use_identity)
        dx_p, ok = cholesky_solve(schur_to_dense(problem, ops.ss, ops.sv),
                                  b_s)
        return schur_delta(ops, lin, dx_p, ok), ok
