"""Matrix-free preconditioned conjugate gradients (counterpart of
``graphite_tpu/solvers/pcg.py``).

- the implicit Hessian product ``H p = J^T dL P (J p)`` plus damping
  ``mu * clamp(diag, 1e-6, 1e32) * p``, or ``mu * p`` for identity damping;
- ``run_pcg``'s semantics (normalized residual before each preconditioner
  application, divergence rejection with restore, running-minimum rz);
- the whole solve in one ``solve_pcg_mf`` call (kernel K6 on CUDA, its
  plain version on the CPU) under the JAX package's gate: a block-Jacobi
  or identity preconditioner and a feasible ``plan_pcg_mf`` site (one
  vertex type, the folded J within ``J_BYTES_LIMIT``), in a float32 or a
  float64 graph (the JAX package takes its Pallas kernel in float32 only,
  the TPU having no float64; K6 has a float64 instance); otherwise
  ``run_pcg`` on ``hessian_matvec``, whose
  row reductions take kernel K1 on CUDA (``run_pcg_fixed`` inside the
  device-controlled LM iteration). A factor set without stored Jacobians
  (``store_jacobians=False``) closes the K6 gate; ``hessian_matvec``
  then recomputes its J from ``params``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..linearize import DIAG_MAX, DIAG_MIN, Linearization, hessian_matvec
from ..ops.cuda.pcg_mf import fold_jacobians, plan_pcg_mf, solve_pcg_mf
from ..ops.pcg_loop import pcg
from ..preconditioners.block_jacobi import (
    BlockJacobiPreconditioner,
    BlockJacobiState,
    row_inverse_blocks,
)
from ..preconditioners.identity import IdentityPreconditioner
from .base import prepared


@dataclasses.dataclass
class PCGState:
    precond_state: object


@dataclasses.dataclass(frozen=True)
class PCGSolver:
    max_iter: int = 10
    tol: float = 1.0
    rejection_ratio: float = 5.0
    preconditioner: object = dataclasses.field(
        default_factory=IdentityPreconditioner)

    def prepare(self, problem, lin: Linearization, params=None,
                out=None) -> PCGState:
        return prepared(PCGState(
            precond_state=self.preconditioner.prepare(problem, lin, params)),
            out)

    def solve(self, problem, lin: Linearization, state: PCGState, damping,
              use_identity: bool, params=None):
        """Returns (delta_x (dim_x,), ok)."""
        gdt = problem.precision.graph_dtype
        damping = torch.as_tensor(damping, dtype=gdt, device=problem.device)
        pstate = self.preconditioner.set_damping(
            problem, lin, state.precond_state, damping, use_identity)
        diag = lin.diag.clamp(DIAG_MIN, DIAG_MAX)
        if use_identity:
            damp_vec = torch.ones_like(diag) * damping
        else:
            damp_vec = diag * damping
        ok = torch.ones((), dtype=torch.bool, device=problem.device)

        site = None
        # K6 sums J^T J p over every factor inside one kernel: a rank that
        # holds a slice of the factors takes run_pcg, whose JtPv is summed
        # over the ranks. Every graph dtype (float32, float64) has an
        # instance.
        if not problem.sharded and isinstance(
                self.preconditioner,
                (BlockJacobiPreconditioner, IdentityPreconditioner)):
            site = plan_pcg_mf(problem, lin)
        if site is not None:
            name = site.vt_name
            minv = (row_inverse_blocks(problem, pstate, name)
                    if isinstance(pstate, BlockJacobiState) else None)
            x_rows, _ = solve_pcg_mf(
                site, fold_jacobians(problem, lin, site),
                problem.rows_view(lin.b, name).reshape(-1),
                problem.rows_view(damp_vec, name).reshape(-1), minv,
                max_iter=self.max_iter, tol=self.tol,
                rejection_ratio=self.rejection_ratio)
            return problem.flat_from_rows({name: x_rows}), ok

        def matvec(p):
            return hessian_matvec(problem, lin, p, params) + damp_vec * p

        def precond(y):
            return self.preconditioner.apply(problem, lin, pstate, y)

        x, _ = pcg(lin.b, matvec, precond, self.max_iter, self.tol,
                   self.rejection_ratio)
        x = x.clone()
        x[problem.dim_h:] = 0.0
        return x, ok
