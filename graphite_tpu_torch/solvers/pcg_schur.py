"""PCG on the explicit Schur system (counterpart of
``graphite_tpu/solvers/pcg_schur.py``).

Per solve: damp H, build the Schur values, b_S and the preconditioner, run
PCG on S dx_p = b_S, then back-substitute the landmarks. Up to
``dense_matvec_limit`` pose columns S is densified; when dim_p <=
``fused_pcg_limit``, the values are float32 and the preconditioner is
block-Jacobi-Schur, the whole PCG runs as one ``dense_pcg`` call (kernel K2
on CUDA), as in the JAX package. Above ``dense_matvec_limit`` the PCG runs
on the host loop with the block-sparse S matvec (``SchurOps.s_matvec``:
kernel K5 on CUDA at BAL Venice scale); inside the device-controlled
LM iteration it is ``run_pcg_fixed``, with no host read. The other dense
branch (above ``fused_pcg_limit``, another preconditioner, or a float64
S) multiplies by S with ``tree_matvec``, in one order on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from ..linearize import Linearization
from ..ops.cuda.pcg_dense import dense_pcg
from ..ops.pcg_loop import pcg, tree_matvec
from ..preconditioners.block_jacobi_schur import (
    BlockJacobiSchurPreconditioner,
    dense_preconditioner_matrix,
)
from ..schur import SchurOps, build_schur_structure, schur_values
from .dense_cholesky_schur import SchurSolverState, schur_to_dense


@dataclasses.dataclass(frozen=True)
class PCGSchurSolver:
    max_iter: int = 10
    tol: float = 1.0
    rejection_ratio: float = 5.0
    preconditioner: object = dataclasses.field(
        default_factory=BlockJacobiSchurPreconditioner)
    dense_matvec_limit: int = 8192
    fused_pcg_limit: int = 1024

    def prepare(self, problem, lin: Linearization, params=None,
                out: Optional[SchurSolverState] = None):
        """The undamped Hessian values of ``lin``; with ``out`` (a state
        of this solver on the same problem) written into ``out``'s groups
        (``compute_hessian_values``), and ``out`` returned."""
        hs = build_hessian_structure(problem)
        build_schur_structure(problem)
        hvals = compute_hessian_values(
            problem, hs, lin, None if out is None else out.hvals)
        return SchurSolverState(hvals=hvals) if out is None else out

    def solve(self, problem, lin: Linearization, state: SchurSolverState,
              damping, use_identity: bool, params=None):
        """Returns (delta_x (dim_x,), ok)."""
        # The Schur complement cancels catastrophically at reduced matmul
        # precision: keep every float32 product in IEEE float32 (no TF32).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gdt = problem.precision.graph_dtype
        hs = build_hessian_structure(problem)
        ss = build_schur_structure(problem)
        hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                           use_identity)
        sv = schur_values(problem, ss, hv)
        ops = SchurOps(problem, ss, hv, sv)
        b_s = ops.b_schur(lin.b)
        pstate = self.preconditioner.prepare(problem, ss, sv)

        def precond(y):
            return self.preconditioner.apply(problem, ss, pstate, y)

        if ss.dim_p > self.dense_matvec_limit:
            ops.prepare_matvec()
            dx_p, _ = pcg(b_s, ops.s_matvec, precond, self.max_iter,
                          self.tol, self.rejection_ratio)
        else:
            S = schur_to_dense(problem, ss, sv)
            if (ss.dim_p <= self.fused_pcg_limit
                    and S.dtype == torch.float32
                    and isinstance(self.preconditioner,
                                   BlockJacobiSchurPreconditioner)):
                M = dense_preconditioner_matrix(problem, ss, pstate, S.dtype)
                dx_p, _ = dense_pcg(S, M, b_s.to(S.dtype),
                                    max_iter=self.max_iter, tol=self.tol,
                                    rejection_ratio=self.rejection_ratio)
            else:
                dx_p, _ = pcg(
                    b_s, lambda p: tree_matvec(S, p.to(S.dtype)).to(gdt),
                    precond, self.max_iter, self.tol, self.rejection_ratio)
        dx_p = dx_p.to(gdt)
        dx_l_rows = ops.landmark_update(lin.b, dx_p)
        ok = torch.ones((), dtype=torch.bool, device=problem.device)
        return ops.compose_delta(dx_p, dx_l_rows), ok
