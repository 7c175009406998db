"""Block-Jacobi preconditioner (counterpart of
``graphite_tpu/preconditioners/block_jacobi.py``).

- per-vertex diagonal blocks ``B_v = sum_f dL_f J_{f,v}^T P_f J_{f,v}``
  from the (scaled) stored Jacobians: in-order block products, reduced
  over the vertex ids by ``reduce_rows`` (kernel K1 on CUDA, through the
  sort permutation where the ids are not sorted);
- LM damping on the diagonal from a pre-damping backup: ``d += mu``
  (identity damping) or ``d += mu * clamp(d, 1e-6, 1e32)``;
- inactive vertices get identity blocks so every inverse is finite;
  ``spd_inverse`` inverts in the precision's ``inv_dtype`` (blocks above
  3x3 by a float64 Cholesky, rounded);
- apply: ``z = B_v^{-1} r`` per row of each vertex type, the inverse
  blocks gathered by the row -> vertex map.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..linearize import DIAG_MAX, DIAG_MIN, Linearization, _apply_precision
from ..ops.batched_linalg import spd_inverse
from ..ops.blockfmt import flat_block_mm_tn, flat_block_mv
from ..ops.streamreduce import reduce_rows, segment_plan


@dataclasses.dataclass
class BlockJacobiState:
    blocks: Dict[str, torch.Tensor]  # (V, d*d) flat pre-damping blocks
    diag_backup: Dict[str, torch.Tensor]  # (V, d) pre-damping diagonals
    inv_blocks: Dict[str, torch.Tensor]  # (V, d*d) flat damped inverses


def compute_block_diagonal(problem, lin: Linearization
                           ) -> Dict[str, torch.Tensor]:
    """Per-vertex (V, d*d) diagonal Hessian blocks (summed over the ranks
    on a rank's replica)."""
    inv_dt = problem.precision.inv_dtype
    acc = problem.precision.acc_dtype
    blocks = {
        name: torch.zeros((vm.count, vm.vtype.dim * vm.vtype.dim),
                          dtype=inv_dt, device=problem.device)
        for name, vm in problem.vertex_meta.items()
    }
    for fname, fm in problem.factor_meta.items():
        if lin.jacobians[fname] is None:
            raise ValueError(
                "block-Jacobi preconditioner requires stored Jacobians; "
                f"factor block '{fname}' is in dynamic mode")
        fa = problem.data.factors[fname]
        dL = lin.chi2_deriv[fname].to(acc)
        E = fm.ftype.residual_dim
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = lin.jacobians[fname][s].to(acc)
            PJ = _apply_precision(fa.precision, Ji, E, vt.dim, acc)
            blk = flat_block_mm_tn(Ji, PJ, vt.dim, E, vt.dim,
                                   acc_dtype=acc) * dL[:, None]
            plan = segment_plan(problem, ("bj_blocks", fname, s),
                                problem.shard_slice(
                                    problem.host.factor_ids[fname][:, s],
                                    blk.shape[0]),
                                problem.vertex_meta[vt.name].count,
                                vt.dim * vt.dim)
            blocks[vt.name] = blocks[vt.name] + reduce_rows(blk.to(inv_dt),
                                                            plan)
    return {name: problem.allreduce(b, f"block_jacobi {name}")
            for name, b in blocks.items()}


def row_inverse_blocks(problem, state: BlockJacobiState,
                       name: str) -> torch.Tensor:
    """(n_rows, d*d) inverse blocks of vertex type ``name`` in row order."""
    return state.inv_blocks[name].index_select(
        0, problem.index(("row_vertex", name), problem.row_vertex[name]))


@dataclasses.dataclass(frozen=True)
class BlockJacobiPreconditioner:
    def prepare(self, problem, lin: Linearization,
                params=None) -> BlockJacobiState:
        blocks = compute_block_diagonal(problem, lin)
        diag_backup = {}
        for name, b in blocks.items():
            d = problem.vertex_meta[name].vtype.dim
            diag_backup[name] = b[:, ::d + 1]
        return BlockJacobiState(
            blocks=blocks, diag_backup=diag_backup,
            inv_blocks={n: torch.zeros_like(b) for n, b in blocks.items()})

    def set_damping(self, problem, lin, state: BlockJacobiState, damping,
                    use_identity) -> BlockJacobiState:
        inv_blocks = {}
        for name, vm in problem.vertex_meta.items():
            dim = vm.vtype.dim
            d0 = state.diag_backup[name]
            if use_identity:
                dd = d0 + damping
            else:
                dd = d0 + damping * d0.clamp(DIAG_MIN, DIAG_MAX)
            damped = state.blocks[name].clone()
            damped[:, ::dim + 1] = dd.to(damped.dtype)
            damped = damped.reshape(-1, dim, dim)
            # inactive vertices have all-zero blocks: identity keeps their
            # inverse finite (apply never reads it)
            active = problem.data.vertices[name].active
            eye = torch.eye(dim, dtype=damped.dtype, device=damped.device)
            damped = torch.where(active[:, None, None], damped, eye)
            inv_blocks[name] = spd_inverse(damped).reshape(-1, dim * dim)
        return BlockJacobiState(blocks=state.blocks,
                                diag_backup=state.diag_backup,
                                inv_blocks=inv_blocks)

    def apply(self, problem, lin, state: BlockJacobiState,
              r: torch.Tensor) -> torch.Tensor:
        acc = problem.precision.acc_dtype
        z_rows = {}
        for name, vm in problem.vertex_meta.items():
            if problem.seg_rows[name] == 0:
                continue
            dim = vm.vtype.dim
            z_rows[name] = flat_block_mv(
                row_inverse_blocks(problem, state, name),
                problem.rows_view(r, name), dim, dim, acc_dtype=acc)
        return problem.flat_from_rows(z_rows,
                                      dtype=problem.precision.graph_dtype)
