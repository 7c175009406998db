"""Marginal / joint covariance recovery at the current linearization point
(counterpart of ``graphite_tpu/covariance.py``).

Selected columns of the inverse Gauss-Newton Hessian ``H = J^T dL P J``,
recovered through the same dense / Schur elimination paths the direct
solvers use.

Semantics (the JAX package's):

- the covariance is the inverse of the (robust-reweighted) Gauss-Newton
  Hessian at the linearization point in original parameter units: the
  scaled system's selected inverse entries are unscaled by
  ``lin.scales``;
- ``damping=0`` (the default) needs a gauge-fixed problem; ``damping>0``
  returns the Tikhonov-regularized inverse (the LM step's diagonal
  augmentation);
- a manifold vertex's covariance lives in its tangent space.

Paths:

- ``method="dense"``: densify H (O(dim_h^2) memory), one Cholesky, solve
  the requested unit columns;
- ``method="schur"``: the Schur solvers' elimination: the Hessian values
  (K1 on the card), ``schur_values`` (K3 above the JAX package's gate),
  the dense pose system factored once, and per requested column b_S
  (``SchurOps.b_schur``, K4), one multi-right-hand-side solve over all
  columns, the landmark back-substitution (``landmark_update``, K4) and
  ``compose_delta``. O(dim_p^2) memory whatever the landmark count; needs
  an eliminated vertex type;
- ``method="auto"``: schur when the problem has an eliminated type, else
  dense.

Both paths factor in float64 (``dense_cholesky.cholesky_solve`` says why)
and return float64: a pose solution keeps its float64 bits (the JAX
package rounds it to the graph dtype), while the landmark
back-substitution takes it rounded to the graph dtype, as in the JAX
package. A failed factorization gives NaN, as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from .linearize import Linearization
from .schur import SchurOps, build_schur_structure, schur_values
from .solvers.dense_cholesky import assemble_dense_hessian, damp_hessian
from .solvers.dense_cholesky_schur import schur_to_dense

Target = Tuple[str, int]  # (vertex type name, global id)


def _target_columns(problem, targets: Sequence[Target]):
    """Resolve (vname, gid) targets to scaled-Hessian column indices.

    Returns (cols, spans): ``cols`` is the concatenated column list,
    ``spans[i] = (start, dim)`` locates target i inside it.
    """
    cols: List[int] = []
    spans: List[Tuple[int, int]] = []
    for vname, gid in targets:
        if vname not in problem.vertex_meta:
            raise KeyError(f"unknown vertex type {vname!r}")
        local = problem.host_local_index(vname, gid)
        c0 = int(problem.host.vertex_col_offset[vname][local])
        # fixed/inactive vertices point at the trash pad region past dim_h
        # (masking-not-compaction layout); they carry no Hessian columns
        if c0 < 0 or c0 >= problem.dim_h:
            raise ValueError(
                f"vertex ({vname!r}, {gid}) has no Hessian columns — it is "
                "fixed or inactive; its covariance is zero by definition")
        d = problem.vertex_meta[vname].vtype.dim
        spans.append((len(cols), d))
        cols.extend(range(c0, c0 + d))
    return np.asarray(cols, dtype=np.int64), spans


def cholesky64(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of A in float64; NaN where the
    factorization failed."""
    L, info = torch.linalg.cholesky_ex(A.to(torch.float64),
                                       check_errors=False)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def unit_column(n: int, col: int, dtype, device) -> torch.Tensor:
    """(n,) unit vector e_col."""
    e = torch.zeros(n, dtype=dtype, device=device)
    e[col] = 1
    return e


def _dense_selected_inverse(problem, lin: Linearization, cols: np.ndarray,
                            damping: float,
                            use_identity: bool) -> torch.Tensor:
    """(k, k) = H_scaled^{-1}[cols, cols] via one dense Cholesky."""
    H = assemble_dense_hessian(problem, lin)
    if damping:
        H = damp_hessian(H, damping, use_identity)
    L = cholesky64(H)
    c = torch.as_tensor(cols, device=problem.device)
    E = torch.zeros(problem.dim_h, cols.shape[0], dtype=L.dtype,
                    device=problem.device)
    E[c, torch.arange(cols.shape[0], device=problem.device)] = 1
    return torch.cholesky_solve(E, L).index_select(0, c)  # (k, k)


def schur_system(problem, lin: Linearization, damping: float,
                 use_identity: bool) -> SchurOps:
    """The damped Hessian values and their Schur complement."""
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv = compute_hessian_values(problem, hs, lin)
    if damping:
        hv = apply_damping(problem, hs, hv, lin.diag, damping, use_identity)
    return SchurOps(problem, ss, hv, schur_values(problem, ss, hv))


def schur_column(ops: SchurOps, col: int, x_p: torch.Tensor) -> torch.Tensor:
    """The (dim_x,) column ``col`` of H^{-1} (graph dtype) from its pose
    part ``x_p`` (float64): the landmark back-substitution and
    ``compose_delta``."""
    problem = ops.problem
    gdt = problem.precision.graph_dtype
    e = unit_column(problem.dim_x, col, gdt, problem.device)
    x_p = x_p.to(gdt)
    return ops.compose_delta(x_p, ops.landmark_update(e, x_p))


def _schur_selected_inverse(problem, lin: Linearization, cols: np.ndarray,
                            damping: float,
                            use_identity: bool) -> torch.Tensor:
    """(k, k) = H_scaled^{-1}[cols, cols] via Schur elimination:
    x_p = S^{-1}(e_p - Hpl Hll^{-1} e_l), x_l = Hll^{-1}(e_l - Hpl^T x_p)
    per requested column e."""
    ops = schur_system(problem, lin, damping, use_identity)
    L = cholesky64(schur_to_dense(problem, ops.ss, ops.sv))
    gdt = problem.precision.graph_dtype
    dim_p = ops.ss.dim_p
    B = torch.stack([ops.b_schur(unit_column(problem.dim_x, int(c), gdt,
                                             problem.device))
                     for c in cols], dim=1)  # (dim_p, k)
    Xp = torch.cholesky_solve(B.to(L.dtype), L)  # (dim_p, k) float64
    c = torch.as_tensor(cols, device=problem.device)
    pose = torch.as_tensor(cols < dim_p, device=problem.device)
    pose_rows = c.clamp(max=dim_p - 1)
    out = []
    for j in range(cols.shape[0]):
        x = schur_column(ops, int(cols[j]), Xp[:, j])
        # a pose entry keeps the float64 solution's bits
        out.append(torch.where(pose, Xp[:, j].index_select(0, pose_rows),
                               x.index_select(0, c).to(Xp.dtype)))
    return torch.stack(out, dim=1)  # [i, j] = (H^-1)_{ci, cj}


def _resolve_method(problem, method: str) -> str:
    if method not in ("auto", "dense", "schur"):
        raise ValueError(f"unknown method {method!r}")
    has_elim = problem.elimination_block < problem.n_blocks
    if method == "schur" and not has_elim:
        raise ValueError(
            "method='schur' requires an eliminated vertex type "
            "(VertexSet.set_eliminate)")
    if method == "auto":
        return "schur" if has_elim else "dense"
    return method


def joint_covariance(problem, lin: Linearization,
                     targets: Sequence[Target], *,
                     method: str = "auto", damping: float = 0.0,
                     use_identity: bool = False) -> torch.Tensor:
    """Joint covariance over the requested vertices.

    Returns the (D, D) float64 block of ``H^{-1}`` (original units)
    spanning the targets' tangent coordinates in the order given, D = sum
    of vertex dims. Marginals are its diagonal blocks; off-diagonal blocks
    are the cross-covariances.
    """
    if not targets:
        raise ValueError("no targets given")
    cols, _ = _target_columns(problem, targets)
    fn = (_dense_selected_inverse if _resolve_method(problem, method)
          == "dense" else _schur_selected_inverse)
    sub = fn(problem, lin, cols, float(damping), use_identity)
    # unscale: H_unscaled^{-1} = S H_scaled^{-1} S with S = diag(lin.scales)
    s = lin.scales.index_select(
        0, torch.as_tensor(cols, device=problem.device)).to(sub.dtype)
    sub = sub * s[:, None] * s[None, :]
    return 0.5 * (sub + sub.T)  # exact-symmetry cleanup


def marginal_covariances(problem, lin: Linearization,
                         targets: Sequence[Target], *,
                         method: str = "auto", damping: float = 0.0,
                         use_identity: bool = False
                         ) -> Dict[Target, torch.Tensor]:
    """Per-vertex (d, d) marginal covariance blocks (original units).

    One batched selected-inverse solve over all targets' columns; see the
    module docstring for semantics and method selection.
    """
    joint = joint_covariance(problem, lin, targets, method=method,
                             damping=damping, use_identity=use_identity)
    _, spans = _target_columns(problem, targets)
    return {t: joint[s:s + d, s:s + d] for t, (s, d) in zip(targets, spans)}
