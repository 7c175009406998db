"""Linearization: residuals, Jacobians, chi2, Jacobi scaling, b, and the
matrix-free products (counterpart of ``graphite_tpu/linearize.py``).

- residuals and Jacobians per factor type, masked per slot: analytic
  (``jacobian_fn``) or, without one, forward-mode derivatives through
  each slot's retraction (``Differentiation.AUTO``);
- chi2 with robust loss and its derivative dL;
- Jacobi column scaling ``s = 1 / (eps + sqrt(diag(J^T dL P J)))``;
- ``b = -sum_f J^T dL P r``, reduced per vertex row by ``reduce_rows``;
- ``Jv``, ``JtPv`` and ``hessian_matvec`` (H x = J^T dL P J x) on the
  stored Jacobians, the matrix-free PCG's products.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .factors import Differentiation
from .graph import FactorArrays, Problem
from .ops.blockfmt import (
    flat_block_mm_nn,
    flat_block_mv,
    flat_block_mv_t,
    sum_in_order,
)
from .ops.streamreduce import reduce_rows, segment_plan
from .precision import clamp_to_storage, sqrt_rn

# Diagonal clamp range of LM damping.
DIAG_MIN = 1.0e-6
DIAG_MAX = 1.0e32


@dataclasses.dataclass
class Linearization:
    """Everything one linearization pass produces."""

    residuals: Dict[str, torch.Tensor]  # (F, E) graph dtype
    jacobians: Dict[str, Tuple[torch.Tensor, ...]]  # per slot (F, E*d_i)
    chi2_vec: Dict[str, torch.Tensor]  # (F,) robust per-factor chi2
    chi2_deriv: Dict[str, torch.Tensor]  # (F,) loss derivative dL
    scales: torch.Tensor  # (dim_x,) Jacobi column scales
    diag: torch.Tensor  # (dim_x,) diagonal of the scaled Hessian
    b: torch.Tensor  # (dim_x,) -J^T dL P r of the scaled system
    chi2: torch.Tensor  # scalar


def _tail(fa: FactorArrays):
    return tuple(a for a in (fa.obs, fa.data) if a is not None)


def _gather_params(problem: Problem, params, name: str):
    fa = problem.data.factors[name]
    ftype = problem.factor_meta[name].ftype
    return tuple(params[vt.name].index_select(0, fa.ids[s])
                 for s, vt in enumerate(ftype.vertex_types))


def compute_residuals_block(problem: Problem, params,
                            name: str) -> torch.Tensor:
    """(F, E) residuals of one factor block."""
    fa = problem.data.factors[name]
    ftype = problem.factor_meta[name].ftype
    r = ftype.residual_fn(*_gather_params(problem, params, name), *_tail(fa))
    return r.reshape(-1, ftype.residual_dim)


def _auto_residual_and_jacobians(ftype, gathered, tail):
    """(F, E) residuals and per-slot (F, E, d_s) Jacobians of a factor
    block without ``jacobian_fn``: the residual of each slot's
    ``retract(x, delta)``, differentiated at delta = 0 by forward mode.

    The factors are independent, so column k of every factor's Jacobian
    is the jvp along basis direction k. All K = sum(d_s) columns come from
    one ``torch.func.jvp`` over the block with a leading basis axis of
    size K (direction k in batch entry k)."""
    dims = [vt.dim for vt in ftype.vertex_types]
    K = sum(dims)
    p0 = gathered[0]
    F = p0.shape[0]
    xs = tuple(p.expand(K, *p.shape) for p in gathered)
    rest = tuple(t.expand(K, *t.shape) for t in tail)
    eye = torch.eye(K, dtype=p0.dtype, device=p0.device)
    zeros, tangents, off = [], [], 0
    for d in dims:
        zeros.append(p0.new_zeros((K, F, d)))
        tangents.append(eye[:, None, off:off + d].expand(K, F, d))
        off += d

    def g(*deltas):
        moved = tuple(vt.retract(x, dl) for vt, x, dl
                      in zip(ftype.vertex_types, xs, deltas))
        return ftype.residual_fn(*moved, *rest).reshape(
            K, F, ftype.residual_dim)

    r, jt = torch.func.jvp(g, tuple(zeros), tuple(tangents))
    J, off = [], 0
    for d in dims:  # jt[k, f, e] = d r_e / d delta_k
        J.append(jt[off:off + d].permute(1, 2, 0))
        off += d
    return r[0], tuple(J)


def _residuals_and_flat_jacobians(problem: Problem, params, name: str):
    """(F, E) residuals + per-slot masked flat (F, E*d) Jacobians."""
    fa = problem.data.factors[name]
    ftype = problem.factor_meta[name].ftype
    gathered = _gather_params(problem, params, name)
    if ftype.differentiation is Differentiation.MANUAL:
        args = (*gathered, *_tail(fa))
        r = ftype.residual_fn(*args).reshape(-1, ftype.residual_dim)
        J = ftype.jacobian_fn(*args)
    else:
        r, J = _auto_residual_and_jacobians(ftype, gathered, _tail(fa))
    E = ftype.residual_dim
    jflat = tuple(
        (Ji.reshape(-1, E, vt.dim)
         * fa.slot_mask[:, s, None, None].to(Ji.dtype)).reshape(-1, E * vt.dim)
        for s, (Ji, vt) in enumerate(zip(J, ftype.vertex_types)))
    return r, jflat


def _weighted_residual(fa: FactorArrays, r: torch.Tensor, acc) -> torch.Tensor:
    """P @ r per factor; identity precision short-circuits to r."""
    if fa.precision is None:
        return r
    E = r.shape[-1]
    return flat_block_mv(fa.precision, r, E, E, acc_dtype=acc).to(r.dtype)


def _apply_precision(fa: FactorArrays, J_flat: torch.Tensor, E: int, d: int,
                     acc) -> torch.Tensor:
    """P @ J per factor on flat (F, E*d) blocks; identity short-circuits."""
    if fa.precision is None:
        return J_flat
    return flat_block_mm_nn(fa.precision, J_flat, E, E, d, acc_dtype=acc)


def _factor_row_reduce(problem, contrib, fname, s, vt_name):
    """(F, d) contributions of factor slot ``s`` -> (n_rows, d) rows of
    vertex type ``vt_name`` (inactive vertices hit the dropped trash row)."""
    tag = ("rows", fname, s)
    plan = problem._cache.get("segment_plans", {}).get(tag)
    if plan is None:  # the destinations are gathered on the host once
        ids = problem.host.factor_ids[fname][:, s]
        plan = segment_plan(problem, tag,
                            problem.host.vertex_active_row[vt_name][ids],
                            problem.seg_rows[vt_name] + 1, contrib.shape[1])
    return reduce_rows(contrib, plan)[:-1]


def compute_chi2_block(problem: Problem, name: str, r: torch.Tensor):
    """Per-factor robust chi2 (masked to active factors) and dL."""
    fa = problem.data.factors[name]
    loss = problem.factor_meta[name].ftype.loss
    pr = _weighted_residual(fa, r, problem.precision.acc_dtype)
    raw = sum_in_order(r[:, e] * pr[:, e] for e in range(r.shape[1]))
    chi2 = loss.value(raw, fa.loss_params) * fa.factor_mask.to(raw.dtype)
    return chi2, loss.derivative(raw, fa.loss_params)


def linearize(problem: Problem, params) -> Linearization:
    gdt = problem.precision.graph_dtype
    sdt = problem.precision.solver_dtype
    acc = problem.precision.acc_dtype

    residuals, jac_flat, chi2_vec, chi2_deriv = {}, {}, {}, {}
    for name in problem.factor_meta:
        r, jflat = _residuals_and_flat_jacobians(problem, params, name)
        residuals[name] = r.to(gdt)
        jac_flat[name] = jflat
        chi2_vec[name], chi2_deriv[name] = compute_chi2_block(
            problem, name, residuals[name])

    # Jacobi scaling: diag of the unscaled J^T dL P J, per vertex type in
    # row form
    diag_rows: Dict[str, torch.Tensor] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        dL = chi2_deriv[name].to(acc)
        E = fm.ftype.residual_dim
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = jac_flat[name][s].to(acc)
            PJ = _apply_precision(fa, Ji, E, vt.dim, acc).reshape(-1, E, vt.dim)
            Ji = Ji.reshape(-1, E, vt.dim)
            contrib = sum_in_order(Ji[:, e] * PJ[:, e]
                                   for e in range(E)) * dL[:, None]
            rows = _factor_row_reduce(problem, contrib.to(gdt), name, s,
                                      vt.name)
            prev = diag_rows.get(vt.name)
            diag_rows[vt.name] = rows if prev is None else prev + rows
    diag_raw = problem.flat_from_rows(diag_rows)

    eps = float(np.finfo(np.float64).eps)
    scales = (1.0 / (eps + sqrt_rn(diag_raw))).to(gdt)
    scales = torch.where(diag_raw > 0, scales, torch.ones_like(scales))

    # scale and store the Jacobians; column c of residual row e sits at
    # flat index e*d + c, so the per-column scales tile E times
    jacobians: Dict[str, Tuple[torch.Tensor, ...]] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        scaled = []
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = jac_flat[name][s]
            si = problem.rows_view_padded(scales, vt.name).index_select(
                0, fa.rows[s])
            scaled.append(clamp_to_storage(Ji * si.repeat(1, E).to(Ji.dtype),
                                           sdt))
        jacobians[name] = tuple(scaled)

    diag = diag_raw * scales * scales

    # b = -J^T dL P r
    b_rows: Dict[str, torch.Tensor] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        w = (_weighted_residual(fa, residuals[name], acc)
             * chi2_deriv[name][:, None]).to(acc)
        for s, vt in enumerate(fm.ftype.vertex_types):
            contrib = -flat_block_mv_t(jacobians[name][s], w, E, vt.dim,
                                       acc_dtype=acc)
            rows = _factor_row_reduce(problem, contrib.to(gdt), name, s,
                                      vt.name)
            prev = b_rows.get(vt.name)
            b_rows[vt.name] = rows if prev is None else prev + rows
    b = problem.flat_from_rows(b_rows)

    chi2 = sum(v.sum(dtype=torch.float64) for v in chi2_vec.values()).to(gdt)
    return Linearization(residuals=residuals, jacobians=jacobians,
                         chi2_vec=chi2_vec, chi2_deriv=chi2_deriv,
                         scales=scales, diag=diag, b=b, chi2=chi2)


def compute_chi2(problem: Problem, params) -> torch.Tensor:
    """chi2 only.

    Like ``linearize``'s chi2, the per-factor terms are summed in float64
    (the JAX package sums in the graph dtype): in float32 the summation
    noise over tens of thousands of factors is as large as the gains of
    late LM iterations, and the accept / reject decision would then hang
    on the summation order, which differs between CPU and GPU."""
    total = torch.zeros((), dtype=torch.float64, device=problem.device)
    for name in problem.factor_meta:
        r = compute_residuals_block(problem, params, name)
        c, _ = compute_chi2_block(problem, name, r)
        total = total + c.sum(dtype=torch.float64)
    return total.to(problem.precision.graph_dtype)


def Jv(problem: Problem, lin: Linearization,
       x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """v = J x per factor block ((F, E) each); ``x`` is a (dim_x,) vector
    (its pad is never read: masked Jacobian columns are zero)."""
    acc = problem.precision.acc_dtype
    gdt = problem.precision.graph_dtype
    x_rows = {name: problem.rows_view_padded(x, name)
              for name in problem.vertex_meta}
    out = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        out[name] = sum_in_order(
            flat_block_mv(lin.jacobians[name][s],
                          x_rows[vt.name].index_select(0, fa.rows[s]), E,
                          vt.dim, acc_dtype=acc)
            for s, vt in enumerate(fm.ftype.vertex_types)).to(gdt)
    return out


def JtPv(problem: Problem, lin: Linearization,
         v: Dict[str, torch.Tensor]) -> torch.Tensor:
    """J^T dL P v summed over every factor block into a (dim_x,) vector;
    each slot's rows are reduced by ``reduce_rows`` on the slot's cached
    plan (kernel K1 on CUDA, no float atomics)."""
    acc = problem.precision.acc_dtype
    gdt = problem.precision.graph_dtype
    out_rows: Dict[str, torch.Tensor] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        w = (_weighted_residual(fa, v[name], acc)
             * lin.chi2_deriv[name][:, None]).to(acc)
        for s, vt in enumerate(fm.ftype.vertex_types):
            contrib = flat_block_mv_t(lin.jacobians[name][s], w, E, vt.dim,
                                      acc_dtype=acc)
            rows = _factor_row_reduce(problem, contrib.to(gdt), name, s,
                                      vt.name)
            prev = out_rows.get(vt.name)
            out_rows[vt.name] = rows if prev is None else prev + rows
    return problem.flat_from_rows(out_rows)


def hessian_matvec(problem: Problem, lin: Linearization,
                   x: torch.Tensor) -> torch.Tensor:
    """The implicit H x = J^T dL P (J x)."""
    return JtPv(problem, lin, Jv(problem, lin, x))


def apply_update(problem: Problem, params, lin: Linearization,
                 delta_x: torch.Tensor):
    """params' = retract(params, scales * delta_x) for active vertices."""
    new_params = {}
    scaled = delta_x * lin.scales
    for name, vm in problem.vertex_meta.items():
        va = problem.data.vertices[name]
        rows = problem.rows_view_padded(scaled, name)
        delta = rows.index_select(0, va.active_row).to(params[name].dtype)
        updated = vm.vtype.retract(params[name], delta)
        new_params[name] = torch.where(va.active[:, None], updated,
                                       params[name])
    return new_params


def backup_parameters(problem: Problem, params):
    """Trust-region backup (``save_state`` per vertex type)."""
    return {name: vm.vtype.save_state(params[name])
            for name, vm in problem.vertex_meta.items()}


def restore_parameters(problem: Problem, params, backup):
    """Revert to a backup with partial-state semantics (``load_state``)."""
    return {name: vm.vtype.load_state(params[name], backup[name])
            for name, vm in problem.vertex_meta.items()}
