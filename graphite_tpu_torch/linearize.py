"""Linearization: residuals, Jacobians, chi2, Jacobi scaling, b, and the
matrix-free products (counterpart of ``graphite_tpu/linearize.py``).

- residuals and Jacobians per factor type, masked per slot: analytic
  (``jacobian_fn``) or, without one, forward-mode derivatives through
  each slot's retraction (``Differentiation.AUTO``);
- chi2 with robust loss and its derivative dL;
- Jacobi column scaling ``s = 1 / (eps + sqrt(diag(J^T dL P J)))``;
- ``b = -sum_f J^T dL P r``, reduced per vertex row by ``reduce_rows``;
- ``Jv``, ``JtPv`` and ``hessian_matvec`` (H x = J^T dL P J x) on the
  stored Jacobians, the matrix-free PCG's products. A factor set frozen
  with ``store_jacobians=False`` (dynamic mode) stores none: its entry in
  ``Linearization.jacobians`` is None and the products recompute its
  scaled J from ``params`` on every call, with the same operations as
  ``linearize`` (so the same bits as a stored J).
- On a rank's replica (``parallel/sharding.py``) the factors are the
  rank's slice: the scaling diagonal, b, chi2 and ``JtPv`` are summed over
  the ranks (``problem.allreduce``) after the rank's own row reductions.

``Graph.scale_system(False)`` turns the column scaling off (scales 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
from .ops.cuda import bal as k7
from .ops.cuda import pose as k11
from .ops.device_loop import copy_into
from .ops.streamreduce import reduce_rows, segment_plan
from .precision import clamp_to_storage, sqrt_rn

# Diagonal clamp range of LM damping.
DIAG_MIN = 1.0e-6
DIAG_MAX = 1.0e32


@dataclasses.dataclass
class Linearization:
    """Everything one linearization pass produces."""

    residuals: Dict[str, torch.Tensor]  # (F, E) graph dtype
    # per slot (F, E*d_i); None for a set in dynamic mode
    jacobians: Dict[str, Optional[Tuple[torch.Tensor, ...]]]
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
    return r, _mask_slots(J, fa.slot_mask, ftype.residual_dim, _dims(ftype))


def _dims(ftype):
    return tuple(vt.dim for vt in ftype.vertex_types)


# The per-factor arithmetic below takes tensors, not a problem: the generic
# branch and the plain versions of K11's entries (``ops/cuda/pose.py``)
# share it, so the two give the same bits by construction.

def _mask_slots(J, slot_mask, E: int, dims):
    """Per-slot (F, E, d) Jacobians -> flat (F, E*d), each times its
    slot's mask."""
    return tuple(
        (Ji.reshape(-1, E, d) * slot_mask[:, s, None, None].to(Ji.dtype))
        .reshape(-1, E * d) for s, (Ji, d) in enumerate(zip(J, dims)))


def _weighted_residual(precision, r: torch.Tensor, acc) -> torch.Tensor:
    """P @ r per factor; no precision (identity) short-circuits to r."""
    if precision is None:
        return r
    E = r.shape[-1]
    return flat_block_mv(precision, r, E, E, acc_dtype=acc).to(r.dtype)


def _apply_precision(precision, J_flat: torch.Tensor, E: int, d: int,
                     acc) -> torch.Tensor:
    """P @ J per factor on flat (F, E*d) blocks; identity short-circuits."""
    if precision is None:
        return J_flat
    return flat_block_mm_nn(precision, J_flat, E, E, d, acc_dtype=acc)


def _chi2_terms(r, precision, factor_mask, loss_params, loss, acc):
    """Per-factor robust chi2 (masked to active factors) and dL of the
    residuals ``r``."""
    pr = _weighted_residual(precision, r, acc)
    raw = sum_in_order(r[:, e] * pr[:, e] for e in range(r.shape[1]))
    chi2 = loss.value(raw, loss_params) * factor_mask.to(raw.dtype)
    return chi2, loss.derivative(raw, loss_params)


def _diag_rows(jflat, precision, dL, E: int, dims, acc):
    """Each slot's (F, d) rows of the unscaled J^T dL P J's diagonal."""
    dL = dL.to(acc)
    out = []
    for Ji, d in zip(jflat, dims):
        Ji = Ji.to(acc)
        PJ = _apply_precision(precision, Ji, E, d, acc).reshape(-1, E, d)
        Ji = Ji.reshape(-1, E, d)
        out.append(sum_in_order(Ji[:, e] * PJ[:, e] for e in range(E))
                   * dL[:, None])
    return tuple(out)


def _store_jacobians(jflat, scale_rows, rows, E: int, storage):
    """Each slot's flat J times its columns' scales, in ``storage``:
    ``scale_rows`` holds each slot's padded (n_rows + 1, d) scale rows,
    gathered at the slot's ``rows`` (None: not scaled). Column c of
    residual row e sits at flat index e*d + c, so the per-column scales
    tile E times."""
    out = []
    for s, Ji in enumerate(jflat):
        if scale_rows is not None:
            si = scale_rows[s].index_select(0, rows[s])
            Ji = Ji * si.repeat(1, E).to(Ji.dtype)
        out.append(clamp_to_storage(Ji, storage))
    return tuple(out)


def _b_rows(stored, r, dL, precision, E: int, dims, acc):
    """Each slot's (F, d) rows of b = -J^T dL P r, from the stored J."""
    w = (_weighted_residual(precision, r, acc) * dL[:, None]).to(acc)
    return tuple(-flat_block_mv_t(Js, w, E, d, acc_dtype=acc)
                 for Js, d in zip(stored, dims))


def _retract_active(retract, params, rows, active_row, active):
    """retract(params, delta) for active vertices, delta gathered from a
    type's padded (n_rows + 1, d) rows of the scaled step at
    ``active_row``; inactive vertices keep their parameters."""
    delta = rows.index_select(0, active_row).to(params.dtype)
    return torch.where(active[:, None], retract(params, delta), params)


def _factor_row_reduce(problem, contrib, fname, s, vt_name):
    """(F, d) contributions of factor slot ``s`` -> (n_rows, d) rows of
    vertex type ``vt_name`` (inactive vertices hit the dropped trash row)."""
    tag = ("rows", fname, s)
    plan = problem._cache.get("segment_plans", {}).get(tag)
    if plan is None:  # the destinations are gathered on the host once
        ids = problem.shard_slice(problem.host.factor_ids[fname][:, s],
                                  contrib.shape[0])
        plan = segment_plan(problem, tag,
                            problem.host.vertex_active_row[vt_name][ids],
                            problem.seg_rows[vt_name] + 1, contrib.shape[1])
    return reduce_rows(contrib, plan)[:-1]


def compute_chi2_block(problem: Problem, name: str, r: torch.Tensor):
    """Per-factor robust chi2 (masked to active factors) and dL."""
    fa = problem.data.factors[name]
    return _chi2_terms(r, fa.precision, fa.factor_mask, fa.loss_params,
                       problem.factor_meta[name].ftype.loss,
                       problem.precision.acc_dtype)


def linearize(problem: Problem, params,
              out: Optional[Linearization] = None) -> Linearization:
    """One linearization pass. A set that passes K7's gate
    (``ops/cuda/bal.gate``: the BAL reprojection factor, in a float32 or
    a float64 graph) or K11's
    (``ops/cuda/pose.gate``: the SE(3) pose-graph factors) takes that
    kernel's two fused entries for its per-factor rows; every set's rows
    are then summed per vertex row by the same plans (K1), in the same
    order.

    With ``out`` (a linearization of the same problem, which this pass
    does not read) the pass writes into ``out``'s tensors and returns it:
    K7 and K11 store r, chi2, dL and the stored J into them, b, the
    diagonal and the scales are formed in them; what else a set computes
    (a set off both gates, the scalar chi2) is copied in. The same bits
    as a new linearization."""
    gdt = problem.precision.graph_dtype
    acc = problem.precision.acc_dtype

    residuals, jac_flat, chi2_vec, chi2_deriv = {}, {}, {}, {}
    fused, diag_contribs = {}, {}
    for name in problem.factor_meta:
        into = None if out is None else (
            out.residuals[name], out.chi2_vec[name], out.chi2_deriv[name])
        loss = k7.gate(problem, name)
        if loss is not None:
            fused[name] = k7
            (residuals[name], jc, jp, chi2_vec[name], chi2_deriv[name],
             dc, dp) = k7.bal_linearize(*_gather_args(problem, params, name),
                                        loss, into)
            jac_flat[name] = (jc, jp)
            diag_contribs[name] = (dc, dp)
            continue
        loss = k11.gate(problem, name)
        if loss is not None:
            fused[name] = k11
            fa = problem.data.factors[name]
            (residuals[name], jac_flat[name], chi2_vec[name],
             chi2_deriv[name], diag_contribs[name]) = k11.se3_linearize(
                *_pose_args(problem, params, name), fa.slot_mask,
                fa.factor_mask, fa.loss_params, loss, into)
            continue
        r, jflat = _residuals_and_flat_jacobians(problem, params, name)
        residuals[name] = r.to(gdt)
        jac_flat[name] = jflat
        chi2_vec[name], chi2_deriv[name] = compute_chi2_block(
            problem, name, residuals[name])
        # Jacobi scaling: diag of the unscaled J^T dL P J
        ftype = problem.factor_meta[name].ftype
        diag_contribs[name] = _diag_rows(
            jflat, problem.data.factors[name].precision, chi2_deriv[name],
            ftype.residual_dim, _dims(ftype), acc)
    diag_raw = problem.allreduce(_reduce_contribs(problem, diag_contribs),
                                 "linearize.diag")
    del diag_contribs

    if problem.scale_jacobians:
        eps = float(np.finfo(np.float64).eps)
        scales = (1.0 / (eps + sqrt_rn(diag_raw))).to(gdt)
        scales = torch.where(diag_raw > 0, scales, torch.ones_like(scales),
                             out=None if out is None else out.scales)
    else:
        scales = torch.ones(problem.dim_x, dtype=gdt, device=problem.device)

    # the scaled Jacobians, stored for every set not in dynamic mode, and
    # b = -J^T dL P r
    jacobians: Dict[str, Optional[Tuple[torch.Tensor, ...]]] = {}
    b_contribs = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        if name in fused:
            jacobians[name], b_contribs[name] = fused[name].scale_b(
                jac_flat[name], residuals[name], chi2_deriv[name],
                fa.precision, _scale_rows(problem, name, scales), fa.rows,
                problem.precision.solver_dtype,
                None if out is None else out.jacobians[name])
            continue
        jflat = _scaled_jacobians(problem, name, jac_flat[name], scales)
        jacobians[name] = jflat if fm.store_jacobians else None
        b_contribs[name] = _b_rows(jflat, residuals[name], chi2_deriv[name],
                                   fa.precision, fm.ftype.residual_dim,
                                   _dims(fm.ftype), acc)
    del jac_flat
    diag = torch.mul(diag_raw * scales, scales,
                     out=None if out is None else out.diag)
    b = problem.allreduce(
        _reduce_contribs(problem, b_contribs,
                         None if out is None else out.b), "linearize.b")

    chi2 = problem.allreduce(sum(v.sum(dtype=torch.float64)
                                 for v in chi2_vec.values()),
                             "linearize.chi2").to(gdt)
    lin = Linearization(residuals=residuals, jacobians=jacobians,
                        chi2_vec=chi2_vec, chi2_deriv=chi2_deriv,
                        scales=scales, diag=diag, b=b, chi2=chi2)
    if out is None:
        return lin
    copy_into(out, lin)
    return out


def _reduce_contribs(problem: Problem, contribs,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-set, per-slot (F, d) rows -> the flat (dim_x,) sum per vertex
    row, the sets added in ``factor_meta`` order (into ``out`` when
    given)."""
    gdt = problem.precision.graph_dtype
    rows_by_type: Dict[str, torch.Tensor] = {}
    for name, fm in problem.factor_meta.items():
        for s, vt in enumerate(fm.ftype.vertex_types):
            rows = _factor_row_reduce(problem, contribs[name][s].to(gdt),
                                      name, s, vt.name)
            prev = rows_by_type.get(vt.name)
            rows_by_type[vt.name] = rows if prev is None else prev + rows
    return problem.flat_from_rows(rows_by_type, out=out)


def _gather_args(problem: Problem, params, name: str):
    """K7's inputs of a set: the camera and point tables, the factors'
    vertex ids, observations, slot and factor masks and loss parameters."""
    fa = problem.data.factors[name]
    ftype = problem.factor_meta[name].ftype
    return (*(params[vt.name] for vt in ftype.vertex_types), *fa.ids,
            fa.obs, fa.slot_mask, fa.factor_mask, fa.loss_params)


def _pose_args(problem: Problem, params, name: str):
    """K11's inputs of a set: the pose table, the factors' vertex ids per
    slot, the measurements and the precision."""
    fa = problem.data.factors[name]
    vt = problem.factor_meta[name].ftype.vertex_types[0]
    return params[vt.name], fa.ids, fa.obs, fa.precision


def _scale_rows(problem: Problem, name: str, scales):
    """Each slot's padded (n_rows + 1, d) rows of the flat ``scales``, or
    None when the problem does not scale its Jacobians."""
    if not problem.scale_jacobians:
        return None
    return tuple(problem.rows_view_padded(scales, vt.name)
                 for vt in problem.factor_meta[name].ftype.vertex_types)


def _scaled_jacobians(problem: Problem, name: str, jflat, scales):
    """A set's masked flat Jacobians times their columns' scales, in the
    storage dtype."""
    return _store_jacobians(
        jflat, _scale_rows(problem, name, scales),
        problem.data.factors[name].rows,
        problem.factor_meta[name].ftype.residual_dim,
        problem.precision.solver_dtype)


def block_jacobians(problem: Problem, lin: Linearization, name: str,
                    params=None) -> Tuple[torch.Tensor, ...]:
    """A set's scaled Jacobians: stored, or (dynamic mode) recomputed
    from ``params``; raises when a dynamic set gets no ``params``."""
    J = lin.jacobians[name]
    if J is not None:
        return J
    if params is None:
        raise ValueError(f"factor block '{name}' uses dynamic Jacobians; "
                         "pass params to the matvec")
    _, jflat = _residuals_and_flat_jacobians(problem, params, name)
    return _scaled_jacobians(problem, name, jflat, lin.scales)


def compute_chi2(problem: Problem, params) -> torch.Tensor:
    """chi2 only.

    Like ``linearize``'s chi2, the per-factor terms are summed in float64
    (the JAX package sums in the graph dtype): in float32 the summation
    noise over tens of thousands of factors is as large as the gains of
    late LM iterations, and the accept / reject decision would then hang
    on the summation order, which differs between CPU and GPU."""
    total = torch.zeros((), dtype=torch.float64, device=problem.device)
    for name in problem.factor_meta:
        loss = k7.gate(problem, name)
        if loss is not None:
            cam, pt, ids0, ids1, obs, _, fmask, lp = _gather_args(
                problem, params, name)
            c = k7.bal_residual(cam, pt, ids0, ids1, obs, fmask, lp, loss)
            total = total + c.sum(dtype=torch.float64)
            continue
        loss = k11.gate(problem, name)
        if loss is not None:
            fa = problem.data.factors[name]
            c = k11.se3_residual(*_pose_args(problem, params, name),
                                 fa.factor_mask, fa.loss_params, loss)
            total = total + c.sum(dtype=torch.float64)
            continue
        r = compute_residuals_block(problem, params, name)
        c, _ = compute_chi2_block(problem, name, r)
        total = total + c.sum(dtype=torch.float64)
    return problem.allreduce(total, "compute_chi2").to(
        problem.precision.graph_dtype)


def Jv(problem: Problem, lin: Linearization, x: torch.Tensor,
       params=None) -> Dict[str, torch.Tensor]:
    """v = J x per factor block ((F, E) each); ``x`` is a (dim_x,) vector
    (its pad is never read: masked Jacobian columns are zero). ``params``:
    the linearization point, needed by sets in dynamic mode."""
    acc = problem.precision.acc_dtype
    gdt = problem.precision.graph_dtype
    x_rows = {name: problem.rows_view_padded(x, name)
              for name in problem.vertex_meta}
    out = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        J = block_jacobians(problem, lin, name, params)
        out[name] = sum_in_order(
            flat_block_mv(J[s],
                          x_rows[vt.name].index_select(0, fa.rows[s]), E,
                          vt.dim, acc_dtype=acc)
            for s, vt in enumerate(fm.ftype.vertex_types)).to(gdt)
    return out


def JtPv(problem: Problem, lin: Linearization,
         v: Dict[str, torch.Tensor], params=None) -> torch.Tensor:
    """J^T dL P v summed over every factor block into a (dim_x,) vector;
    each slot's rows are reduced by ``reduce_rows`` on the slot's cached
    plan (kernel K1 on CUDA, no float atomics)."""
    acc = problem.precision.acc_dtype
    gdt = problem.precision.graph_dtype
    out_rows: Dict[str, torch.Tensor] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        w = (_weighted_residual(fa.precision, v[name], acc)
             * lin.chi2_deriv[name][:, None]).to(acc)
        J = block_jacobians(problem, lin, name, params)
        for s, vt in enumerate(fm.ftype.vertex_types):
            contrib = flat_block_mv_t(J[s], w, E, vt.dim,
                                      acc_dtype=acc)
            rows = _factor_row_reduce(problem, contrib.to(gdt), name, s,
                                      vt.name)
            prev = out_rows.get(vt.name)
            out_rows[vt.name] = rows if prev is None else prev + rows
    return problem.allreduce(problem.flat_from_rows(out_rows), "JtPv")


def hessian_matvec(problem: Problem, lin: Linearization,
                   x: torch.Tensor, params=None) -> torch.Tensor:
    """The implicit H x = J^T dL P (J x)."""
    return JtPv(problem, lin, Jv(problem, lin, x, params), params)


def apply_update(problem: Problem, params, lin: Linearization,
                 delta_x: torch.Tensor):
    """params' = retract(params, scales * delta_x) for active vertices; an
    SE(3) type in a float32 graph (``ops/cuda/pose.update_gate``) on K11's
    ``se3_update``."""
    new_params = {}
    scaled = None
    for name, vm in problem.vertex_meta.items():
        va = problem.data.vertices[name]
        if k11.update_gate(problem, name):
            new_params[name] = k11.se3_update(
                params[name], delta_x, lin.scales, problem.seg_start[name],
                problem.seg_rows[name], va.active_row, va.active)
            continue
        if scaled is None:
            scaled = delta_x * lin.scales
        new_params[name] = _retract_active(
            vm.vtype.retract, params[name],
            problem.rows_view_padded(scaled, name), va.active_row, va.active)
    return new_params


def backup_parameters(problem: Problem, params):
    """Trust-region backup (``save_state`` per vertex type)."""
    return {name: vm.vtype.save_state(params[name])
            for name, vm in problem.vertex_meta.items()}


def restore_parameters(problem: Problem, params, backup):
    """Revert to a backup with partial-state semantics (``load_state``)."""
    return {name: vm.vtype.load_state(params[name], backup[name])
            for name, vm in problem.vertex_meta.items()}
