"""The BAL reprojection factor's linearization and Hessian values: kernel
K7 (``csrc/bal.cu``).

No ``pl.pallas_call`` of the JAX package computes this: there it is plain
``jnp`` code that XLA fuses (``graphite_tpu/models/bal.py``: the residual
and its analytic Jacobian; ``graphite_tpu/linearize.py``: chi2, the
diagonal, the scaling and ``b``; ``graphite_tpu/hessian.py``:
``compute_hessian_values``). Eager PyTorch runs it as some 200 kernels a
pass, so K7 fuses it per factor:

- ``bal_residual``: the masked robust chi2 of each factor
  (``compute_chi2``, the LM's trial chi2);
- ``bal_linearize``: r, the masked unscaled J, chi2, dL and the Jacobi
  diagonal's rows (``linearize``'s first pass);
- ``bal_scale_b``: the stored J (scaled, in the storage dtype) and b's
  rows (``linearize``'s second pass);
- ``bal_hessian_sum``: one Hessian site of ``compute_hessian_values``:
  each factor's ``J_s^T dL J_t`` for one slot pair, summed into its
  block of the site's group on the site's K1 plan, in K1's order (the
  counterpart of the JAX package's products and of its Pallas
  ``streaming_segment_sum`` over them), stored into the group or added
  to it.

The per-vertex sums of linearize's rows stay on K1, on the same plans,
so they are added in the same order as on the generic branch.

``gate`` decides, from shapes and dtypes alone, which factor sets take
K7: the analytic ``models.bal.REPROJECTION`` with identity precision, a
default, Huber or Cauchy loss, stored Jacobians and a float32 graph
(FP32_FP32, FP32_BF16, FP32_FP16). Every other set keeps the generic
code. Each entry's plain version (``*_plain``, the same signature) follows
the generic code op by op, so the CPU path's bits are the generic
branch's; a wrapper takes it for CPU tensors only, and on a CUDA tensor
launches K7 or raises.

``bal_linearize`` and ``bal_scale_b`` take ``out``: the arrays of an
existing linearization (r, chi2, dL; the stored J) that the kernel
stores into instead of new ones (the LM device loop's accepted branch
relinearizes in place); the plain versions copy into them
(``device_loop.copy_into``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...loss import CauchyLoss, DefaultLoss, HuberLoss, Loss
from ...models.bal import (
    CAMERA,
    POINT,
    reprojection_jacobian,
    reprojection_residual,
)
from ...precision import clamp_to_storage
from ..blockfmt import flat_block_mm_tn, flat_block_mv_t
from ..device_loop import copy_into
from . import build
from .launches import (
    LaunchStats,
    check_tensors,
    cuda_device,
    launch,
    outputs,
)
from .segsum import SegmentPlan, segment_sum_ordered

RESIDUAL_STATS = LaunchStats("bal.bal_residual")
LINEARIZE_STATS = LaunchStats("bal.bal_linearize")
SCALE_B_STATS = LaunchStats("bal.bal_scale_b")
HESSIAN_SUM_STATS = LaunchStats("bal.bal_hessian_sum")

# the kernel's compile-time loss cases, by the loss's exact type
LOSS_CODES = {Loss: 0, DefaultLoss: 0, HuberLoss: 1, CauchyLoss: 2}
_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16"}
# (slot s, slot t) of each Hessian site bal_hessian_sum takes
PAIRS = ((0, 0), (0, 1), (1, 1))
_DIMS = (9, 3)  # the camera's and the point's columns

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # cams, pts, ids0, ids1, obs, fmask, loss_params, chi2, F, loss, stream
    "gt_bal_residual": [_P] * 8 + [_L, _I, _P],
    # cams, pts, ids0, ids1, obs, smask, fmask, loss_params, r, jc, jp,
    # chi2, dl, diag_c, diag_p, F, loss, stream
    "gt_bal_linearize": [_P] * 15 + [_L, _I, _P],
    **{f"gt_bal_scale_b_{s}": [_P] * 12 + [_L, _P]
       for s in _STORAGE.values()},
    # jc, jp, dl, perm, offsets, out, num_segments, pair, transposed,
    # group_log2, accumulate, stream
    **{f"gt_bal_hessian_sum_{s}": [_P] * 6 + [_I] * 5 + [_P]
       for s in _STORAGE.values()},
}


def load_kernel() -> build.KernelLibrary:
    """Build K7 (at first use) and load it."""
    return build.load_library("bal", _SIGNATURES)


def gate(problem, name: str) -> Optional[Loss]:
    """The loss of factor set ``name`` when it takes K7, else None (the
    generic branch): K7 takes the analytic BAL reprojection factor with
    identity precision, a default, Huber or Cauchy loss and stored
    Jacobians, in a float32 graph with float32, bf16 or fp16 storage."""
    fm = problem.factor_meta[name]
    ft = fm.ftype
    prec = problem.precision
    if (ft.residual_fn is not reprojection_residual
            or ft.jacobian_fn is not reprojection_jacobian
            or ft.vertex_types != (CAMERA, POINT)
            or type(ft.loss) not in LOSS_CODES
            or problem.data.factors[name].precision is not None
            or not fm.store_jacobians
            or prec.graph_dtype != torch.float32
            or prec.solver_dtype not in _STORAGE):
        return None
    return ft.loss


# ---- bal_residual ---------------------------------------------------------

def bal_residual_plain(cameras, points, ids0, ids1, obs, factor_mask,
                       loss_params, loss: Loss) -> torch.Tensor:
    """(F,) masked robust chi2: ``compute_chi2``'s per-factor terms."""
    r = reprojection_residual(cameras.index_select(0, ids0),
                              points.index_select(0, ids1), obs).reshape(-1, 2)
    raw = r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]
    return loss.value(raw, loss_params) * factor_mask.to(raw.dtype)


def bal_residual(cameras, points, ids0, ids1, obs, factor_mask, loss_params,
                 loss: Loss) -> torch.Tensor:
    if cameras.device.type == "cpu":
        return bal_residual_plain(cameras, points, ids0, ids1, obs,
                                  factor_mask, loss_params, loss)
    name = RESIDUAL_STATS.name
    dev = cuda_device(name, cameras)
    F = ids0.shape[0]
    check_tensors(name, dev, f_cameras=cameras, f_points=points,
                  i_ids0=ids0, i_ids1=ids1, f_obs=obs,
                  b_factor_mask=factor_mask, f_loss_params=loss_params)
    chi2 = torch.empty(F, dtype=torch.float32, device=dev)
    launch(load_kernel, RESIDUAL_STATS, "gt_bal_residual", dev,
           cameras.data_ptr(), points.data_ptr(), ids0.data_ptr(),
           ids1.data_ptr(), obs.data_ptr(), factor_mask.data_ptr(),
           loss_params.data_ptr(), chi2.data_ptr(), F,
           LOSS_CODES[type(loss)])
    return chi2


# ---- bal_linearize --------------------------------------------------------

def bal_linearize_plain(cameras, points, ids0, ids1, obs, slot_mask,
                        factor_mask, loss_params, loss: Loss):
    """(r (F, 2), masked unscaled J (F, 18) and (F, 6), chi2 (F,), dL
    (F,), the diagonal's rows (F, 9) and (F, 3)): ``linearize``'s first
    pass over one set."""
    cam = cameras.index_select(0, ids0)
    pt = points.index_select(0, ids1)
    r = reprojection_residual(cam, pt, obs).reshape(-1, 2)
    J = reprojection_jacobian(cam, pt, obs)
    jflat = tuple(
        (Ji.reshape(-1, 2, d) * slot_mask[:, s, None, None].to(Ji.dtype))
        .reshape(-1, 2 * d) for s, (Ji, d) in enumerate(zip(J, (9, 3))))
    raw = r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]
    chi2 = loss.value(raw, loss_params) * factor_mask.to(raw.dtype)
    dL = loss.derivative(raw, loss_params)
    diag = []
    for Ji, d in zip(jflat, (9, 3)):
        Ji = Ji.reshape(-1, 2, d)
        diag.append((Ji[:, 0] * Ji[:, 0] + Ji[:, 1] * Ji[:, 1])
                    * dL[:, None])
    return (r, *jflat, chi2, dL, *diag)


def bal_linearize(cameras, points, ids0, ids1, obs, slot_mask, factor_mask,
                  loss_params, loss: Loss, out=None):
    """``bal_linearize_plain``'s arrays; ``out``: (r (F, 2), chi2 (F,),
    dL (F,)) to store those three into."""
    if cameras.device.type == "cpu":
        r, jc, jp, chi2, dL, dc, dp = bal_linearize_plain(
            cameras, points, ids0, ids1, obs, slot_mask, factor_mask,
            loss_params, loss)
        if out is not None:
            copy_into(out, (r, chi2, dL))
            r, chi2, dL = out
        return r, jc, jp, chi2, dL, dc, dp
    name = LINEARIZE_STATS.name
    dev = cuda_device(name, cameras)
    F = ids0.shape[0]
    check_tensors(name, dev, f_cameras=cameras, f_points=points,
                  i_ids0=ids0, i_ids1=ids1, f_obs=obs, b_slot_mask=slot_mask,
                  b_factor_mask=factor_mask, f_loss_params=loss_params)
    r, chi2, dL = outputs(name, out, ((F, 2), (F,), (F,)),
                          (torch.float32,) * 3, dev)
    jc, jp, dc, dp = (torch.empty((F, w), dtype=torch.float32, device=dev)
                      for w in (18, 6, 9, 3))
    launch(load_kernel, LINEARIZE_STATS, "gt_bal_linearize", dev,
           cameras.data_ptr(), points.data_ptr(), ids0.data_ptr(),
           ids1.data_ptr(), obs.data_ptr(), slot_mask.data_ptr(),
           factor_mask.data_ptr(), loss_params.data_ptr(),
           *(t.data_ptr() for t in (r, jc, jp, chi2, dL, dc, dp)), F,
           LOSS_CODES[type(loss)])
    return r, jc, jp, chi2, dL, dc, dp


# ---- bal_scale_b ----------------------------------------------------------

def bal_scale_b_plain(jc, jp, r, dL, scales_c: Optional[torch.Tensor],
                      scales_p: Optional[torch.Tensor], rows0, rows1,
                      storage: torch.dtype):
    """(stored J (F, 18) and (F, 6) in ``storage``, b's rows (F, 9) and
    (F, 3)): the J scaled by its columns' padded scale rows at ``rows0``
    / ``rows1`` (None: not scaled), cast to storage, and ``-J^T dL r``
    from the stored values."""
    stored = []
    for J, sc, rows in ((jc, scales_c, rows0), (jp, scales_p, rows1)):
        if sc is not None:
            J = J * sc.index_select(0, rows).repeat(1, 2).to(J.dtype)
        stored.append(clamp_to_storage(J, storage))
    w = (r * dL[:, None]).to(torch.float32)
    b = [-flat_block_mv_t(Js, w, 2, d, acc_dtype=torch.float32)
         for Js, d in zip(stored, (9, 3))]
    return (*stored, *b)


def bal_scale_b(jc, jp, r, dL, scales_c, scales_p, rows0, rows1,
                storage: torch.dtype, out=None):
    """``bal_scale_b_plain``'s arrays; ``out``: the stored J ((F, 18),
    (F, 6) in ``storage``) to store into."""
    if jc.device.type == "cpu":
        *stored, bc, bp = bal_scale_b_plain(jc, jp, r, dL, scales_c,
                                            scales_p, rows0, rows1, storage)
        if out is not None:
            copy_into(out, stored)
            stored = out
        return (*stored, bc, bp)
    name = SCALE_B_STATS.name
    dev = cuda_device(name, jc)
    F = jc.shape[0]
    if storage not in _STORAGE:
        raise NotImplementedError(f"{name}: no kernel for storage {storage}")
    if (scales_c is None) != (scales_p is None):
        raise ValueError(f"{name}: scale both slots or neither")
    check_tensors(name, dev, f_jc=jc, f_jp=jp, f_r=r, f_dL=dL,
                  f_scales_c=scales_c, f_scales_p=scales_p, i_rows0=rows0,
                  i_rows1=rows1)
    out = outputs(name, out, ((F, 18), (F, 6)), (storage,) * 2, dev)
    out += [torch.empty((F, w), dtype=torch.float32, device=dev)
            for w in (9, 3)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch(load_kernel, SCALE_B_STATS, f"gt_bal_scale_b_{_STORAGE[storage]}",
           dev, jc.data_ptr(), jp.data_ptr(), r.data_ptr(), dL.data_ptr(),
           ptr(scales_c), ptr(scales_p), rows0.data_ptr(), rows1.data_ptr(),
           *(t.data_ptr() for t in out), F)
    return tuple(out)


def scale_b(jflat, r, dL, precision, scales, rows, storage: torch.dtype,
            out=None):
    """``bal_scale_b`` in the second-pass form ``linearize`` calls every
    fused kernel by (K11's ``se3_scale_b``): each slot's J, scale rows
    (``scales`` None: not scaled) and rows as tuples; returns (the stored
    J, b's rows), a tuple each. K7's factors have no precision."""
    if precision is not None:
        raise ValueError(f"{SCALE_B_STATS.name}: K7 takes no precision")
    jc, jp, b_c, b_p = bal_scale_b(*jflat, r, dL, *(scales or (None, None)),
                                   *rows, storage, out)
    return (jc, jp), (b_c, b_p)


# ---- bal_hessian_sum ------------------------------------------------------

def hessian_rows_plain(jc, jp, dL, s: int, t: int,
                       transposed: bool) -> torch.Tensor:
    """(F, ds * dt) float32: each factor's ``J_s^T dL J_t``, row-major
    (ds, dt), or its (dt, ds) transpose: ``compute_hessian_values``'s
    per-factor products of one slot pair."""
    acc = torch.float32
    J = (jc, jp)
    ds, dt = _DIMS[s], _DIMS[t]
    rows = (flat_block_mm_tn(J[s], J[t].to(acc), ds, 2, dt, acc_dtype=acc)
            * dL.to(acc)[:, None])
    if transposed:
        rows = rows.reshape(-1, ds, dt).transpose(1, 2).reshape(-1, ds * dt)
    return rows


def bal_hessian_sum_plain(jc, jp, dL, plan: SegmentPlan, s: int, t: int,
                          transposed: bool, out: torch.Tensor,
                          accumulate: bool) -> torch.Tensor:
    """``out`` (the site's (num_segments, D) group) with each factor's
    product rows summed into its block on ``plan`` in K1's lane order
    (``segsum.segment_sum_ordered``: the same bits on the card as on the
    CPU): stored (``accumulate`` False) or added."""
    sums = segment_sum_ordered(
        hessian_rows_plain(jc, jp, dL, s, t, transposed).to(out.dtype), plan)
    return out.add_(sums) if accumulate else out.copy_(sums)


def bal_hessian_sum(jc, jp, dL, plan: SegmentPlan, s: int, t: int,
                    transposed: bool, out: torch.Tensor,
                    accumulate: bool) -> torch.Tensor:
    if jc.device.type == "cpu":
        return bal_hessian_sum_plain(jc, jp, dL, plan, s, t, transposed, out,
                                     accumulate)
    name = HESSIAN_SUM_STATS.name
    dev = cuda_device(name, jc)
    if jc.dtype not in _STORAGE or jp.dtype != jc.dtype:
        raise NotImplementedError(
            f"{name}: no kernel for J of {jc.dtype} / {jp.dtype}")
    pair = PAIRS.index((s, t))
    if transposed and s == t:
        raise ValueError(f"{name}: slot pair {(s, t)} has no transposed site")
    width = _DIMS[s] * _DIMS[t]
    if (plan.rows != dL.shape[0] or out.shape != (plan.num_segments, width)
            or plan.offsets_i32.device != dev):
        raise ValueError(
            f"{name}: a plan of {plan.rows} rows into {plan.num_segments} "
            f"blocks of {width} on {plan.offsets_i32.device} does not fit "
            f"{dL.shape[0]} factors and out {tuple(out.shape)} on {dev}")
    check_tensors(name, dev, s_jc=jc, s_jp=jp, f_dL=dL, f_out=out)
    launch(load_kernel, HESSIAN_SUM_STATS,
           f"gt_bal_hessian_sum_{_STORAGE[jc.dtype]}", dev, jc.data_ptr(),
           jp.data_ptr(), dL.data_ptr(),
           None if plan.perm_i32 is None else plan.perm_i32.data_ptr(),
           plan.offsets_i32.data_ptr(), out.data_ptr(), plan.num_segments,
           pair, int(transposed), plan.group.bit_length() - 1,
           int(accumulate))
    return out
