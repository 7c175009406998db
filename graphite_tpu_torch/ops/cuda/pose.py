"""The SE(3) pose-graph factors' linearization and chi2, and the SE(3)
retraction of the LM update: kernel K11 (``csrc/pose.cu``).

No ``pl.pallas_call`` of the JAX package computes this: there it is plain
``jnp`` code that XLA fuses, the AUTO branch's "vmapped ``jax.jacfwd``
trace per factor type" (``graphite_tpu/linearize.py:129-153``) over
``se3_between_residual`` / ``se3_prior_residual``
(``graphite_tpu/models/pose_graph.py``, ``models/lie.py``), with chi2,
the diagonal, the scaling and ``b`` around it, and ``apply_update``'s
retraction. Eager PyTorch runs it as ``torch.func.jvp`` over each set's
12 (6) tangent directions: ~1,600 kernels a linearization, ~270-300 a
trial chi2, ~170 an update (sphere2500). K11 takes it per factor and per vertex:

- ``se3_residual``: the masked robust chi2 of each factor
  (``compute_chi2``, the LM's trial chi2);
- ``se3_linearize``: r, the masked unscaled J of each slot by
  forward-mode dual numbers (``csrc/se3_dual.cuh``), chi2, dL and the
  Jacobi diagonal's rows (``linearize``'s first pass);
- ``se3_scale_b``: the stored J (scaled, in the storage dtype) and b's
  rows (``linearize``'s second pass);
- ``se3_update``: ``apply_update`` for an SE(3) vertex type.

The per-vertex sums of linearize's rows stay on K1, on the same plans,
so they are added in the same order as on the generic branch.

``gate`` decides, from types and dtypes alone, which factor sets take
K11: ``se3_between_residual`` or ``se3_prior_residual`` on ``SE3``
vertices with no ``jacobian_fn``, a default, Huber or Cauchy loss (K7's
``LOSS_CODES``), a per-factor (F, 36) precision or none, stored
Jacobians, in a float32 graph with float32, bf16 or fp16 storage;
``update_gate`` which vertex types take ``se3_update`` (``SE3`` in a
float32 graph). Every other set keeps the generic code: the FP64
policies, SE(2), dynamic Jacobians, user factors. Each entry's plain
version (``*_plain``, the same signature) calls the generic branch's own
per-factor helpers in ``linearize`` (the ``torch.func.jvp`` branch for
``se3_linearize``), so the CPU path's bits are the generic branch's; a
wrapper takes it for CPU tensors only, and on a CUDA tensor launches K11
or raises.

``se3_linearize`` and ``se3_scale_b`` take ``out``: the arrays of an
existing linearization (r, chi2, dL; the stored J) that the kernel
stores into instead of new ones (the LM device loop's accepted branch
relinearizes in place); the plain versions copy into them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ...graph import padded_rows
from ...loss import Loss
from ...models import lie
from ...models.pose_graph import (
    SE3,
    SE3_BETWEEN,
    SE3_PRIOR,
    se3_between_residual,
    se3_prior_residual,
)
from ..device_loop import copy_into
from . import build
from .bal import LOSS_CODES
from .launches import (
    LaunchStats,
    check_tensors,
    cuda_device,
    launch,
    outputs,
)

RESIDUAL_STATS = LaunchStats("pose.se3_residual")
LINEARIZE_STATS = LaunchStats("pose.se3_linearize")
SCALE_B_STATS = LaunchStats("pose.se3_scale_b")
UPDATE_STATS = LaunchStats("pose.se3_update")

_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16"}
_PREC_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FTYPES = {se3_between_residual: SE3_BETWEEN, se3_prior_residual: SE3_PRIOR}
E = 6  # residual rows; an SE(3) slot has as many tangent columns
ACC = torch.float32  # the accumulation dtype of a float32 graph

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # poses, ids0, ids1, obs, prec, prec_kind, fmask, loss_params, chi2, F,
    # nslot, loss, stream
    "gt_pose_residual": [_P] * 5 + [_I] + [_P] * 3 + [_L, _I, _I, _P],
    # poses, ids0, ids1, obs, prec, prec_kind, smask, fmask, loss_params,
    # r, j0, j1, chi2, dl, d0, d1, F, nslot, loss, stream
    "gt_pose_linearize": [_P] * 5 + [_I] + [_P] * 10 + [_L, _I, _I, _P],
    # j0, j1, r, dl, prec, prec_kind, sc0, sc1, rows0, rows1, j0_out,
    # j1_out, b0, b1, F, nslot, stream
    **{f"gt_pose_scale_b_{s}": [_P] * 5 + [_I] + [_P] * 8 + [_L, _I, _P]
       for s in _STORAGE.values()},
    # poses, dx, sc, start, n_rows, active_row, active, out, V, stream
    "gt_pose_update": [_P] * 3 + [_L, _L] + [_P] * 3 + [_L, _P],
}


def load_kernel() -> build.KernelLibrary:
    """Build K11 (at first use) and load it."""
    return build.load_library("pose", _SIGNATURES)


def gate(problem, name: str) -> Optional[Loss]:
    """The loss of factor set ``name`` when it takes K11, else None (the
    generic branch); see the module docstring."""
    fm = problem.factor_meta[name]
    ft = fm.ftype
    fa = problem.data.factors[name]
    prec = problem.precision
    want = _FTYPES.get(ft.residual_fn)
    if (want is None
            or ft.jacobian_fn is not None
            or ft.residual_dim != E
            or len(ft.vertex_types) != want.arity
            or not all(vt == SE3 and vt.retract is lie.se3_retract
                       for vt in ft.vertex_types)
            or type(ft.loss) not in LOSS_CODES
            or fa.obs is None or fa.data is not None
            or (fa.precision is not None
                and tuple(fa.precision.shape[1:]) != (E * E,))
            or not fm.store_jacobians
            or prec.graph_dtype != torch.float32
            or prec.solver_dtype not in _STORAGE):
        return None
    return ft.loss


def update_gate(problem, name: str) -> bool:
    """Whether vertex type ``name``'s update takes ``se3_update``: ``SE3``
    in a float32 graph."""
    vt = problem.vertex_meta[name].vtype
    return (vt == SE3 and vt.retract is lie.se3_retract
            and problem.precision.graph_dtype == torch.float32)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _slots(name: str, ids: Sequence[torch.Tensor]) -> int:
    if len(ids) not in (1, 2):
        raise ValueError(f"{name}: one or two slots, got {len(ids)}")
    return len(ids)


def _check_precision(name: str, dev, precision, F: int, storage=None):
    """The precision's kind code (0 for none); raises unless it is a
    contiguous (F, 36) tensor on ``dev`` of a storage dtype (``storage``
    when given)."""
    if precision is None:
        return 0
    if (precision.device != dev or not precision.is_contiguous()
            or precision.dtype not in _PREC_KIND
            or tuple(precision.shape) != (F, E * E)
            or (storage is not None and precision.dtype != storage)):
        raise ValueError(
            f"{name}: precision must be a contiguous ({F}, 36) float32, "
            f"bf16 or fp16 tensor on {dev}, got {precision.dtype} "
            f"{tuple(precision.shape)} on {precision.device}")
    return _PREC_KIND[precision.dtype]


# ---- se3_residual ---------------------------------------------------------

def se3_residual_plain(poses, ids, obs, precision, factor_mask, loss_params,
                       loss: Loss) -> torch.Tensor:
    """(F,) masked robust chi2: ``compute_chi2``'s per-factor terms of an
    ``se3_between`` (two ``ids``) or ``se3_prior`` (one) set."""
    # imported here in each plain version: linearize imports this module
    from ...linearize import _chi2_terms

    fn = se3_between_residual if len(ids) == 2 else se3_prior_residual
    r = fn(*(poses.index_select(0, i) for i in ids), obs).reshape(-1, E)
    return _chi2_terms(r, precision, factor_mask, loss_params, loss, ACC)[0]


def se3_residual(poses, ids, obs, precision, factor_mask, loss_params,
                 loss: Loss) -> torch.Tensor:
    if poses.device.type == "cpu":
        return se3_residual_plain(poses, ids, obs, precision, factor_mask,
                                  loss_params, loss)
    name = RESIDUAL_STATS.name
    dev = cuda_device(name, poses)
    nslot = _slots(name, ids)
    F = ids[0].shape[0]
    check_tensors(name, dev, f_poses=poses, i_ids0=ids[0], i_ids1=ids[-1],
                  f_obs=obs, b_factor_mask=factor_mask,
                  f_loss_params=loss_params)
    kind = _check_precision(name, dev, precision, F)
    chi2 = torch.empty(F, dtype=torch.float32, device=dev)
    launch(load_kernel, RESIDUAL_STATS, "gt_pose_residual", dev,
           poses.data_ptr(), ids[0].data_ptr(),
           ids[1].data_ptr() if nslot == 2 else None, obs.data_ptr(),
           _ptr(precision), kind, factor_mask.data_ptr(),
           loss_params.data_ptr(), chi2.data_ptr(), F, nslot,
           LOSS_CODES[type(loss)])
    return chi2


# ---- se3_linearize --------------------------------------------------------

def se3_linearize_plain(poses, ids, obs, precision, slot_mask, factor_mask,
                        loss_params, loss: Loss):
    """(r (F, 6), the masked unscaled J (F, 36) of each slot, chi2 (F,),
    dL (F,), the diagonal's rows (F, 6) of each slot): ``linearize``'s
    first pass over one set, the AUTO branch (``torch.func.jvp``)."""
    from ...linearize import (
        _auto_residual_and_jacobians,
        _chi2_terms,
        _diag_rows,
        _mask_slots,
    )

    ftype = SE3_BETWEEN if len(ids) == 2 else SE3_PRIOR
    dims = (E,) * len(ids)
    r, J = _auto_residual_and_jacobians(
        ftype, tuple(poses.index_select(0, i) for i in ids), (obs,))
    jflat = _mask_slots(J, slot_mask, E, dims)
    r = r.to(torch.float32)
    chi2, dL = _chi2_terms(r, precision, factor_mask, loss_params, loss, ACC)
    return r, jflat, chi2, dL, _diag_rows(jflat, precision, dL, E, dims, ACC)


def se3_linearize(poses, ids, obs, precision, slot_mask, factor_mask,
                  loss_params, loss: Loss, out=None):
    """``se3_linearize_plain``'s arrays; ``out``: (r (F, 6), chi2 (F,),
    dL (F,)) to store those three into."""
    if poses.device.type == "cpu":
        r, J, chi2, dL, diag = se3_linearize_plain(
            poses, ids, obs, precision, slot_mask, factor_mask, loss_params,
            loss)
        if out is not None:
            copy_into(out, (r, chi2, dL))
            r, chi2, dL = out
        return r, J, chi2, dL, diag
    name = LINEARIZE_STATS.name
    dev = cuda_device(name, poses)
    nslot = _slots(name, ids)
    F = ids[0].shape[0]
    check_tensors(name, dev, f_poses=poses, i_ids0=ids[0], i_ids1=ids[-1],
                  f_obs=obs, b_slot_mask=slot_mask, b_factor_mask=factor_mask,
                  f_loss_params=loss_params)
    kind = _check_precision(name, dev, precision, F)
    r, chi2, dL = outputs(name, out, ((F, E), (F,), (F,)),
                          (torch.float32,) * 3, dev)
    J = tuple(torch.empty((F, E * E), dtype=torch.float32, device=dev)
              for _ in range(nslot))
    diag = tuple(torch.empty((F, E), dtype=torch.float32, device=dev)
                 for _ in range(nslot))
    launch(load_kernel, LINEARIZE_STATS, "gt_pose_linearize", dev,
           poses.data_ptr(), ids[0].data_ptr(),
           ids[1].data_ptr() if nslot == 2 else None, obs.data_ptr(),
           _ptr(precision), kind, slot_mask.data_ptr(),
           factor_mask.data_ptr(), loss_params.data_ptr(), r.data_ptr(),
           J[0].data_ptr(), J[1].data_ptr() if nslot == 2 else None,
           chi2.data_ptr(), dL.data_ptr(), diag[0].data_ptr(),
           diag[1].data_ptr() if nslot == 2 else None, F, nslot,
           LOSS_CODES[type(loss)])
    return r, J, chi2, dL, diag


# ---- se3_scale_b ----------------------------------------------------------

def se3_scale_b_plain(J, r, dL, precision, scales, rows,
                      storage: torch.dtype):
    """(the stored J (F, 36) of each slot in ``storage``, b's rows (F, 6)
    of each slot): each J times its columns' padded scale rows at
    ``rows`` (``scales`` None: not scaled), cast to storage, and
    ``-J^T dL P r`` from the stored values."""
    from ...linearize import _b_rows, _store_jacobians

    stored = _store_jacobians(J, scales, rows, E, storage)
    return stored, _b_rows(stored, r, dL, precision, E, (E,) * len(J), ACC)


def se3_scale_b(J, r, dL, precision, scales, rows, storage: torch.dtype,
                out=None):
    """``se3_scale_b_plain``'s arrays; ``out``: the stored J ((F, 36) a
    slot, in ``storage``) to store into."""
    if r.device.type == "cpu":
        stored, b = se3_scale_b_plain(J, r, dL, precision, scales, rows,
                                      storage)
        if out is not None:
            copy_into(out, stored)
            stored = tuple(out)
        return stored, b
    name = SCALE_B_STATS.name
    dev = cuda_device(name, r)
    nslot = _slots(name, J)
    F = r.shape[0]
    if storage not in _STORAGE:
        raise NotImplementedError(f"{name}: no kernel for storage {storage}")
    if scales is not None and len(scales) != nslot:
        raise ValueError(f"{name}: scale every slot or none")
    check_tensors(name, dev, f_J0=J[0], f_J1=J[-1], f_r=r, f_dL=dL,
                  f_scales0=None if scales is None else scales[0],
                  f_scales1=None if scales is None else scales[-1],
                  i_rows0=rows[0], i_rows1=rows[-1])
    kind = _check_precision(name, dev, precision, F, storage)
    stored = outputs(name, out, ((F, E * E),) * nslot, (storage,) * nslot,
                     dev)
    b = [torch.empty((F, E), dtype=torch.float32, device=dev)
         for _ in range(nslot)]

    def second(ts):
        return ts[1].data_ptr() if nslot == 2 else None

    launch(load_kernel, SCALE_B_STATS, f"gt_pose_scale_b_{_STORAGE[storage]}",
           dev, J[0].data_ptr(), second(J), r.data_ptr(), dL.data_ptr(),
           _ptr(precision), kind,
           None if scales is None else scales[0].data_ptr(),
           None if scales is None else second(scales), rows[0].data_ptr(),
           second(rows), stored[0].data_ptr(), second(stored),
           b[0].data_ptr(), second(b), F, nslot)
    return tuple(stored), tuple(b)


# the second-pass form linearize calls every fused kernel by
scale_b = se3_scale_b


# ---- se3_update -----------------------------------------------------------

def se3_update_plain(poses, delta_x, scales, start: int, n_rows: int,
                     active_row, active) -> torch.Tensor:
    """(V, 7): ``apply_update`` for one SE(3) vertex type, whose rows of
    the flat ``delta_x * scales`` start at ``start`` (``n_rows`` of 6; the
    trash row ``n_rows`` is zero)."""
    from ...linearize import _retract_active

    return _retract_active(lie.se3_retract, poses,
                           padded_rows(delta_x * scales, start, n_rows, E),
                           active_row, active)


def se3_update(poses, delta_x, scales, start: int, n_rows: int, active_row,
               active) -> torch.Tensor:
    if poses.device.type == "cpu":
        return se3_update_plain(poses, delta_x, scales, start, n_rows,
                                active_row, active)
    name = UPDATE_STATS.name
    dev = cuda_device(name, poses)
    check_tensors(name, dev, f_poses=poses, f_delta_x=delta_x,
                  f_scales=scales, i_active_row=active_row, b_active=active)
    out = torch.empty_like(poses)
    launch(load_kernel, UPDATE_STATS, "gt_pose_update", dev,
           poses.data_ptr(), delta_x.data_ptr(), scales.data_ptr(), start,
           n_rows, active_row.data_ptr(), active.data_ptr(), out.data_ptr(),
           poses.shape[0])
    return out
