"""The vector work of one preconditioned CG step in three launches: kernel
K12 (``csrc/pcg_step.cu``).

No ``pl.pallas_call`` of the JAX package computes it: there the CG step
is one ``lax.while_loop`` body (``graphite_tpu/ops/pcg_loop.py``) whose
vector updates, block-Jacobi-Schur apply and flags XLA fuses. The plain
versions here are the ops ``ops/pcg_loop.py`` and
``preconditioners/block_jacobi_schur.py`` ran before K12, moved:

- ``bjs_apply(r, rr, inv_blocks, segments)``: the block-Jacobi-Schur
  preconditioner on the residual normalised by its r.r, ``rr``
  (``pcg_loop.normalize``), each pose type's rows by ``flat_block_mv`` in
  the inverses' dtype, written into a (dim_p,) vector
  (``graph.PoseSegments``);
- ``cg_advance(x, r, p, v, rz, pv, x_out, r_out)``: alpha = rz / pv,
  x_out = x + alpha p, r_out = r - alpha v;
- ``cg_commit(x, r, p, z, x_new, r_new, z_new, rz, rz_new, rz_min, k,
  done, ticket, rejection_ratio, tol)``: the tail of ``run_pcg_fixed``'s
  step, in place: the rejection test, p's update, the kept states,
  rz_min, the step count and the exit flag (``ticket``: the kernel's
  counter of CTAs, one per solve).

Each wrapper takes its plain version for CPU tensors only; on CUDA tensors
it launches K12 (float32 or float64 vectors and inverses) or raises. Scalars are 0-d tensors on the
vectors' device; nothing is read back to the host, so the step runs inside
a captured CUDA graph's "while" node. Launches with float32 vectors count
in ``*_STATS``, with float64 vectors in ``*_STATS_F64``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..blockfmt import flat_block_mv
from . import build
from .launches import LaunchStats, launch

BJS_STATS = LaunchStats("pcg_step.bjs_apply")
ADVANCE_STATS = LaunchStats("pcg_step.cg_advance")
COMMIT_STATS = LaunchStats("pcg_step.cg_commit")
# float64 vectors apart (as K9's): a float64 path launches no float32 entry
BJS_STATS_F64 = LaunchStats("pcg_step.bjs_apply[f64]")
ADVANCE_STATS_F64 = LaunchStats("pcg_step.cg_advance[f64]")
COMMIT_STATS_F64 = LaunchStats("pcg_step.cg_commit[f64]")

MAX_SEGMENTS = 8  # pose types of a vector (csrc/pcg_step.cu)
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    **{f"gt_bjs_apply_{v}_{i}":
       # r, rr, inverses, starts, dims, count, out, stream
       [_P, _P, _P, _P, _P, _I, _P, _P]
       for v in _DTYPES.values() for i in _DTYPES.values()},
    **{f"gt_cg_advance_{s}": [_P] * 8 + [_L, _P] for s in _DTYPES.values()},
    **{f"gt_cg_commit_{s}": [_P] * 13 + [_L, _D, _D, _P]
       for s in _DTYPES.values()},
}


def load_kernel() -> build.KernelLibrary:
    """Build K12 (at first use) and load it."""
    return build.load_library("pcg_step", _SIGNATURES)


def _stats(dtype, f32: LaunchStats, f64: LaunchStats) -> LaunchStats:
    return f64 if dtype == torch.float64 else f32


def _check(name: str, dtype, device, vectors, scalars=()) -> None:
    """Raise unless every vector is a contiguous 1-D CUDA tensor of one
    length and ``dtype`` (float32 / float64) on ``device``, and every
    scalar a 0-d one."""
    if device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {device}")
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"{name}: the kernel takes float32 or float64 vectors, got "
            f"{dtype}")
    n = vectors[0].shape
    for t in vectors:
        if (t.dtype != dtype or t.device != device or t.dim() != 1
                or t.shape != n or not t.is_contiguous()):
            raise ValueError(
                f"{name}: every vector must be a contiguous 1-D {dtype} "
                f"tensor of shape {tuple(n)} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    for t in scalars:
        if t.dtype != dtype or t.device != device or t.dim() != 0:
            raise ValueError(f"{name}: every scalar must be a 0-d {dtype} "
                             f"tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


# ---- bjs_apply -------------------------------------------------------------

def bjs_apply_plain(r: torch.Tensor, rr: torch.Tensor,
                    inv_blocks: Dict[str, torch.Tensor],
                    segments) -> torch.Tensor:
    """z = M^-1 normalize(r, rr): each pose type's rows by
    ``flat_block_mv`` in its inverses' dtype, into the (dim_p,) vector of
    ``segments`` in r's dtype (a type without inverses: 0)."""
    from ..pcg_loop import normalize

    y = normalize(r, rr)
    z_rows = {}
    for t, start, n, d in segments.segments:
        inv = inv_blocks.get(t)
        if inv is not None:
            z_rows[t] = flat_block_mv(inv, y[start:start + n * d].reshape(
                n, d), d, d, acc_dtype=inv.dtype)
    return segments.flat(z_rows, r.dtype, r.device)


def bjs_apply(r: torch.Tensor, rr: torch.Tensor,
              inv_blocks: Dict[str, torch.Tensor], segments) -> torch.Tensor:
    """``bjs_apply_plain`` in one launch on the card: r (dim_p,), rr = r.r
    a 0-d tensor, ``inv_blocks`` pose type -> (rows, d*d) inverses (one
    dtype), ``segments`` the pose types' ``graph.PoseSegments``; returns
    z."""
    if r.device.type == "cpu":
        return bjs_apply_plain(r, rr, inv_blocks, segments)
    stats = _stats(r.dtype, BJS_STATS, BJS_STATS_F64)
    name = stats.name
    segs = segments.segments
    out = torch.empty(segments.dim_p, dtype=r.dtype, device=r.device)
    _check(name, r.dtype, r.device, [r, out], (rr,))
    if r.shape[0] != segments.dim_p or not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(
            f"{name}: r has {r.shape[0]} entries and {len(segs)} pose "
            f"types for dim_p = {segments.dim_p} (at most {MAX_SEGMENTS})")
    inv_dtypes = {inv.dtype for inv in inv_blocks.values()}
    if len(inv_dtypes) > 1 or not inv_dtypes <= set(_DTYPES):
        raise NotImplementedError(
            f"{name}: the kernel takes inverses of one dtype, float32 or "
            f"float64, got {inv_dtypes}")
    inv_dt = next(iter(inv_dtypes), r.dtype)
    ptrs, starts, dims = [], [], []
    for t, start, n, d in segs:
        inv = inv_blocks.get(t)
        if inv is not None and (
                inv.shape != (n, d * d) or inv.device != r.device
                or not inv.is_contiguous()):
            raise ValueError(
                f"{name}: the inverses of '{t}' must be a contiguous "
                f"({n}, {d * d}) tensor on {r.device}, got "
                f"{tuple(inv.shape)} on {inv.device}")
        ptrs.append(None if inv is None else inv.data_ptr())
        starts.append(start)
        dims.append(d)
    starts.append(segments.dim_p)
    launch(load_kernel, stats,
           f"gt_bjs_apply_{_DTYPES[r.dtype]}_{_DTYPES[inv_dt]}", r.device,
           r.data_ptr(), rr.data_ptr(),
           (ctypes.c_void_p * len(ptrs))(*ptrs),
           (ctypes.c_longlong * len(starts))(*starts),
           (ctypes.c_int * len(dims))(*dims), len(dims), out.data_ptr())
    return out


# ---- cg_advance ------------------------------------------------------------

def cg_advance_plain(x, r, p, v, rz, pv, x_out, r_out):
    """alpha = rz / pv; x_out = x + alpha p, r_out = r - alpha v."""
    alpha = rz / pv
    torch.add(x, alpha * p, out=x_out)
    torch.sub(r, alpha * v, out=r_out)
    return x_out, r_out


def cg_advance(x, r, p, v, rz, pv, x_out, r_out):
    """``cg_advance_plain`` in one launch on the card: x, r, p, v, x_out,
    r_out of one length, rz and pv 0-d; returns (x_out, r_out)."""
    if x.device.type == "cpu":
        return cg_advance_plain(x, r, p, v, rz, pv, x_out, r_out)
    stats = _stats(x.dtype, ADVANCE_STATS, ADVANCE_STATS_F64)
    _check(stats.name, x.dtype, x.device, [x, r, p, v, x_out, r_out],
           (rz, pv))
    launch(load_kernel, stats, f"gt_cg_advance_{_DTYPES[x.dtype]}",
           x.device, *(t.data_ptr() for t in (x, r, p, v, rz, pv, x_out,
                                             r_out)), x.shape[0])
    return x_out, r_out


# ---- cg_commit -------------------------------------------------------------

def cg_commit_plain(x, r, p, z, x_new, r_new, z_new, rz, rz_new, rz_min, k,
                    done, ticket, rejection_ratio: float, tol: float) -> None:
    """The end of a CG step, in place: a step with |rz_new| >
    rejection_ratio * rz_min or a NaN rz_new is rejected and keeps x, r,
    p, z and rz; else p = z_new + (rz_new / rz) p and x, r, z, rz take the
    new values; rz_min = minimum(rz_min, |rz_new|), k += 1, done = reject
    | |rz| < tol | rz == 0. ``ticket`` is the kernel's (not read here)."""
    reject = ((rz_new.abs() > rejection_ratio * rz_min)
              | torch.isnan(rz_new))
    p_new = z_new + (rz_new / rz) * p
    rz_min.copy_(torch.minimum(rz_min, rz_new.abs()))
    k.add_(1)
    p.copy_(torch.where(reject, p, p_new))
    x.copy_(torch.where(reject, x, x_new))
    r.copy_(torch.where(reject, r, r_new))
    z.copy_(torch.where(reject, z, z_new))
    rz.copy_(torch.where(reject, rz, rz_new))
    done.copy_(reject | (rz.abs() < tol) | (rz == 0))


def cg_commit(x, r, p, z, x_new, r_new, z_new, rz, rz_new, rz_min, k, done,
              ticket, rejection_ratio: float, tol: float) -> None:
    """``cg_commit_plain`` in one launch on the card: the vectors of one
    length and dtype, rz, rz_new, rz_min 0-d of it, k a 0-d int64 and
    done a 0-d bool tensor; ``ticket`` a 0-d int32 tensor, 0, that no
    other launch running at the same time uses (the last CTA to count
    itself on it writes the scalars and resets it to 0)."""
    if x.device.type == "cpu":
        return cg_commit_plain(x, r, p, z, x_new, r_new, z_new, rz, rz_new,
                               rz_min, k, done, ticket, rejection_ratio, tol)
    stats = _stats(x.dtype, COMMIT_STATS, COMMIT_STATS_F64)
    _check(stats.name, x.dtype, x.device, [x, r, p, z, x_new, r_new, z_new],
           (rz, rz_new, rz_min))
    for t, dt in ((k, torch.int64), (done, torch.bool),
                  (ticket, torch.int32)):
        if t.dtype != dt or t.device != x.device or t.dim() != 0:
            raise ValueError(f"{stats.name}: k, done and ticket must be 0-d "
                             f"int64, bool and int32 tensors on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    launch(load_kernel, stats, f"gt_cg_commit_{_DTYPES[x.dtype]}", x.device,
           *(t.data_ptr() for t in (x, r, p, z, x_new, r_new, z_new, rz,
                                    rz_new, rz_min, k, done, ticket)),
           x.shape[0], float(rejection_ratio), float(tol))
