"""The landmark inverses Hll^-1 and W = Hpl Hll^-1 of the Schur complement
in one launch per Hpl group: kernel K10 (``csrc/schur_w.cu``).

No ``pl.pallas_call`` of the JAX package computes them: there they are
plain ``jnp`` that XLA fuses (``graphite_tpu/schur.py``: the closed-form
inverses, then W from the ``jnp.repeat``-expanded inverse). The plain
versions here, ``hll_inverse_plain`` and ``hpl_w_plain``, are the ops
``schur.py`` ran before K10, unchanged: ``spd_inverse_flat``, then a
``repeat_interleave`` of the inverse to one row per Hpl block and
``flat_block_mm_nn``.

``schur_w(hll, hpl, plan, dp, dl)`` returns (Hll^-1, W). It takes float32
blocks with dl in 1..3 (``gate``) and raises on others. On CPU tensors it
runs the plain versions; on CUDA tensors it launches K10 or raises. It allocates its outputs, launches on the
current stream and reads nothing back, so it runs inside a captured CUDA
graph. Launches count in ``STATS``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..batched_linalg import spd_inverse_flat
from ..blockfmt import flat_block_mm_nn
from . import build
from .launches import LaunchStats, on_device, stream_ptr

STATS = LaunchStats("schur_w.schur_w")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # hll, hpl, offsets, hll_inv, w, dp, dl, L, stream
    "gt_schur_w_f32": [_P] * 5 + [_I, _I, _I, _P],
}


def load_kernel() -> build.KernelLibrary:
    """Build K10 (at first use) and load it."""
    return build.load_library("schur_w", _SIGNATURES)


def gate(inv_dtype: torch.dtype, dl: int) -> bool:
    """Whether a landmark dim takes K10: float32 inverses (``inv_dtype``,
    as ``schur.kernel_dtype``) of 1x1 to 3x3 blocks. Dtype and shape
    only."""
    return inv_dtype == torch.float32 and 1 <= dl <= 3


@dataclasses.dataclass
class WPlan:
    """Where each landmark's Hpl blocks are in a group sorted by landmark:
    ``counts[l]`` blocks (``repeat_interleave``'s counts, the plain
    version's) from row ``offsets[l]`` (their exclusive prefix sum, int32,
    K10's)."""

    counts: torch.Tensor  # (L,) int64
    offsets: torch.Tensor  # (L + 1,) int32
    rows: int  # K, the group's Hpl blocks


def plan_w(counts: np.ndarray, device) -> WPlan:
    """The plan of a group whose landmarks have ``counts`` Hpl blocks each
    (built once on the host)."""
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    if offsets[-1] >= 2**31:
        raise ValueError(f"schur_w: {offsets[-1]} Hpl blocks do not fit "
                         "K10's int32 row offsets")
    return WPlan(counts=torch.as_tensor(counts, device=device),
                 offsets=torch.as_tensor(offsets.astype(np.int32),
                                         device=device),
                 rows=int(offsets[-1]))


def hll_inverse_plain(hll: torch.Tensor, dl: int) -> torch.Tensor:
    """(L, dl*dl) -> the blocks' inverses (``spd_inverse_flat``)."""
    return spd_inverse_flat(hll, dl)


def hpl_w_plain(hpl: torch.Tensor, hll_inv: torch.Tensor, plan: WPlan,
                dp: int, dl: int) -> torch.Tensor:
    """W = Hpl Hll^-1 per block: (K, dp*dl), the inverse expanded to one
    row per block, products summed in index order in its dtype."""
    inv_exp = torch.repeat_interleave(hll_inv, plan.counts, dim=0,
                                      output_size=hpl.shape[0])
    return flat_block_mm_nn(hpl, inv_exp, dp, dl, dl,
                            acc_dtype=hll_inv.dtype)


def schur_w(hll: torch.Tensor, hpl: Optional[torch.Tensor],
            plan: Optional[WPlan], dp: int, dl: int,
            write_inverse: bool = True
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(Hll^-1, W) of one Hpl group: ``hll`` (L, dl*dl) the landmark
    blocks, ``hpl`` (K, dp*dl) the group's blocks sorted by landmark
    (``plan``). ``hpl`` and ``plan`` None: the inverses only (a landmark
    dim without Hpl blocks; W is None). ``write_inverse=False``: K10
    computes the inverses without storing them (another group of the same
    dl stored them) and the first result is None."""
    name = STATS.name
    if (hpl is None) != (plan is None):
        raise ValueError(f"{name}: give hpl and its plan, or neither")
    tensors = (hll,) if hpl is None else (hll, hpl)
    if not gate(hll.dtype, dl) or any(t.dtype != torch.float32
                                      for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel takes float32 blocks of dl 1..3, got "
            f"dl={dl} and {[t.dtype for t in tensors]}")
    L = hll.shape[0]
    if hll.shape != (L, dl * dl) or (hpl is not None and (
            hpl.shape != (plan.rows, dp * dl) or dp < 1
            or plan.offsets.shape != (L + 1,))):
        raise ValueError(
            f"{name}: Hll {tuple(hll.shape)}, Hpl "
            f"{None if hpl is None else tuple(hpl.shape)} do not fit "
            f"dp={dp}, dl={dl} and the plan")
    if hll.device.type == "cpu":
        inv = hll_inverse_plain(hll, dl)
        w = None if hpl is None else hpl_w_plain(hpl, inv, plan, dp, dl)
        return (inv if write_inverse else None), w
    if hll.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device "
                                  f"{hll.device}")
    for t in tensors + (() if plan is None else (plan.offsets,)):
        if t.device != hll.device or not t.is_contiguous():
            raise ValueError(f"{name}: every input contiguous on "
                             f"{hll.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must start 16-byte aligned")
    inv = torch.empty_like(hll) if write_inverse else None
    w = None if hpl is None else torch.empty_like(hpl)
    rows = w is not None and w.shape[0] > 0
    if L == 0 or not (rows or write_inverse):
        return inv, w
    lib = load_kernel()
    with on_device(hll.device):
        ev = STATS.start()
        err = lib.lib.gt_schur_w_f32(
            hll.data_ptr(), hpl.data_ptr() if rows else None,
            plan.offsets.data_ptr() if rows else None,
            None if inv is None else inv.data_ptr(),
            w.data_ptr() if rows else None, dp if rows else 0, dl, L,
            stream_ptr(hll.device))
        lib.check(err, name)
        STATS.done(ev)
    return inv, w
