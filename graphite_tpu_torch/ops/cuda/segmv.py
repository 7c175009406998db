"""Gathered block matvecs reduced over segments: kernels K4 and K5
(``csrc/segmv.cu``).

Counterpart of ``graphite_tpu/ops/pallas/segmv.py``:

- ``block_matvec_stream`` (K4): y[dst_i] += A_i w_i, the w rows gathered
  beforehand (the TPU's few-destination stream);
- ``block_matvec_wtbl`` (K4): y[dst_i] += A_i w[lid_i] (``b_schur``);
- ``matvec_sym_stream`` (K5): the symmetric block-sparse S matvec over the
  stored upper triangle (the PCG matvec above ``dense_matvec_limit``).

``segsum_stream.streaming_matvec_tbl`` is K4's third entry point. This
module holds what they share: the host plans (``plan_matvec``,
``plan_matvec_sym``), the plain PyTorch versions (``segmv_plain``,
``matvec_sym_plain``) and the launchers.

A segment's rows are summed by a group of ``plan.group`` kernel threads
(a power of two): lane l sums rows l, l+G, ... of the segment in order,
then a halving tree combines the lanes. The plain versions add in that
same order (``index_add_`` adds rows in order on the CPU), so on the CPU
they equal the kernels bitwise.

A wrapper takes the plain version for a tensor on the CPU only; for a
CUDA tensor it launches the kernel (float32 only) or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..blockfmt import flat_block_mv, flat_block_mv_t
from . import build
from .launches import LaunchStats
from .segsum import SegmentPlan, device_plan, host_plan

STREAM_STATS = LaunchStats("segmv.block_matvec_stream")
WTBL_STATS = LaunchStats("segmv.block_matvec_wtbl")
SYM_STATS = LaunchStats("segmv.matvec_sym_stream")

MAX_DIM = 16  # largest block side the kernels take
MAX_GROUP = 256  # most threads per segment (one CUDA block)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # A, xi, x, n_x, perm, offsets, out, num_segments, m, k, transpose,
    # group_log2, stream
    "gt_segmv_f32": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # S, m, k, then per half (x, n_x, xi, perm, offsets, y, ns, group_log2)
    # for the row half and the column half, stream
    "gt_segmv_sym_f32": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I,
                         _P, _I, _P, _P, _P, _P, _I, _I, _P],
}


def load_kernel() -> build.KernelLibrary:
    """Build K4 / K5 (at first use) and load them."""
    return build.load_library("segmv", _SIGNATURES)


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    """Host-built plan of one K4 site (or one half of a K5 site).

    ``seg`` is the destinations' segment plan (its ``perm`` orders unsorted
    destinations); ``group`` the threads that reduce one segment.
    """

    seg: SegmentPlan
    group: int


def group_size(rows: int, nonempty_segments: int) -> int:
    """Threads per segment: the smallest power of two that leaves each
    lane about 8 rows of the mean segment, at most ``MAX_GROUP``."""
    mean = rows / max(nonempty_segments, 1)
    g = 1
    while g < MAX_GROUP and 8 * g < mean:
        g *= 2
    return g


def plan_matvec(dst: np.ndarray, num_segments: int, device,
                group: Optional[int] = None) -> MatvecPlan:
    """Plan y[dst_i] += ... for destinations ``dst`` (any order)."""
    seg_sorted, perm, offsets = host_plan(dst, num_segments)
    if group is None:
        group = group_size(seg_sorted.size,
                           int(np.count_nonzero(np.diff(offsets))))
    if group < 1 or group > MAX_GROUP or group & (group - 1):
        raise ValueError(f"group {group} is not a power of two <= "
                         f"{MAX_GROUP}")
    return MatvecPlan(seg=device_plan(seg_sorted, perm, offsets, device),
                      group=group)


def lane_slots(plan: MatvecPlan) -> torch.Tensor:
    """The kernel's accumulator ``segment * group + lane`` of each sorted
    row (lane = the row's position in its segment modulo ``group``)."""
    seg = plan.seg
    pos = (torch.arange(seg.rows, device=seg.seg.device)
           - seg.offsets.index_select(0, seg.seg))
    return seg.seg * plan.group + pos % plan.group


def segmv_plain(left: torch.Tensor, x: torch.Tensor,
                xi: Optional[torch.Tensor], plan: MatvecPlan, m: int, k: int,
                transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4 (the CPU path and the kernel's oracle):
    y[s] = sum of op(A_i) x[xi_i] over the rows i with destination s.

    ``left`` (rows, m*k); ``x`` (n_x, k), or (n_x, m) with ``transpose``;
    ``xi`` (rows,) x row of each A row, or None when ``x`` holds one
    gathered row per A row. An index outside [0, n_x) reads a zero row.
    Returns (num_segments, m), or (num_segments, k) with ``transpose``.
    """
    seg = plan.seg
    if xi is None:
        xg = x
    else:
        n_x = x.shape[0]
        x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        xi = torch.where((xi >= 0) & (xi < n_x), xi, n_x)
        xg = x_pad.index_select(0, xi)
    mv = flat_block_mv_t if transpose else flat_block_mv
    y = mv(left, xg, m, k, acc_dtype=left.dtype)
    if seg.perm is not None:
        y = y.index_select(0, seg.perm)
    g = plan.group
    lanes = y.new_zeros((seg.num_segments * g, y.shape[1]))
    lanes.index_add_(0, lane_slots(plan), y)
    lanes = lanes.view(seg.num_segments, g, y.shape[1])
    while lanes.shape[1] > 1:  # the kernel's halving tree
        h = lanes.shape[1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    return lanes[:, 0]


def _check(name: str, left: torch.Tensor, x: torch.Tensor,
           xi: Optional[torch.Tensor], plan: MatvecPlan, m: int, k: int,
           transpose: bool):
    for what, t in (("left", left), ("x", x)):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes float32, {what} is "
                f"{t.dtype}")
        if t.device != left.device:
            raise ValueError(f"{name}: {what} is on {t.device}")
    if not (1 <= m <= MAX_DIM and 1 <= k <= MAX_DIM):
        raise ValueError(f"{name}: block ({m}, {k}) larger than {MAX_DIM}")
    rows = plan.seg.rows
    if left.shape != (rows, m * k):
        raise ValueError(f"{name}: left must be ({rows}, {m * k}), got "
                         f"{tuple(left.shape)}")
    xd = m if transpose else k
    if x.dim() != 2 or x.shape[1] != xd:
        raise ValueError(f"{name}: x must be (n, {xd}), got "
                         f"{tuple(x.shape)}")
    if xi is None:
        if x.shape[0] != rows:
            raise ValueError(f"{name}: a gathered x needs {rows} rows")
    elif (xi.dtype != torch.int32 or xi.shape != (rows,)
          or xi.device != left.device):
        raise ValueError(f"{name}: xi must be ({rows},) int32 on "
                         f"{left.device}")
    if plan.seg.offsets_i32.device != left.device:
        raise ValueError(f"{name}: plan and values on different devices")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_segmv(left: torch.Tensor, x: torch.Tensor,
                 xi: Optional[torch.Tensor], plan: MatvecPlan, m: int,
                 k: int, transpose: bool, stats: LaunchStats) -> torch.Tensor:
    """Launch K4 on CUDA tensors, counting the launch in ``stats``."""
    _check(stats.name, left, x, xi, plan, m, k, transpose)
    left, x = left.contiguous(), x.contiguous()
    seg = plan.seg
    out = torch.empty((seg.num_segments, k if transpose else m),
                      dtype=torch.float32, device=left.device)
    lib = load_kernel()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        ev = stats.start()
        err = lib.lib.gt_segmv_f32(
            left.data_ptr(), _ptr(xi), x.data_ptr(), x.shape[0],
            _ptr(seg.perm_i32), seg.offsets_i32.data_ptr(), out.data_ptr(),
            seg.num_segments, m, k, int(transpose),
            plan.group.bit_length() - 1, stream)
        lib.check(err, stats.name)
        stats.done(ev)
    return out


def block_matvec(left, x, xi, plan: MatvecPlan, m: int, k: int,
                 transpose: bool, stats: LaunchStats) -> torch.Tensor:
    """K4 on any device: the plain version for CPU tensors, the kernel
    (counted in ``stats``) for CUDA tensors."""
    if left.device.type == "cpu":
        return segmv_plain(left, x, xi, plan, m, k, transpose)
    if left.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {left.device}")
    return launch_segmv(left, x, xi, plan, m, k, transpose, stats)


def block_matvec_stream(left: torch.Tensor, right: torch.Tensor,
                        plan: MatvecPlan, m: int, k: int,
                        transpose: bool = False) -> torch.Tensor:
    """y[dst_i] += A_i w_i (or A_i^T w_i) with the w rows gathered
    beforehand: ``right`` holds one row per A row. Destinations in any
    order (the plan sorts them)."""
    return block_matvec(left, right, None, plan, m, k, transpose,
                        STREAM_STATS)


def block_matvec_wtbl(left: torch.Tensor, w_rows: torch.Tensor,
                      plan: MatvecPlan, lid: torch.Tensor, m: int,
                      k: int) -> torch.Tensor:
    """y[dst_i] += A_i w[lid_i] (``b_schur``: Hpl blocks into pose rows,
    w read from the landmark solve table by index); ``lid`` int32."""
    return block_matvec(left, w_rows, lid, plan, m, k, False, WTBL_STATS)


@dataclasses.dataclass(frozen=True)
class SymPlan:
    """Host-built plan of one K5 site: the row half (destinations ``rid``,
    sorted through a permutation) and the column half (``cid``)."""

    rows: MatvecPlan
    cols: MatvecPlan


def plan_matvec_sym(rid: np.ndarray, cid: np.ndarray, n_r: int, n_c: int,
                    device) -> SymPlan:
    return SymPlan(rows=plan_matvec(rid, n_r, device),
                   cols=plan_matvec(cid, n_c, device))


def matvec_sym_plain(left, xc, xr, cid, rxi, plan: SymPlan, m: int, k: int):
    """Plain PyTorch version of K5: (y_r, y_c) = (sum A_b x_c[cid_b] into
    rid_b, sum A_b^T x_r[rxi_b] into cid_b)."""
    return (segmv_plain(left, xc, cid, plan.rows, m, k),
            segmv_plain(left, xr, rxi, plan.cols, m, k, transpose=True))


def matvec_sym_stream(left: torch.Tensor, xc: torch.Tensor, xr: torch.Tensor,
                      cid: torch.Tensor, rxi: torch.Tensor, plan: SymPlan,
                      m: int, k: int):
    """Symmetric block matvec over stored blocks ``left`` (rows, m*k):

        y_r[rid_b] += A_b x_c[cid_b]     (every block)
        y_c[cid_b] += A_b^T x_r[rxi_b]   (rxi_b = rid_b off the diagonal,
                                          an out-of-range zero row on it)

    ``xc`` (n_c, k) and ``xr`` (n_r, m) x rows; ``cid`` and ``rxi`` int32.
    Returns (y_r (n_r, m), y_c (n_c, k)); the caller adds the halves."""
    if left.device.type == "cpu":
        return matvec_sym_plain(left, xc, xr, cid, rxi, plan, m, k)
    if left.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {left.device}")
    name = SYM_STATS.name
    _check(name, left, xc, cid, plan.rows, m, k, False)
    _check(name, left, xr, rxi, plan.cols, m, k, True)
    left, xc, xr = left.contiguous(), xc.contiguous(), xr.contiguous()
    rp, cp = plan.rows, plan.cols
    yr = torch.empty((rp.seg.num_segments, m), dtype=torch.float32,
                     device=left.device)
    yc = torch.empty((cp.seg.num_segments, k), dtype=torch.float32,
                     device=left.device)
    lib = load_kernel()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        ev = SYM_STATS.start()
        err = lib.lib.gt_segmv_sym_f32(
            left.data_ptr(), m, k,
            xc.data_ptr(), xc.shape[0], cid.data_ptr(),
            _ptr(rp.seg.perm_i32), rp.seg.offsets_i32.data_ptr(),
            yr.data_ptr(), rp.seg.num_segments, rp.group.bit_length() - 1,
            xr.data_ptr(), xr.shape[0], rxi.data_ptr(),
            _ptr(cp.seg.perm_i32), cp.seg.offsets_i32.data_ptr(),
            yc.data_ptr(), cp.seg.num_segments, cp.group.bit_length() - 1,
            stream)
        lib.check(err, name)
        SYM_STATS.done(ev)
    return yr, yc
