"""Gathered block matvecs reduced over segments: kernels K4 and K5
(``csrc/segmv.cu``).

Counterpart of ``graphite_tpu/ops/pallas/segmv.py``:

- ``block_matvec_stream`` (K4): y[dst_i] += A_i w_i, the w rows gathered
  beforehand (the TPU's few-destination stream);
- ``block_matvec_wtbl`` (K4): y[dst_i] += A_i w[lid_i] (``b_schur``);
- ``matvec_sym_stream`` (K5): the symmetric block-sparse S matvec over the
  stored upper triangle (the PCG matvec above ``dense_matvec_limit``).

``segsum_stream.streaming_matvec_tbl`` is K4's third entry point. This
module holds what they share: K5's host plan (``plan_matvec_sym``), the
plain PyTorch versions (``segmv_plain``, ``matvec_sym_plain``) and the
launchers. A K4 site, and each half of a K5 site, is planned as K1's
sites are (``segsum.plan_segments``).

A segment's rows are summed in K1's order (``segsum.lane_sum``): lane l
of ``plan.group`` lanes sums rows l, l+G, ... of the segment in order,
then a halving tree combines the lanes. The plain versions add in that
same order, so on the CPU they equal the kernels bitwise. K5 runs in two
launches, counted as one: its own pass over the stored blocks, then K1
over the row products (``csrc/segmv.cu``).

A wrapper takes the plain version for a tensor on the CPU only; for a
CUDA tensor it launches the kernel (float32 or float64 values, x in the
values' dtype) or raises. Each entry counts its float64 launches apart
(``STREAM_STATS_F64``, ``WTBL_STATS_F64``, ``SYM_STATS_F64``: the FP64
policies' instances, names ending ``[f64]``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..blockfmt import flat_block_mv, flat_block_mv_t
from . import build, segsum
from .launches import LaunchStats, on_device, stream_ptr
from .segsum import SegmentPlan, plan_segments

STREAM_STATS = LaunchStats("segmv.block_matvec_stream")
STREAM_STATS_F64 = LaunchStats("segmv.block_matvec_stream[f64]")
WTBL_STATS = LaunchStats("segmv.block_matvec_wtbl")
WTBL_STATS_F64 = LaunchStats("segmv.block_matvec_wtbl[f64]")
SYM_STATS = LaunchStats("segmv.matvec_sym_stream")
SYM_STATS_F64 = LaunchStats("segmv.matvec_sym_stream[f64]")

MAX_DIM = 16  # largest block side the kernels take
K4_THREADS = 256  # threads of a K4 CTA; a segment's group never spans two
K4_PRODUCT_STRIDE = MAX_DIM + 1  # elements per product row in shared memory
K4_STAGES = 2  # tiles in a K4 CTA's shared memory (csrc/segmv.cu, kK4Stages)
# most blocks per K4 tile (``python -m graphite_tpu_torch.kernel_sweep``
# times K4 at Venice-1778's sites by tile size)
K4_MAX_TILE = 128
# most shared memory of a K4 CTA: its tiles, their products and indices
# (38.0 KB at 9x3 blocks in tiles of 128 in float32; 55.1 KB in tiles of
# 96 in float64)
K4_TILE_BYTES = 56 * 1024
# shared memory a CTA can use (K5's two tiles of G blocks a group must fit)
SMEM_BYTES = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_SIGNATURES = {
    # A, xi, x, n_x, perm, offsets, out, num_segments, m, k, transpose,
    # group_log2, tile_blocks, stream
    **{f"gt_segmv_{d}": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _P] for d in _DTYPES.values()},
    # S, m, k, xc, n_xc, cid, xr, n_xr, rxi, perm, offsets, order, yc, ns,
    # group_log2, P, stream
    **{f"gt_segmv_sym_{d}": [_P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P,
                             _P, _P, _I, _I, _P, _P]
       for d in _DTYPES.values()},
}


def load_kernel() -> build.KernelLibrary:
    """Build K4 / K5 (at first use) and load them."""
    return build.load_library("segmv", _SIGNATURES)


def segmv_plain(left: torch.Tensor, x: torch.Tensor,
                xi: Optional[torch.Tensor], plan: SegmentPlan, m: int, k: int,
                transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4 (the CPU path and the kernel's oracle):
    y[s] = sum of op(A_i) x[xi_i] over the rows i with destination s.

    ``left`` (rows, m*k); ``x`` (n_x, k), or (n_x, m) with ``transpose``;
    ``xi`` (rows,) x row of each A row, or None when ``x`` holds one
    gathered row per A row. An index outside [0, n_x) reads a zero row.
    Returns (num_segments, m), or (num_segments, k) with ``transpose``.
    """
    if xi is None:
        xg = x
    else:
        n_x = x.shape[0]
        x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        xi = torch.where((xi >= 0) & (xi < n_x), xi, n_x)
        xg = x_pad.index_select(0, xi)
    mv = flat_block_mv_t if transpose else flat_block_mv
    return segsum.segment_sum_plain(mv(left, xg, m, k, acc_dtype=left.dtype),
                                    plan)


def k4_tile_blocks(m: int, k: int, elem_bytes: int = 4) -> int:
    """Blocks per K4 tile of elements of ``elem_bytes`` (4: float32, 8:
    float64): ``K4_MAX_TILE``, fewer when ``K4_STAGES`` tiles of (m, k)
    blocks, their product rows and their int32 index rows would not fit
    ``K4_TILE_BYTES``; a multiple of 16 / ``elem_bytes`` blocks (4 in
    float32, 2 in float64), so that an unpermuted tile starts 16-byte
    aligned."""
    per_block = (elem_bytes * (K4_STAGES * m * k + K4_PRODUCT_STRIDE)
                 + 4 * (2 * K4_STAGES + 1))
    align = 16 // elem_bytes
    return max(4, min(K4_MAX_TILE, K4_TILE_BYTES // per_block)
               & ~(align - 1))


def sym_group_cap(m: int, k: int, elem_bytes: int = 4) -> int:
    """Most lanes a K5 column segment may take: K5's pass 1 stages two
    tiles of G (m, k) blocks for a group of G = max(G, 32) threads, which
    must fit ``SMEM_BYTES`` (256 at 9x9 in float32, 128 in float64)."""
    g = segsum.MAX_GROUP
    while g > 1 and 2 * max(g, 32) * m * k * elem_bytes > SMEM_BYTES:
        g //= 2
    return g


def _check(name: str, left: torch.Tensor, x: torch.Tensor,
           xi: Optional[torch.Tensor], plan: SegmentPlan, m: int, k: int,
           transpose: bool):
    for what, t in (("left", left), ("x", x)):
        if left.dtype not in _DTYPES or t.dtype != left.dtype:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes float32 or float64 (one "
                f"dtype), {what} is {t.dtype}")
        if t.device != left.device:
            raise ValueError(f"{name}: {what} is on {t.device}")
    if not (1 <= m <= MAX_DIM and 1 <= k <= MAX_DIM):
        raise ValueError(f"{name}: block ({m}, {k}) larger than {MAX_DIM}")
    rows = plan.rows
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
    if plan.offsets_i32.device != left.device:
        raise ValueError(f"{name}: plan and values on different devices")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_segmv(left: torch.Tensor, x: torch.Tensor,
                 xi: Optional[torch.Tensor], plan: SegmentPlan, m: int,
                 k: int, transpose: bool, stats: LaunchStats) -> torch.Tensor:
    """Launch K4 on CUDA tensors, counting the launch in ``stats``."""
    _check(stats.name, left, x, xi, plan, m, k, transpose)
    left, x = left.contiguous(), x.contiguous()
    out = torch.empty((plan.num_segments, k if transpose else m),
                      dtype=left.dtype, device=left.device)
    lib = load_kernel()
    with on_device(left.device):
        stream = stream_ptr(left.device)
        ev = stats.start()
        err = getattr(lib.lib, f"gt_segmv_{_DTYPES[left.dtype]}")(
            left.data_ptr(), _ptr(xi), x.data_ptr(), x.shape[0],
            _ptr(plan.perm_i32), plan.offsets_i32.data_ptr(), out.data_ptr(),
            plan.num_segments, m, k, int(transpose),
            plan.group.bit_length() - 1,
            k4_tile_blocks(m, k, left.element_size()), stream)
        lib.check(err, stats.name)
        stats.done(ev)
    return out


def block_matvec(left, x, xi, plan: SegmentPlan, m: int, k: int,
                 transpose: bool, stats: LaunchStats,
                 stats_f64: LaunchStats) -> torch.Tensor:
    """K4 on any device: the plain version for CPU tensors, the kernel
    for CUDA tensors (counted in ``stats``, float64 values in
    ``stats_f64``)."""
    if left.device.type == "cpu":
        return segmv_plain(left, x, xi, plan, m, k, transpose)
    if left.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {left.device}")
    return launch_segmv(left, x, xi, plan, m, k, transpose,
                        segsum.stats_for(left, stats, stats_f64))


def block_matvec_stream(left: torch.Tensor, right: torch.Tensor,
                        plan: SegmentPlan, m: int, k: int,
                        transpose: bool = False) -> torch.Tensor:
    """y[dst_i] += A_i w_i (or A_i^T w_i) with the w rows gathered
    beforehand: ``right`` holds one row per A row. Destinations in any
    order (the plan sorts them)."""
    return block_matvec(left, right, None, plan, m, k, transpose,
                        STREAM_STATS, STREAM_STATS_F64)


def block_matvec_wtbl(left: torch.Tensor, w_rows: torch.Tensor,
                      plan: SegmentPlan, lid: torch.Tensor, m: int,
                      k: int) -> torch.Tensor:
    """y[dst_i] += A_i w[lid_i] (``b_schur``: Hpl blocks into pose rows,
    w read from the landmark solve table by index); ``lid`` int32."""
    return block_matvec(left, w_rows, lid, plan, m, k, False, WTBL_STATS,
                        WTBL_STATS_F64)


@dataclasses.dataclass(frozen=True)
class SymPlan:
    """Host-built plan of one K5 site: the row half (destinations ``rid``,
    sorted through a permutation) and the column half (``cid``), with
    ``col_order`` (int32) the column segments longest first: K5's pass 1
    takes them in that order, so the longest do not start last."""

    rows: SegmentPlan
    cols: SegmentPlan
    col_order: torch.Tensor


def plan_matvec_sym(rid: np.ndarray, cid: np.ndarray, n_r: int, n_c: int,
                    device, m: int, group: Optional[int] = None,
                    k: Optional[int] = None,
                    elem_bytes: int = 4) -> SymPlan:
    """Plan the K5 site of stored (m, k) blocks (k = m by default) of
    ``elem_bytes`` elements at (``rid``, ``cid``): the row half is K1 over
    m-wide row products; the column half's lanes are at most
    ``sym_group_cap``. ``group`` forces the lanes per segment of both
    halves."""
    lengths = np.bincount(np.asarray(cid, dtype=np.int64), minlength=n_c)
    order = np.argsort(-lengths, kind="stable").astype(np.int32)
    col_group = group
    if col_group is None:
        col_group = min(segsum.group_size(int(lengths.sum()),
                                          int(np.count_nonzero(lengths))),
                        sym_group_cap(m, m if k is None else k, elem_bytes))
    return SymPlan(rows=plan_segments(rid, n_r, device, group, m),
                   cols=plan_segments(cid, n_c, device, col_group),
                   col_order=torch.as_tensor(order, device=device))


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
    Returns (y_r (n_r, m), y_c (n_c, k)); the caller adds the halves.

    On CUDA: pass 1 reads each stored block once, for y_c and for its row
    product P_b = A_b x_c[cid_b]; pass 2 is K1 summing P into y_r. One
    launch counted in ``SYM_STATS`` (float64 values: ``SYM_STATS_F64``)."""
    if left.device.type == "cpu":
        return matvec_sym_plain(left, xc, xr, cid, rxi, plan, m, k)
    if left.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {left.device}")
    stats = segsum.stats_for(left, SYM_STATS, SYM_STATS_F64)
    name = stats.name
    _check(name, left, xc, cid, plan.rows, m, k, False)
    _check(name, left, xr, rxi, plan.cols, m, k, True)
    cp = plan.cols
    left, xc, xr = left.contiguous(), xc.contiguous(), xr.contiguous()
    P = torch.empty((plan.rows.rows, m), dtype=left.dtype,
                    device=left.device)
    yc = torch.empty((cp.num_segments, k), dtype=left.dtype,
                     device=left.device)
    lib = load_kernel()
    with on_device(left.device):
        stream = stream_ptr(left.device)
        ev = stats.start()
        err = getattr(lib.lib, f"gt_segmv_sym_{_DTYPES[left.dtype]}")(
            left.data_ptr(), m, k, xc.data_ptr(), xc.shape[0], cid.data_ptr(),
            xr.data_ptr(), xr.shape[0], rxi.data_ptr(), _ptr(cp.perm_i32),
            cp.offsets_i32.data_ptr(), plan.col_order.data_ptr(),
            yc.data_ptr(), cp.num_segments, cp.group.bit_length() - 1,
            P.data_ptr(), stream)
        lib.check(err, name)
        yr = segsum.launch_segsum(P, plan.rows, None, name)
        stats.done(ev)
    return yr, yc
