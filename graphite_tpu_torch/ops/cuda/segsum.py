"""Sorted segmented row sum: kernel K1 (``csrc/segsum.cu``).

Counterpart of ``graphite_tpu/ops/pallas/segsum.py`` (``sorted_segment_sum``:
the Schur product scatter, whose TPU output stays in VMEM). This module
also holds what every segment reduction of the port shares (K1, K4 / K5
in ``segmv`` and K3 in ``segsum_stream``): the host plan
(``plan_segments``) with its group rule (``group_size``), the summation
order (``lane_sum``: ``lane_slots``, then ``halve_lanes``), the plain
PyTorch version (``segment_sum_plain``) and the launcher
(``launch_segsum``).
``segsum_stream.streaming_segment_sum`` is K1's other entry.

The order: a segment's sorted rows are summed by ``plan.group`` lanes (a
power of two). Lane l sums rows l, l+G, l+2G, ... of the segment in order;
then a halving tree combines the lanes (lane l += lane l+h, h = G/2, ...,
1). At G = 1 that is row order. The kernels add in this order and the
plain versions too (``index_add_`` adds rows in order on the CPU), so on
the CPU they equal the kernels bitwise.

A wrapper takes the plain version for a tensor on the CPU only; for a
CUDA tensor it launches K1 (float32 or float64; any other dtype raises).
Each entry counts its float64 launches apart (``STATS_F64``: the FP64
policies' instance of the kernel).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ... import hostops
from . import build
from .launches import LaunchStats, on_device, stream_ptr

STATS = LaunchStats("segsum.sorted_segment_sum")
STATS_F64 = LaunchStats("segsum.sorted_segment_sum[f64]")

MAX_GROUP = 256  # most lanes per segment
# K1 spreads a row's columns, up to 32 at a time, over the threads of a CTA
# of at most K1_THREADS and keeps each thread's lanes in registers; beyond
# two lanes a thread the registers cost more than the lanes gain
# (``python -m graphite_tpu_torch.kernel_sweep``)
K1_THREADS = 512

# vals, perm (or null), offsets, out, num_segments, d, group_log2, stream
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ENTRY = {torch.float32: "gt_segsum_f32", torch.float64: "gt_segsum_f64"}
_SIGNATURES = {entry: _ARGS for entry in _ENTRY.values()}


def load_kernel() -> build.KernelLibrary:
    """Build K1 (at first use) and load it."""
    return build.load_library("segsum", _SIGNATURES)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Host-built plan of one reduction site: ``(rows, D)`` values ->
    ``(num_segments, D)`` sums.

    ``perm`` (None when the destinations are already sorted) orders the
    value rows by destination: sorted row r is ``values[perm[r]]``.
    ``offsets`` is the CSR segment start of each destination over the
    sorted order; ``seg`` the destination of each sorted row. int64 for
    torch indexing, with int32 copies for the kernels' C interface.
    ``group`` is the number of lanes that sum one segment.
    """

    rows: int
    num_segments: int
    seg: torch.Tensor
    offsets: torch.Tensor
    perm: Optional[torch.Tensor]
    offsets_i32: torch.Tensor
    perm_i32: Optional[torch.Tensor]
    group: int


def lane_cap(width: int) -> int:
    """Most lanes per segment for K1 at ``width`` columns: two per thread
    of a ``K1_THREADS`` CTA whose threads each take one of up to 32
    columns (64 at width 9, 32 at widths above 16)."""
    slots = 1
    while 2 * slots * min(width, 32) <= K1_THREADS:
        slots *= 2
    return 2 * slots


def group_size(rows: int, nonempty_segments: int,
               width: Optional[int] = None) -> int:
    """Lanes per segment: the smallest power of two that leaves each lane
    about 8 rows of the mean non-empty segment, at most ``MAX_GROUP`` and,
    for a K1 site of ``width`` columns, at most ``lane_cap(width)`` (K4
    and K5's column pass give each lane a thread: no width). Short
    segments (landmarks, pose-graph rows) get 1 lane, so they keep row
    order; a camera's ~600-2,800 rows get 32-256."""
    cap = MAX_GROUP if width is None else min(MAX_GROUP, lane_cap(width))
    mean = rows / max(nonempty_segments, 1)
    g = 1
    while g < cap and 8 * g < mean:
        g *= 2
    return g


def host_plan(seg: np.ndarray, num_segments: int):
    """The host arrays of a plan: (destinations sorted, stable sort
    permutation or None when already sorted, CSR offsets), all int64. The
    permutation is a counting sort over the segments
    (``hostops.stable_argsort``)."""
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    if seg.size and (seg.min() < 0 or seg.max() >= num_segments):
        raise ValueError("segment id out of range [0, num_segments)")
    if seg.size > (1 << 31) - 1024:  # the kernels index rows in int32
        raise ValueError("more than 2^31 - 1024 rows in one reduction")
    if seg.size == 0 or np.all(np.diff(seg) >= 0):
        perm = None
        seg_sorted = seg
    else:
        perm = hostops.stable_argsort(seg, num_segments)
        seg_sorted = seg[perm]
    offsets = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg_sorted, minlength=num_segments),
              out=offsets[1:])
    return seg_sorted, perm, offsets


def plan_segments(seg: np.ndarray, num_segments: int, device,
                  group: Optional[int] = None,
                  width: Optional[int] = None) -> SegmentPlan:
    """Plan the reduction of rows with destinations ``seg`` (any order);
    ``group`` forces the lanes per segment (default: ``group_size`` for
    rows of ``width`` columns)."""
    return device_plan(*host_plan(seg, num_segments), device, group, width)


def device_plan(seg_sorted: np.ndarray, perm: Optional[np.ndarray],
                offsets: np.ndarray, device, group: Optional[int] = None,
                width: Optional[int] = None) -> SegmentPlan:
    """The ``SegmentPlan`` of ``host_plan``'s arrays on ``device``."""
    num_segments = offsets.shape[0] - 1
    if group is None:
        group = group_size(seg_sorted.size,
                           int(np.count_nonzero(np.diff(offsets))), width)
    if group < 1 or group > MAX_GROUP or group & (group - 1):
        raise ValueError(f"group {group} is not a power of two <= "
                         f"{MAX_GROUP}")

    def dev(a, dtype):
        return None if a is None else torch.as_tensor(
            a.astype(dtype), device=device)

    return SegmentPlan(
        rows=int(seg_sorted.size), num_segments=int(num_segments),
        seg=dev(seg_sorted, np.int64), offsets=dev(offsets, np.int64),
        perm=dev(perm, np.int64), offsets_i32=dev(offsets, np.int32),
        perm_i32=dev(perm, np.int32), group=int(group))


def positions_in_segments(plan: SegmentPlan) -> torch.Tensor:
    """Each sorted row's position in its segment."""
    return (torch.arange(plan.rows, device=plan.seg.device)
            - plan.offsets.index_select(0, plan.seg))


def lane_slots(plan: SegmentPlan) -> torch.Tensor:
    """The lane ``segment * group + lane`` of each sorted row (lane = the
    row's position in its segment modulo ``group``)."""
    return plan.seg * plan.group + positions_in_segments(plan) % plan.group


def halve_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """(n, g, D) lane sums -> (n, D) by the halving tree: lane l += lane
    l+h, h = g/2, ..., 1."""
    while lanes.shape[1] > 1:
        h = lanes.shape[1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    return lanes[:, 0]


def lane_sum(rows: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows in sorted order -> (num_segments, D) sums, added in the
    kernels' order: per lane in row order, then the halving tree."""
    g = plan.group
    lanes = rows.new_zeros((plan.num_segments * g, rows.shape[1]))
    lanes.index_add_(0, plan.seg if g == 1 else lane_slots(plan), rows)
    return halve_lanes(lanes.view(plan.num_segments, g, rows.shape[1]))


def segment_sum_plain(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Plain PyTorch version of K1 (the CPU path and the kernel's oracle)."""
    v = values if plan.perm is None else values.index_select(0, plan.perm)
    return lane_sum(v, plan)


def launch_segsum(values: torch.Tensor, plan: SegmentPlan,
                  stats: Optional[LaunchStats],
                  name: Optional[str] = None) -> torch.Tensor:
    """Launch K1 on a CUDA tensor, on the current stream, counting the
    launch in ``stats``; ``stats`` None launches uncounted (K5 runs K1 as
    its second pass, under its own count) and ``name`` names the caller in
    errors. Raises on what K1 does not take."""
    name = stats.name if stats is not None else name
    entry = _ENTRY.get(values.dtype)
    if entry is None:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes float32 or float64, got "
            f"{values.dtype}")
    if values.dim() != 2 or values.shape[0] != plan.rows:
        raise ValueError(
            f"{name}: values must be ({plan.rows}, D), got "
            f"{tuple(values.shape)}")
    if plan.offsets_i32.device != values.device:
        raise ValueError(f"{name}: plan and values on different devices")
    values = values.contiguous()
    d = values.shape[1]
    out = torch.empty((plan.num_segments, d), dtype=values.dtype,
                      device=values.device)
    lib = load_kernel()
    with on_device(values.device):
        ev = None if stats is None else stats.start()
        err = getattr(lib.lib, entry)(
            values.data_ptr(),
            None if plan.perm_i32 is None else plan.perm_i32.data_ptr(),
            plan.offsets_i32.data_ptr(), out.data_ptr(), plan.num_segments,
            d, plan.group.bit_length() - 1,
            stream_ptr(values.device))
        lib.check(err, name)
        if stats is not None:
            stats.done(ev)
    return out


def stats_for(values: torch.Tensor, stats: LaunchStats,
              stats_f64: LaunchStats) -> LaunchStats:
    """The count a K1 entry adds a launch on ``values`` to: its float64
    count for float64 values, else its own."""
    return stats_f64 if values.dtype == torch.float64 else stats


def sorted_segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows -> (num_segments, D) sums (the Schur product scatter)."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, plan)
    if values.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {values.device}")
    return launch_segsum(values, plan, stats_for(values, STATS, STATS_F64))
