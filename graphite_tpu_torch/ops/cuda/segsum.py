"""Sorted segmented row sum: kernel K1 (``csrc/segsum.cu``).

Counterpart of ``graphite_tpu/ops/pallas/segsum.py`` (``sorted_segment_sum``:
the Schur product scatter, whose TPU output stays in VMEM). This module
also holds what both K1 entry points share: the host plan
(``plan_segments``), the plain PyTorch version (``segment_sum_plain``) and
the launcher. ``segsum_stream.streaming_segment_sum`` is the other entry.

A wrapper takes the plain version for a tensor on the CPU only; for a
CUDA tensor it launches K1 (float32 only) or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import build
from .launches import LaunchStats

STATS = LaunchStats("segsum.sorted_segment_sum")

_SIGNATURES = {
    # vals, perm (or null), offsets, out, num_segments, d, stream
    "gt_segsum_f32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p],
}


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
    torch indexing, with int32 copies for the kernel's C interface.
    """

    rows: int
    num_segments: int
    seg: torch.Tensor
    offsets: torch.Tensor
    perm: Optional[torch.Tensor]
    offsets_i32: torch.Tensor
    perm_i32: Optional[torch.Tensor]


def host_plan(seg: np.ndarray, num_segments: int):
    """The host arrays of a plan: (destinations sorted, stable sort
    permutation or None when already sorted, CSR offsets), all int64."""
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    if seg.size and (seg.min() < 0 or seg.max() >= num_segments):
        raise ValueError("segment id out of range [0, num_segments)")
    if seg.size >= (1 << 31):
        raise ValueError("more than 2^31 rows in one reduction")
    if seg.size == 0 or np.all(np.diff(seg) >= 0):
        perm = None
        seg_sorted = seg
    else:
        perm = np.argsort(seg, kind="stable")
        seg_sorted = seg[perm]
    offsets = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg_sorted, minlength=num_segments),
              out=offsets[1:])
    return seg_sorted, perm, offsets


def plan_segments(seg: np.ndarray, num_segments: int,
                  device) -> SegmentPlan:
    """Plan the reduction of rows with destinations ``seg`` (any order)."""
    return device_plan(*host_plan(seg, num_segments), device)


def device_plan(seg_sorted: np.ndarray, perm: Optional[np.ndarray],
                offsets: np.ndarray, device) -> SegmentPlan:
    """The ``SegmentPlan`` of ``host_plan``'s arrays on ``device``."""
    num_segments = offsets.shape[0] - 1

    def dev(a, dtype):
        return None if a is None else torch.as_tensor(
            a.astype(dtype), device=device)

    return SegmentPlan(
        rows=int(seg_sorted.size), num_segments=int(num_segments),
        seg=dev(seg_sorted, np.int64), offsets=dev(offsets, np.int64),
        perm=dev(perm, np.int64), offsets_i32=dev(offsets, np.int32),
        perm_i32=dev(perm, np.int32))


def segment_sum_plain(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Plain PyTorch version of K1 (the CPU path and the kernel's oracle)."""
    v = values if plan.perm is None else values.index_select(0, plan.perm)
    out = values.new_zeros((plan.num_segments, values.shape[1]))
    return out.index_add_(0, plan.seg, v)


def launch_segsum(values: torch.Tensor, plan: SegmentPlan,
                  stats: LaunchStats) -> torch.Tensor:
    """Launch K1 on a CUDA tensor, counting the launch in ``stats``."""
    if values.dtype != torch.float32:
        raise NotImplementedError(
            f"{stats.name}: the CUDA kernel takes float32, got {values.dtype}")
    if values.dim() != 2 or values.shape[0] != plan.rows:
        raise ValueError(
            f"{stats.name}: values must be ({plan.rows}, D), got "
            f"{tuple(values.shape)}")
    if plan.offsets_i32.device != values.device:
        raise ValueError(f"{stats.name}: plan and values on different devices")
    values = values.contiguous()
    d = values.shape[1]
    out = torch.empty((plan.num_segments, d), dtype=torch.float32,
                      device=values.device)
    lib = load_kernel()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        ev = stats.start()
        err = lib.lib.gt_segsum_f32(
            values.data_ptr(),
            None if plan.perm_i32 is None else plan.perm_i32.data_ptr(),
            plan.offsets_i32.data_ptr(), out.data_ptr(), plan.num_segments,
            d, stream)
        lib.check(err, stats.name)
        stats.done(ev)
    return out


def sorted_segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows -> (num_segments, D) sums (the Schur product scatter)."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, plan)
    if values.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {values.device}")
    return launch_segsum(values, plan, STATS)
