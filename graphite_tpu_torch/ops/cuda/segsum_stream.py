"""Reductions of the streamed sites: kernels K1, K3 and K4.

Counterpart of ``graphite_tpu/ops/pallas/segsum_stream.py``, whose TPU
kernels stream an output too large for VMEM through a rolling window. On
the GPU no windows are needed, and its four entry points map onto three
kernels, each entry keeping its own launch count so a run shows which
sites it served:

- ``streaming_segment_sum`` (K1, ``csrc/segsum.cu``): every
  ``ops.streamreduce.reduce_rows`` call (factor-row reductions in
  ``linearize``, Hessian value groups, and the pose rows of ``b_schur`` and
  the landmark back-substitution below their gates);
- ``streaming_segment_product_sum`` and
  ``streaming_segment_product_sum_rtbl`` (K3, ``csrc/segprod.cu``): per-row
  L R^T products reduced over sorted segments, from gathered streams or
  straight from the tables by index (``schur_values`` above its gate);
- ``streaming_matvec_tbl`` (K4, ``csrc/segmv.cu``, shared with
  ``segmv``): a destination-sorted block matvec with the x rows read by
  index (the landmark back-substitution above its gate).

CPU tensors take the plain versions (``streaming_segment_sum_plain``,
``segment_product_sum_plain``, ``segmv.segmv_plain``); CUDA tensors launch
the kernel (float32 only) or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..blockfmt import flat_block_mm_nt
from . import build, segmv
from .launches import LaunchStats, on_device, stream_ptr
from .segsum import SegmentPlan, launch_segsum
from .segsum import segment_sum_plain as streaming_segment_sum_plain

__all__ = [
    "STATS", "PRODUCT_STATS", "PRODUCT_RTBL_STATS", "MATVEC_TBL_STATS",
    "streaming_segment_sum", "streaming_segment_sum_plain",
    "streaming_segment_product_sum", "streaming_segment_product_sum_rtbl",
    "segment_product_sum_plain", "streaming_matvec_tbl",
]

STATS = LaunchStats("segsum_stream.streaming_segment_sum")
PRODUCT_STATS = LaunchStats("segsum_stream.streaming_segment_product_sum")
PRODUCT_RTBL_STATS = LaunchStats(
    "segsum_stream.streaming_segment_product_sum_rtbl")
MATVEC_TBL_STATS = LaunchStats("segsum_stream.streaming_matvec_tbl")

# rows per step of the plain triple product: bounds its (rows, m*n)
# product transient (324 MB for 9x9 blocks in float32)
PLAIN_CHUNK_ROWS = 1 << 20

_SIGNATURES = {
    # L, li, R, ri, offsets, out, num_segments, m, k, n, stream
    "gt_segprod_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p],
}


def load_product_kernel() -> build.KernelLibrary:
    """Build K3 (at first use) and load it."""
    return build.load_library("segprod", _SIGNATURES)


def streaming_segment_sum(values: torch.Tensor,
                          plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows -> (num_segments, D) sums; CPU tensors take the plain
    version, CUDA tensors launch K1."""
    if values.device.type == "cpu":
        return streaming_segment_sum_plain(values, plan)
    if values.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {values.device}")
    return launch_segsum(values, plan, STATS)


def segment_product_sum_plain(left: torch.Tensor, right: torch.Tensor,
                              plan: SegmentPlan, m: int, k: int, n: int,
                              left_idx: Optional[torch.Tensor] = None,
                              right_idx: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K3 (the CPU path and the kernel's oracle):
    out[s] = sum of L_r R_r^T over the rows r of segment s, with L_r =
    left[left_idx[r]] (left[r] when ``left_idx`` is None) and R_r likewise.

    The rows are taken in destination-contiguous chunks of
    ``PLAIN_CHUNK_ROWS``: per-row products (``flat_block_mm_nt``), then
    ``index_add_``, which adds rows in order on the CPU, as the kernel
    does."""
    if plan.perm is not None:
        raise ValueError("the triple product needs destination-sorted rows")
    out = left.new_zeros((plan.num_segments, m * n))
    for c0 in range(0, plan.rows, PLAIN_CHUNK_ROWS):
        c1 = min(c0 + PLAIN_CHUNK_ROWS, plan.rows)
        lrows = (left[c0:c1] if left_idx is None
                 else left.index_select(0, left_idx[c0:c1]))
        rrows = (right[c0:c1] if right_idx is None
                 else right.index_select(0, right_idx[c0:c1]))
        prod = flat_block_mm_nt(lrows, rrows, m, k, n, acc_dtype=out.dtype)
        out.index_add_(0, plan.seg[c0:c1], prod)
    return out


def _product_sum(left, right, plan: SegmentPlan, m, k, n, left_idx,
                 right_idx, stats: LaunchStats) -> torch.Tensor:
    if left.device.type == "cpu":
        return segment_product_sum_plain(left, right, plan, m, k, n,
                                         left_idx, right_idx)
    if left.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {left.device}")
    name = stats.name
    for what, t, width, idx in (("left", left, m * k, left_idx),
                                ("right", right, n * k, right_idx)):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes float32, {what} is "
                f"{t.dtype}")
        if t.device != left.device or t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name}: {what} must be (n, {width}) on "
                             f"{left.device}, got {tuple(t.shape)}")
        if idx is None:
            if t.shape[0] != plan.rows:
                raise ValueError(f"{name}: gathered {what} needs "
                                 f"{plan.rows} rows")
        elif (idx.dtype != torch.int32 or idx.shape != (plan.rows,)
              or idx.device != left.device):
            raise ValueError(f"{name}: {what} index must be "
                             f"({plan.rows},) int32 on {left.device}")
    if max(m, k, n) > segmv.MAX_DIM:
        raise ValueError(f"{name}: block side above {segmv.MAX_DIM}")
    if plan.perm is not None:
        raise ValueError(f"{name}: needs destination-sorted rows")
    if plan.offsets_i32.device != left.device:
        raise ValueError(f"{name}: plan and values on different devices")
    left, right = left.contiguous(), right.contiguous()
    out = torch.empty((plan.num_segments, m * n), dtype=torch.float32,
                      device=left.device)
    lib = load_product_kernel()
    with on_device(left.device):
        stream = stream_ptr(left.device)
        ev = stats.start()
        err = lib.lib.gt_segprod_f32(
            left.data_ptr(),
            None if left_idx is None else left_idx.data_ptr(),
            right.data_ptr(),
            None if right_idx is None else right_idx.data_ptr(),
            plan.offsets_i32.data_ptr(), out.data_ptr(), plan.num_segments,
            m, k, n, stream)
        lib.check(err, name)
        stats.done(ev)
    return out


def streaming_segment_product_sum(left: torch.Tensor, right: torch.Tensor,
                                  plan: SegmentPlan, m: int, k: int,
                                  n: int) -> torch.Tensor:
    """Fused per-row A B^T + sorted segment sum over gathered streams:
    ``left`` (K, m*k) and ``right`` (K, n*k) hold one row per pair, in
    destination order. Returns (num_segments, m*n)."""
    return _product_sum(left, right, plan, m, k, n, None, None,
                        PRODUCT_STATS)


def streaming_segment_product_sum_rtbl(left: torch.Tensor,
                                       right: torch.Tensor,
                                       plan: SegmentPlan, m: int, k: int,
                                       n: int,
                                       left_idx: Optional[torch.Tensor],
                                       right_idx: torch.Tensor
                                       ) -> torch.Tensor:
    """The same sum with the right operand read from its table by
    ``right_idx`` (int32, one per pair), and the left one too when
    ``left_idx`` is given (the Schur triple products read W and Hpl this
    way, so no gathered stream is ever written)."""
    return _product_sum(left, right, plan, m, k, n, left_idx, right_idx,
                        PRODUCT_RTBL_STATS)


def streaming_matvec_tbl(left: torch.Tensor, x: torch.Tensor,
                         idx: torch.Tensor, plan: SegmentPlan, m: int,
                         k: int, transpose: bool = False) -> torch.Tensor:
    """y[seg_i] += A_i x[idx_i] (or A_i^T x[idx_i] with ``transpose``):
    ``left`` (K, m*k) blocks, ``x`` the row table, ``idx`` int32 (an index
    outside the table reads a zero row). K4 with its own launch count."""
    return segmv.block_matvec(left, x, idx, plan, m, k, transpose,
                              MATVEC_TBL_STATS)
