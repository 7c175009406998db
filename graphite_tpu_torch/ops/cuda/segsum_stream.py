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
  straight from the tables by index (``schur_values`` above its gate),
  with a host plan of their own (``plan_products``: lanes per segment);
  the second can store ``base - sums`` instead of the sums (``base``,
  ``base_idx``: S = Hpp - the products, written once, in place for a
  later group into the same S group);
- ``streaming_matvec_tbl`` (K4, ``csrc/segmv.cu``, shared with
  ``segmv``): a destination-sorted block matvec with the x rows read by
  index (the landmark back-substitution above its gate).

CPU tensors take the plain versions (``streaming_segment_sum_plain``,
``segment_product_sum_plain`` and ``product_store_plain``,
``segmv.segmv_plain``); CUDA tensors launch
the kernel or raise: K1, K3 and K4 take float32 and float64, each entry
counting its float64 launches apart (``STATS_F64``, ``PRODUCT_STATS_F64``,
``PRODUCT_RTBL_STATS_F64``, ``MATVEC_TBL_STATS_F64``: the FP64 policies'
instances, names ending ``[f64]``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..blockfmt import flat_block_mm_nt
from . import build, segmv, segsum
from .launches import LaunchStats, on_device, stream_ptr
from .segsum import SegmentPlan, launch_segsum, stats_for
from .segsum import segment_sum_plain as streaming_segment_sum_plain

__all__ = [
    "STATS", "STATS_F64", "PRODUCT_STATS", "PRODUCT_STATS_F64",
    "PRODUCT_RTBL_STATS", "PRODUCT_RTBL_STATS_F64", "MATVEC_TBL_STATS",
    "MATVEC_TBL_STATS_F64",
    "ProductPlan", "plan_products", "product_lanes",
    "streaming_segment_sum", "streaming_segment_sum_plain",
    "streaming_segment_product_sum", "streaming_segment_product_sum_rtbl",
    "segment_product_sum_plain", "product_store_plain",
    "streaming_matvec_tbl",
]

STATS = LaunchStats("segsum_stream.streaming_segment_sum")
STATS_F64 = LaunchStats("segsum_stream.streaming_segment_sum[f64]")
PRODUCT_STATS = LaunchStats("segsum_stream.streaming_segment_product_sum")
PRODUCT_STATS_F64 = LaunchStats(
    "segsum_stream.streaming_segment_product_sum[f64]")
PRODUCT_RTBL_STATS = LaunchStats(
    "segsum_stream.streaming_segment_product_sum_rtbl")
PRODUCT_RTBL_STATS_F64 = LaunchStats(
    "segsum_stream.streaming_segment_product_sum_rtbl[f64]")
MATVEC_TBL_STATS = LaunchStats("segsum_stream.streaming_matvec_tbl")
MATVEC_TBL_STATS_F64 = LaunchStats("segsum_stream.streaming_matvec_tbl[f64]")

# rows per step of the plain triple product: bounds its (rows, m*n)
# product transient (324 MB for 9x9 blocks in float32)
PLAIN_CHUNK_ROWS = 1 << 20

# K3's CTA (``csrc/segprod.cu``): rows staged per round, and the most
# lanes of a segment a thread keeps in registers. Both hold in float64:
# a 256-lane segment fills a CTA's 64 slots only at 4 lanes a thread, and
# a kernel's registers are those of its largest branch, so fewer lanes a
# thread for shorter segments would save none.
PRODUCT_SLOTS = 64
PRODUCT_REGISTER_LANES = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
# L, li, R, ri, offsets, order, ctas, n_cta, out, base, base_idx, m, k, n,
# stream
_PRODUCT_ENTRY = {torch.float32: "gt_segprod_f32",
                  torch.float64: "gt_segprod_f64"}
_SIGNATURES = {entry: [_P] * 7 + [_I] + [_P] * 3 + [_I] * 3 + [_P]
               for entry in _PRODUCT_ENTRY.values()}


def load_product_kernel() -> build.KernelLibrary:
    """Build K3 (at first use) and load it."""
    return build.load_library("segprod", _SIGNATURES)


def streaming_segment_sum(values: torch.Tensor,
                          plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows -> (num_segments, D) sums; CPU tensors take the plain
    version, CUDA tensors launch K1 (float32 or float64)."""
    if values.device.type == "cpu":
        return streaming_segment_sum_plain(values, plan)
    if values.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {values.device}")
    return launch_segsum(values, plan, stats_for(values, STATS, STATS_F64))


def product_lanes(lengths: np.ndarray) -> np.ndarray:
    """K3's lanes per segment: K1's group rule applied to each segment's
    own length (``segsum.group_size(len, 1)``): 1 lane up to 8 rows, then
    a power of two leaving ~8 rows per lane, at most ``segsum.MAX_GROUP``.
    (A thread keeps up to ``PRODUCT_REGISTER_LANES`` of them in registers
    and a segment takes as many threads as it needs, so no lower cap.)"""
    uniq, inv = np.unique(np.asarray(lengths, dtype=np.int64),
                          return_inverse=True)
    rule = np.array([segsum.group_size(int(u), 1) for u in uniq],
                    dtype=np.int64)
    return rule[inv.reshape(-1)]


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    """Host-built plan of one K3 site: the destination-sorted reduction
    ``segments`` (a ``SegmentPlan``; K3 does not read its ``group``), each
    segment's ``lanes`` (``product_lanes``) and ``first_lane``, its first
    slot in the plain version's lane table, numbered bucket by bucket:
    ``buckets`` holds (lanes g, first slot, segment ids) per lane count,
    so a bucket is one (n, g) block of the table. The kernel's work list:
    ``order`` (int32) the segments by (lanes, length), longest first, and
    ``ctas`` (int32, (n_cta, 3)) per CTA its first index into ``order``,
    its number of segments and log2 of their lanes (the same for the
    float32 and the float64 instance)."""

    segments: SegmentPlan
    lanes: torch.Tensor
    first_lane: torch.Tensor
    total_lanes: int
    buckets: Tuple[Tuple[int, int, torch.Tensor], ...]
    order: torch.Tensor
    ctas: torch.Tensor

    @property
    def rows(self) -> int:
        return self.segments.rows

    @property
    def num_segments(self) -> int:
        return self.segments.num_segments


def product_ctas(lanes: np.ndarray, order: np.ndarray) -> np.ndarray:
    """K3's CTAs over ``order`` (segments sorted by lanes, descending): a
    CTA takes ``PRODUCT_SLOTS`` slots of one lane count g, Q = g / L
    slots a segment (L = min(g, PRODUCT_REGISTER_LANES) lanes a thread),
    so 64 segments of up to 4 lanes, 32 of 8, ..., 1 of 256. Rows (first
    index into ``order``, segments, log2 g)."""
    ctas = []
    g_sorted = lanes[order]
    start = 0
    while start < order.size:
        g = int(g_sorted[start])
        end = start + int(np.count_nonzero(g_sorted[start:] == g))
        per_cta = PRODUCT_SLOTS * min(g, PRODUCT_REGISTER_LANES) // g
        for c0 in range(start, end, per_cta):
            ctas.append((c0, min(per_cta, end - c0), g.bit_length() - 1))
        start = end
    return np.asarray(ctas, dtype=np.int32).reshape(-1, 3)


def plan_products(dst: np.ndarray, num_segments: int,
                  device) -> ProductPlan:
    """Plan the K3 site of rows with sorted destinations ``dst``."""
    seg_sorted, perm, offsets = segsum.host_plan(dst, num_segments)
    if perm is not None:
        raise ValueError("the triple product needs destination-sorted rows")
    lengths = np.diff(offsets)
    lanes = product_lanes(lengths)
    first_lane = np.zeros(num_segments, dtype=np.int64)
    buckets, lane0 = [], 0
    for g in np.unique(lanes)[::-1]:
        segs = np.nonzero(lanes == g)[0]
        first_lane[segs] = lane0 + np.arange(segs.size) * g
        buckets.append((int(g), lane0, torch.as_tensor(segs, device=device)))
        lane0 += int(segs.size * g)
    order = np.lexsort((np.arange(num_segments), -lengths, -lanes))

    def dev(a, dtype):
        return torch.as_tensor(a.astype(dtype), device=device)

    return ProductPlan(
        segments=segsum.device_plan(seg_sorted, None, offsets, device,
                                    group=1),
        lanes=dev(lanes, np.int64), first_lane=dev(first_lane, np.int64),
        total_lanes=lane0, buckets=tuple(buckets),
        order=dev(order, np.int32),
        ctas=dev(product_ctas(lanes, order), np.int32))


def segment_product_sum_plain(left: torch.Tensor, right: torch.Tensor,
                              plan: ProductPlan, m: int, k: int, n: int,
                              left_idx: Optional[torch.Tensor] = None,
                              right_idx: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K3 (the CPU path and the kernel's oracle):
    out[s] = sum of L_r R_r^T over the rows r of segment s, with L_r =
    left[left_idx[r]] (left[r] when ``left_idx`` is None) and R_r likewise.

    Added in the kernel's order: per-row products (``flat_block_mm_nt``)
    go to their lanes (``index_add_``, which adds rows in order on the
    CPU), row r of segment s to lane (r - offsets[s]) mod lanes[s]; the
    rows are taken in chunks of ``PLAIN_CHUNK_ROWS`` into one lane table,
    so the chunks do not change the order. Then each bucket of g-lane
    segments is halved (``segsum.halve_lanes``). A one-lane segment is its
    rows in order."""
    sp = plan.segments
    slots = (plan.first_lane.index_select(0, sp.seg)
             + segsum.positions_in_segments(sp)
             % plan.lanes.index_select(0, sp.seg))
    lanes = left.new_zeros((plan.total_lanes, m * n))
    for c0 in range(0, sp.rows, PLAIN_CHUNK_ROWS):
        c1 = min(c0 + PLAIN_CHUNK_ROWS, sp.rows)
        lrows = (left[c0:c1] if left_idx is None
                 else left.index_select(0, left_idx[c0:c1]))
        rrows = (right[c0:c1] if right_idx is None
                 else right.index_select(0, right_idx[c0:c1]))
        prod = flat_block_mm_nt(lrows, rrows, m, k, n, acc_dtype=lanes.dtype)
        lanes.index_add_(0, slots[c0:c1], prod)
    del slots
    out = left.new_zeros((sp.num_segments, m * n))
    for g, lane0, segs in plan.buckets:
        block = lanes[lane0:lane0 + segs.shape[0] * g]
        out.index_copy_(0, segs, segsum.halve_lanes(
            block.view(segs.shape[0], g, m * n)))
    return out


def product_store_plain(sums: torch.Tensor, base: Optional[torch.Tensor],
                        base_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of K3's base store, ``base_row(s) - sums[s]``,
    with ``schur_values``' own ops before the store moved into K3. With
    ``base_idx``: a zero S, the base rows copied in (``index_copy_``: row
    ``base_idx[s]`` of ``base`` to row s, none where it is -1 or ``base``
    is None), minus the sums, into a new array. Without: ``base`` is the
    (num_segments, D) S itself (a later product group into the same S
    group), and the sums are subtracted from it in place."""
    if base_idx is None:
        return base.sub_(sums)
    s = sums.new_zeros(sums.shape)
    if base is not None:
        rows = torch.nonzero(base_idx >= 0).reshape(-1)
        s.index_copy_(0, rows, base.index_select(
            0, base_idx.index_select(0, rows).long()))
    return s - sums


def _check_base(name, base, base_idx, num_segments, width, dtype, device):
    """Raise unless the base store's tensors are what K3 takes (a base in
    the values' ``dtype``)."""
    if base is not None and (
            base.dtype != dtype or base.device != device
            or base.dim() != 2 or base.shape[1] != width
            or not base.is_contiguous()
            or (base_idx is None and base.shape[0] != num_segments)):
        rows = "n" if base_idx is not None else num_segments
        raise ValueError(
            f"{name}: base must be a contiguous {dtype} ({rows}, {width}) "
            f"tensor on {device}, got {base.dtype} {tuple(base.shape)} on "
            f"{base.device}")
    if base_idx is not None and (base_idx.dtype != torch.int32
                                 or base_idx.shape != (num_segments,)
                                 or base_idx.device != device):
        raise ValueError(f"{name}: base index must be ({num_segments},) "
                         f"int32 on {device}")


def _product_sum(left, right, plan: ProductPlan, m, k, n, left_idx,
                 right_idx, stats: LaunchStats, stats_f64: LaunchStats,
                 base=None, base_idx=None) -> torch.Tensor:
    if left.device.type == "cpu":
        sums = segment_product_sum_plain(left, right, plan, m, k, n,
                                         left_idx, right_idx)
        if base is None and base_idx is None:
            return sums
        return product_store_plain(sums, base, base_idx)
    if left.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {left.device}")
    stats = stats_for(left, stats, stats_f64)
    name = stats.name
    entry = _PRODUCT_ENTRY.get(left.dtype)
    for what, t, width, idx in (("left", left, m * k, left_idx),
                                ("right", right, n * k, right_idx)):
        if entry is None or t.dtype != left.dtype:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes float32 or float64 (one "
                f"dtype), {what} is {t.dtype}")
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
    if plan.ctas.device != left.device:
        raise ValueError(f"{name}: plan and values on different devices")
    _check_base(name, base, base_idx, plan.num_segments, m * n, left.dtype,
                left.device)
    left, right = left.contiguous(), right.contiguous()
    if base is not None and base_idx is None:
        out = base
    else:
        out = torch.empty((plan.num_segments, m * n), dtype=left.dtype,
                          device=left.device)
    # an empty base group is no base: every row +0.0 (the kernel's null base)
    base_ptr = (None if base is None or base.numel() == 0
                else base.data_ptr())
    lib = load_product_kernel()
    with on_device(left.device):
        stream = stream_ptr(left.device)
        ev = stats.start()
        err = getattr(lib.lib, entry)(
            left.data_ptr(),
            None if left_idx is None else left_idx.data_ptr(),
            right.data_ptr(),
            None if right_idx is None else right_idx.data_ptr(),
            plan.segments.offsets_i32.data_ptr(), plan.order.data_ptr(),
            plan.ctas.data_ptr(), plan.ctas.shape[0], out.data_ptr(),
            base_ptr, None if base_idx is None else base_idx.data_ptr(),
            m, k, n, stream)
        lib.check(err, name)
        stats.done(ev)
    return out


def streaming_segment_product_sum(left: torch.Tensor, right: torch.Tensor,
                                  plan: ProductPlan, m: int, k: int,
                                  n: int) -> torch.Tensor:
    """Fused per-row A B^T + sorted segment sum over gathered streams:
    ``left`` (K, m*k) and ``right`` (K, n*k) hold one row per pair, in
    destination order. Returns (num_segments, m*n)."""
    return _product_sum(left, right, plan, m, k, n, None, None,
                        PRODUCT_STATS, PRODUCT_STATS_F64)


def streaming_segment_product_sum_rtbl(
        left: torch.Tensor, right: torch.Tensor, plan: ProductPlan, m: int,
        k: int, n: int, left_idx: Optional[torch.Tensor],
        right_idx: torch.Tensor, base: Optional[torch.Tensor] = None,
        base_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same sum with the right operand read from its table by
    ``right_idx`` (int32, one per pair), and the left one too when
    ``left_idx`` is given (the Schur triple products read W and Hpl this
    way, so no gathered stream is ever written).

    With ``base_idx`` (int32, one per segment) the store writes
    ``base_row(s) - sum`` into a new array instead: row ``base_idx[s]`` of
    ``base``, or +0.0 where it is -1 or ``base`` is None or empty (stored
    as ``0.0 - sum``). With ``base`` alone, a (num_segments, m*n) array,
    it writes ``base[s] - sum`` into ``base`` itself (in place) and
    returns it. Its plain version is ``segment_product_sum_plain`` then
    ``product_store_plain``.
    """
    return _product_sum(left, right, plan, m, k, n, left_idx, right_idx,
                        PRODUCT_RTBL_STATS, PRODUCT_RTBL_STATS_F64, base,
                        base_idx)


def streaming_matvec_tbl(left: torch.Tensor, x: torch.Tensor,
                         idx: torch.Tensor, plan: SegmentPlan, m: int,
                         k: int, transpose: bool = False) -> torch.Tensor:
    """y[seg_i] += A_i x[idx_i] (or A_i^T x[idx_i] with ``transpose``):
    ``left`` (K, m*k) blocks, ``x`` the row table, ``idx`` int32 (an index
    outside the table reads a zero row). K4 with its own launch counts."""
    return segmv.block_matvec(left, x, idx, plan, m, k, transpose,
                              MATVEC_TBL_STATS, MATVEC_TBL_STATS_F64)
