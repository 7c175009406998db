"""The one reduction primitive of the hot stages (counterpart of
``graphite_tpu/ops/streamreduce.py``).

``reduce_rows(values, plan)`` sums ``(K, D)`` contribution rows into
``(num_segments, D)`` destination rows. The plan is built once per site on
the host (``segment_plan``: the sort permutation, when the destinations
are not already sorted, and the CSR segment offsets) and cached on the
problem. Every site, sorted or not, goes through the sorted-segment-sum
kernel on CUDA: no float atomics, and results are the same from run to
run. ``matvec_plan`` is the cached plan of a block-matvec site (K4,
``ops/cuda/segmv``), built the same way, and ``product_plan`` that of a
triple-product site (K3, ``ops/cuda/segsum_stream``).

``MAP_BYTES`` / ``map_chunk_rows`` are the JAX package's row budget. There
it bounds scan chunks; here it only gates the block-matvec sites
(``schur._smv_chunk_rows``), so the port takes the JAX package's branch at
every size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda import segsum_stream
from .cuda.segsum import SegmentPlan, plan_segments

MAP_BYTES = 64 << 20


def map_chunk_rows(row_bytes: int, align: int = 2048) -> int:
    rows = max(MAP_BYTES // max(row_bytes, 1), align)
    return (rows // align) * align


def segment_plan(problem, tag, seg: np.ndarray, num_segments: int,
                 width: int, group=None) -> SegmentPlan:
    """Cached plan of the reduction site ``tag``: rows of ``width``
    columns into destinations ``seg`` (``group`` forces the lanes per
    segment)."""
    plans = problem._cache.setdefault("segment_plans", {})
    if tag not in plans:
        plans[tag] = plan_segments(seg, num_segments, problem.device, group,
                                   width)
    return plans[tag]


def matvec_plan(problem, tag, seg: np.ndarray,
                num_segments: int) -> SegmentPlan:
    """Cached plan of the block-matvec site ``tag`` (destinations
    ``seg``)."""
    plans = problem._cache.setdefault("matvec_plans", {})
    if tag not in plans:
        plans[tag] = plan_segments(seg, num_segments, problem.device)
    return plans[tag]


def product_plan(problem, tag, dst: np.ndarray,
                 num_segments: int) -> segsum_stream.ProductPlan:
    """Cached plan of the triple-product site ``tag`` (sorted
    destinations ``dst``)."""
    plans = problem._cache.setdefault("product_plans", {})
    if tag not in plans:
        plans[tag] = segsum_stream.plan_products(dst, num_segments,
                                                 problem.device)
    return plans[tag]


def reduce_rows(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows -> (num_segments, D) sums in ``values.dtype``."""
    return segsum_stream.streaming_segment_sum(values, plan)


def gather_index(problem, tag, arr: torch.Tensor,
                 idx: np.ndarray) -> Optional[torch.Tensor]:
    """The device index of ``arr[idx]``, or None where the gather is the
    identity (or a prefix of it): Hessian value groups carry one trailing
    trash row, so ``arange(n)`` into an (n+1)-row group is a slice."""
    idx = np.asarray(idx)
    ident = problem._cache.setdefault("identity_idx", {})
    if tag not in ident:
        ident[tag] = bool(arr.shape[0] >= idx.shape[0] and np.array_equal(
            idx, np.arange(idx.size, dtype=idx.dtype)))
    return None if ident[tag] else problem.index(tag, idx)


def take_rows(problem, tag, arr: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``arr[idx]`` with identity (or prefix-identity) gathers elided
    (``gather_index``): a slice, not a gather."""
    index = gather_index(problem, tag, arr, idx)
    if index is None:
        return arr[:np.asarray(idx).shape[0]]
    return arr.index_select(0, index)
