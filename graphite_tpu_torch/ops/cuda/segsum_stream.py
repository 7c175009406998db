"""Sorted segmented row sum for the row-reduction sites: kernel K1.

Counterpart of ``graphite_tpu/ops/pallas/segsum_stream.py``
(``streaming_segment_sum``), whose TPU kernel streams an output too large
for VMEM through a rolling window. On the GPU both Pallas modules compute
the same function with the same kernel (``csrc/segsum.cu``); this entry
point keeps its own launch count so a run shows which sites it served:
every ``ops.streamreduce.reduce_rows`` call (factor-row reductions in
``linearize``, Hessian value groups, the pose rows of ``b_schur`` and the
landmark back-substitution).
"""

from __future__ import annotations

import torch

from .launches import LaunchStats
from .segsum import SegmentPlan, launch_segsum
from .segsum import segment_sum_plain as streaming_segment_sum_plain

__all__ = ["STATS", "streaming_segment_sum", "streaming_segment_sum_plain"]

STATS = LaunchStats("segsum_stream.streaming_segment_sum")


def streaming_segment_sum(values: torch.Tensor,
                          plan: SegmentPlan) -> torch.Tensor:
    """(K, D) rows -> (num_segments, D) sums; CPU tensors take the plain
    version, CUDA tensors launch K1."""
    if values.device.type == "cpu":
        return streaming_segment_sum_plain(values, plan)
    if values.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {values.device}")
    return launch_segsum(values, plan, STATS)
