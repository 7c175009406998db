"""Sorted segmented row sum (kernel K1) of the PyTorch port.

- CPU: the port's plain version vs the JAX package's Pallas kernels
  ``segsum.sorted_segment_sum`` and ``segsum_stream.streaming_segment_sum``
  run in interpret mode, float32, to 1e-5 relative to the largest output
  (the TPU kernels sum in another order, through bf16x3 splits of the
  values); the plan for unsorted destinations vs ``np.add.at``; the
  wrappers take the plain version for CPU tensors.
- The plain version's summation order is the kernel's at every group
  size: lane l of G sums a segment's sorted rows l, l+G, ... in order,
  then a halving tree (float32, checked bitwise against a loop written
  out; float64 equal to ``np.add.at`` to 1e-12); the plan's group rule.

The kernel itself is tested on the card by ``test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu.ops.pallas.segsum as jax_segsum
import graphite_tpu.ops.pallas.segsum_stream as jax_segsum_stream
from graphite_tpu_torch.ops.cuda import segsum, segsum_stream
from graphite_tpu_torch.ops.cuda.segsum import (
    group_size,
    lane_cap,
    plan_segments,
    segment_sum_plain,
)

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    interp = functools.partial(jax.experimental.pallas.pallas_call,
                               interpret=True)
    monkeypatch.setattr(jax_segsum.pl, "pallas_call", interp)
    monkeypatch.setattr(jax_segsum_stream.pl, "pallas_call", interp)
    jax_segsum._run.clear_cache()
    jax_segsum_stream._run.clear_cache()
    yield
    jax_segsum._run.clear_cache()
    jax_segsum_stream._run.clear_cache()


def _case(k, ns, d, seed):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, ns, k)).astype(np.int32)
    vals = rng.standard_normal((k, d)).astype(np.float32)
    return seg, vals


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("k,ns,d,chunk", [
    (4096, 100, 81, 512),   # Schur product scatter shape, scaled down
    (1000, 37, 16, 128),
    (130, 5, 8, 256),
])
def test_plain_matches_pallas_sorted_segment_sum(interpret_mode, k, ns, d,
                                                 chunk):
    seg, vals = _case(k, ns, d, 1)
    plan = jax_segsum.plan_sorted_segsum(seg, ns, chunk=chunk)
    ref = np.asarray(jax_segsum.sorted_segment_sum(jnp.asarray(vals), plan))
    out = segment_sum_plain(torch.as_tensor(vals),
                            plan_segments(seg, ns, "cpu")).numpy()
    assert _rel_err(out, ref) <= REL


@pytest.mark.parametrize("k,ns,d,chunk", [
    (5_000, 500, 81, 512),   # multi-flush
    (3_000, 2_900, 3, 256),  # near-unique segments, landmark width
    (4_096, 40, 27, 512),    # Hpl width
    (2_000, 700, 9, 256),    # Hll width
])
def test_plain_matches_pallas_streaming_segment_sum(interpret_mode, k, ns,
                                                    d, chunk):
    seg, vals = _case(k, ns, d, k)
    plan = jax_segsum_stream.plan_streaming_segsum(seg, ns, chunk=chunk)
    assert plan["feasible"]
    ref = np.asarray(jax_segsum_stream.streaming_segment_sum(
        jnp.asarray(vals), plan))
    out = segment_sum_plain(torch.as_tensor(vals),
                            plan_segments(seg, ns, "cpu")).numpy()
    assert _rel_err(out, ref) <= REL


@pytest.mark.parametrize("sorted_dst", [True, False])
def test_plan_and_wrappers_on_cpu(sorted_dst):
    rng = np.random.default_rng(3)
    k, ns, d = 3000, 50, 9
    seg = rng.integers(0, ns, k)
    if sorted_dst:
        seg = np.sort(seg)
    vals = rng.standard_normal((k, d))
    ref = np.zeros((ns, d))
    np.add.at(ref, seg, vals)
    plan = plan_segments(seg, ns, "cpu")
    assert (plan.perm is None) == sorted_dst
    assert plan.offsets[-1].item() == k
    assert torch.all(plan.seg[1:] >= plan.seg[:-1])
    v = torch.as_tensor(vals)
    for fn in (segment_sum_plain, segsum.sorted_segment_sum,
               segsum_stream.streaming_segment_sum):
        np.testing.assert_allclose(fn(v, plan).numpy(), ref, rtol=1e-12,
                                   atol=1e-12)
    before = (segsum.STATS.launches, segsum_stream.STATS.launches)
    segsum.sorted_segment_sum(v, plan)
    assert (segsum.STATS.launches, segsum_stream.STATS.launches) == before


def test_plan_rejects_out_of_range():
    with pytest.raises(ValueError):
        plan_segments(np.array([0, 3]), 3, "cpu")


def _lane_order(vals, seg, ns, group):
    """K1's float32 order, written out: per segment, lane l sums the rows
    l, l+G, ... of the stable destination order, then the halving tree
    lane l += lane l+h."""
    order = np.argsort(seg, kind="stable")
    out = np.zeros((ns, vals.shape[1]), np.float32)
    for s in range(ns):
        lanes = np.zeros((group, vals.shape[1]), np.float32)
        for q, r in enumerate(order[seg[order] == s]):
            lanes[q % group] = lanes[q % group] + vals[r]
        h = group // 2
        while h >= 1:
            lanes[:h] = lanes[:h] + lanes[h:2 * h]
            h //= 2
        out[s] = lanes[0]
    return out


@pytest.mark.parametrize("d", [9, 81])
@pytest.mark.parametrize("sorted_dst", [True, False])
@pytest.mark.parametrize("group", [1, 2, 8, 64, 256])
def test_plain_sums_in_lane_order(group, sorted_dst, d):
    rng = np.random.default_rng(group + 3 * sorted_dst + d)
    k, ns = 1_200, 6
    seg = rng.integers(0, ns, k)
    seg[seg == 2] = 5  # an empty segment
    if sorted_dst:
        seg = np.sort(seg)
    vals = rng.standard_normal((k, d)).astype(np.float32)
    plan = plan_segments(seg, ns, "cpu", group=group)
    assert plan.group == group and (plan.perm is None) == sorted_dst
    out = segment_sum_plain(torch.as_tensor(vals), plan).numpy()
    assert np.array_equal(out, _lane_order(vals, seg, ns, group))
    assert not out[2].any()

    # float64: the same sums as np.add.at
    ref = np.zeros((ns, d))
    np.add.at(ref, seg, vals.astype(np.float64))
    out64 = segsum.sorted_segment_sum(torch.as_tensor(vals, dtype=torch.float64),
                                      plan).numpy()
    np.testing.assert_allclose(out64, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rows_per_segment,width,group", [
    (1.1, 6, 1),       # sphere2500's factor rows
    (4.0, 9, 1),       # a landmark's observations
    (70.0, 81, 16),    # Ladybug's Schur product scatter
    (637.0, 9, 64),    # a Ladybug camera's observations, capped at 9 wide
    (637.0, 81, 32),   # ... and at 81 wide
    (2_812.0, 9, 64),  # a Venice camera's observations
    (2_812.0, 81, 32),
    (637.0, None, 128),  # K4's rule: a thread per lane, no cap
    (2_812.0, None, 256),
])
def test_plan_picks_group(rows_per_segment, width, group):
    ns = 40
    k = int(rows_per_segment * ns)
    seg = np.random.default_rng(k).permutation(np.arange(k) % ns)
    assert group_size(k, ns, width) == group
    assert plan_segments(seg, ns, "cpu", width=width).group == group
    # an empty segment does not count towards the mean
    assert plan_segments(seg, ns + 3, "cpu", width=width).group == group


def test_lane_cap():
    # two lanes per thread of a 512-thread CTA, a thread per column (up to
    # 32 columns at a time)
    assert [lane_cap(w) for w in (1, 3, 6, 9, 16, 17, 27, 36, 81)] == [
        1024, 256, 128, 64, 64, 32, 32, 32, 32]


def test_plan_keeps_forced_group():
    seg = np.arange(3_000) % 7
    assert plan_segments(seg, 7, "cpu").group == 64
    for g in (1, 4, 256):
        assert plan_segments(seg, 7, "cpu", group=g).group == g
    for bad in (0, 3, 512):
        with pytest.raises(ValueError):
            plan_segments(seg, 7, "cpu", group=bad)
