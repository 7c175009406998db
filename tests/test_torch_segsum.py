"""Sorted segmented row sum (kernel K1) of the PyTorch port.

- CPU: the port's plain version vs the JAX package's Pallas kernels
  ``segsum.sorted_segment_sum`` and ``segsum_stream.streaming_segment_sum``
  run in interpret mode, float32, to 1e-5 relative to the largest output
  (the TPU kernels sum in another order, through bf16x3 splits of the
  values); the plan for unsorted destinations vs ``np.add.at``; the
  wrappers take the plain version for CPU tensors.

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
from graphite_tpu_torch.ops.cuda.segsum import plan_segments, segment_sum_plain

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
