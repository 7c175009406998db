"""Gathered triple product reduced over sorted segments (kernel K3) of
the PyTorch port.

- The plain version vs the JAX package's Pallas kernel
  ``segsum_stream.streaming_segment_product_sum`` in interpret mode,
  float32, to 1e-5 relative to the largest output (the TPU kernel sums in
  another order, through bf16x3 splits of the operands).
- Both entry points on the CPU: the table form (rows read by index) equals
  the gathered-stream form bitwise, equals a float64 ``np.add.at``
  reference, and launches nothing.

The kernel itself is tested on the card by ``test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu.ops.pallas.segsum_stream as jax_segsum_stream
from graphite_tpu_torch.ops.cuda import segsum_stream
from graphite_tpu_torch.ops.cuda.segsum import plan_segments

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jax_segsum_stream.pl, "pallas_call",
                        functools.partial(jax.experimental.pallas.pallas_call,
                                          interpret=True))
    jax_segsum_stream._run_prod.clear_cache()
    yield
    jax_segsum_stream._run_prod.clear_cache()


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("m,k,n", [(9, 3, 9), (6, 3, 6), (9, 9, 9)])
def test_plain_matches_pallas_product_sum(interpret_mode, m, k, n):
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    rows, ns, chunk = 3_000, 280, 512
    seg = np.sort(rng.integers(0, ns, rows)).astype(np.int32)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    right = rng.standard_normal((rows, n * k)).astype(np.float32)
    plan_j = jax_segsum_stream.plan_streaming_segsum(seg, ns, chunk=chunk)
    assert plan_j["feasible"]
    pad = plan_j["k_pad"] - rows
    ref = np.asarray(jax_segsum_stream.streaming_segment_product_sum(
        jnp.asarray(np.concatenate([left, np.zeros((pad, m * k),
                                                   np.float32)])),
        jnp.asarray(np.concatenate([right, np.zeros((pad, n * k),
                                                    np.float32)])),
        plan_j, m, k, n))
    out = segsum_stream.segment_product_sum_plain(
        torch.as_tensor(left), torch.as_tensor(right),
        plan_segments(seg, ns, "cpu"), m, k, n).numpy()
    assert out.shape == ref.shape == (ns, m * n)
    assert _rel_err(out, ref) <= REL


@pytest.mark.parametrize("m,k,n,chunk_rows", [(9, 3, 9, 1 << 20),
                                              (3, 2, 4, 97)])
def test_entry_points_on_cpu(monkeypatch, m, k, n, chunk_rows):
    """Table form == stream form (bitwise, also across plain-version
    chunks) == float64 reference; CPU tensors launch no kernel."""
    monkeypatch.setattr(segsum_stream, "PLAIN_CHUNK_ROWS", chunk_rows)
    rng = np.random.default_rng(m + k + n)
    rows, ns, n_l, n_r = 2_000, 150, 300, 260
    seg = np.sort(rng.integers(0, ns, rows))
    ltab = rng.standard_normal((n_l, m * k)).astype(np.float32)
    rtab = rng.standard_normal((n_r, n * k)).astype(np.float32)
    li = rng.integers(0, n_l, rows)
    ri = rng.integers(0, n_r, rows)
    plan = plan_segments(seg, ns, "cpu")
    before = (segsum_stream.PRODUCT_STATS.launches,
              segsum_stream.PRODUCT_RTBL_STATS.launches)
    tbl = segsum_stream.streaming_segment_product_sum_rtbl(
        torch.as_tensor(ltab), torch.as_tensor(rtab), plan, m, k, n,
        torch.as_tensor(li, dtype=torch.int32),
        torch.as_tensor(ri, dtype=torch.int32))
    stream = segsum_stream.streaming_segment_product_sum(
        torch.as_tensor(ltab[li]), torch.as_tensor(rtab[ri]), plan, m, k, n)
    assert torch.equal(tbl, stream)
    assert (segsum_stream.PRODUCT_STATS.launches,
            segsum_stream.PRODUCT_RTBL_STATS.launches) == before
    prod = np.einsum("rak,rbk->rab",
                     ltab[li].astype(np.float64).reshape(rows, m, k),
                     rtab[ri].astype(np.float64).reshape(rows, n, k))
    ref = np.zeros((ns, m * n))
    np.add.at(ref, seg, prod.reshape(rows, m * n))
    assert _rel_err(tbl.numpy(), ref) <= REL


def test_product_rejects_unsorted_destinations():
    plan = plan_segments(np.array([1, 0, 1]), 2, "cpu")
    with pytest.raises(ValueError):
        segsum_stream.segment_product_sum_plain(
            torch.zeros(3, 4), torch.zeros(3, 4), plan, 2, 2, 2)
