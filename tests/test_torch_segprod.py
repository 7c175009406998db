"""Gathered triple product reduced over sorted segments (kernel K3) of
the PyTorch port.

- The plain version vs the JAX package's Pallas kernel
  ``segsum_stream.streaming_segment_product_sum`` in interpret mode,
  float32, to 1e-5 relative to the largest output (the TPU kernel sums in
  another order, through bf16x3 splits of the operands).
- Both entry points on the CPU: the table form (rows read by index) equals
  the gathered-stream form bitwise, equals a float64 ``np.add.at``
  reference, and launches nothing.
- The kernel's order on a site that mixes a few segments of ~2,000 rows
  with many of 1-20 (the Venice-1778 site in small), with plain-version
  chunks that cut segments: in float32 the plain version equals, bitwise,
  a NumPy loop written in the kernel's order (lanes per segment by K1's
  rule, then the halving tree); in float64 it is within 1e-12 of
  ``np.add.at``; its one-lane segments equal a row-order ``index_add_``
  bitwise. The lane rule and the kernel's CTA work list.

The kernel itself is tested on the card by ``test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu.ops.pallas.segsum_stream as jax_segsum_stream
from graphite_tpu_torch.ops.blockfmt import flat_block_mm_nt
from graphite_tpu_torch.ops.cuda import segsum, segsum_stream
from graphite_tpu_torch.ops.cuda.segsum_stream import plan_products

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
        plan_products(seg, ns, "cpu"), m, k, n).numpy()
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
    plan = plan_products(seg, ns, "cpu")
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
    with pytest.raises(ValueError):
        plan_products(np.array([1, 0, 1]), 2, "cpu")


def _mixed_site(rng, long_rows=(2_000, 2_100, 1_950), short=300):
    """Sorted destinations: a few long segments among many of 1-20 rows,
    and an empty one."""
    lengths = np.concatenate([rng.integers(1, 21, short), long_rows, [0]])
    lengths = lengths[rng.permutation(lengths.size)]
    dst = np.repeat(np.arange(lengths.size), lengths)
    return dst, lengths.size


def _kernel_order(ltab, rtab, li, ri, dst, ns, m, k, n):
    """K3's float32 order, written out: row r of segment s goes to lane
    (r - start) mod g_s (g_s by K1's rule on the segment's length), each
    product p_ab = L[a, 0] R[b, 0] + L[a, 1] R[b, 1] + ... in order, each
    lane in row order, then the halving tree."""
    out = np.zeros((ns, m * n), np.float32)
    starts = np.searchsorted(dst, np.arange(ns + 1))
    for s in range(ns):
        r0, r1 = starts[s], starts[s + 1]
        g = segsum.group_size(r1 - r0, 1)
        lanes = np.zeros((g, m, n), np.float32)
        for r in range(r0, r1):
            L = ltab[li[r]].reshape(m, k)
            R = rtab[ri[r]].reshape(n, k)
            p = L[:, None, 0] * R[None, :, 0]
            for j in range(1, k):
                p = p + L[:, None, j] * R[None, :, j]
            lanes[(r - r0) % g] = lanes[(r - r0) % g] + p
        while g > 1:
            g //= 2
            lanes = lanes[:g] + lanes[g:2 * g]
        out[s] = lanes[0].reshape(-1)
    return out


@pytest.mark.parametrize("m,k,n", [(9, 3, 9), (6, 3, 6)])
def test_plain_sums_in_kernel_order(monkeypatch, m, k, n):
    monkeypatch.setattr(segsum_stream, "PLAIN_CHUNK_ROWS", 777)
    rng = np.random.default_rng(m + 10 * n)
    dst, ns = _mixed_site(rng)
    rows, n_l, n_r = dst.size, 900, 800
    ltab = rng.standard_normal((n_l, m * k)).astype(np.float32)
    rtab = rng.standard_normal((n_r, n * k)).astype(np.float32)
    li = rng.integers(0, n_l, rows)
    ri = rng.integers(0, n_r, rows)
    plan = plan_products(dst, ns, "cpu")
    lanes = plan.lanes.numpy()
    assert lanes.max() == 256 and lanes.min() == 1 and 2 in lanes

    def run(dtype):
        return segsum_stream.segment_product_sum_plain(
            torch.as_tensor(ltab, dtype=dtype),
            torch.as_tensor(rtab, dtype=dtype), plan, m, k, n,
            torch.as_tensor(li), torch.as_tensor(ri)).numpy()

    out = run(torch.float32)
    assert np.array_equal(
        out, _kernel_order(ltab, rtab, li, ri, dst, ns, m, k, n))

    # float64: the same sums as np.add.at
    prod = np.einsum("rak,rbk->rab",
                     ltab[li].astype(np.float64).reshape(rows, m, k),
                     rtab[ri].astype(np.float64).reshape(rows, n, k))
    ref = np.zeros((ns, m * n))
    np.add.at(ref, dst, prod.reshape(rows, m * n))
    np.testing.assert_allclose(run(torch.float64), ref, rtol=1e-12,
                               atol=1e-12)

    # one-lane segments: the row-order index_add_ of every segment
    prev = torch.zeros((ns, m * n))
    for c0 in range(0, rows, 777):
        sl = slice(c0, min(c0 + 777, rows))
        prev.index_add_(0, torch.as_tensor(dst[sl]), flat_block_mm_nt(
            torch.as_tensor(ltab[li[sl]]), torch.as_tensor(rtab[ri[sl]]),
            m, k, n))
    one = lanes == 1
    assert one.sum() > 100
    assert np.array_equal(out[one], prev.numpy()[one])


def test_product_lanes_rule():
    lengths = [0, 1, 8, 9, 16, 17, 64, 65, 2_048, 2_049, 100_000]
    assert segsum_stream.product_lanes(lengths).tolist() == [
        1, 1, 1, 2, 2, 4, 8, 16, 256, 256, 256]
    assert segsum_stream.product_lanes(lengths).tolist() == [
        segsum.group_size(n, 1) for n in lengths]


def test_product_plan_work_list():
    """Every segment is in one CTA; a CTA's segments share their lane
    count and fill at most its slots; the longest come first."""
    rng = np.random.default_rng(4)
    dst, ns = _mixed_site(rng, long_rows=(300, 2_000, 40, 70), short=500)
    plan = plan_products(dst, ns, "cpu")
    lanes = plan.lanes.numpy()
    lengths = np.diff(plan.segments.offsets.numpy())
    order = plan.order.numpy()
    assert sorted(order.tolist()) == list(range(ns))
    assert np.all(np.diff(lanes[order]) <= 0)
    seen = []
    for first, count, g_log2 in plan.ctas.numpy().tolist():
        segs = order[first:first + count]
        g = 1 << g_log2
        assert np.all(lanes[segs] == g)
        slots_each = g // min(g, segsum_stream.PRODUCT_REGISTER_LANES)
        assert 1 <= count * slots_each <= segsum_stream.PRODUCT_SLOTS
        assert np.all(np.diff(lengths[segs]) <= 0)
        seen.extend(segs.tolist())
    assert seen == order.tolist()
    assert [g for g, _, _ in plan.buckets] == sorted(set(lanes.tolist()),
                                                    reverse=True)
    assert plan.total_lanes == int(lanes.sum())
