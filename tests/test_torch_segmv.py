"""Gathered block matvecs reduced over segments (kernels K4 and K5) of the
PyTorch port.

- The plain versions vs the JAX package's Pallas kernels in interpret
  mode, float32, to 1e-5 relative to the largest output (the TPU kernels
  sum in another order, through bf16x3 splits): K4 against
  ``segsum_stream.streaming_matvec_tbl`` (both directions),
  ``segmv.block_matvec_stream`` and ``segmv.block_matvec_wtbl``; K5
  against ``segmv.matvec_sym_stream``. Masked rows (x index at the fill
  row) and diagonal blocks are included.
- The plain version's summation order is the kernel's: lane l of a
  segment's group sums rows l, l+G, ... in order, then a halving tree
  (checked bitwise against a loop written out); float64 results equal
  ``np.add.at`` for every group size.
- K4's walk (the ranges its CTAs own, tile by tile, as ``csrc/segmv.cu``
  takes them) covers every sorted position exactly once, with and
  without a permutation, and its tiles start on a 4-block grid.
- K5's two passes on the CUDA card, composed on the CPU: the row products
  P_b = S_b x_c[cid_b] of every stored block, then K1's plain version over
  the row plan, equal ``matvec_sym_plain`` bitwise, and both halves equal
  the kernel order written out.

The kernels themselves are tested on the card by ``test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu.ops.pallas.segmv as jax_segmv
import graphite_tpu.ops.pallas.segsum_stream as jax_segsum_stream
from graphite_tpu_torch.ops.cuda import segmv, segsum, segsum_stream
from graphite_tpu_torch.ops.cuda.segsum import plan_segments

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    interp = functools.partial(jax.experimental.pallas.pallas_call,
                               interpret=True)
    monkeypatch.setattr(jax_segsum_stream.pl, "pallas_call", interp)
    monkeypatch.setattr(jax_segmv.pl, "pallas_call", interp)
    runs = (jax_segsum_stream._run_mv_tbl, jax_segmv._run_stream,
            jax_segmv._run_wtbl, jax_segmv._run_sym)
    for run in runs:
        run.clear_cache()
    yield
    for run in runs:
        run.clear_cache()


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _xtab(x_rows, width):
    out = np.zeros((jax_segmv.tpad(x_rows.shape[0] + 1), width), np.float32)
    out[:x_rows.shape[0], :x_rows.shape[1]] = x_rows
    return jnp.asarray(out)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _i32(a):
    return _t(a, torch.int32)


@pytest.mark.parametrize("m,k,transpose", [
    (9, 9, False),  # S matvec forward
    (9, 9, True),   # S matvec transposed
    (9, 3, True),   # back-substitution: Hpl^T dx_p
    (6, 2, False),  # rectangular
])
def test_plain_matches_pallas_matvec_tbl(interpret_mode, m, k, transpose):
    rng = np.random.default_rng(m * 10 + k + transpose)
    rows, ns, n_x, chunk = 3_000, 250, 137, 512
    seg = np.sort(rng.integers(0, ns, rows))
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xd = m if transpose else k
    x_rows = rng.standard_normal((n_x, xd)).astype(np.float32)
    idx = rng.integers(0, n_x, rows)
    idx[rng.random(rows) < 0.1] = n_x  # masked rows: the fill row

    plan_j = jax_segsum_stream.plan_streaming_segsum(
        seg.astype(np.int32), ns, chunk=chunk)
    k_pad = plan_j["k_pad"]
    left_pad = np.zeros((k_pad, m * k), np.float32)
    left_pad[:rows] = left
    ref = np.asarray(jax_segsum_stream.streaming_matvec_tbl(
        jnp.asarray(left_pad), _xtab(x_rows, max(m, k)),
        jnp.asarray(jax_segmv.pack_chunk_ids(idx, k_pad, chunk, fill=n_x)),
        plan_j, m, k, transpose=transpose))
    out = segsum_stream.streaming_matvec_tbl(
        _t(left), _t(x_rows), _i32(idx), plan_segments(seg, ns, "cpu"),
        m, k, transpose=transpose).numpy()
    assert out.shape == ref.shape
    assert _rel_err(out, ref) <= REL


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_matches_pallas_block_matvec_stream(interpret_mode,
                                                  transpose):
    """Few unsorted destinations, x rows gathered beforehand (the
    kernel-6 form): ~10 rows per destination, so each takes a group of
    threads."""
    m, k = 9, 3
    rng = np.random.default_rng(3 + transpose)
    rows, n_rows, chunk = 3_100, 300, 512
    dst = rng.integers(0, n_rows, rows)  # unsorted
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xd = m if transpose else k
    right = rng.standard_normal((rows, xd)).astype(np.float32)
    plan_j = jax_segmv.plan_block_matvec(rows, chunk=chunk)
    k_pad = plan_j["k_pad"]
    lp = np.zeros((k_pad, m * k), np.float32)
    lp[:rows] = left
    rp = np.zeros((k_pad, xd), np.float32)
    rp[:rows] = right
    ref = np.asarray(jax_segmv.block_matvec_stream(
        jnp.asarray(lp), jnp.asarray(rp), plan_j,
        jnp.asarray(jax_segmv.pack_chunk_ids(dst, k_pad, chunk,
                                             fill=n_rows)),
        m, k, n_rows, transpose=transpose))
    plan = plan_segments(dst, n_rows, "cpu")
    assert plan.group > 1 and plan.perm is not None
    out = segmv.block_matvec_stream(_t(left), _t(right), plan, m, k,
                                    transpose=transpose).numpy()
    assert _rel_err(out, ref) <= REL


def test_plain_matches_pallas_block_matvec_wtbl(interpret_mode):
    """b_schur: Hpl blocks into few unsorted pose rows, w read by the
    non-decreasing landmark index; some rows masked (fill)."""
    m, k = 9, 3
    rng = np.random.default_rng(17)
    rows, n_out, n_w, chunk = 3_000, 40, 900, 1024
    lid = np.sort(rng.integers(0, n_w, rows))
    dst = rng.integers(0, n_out, rows)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    w_rows = rng.standard_normal((n_w, k)).astype(np.float32)
    lid_eff = np.where(rng.random(rows) < 0.05, n_w, lid)
    plan_j = jax_segmv.plan_matvec_wtbl(lid, n_w, rows, chunk=chunk)
    assert plan_j is not None
    k_pad = plan_j["k_pad"]
    lp = np.zeros((k_pad, m * k), np.float32)
    lp[:rows] = left
    ref = np.asarray(jax_segmv.block_matvec_wtbl(
        jnp.asarray(lp), jnp.asarray(w_rows), plan_j,
        jnp.asarray(jax_segmv.pack_chunk_ids(dst, k_pad, chunk,
                                             fill=n_out)),
        jnp.asarray(jax_segmv.pack_chunk_ids(lid_eff, k_pad, chunk,
                                             fill=n_w)),
        m, k, n_out))
    plan = plan_segments(dst, n_out, "cpu")
    assert plan.group == 16
    out = segmv.block_matvec_wtbl(_t(left), _t(w_rows), plan,
                                  _i32(lid_eff), m, k).numpy()
    assert _rel_err(out, ref) <= REL


@pytest.mark.parametrize("m,k", [(9, 9), (6, 9)])
def test_plain_matches_pallas_matvec_sym(interpret_mode, m, k):
    rng = np.random.default_rng(11 + m)
    rows, n_r, n_c, chunk = 3_000, 210, 180, 512
    rid = rng.integers(0, n_r, rows)  # unsorted
    cid = rng.integers(0, n_c, rows)
    diag = (rng.random(rows) < 0.15) if m == k else np.zeros(rows, bool)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xc_rows = rng.standard_normal((n_c, k)).astype(np.float32)
    xr_rows = rng.standard_normal((n_r, m)).astype(np.float32)
    rxi = np.where(diag, n_r, rid)
    plan_j = jax_segmv.plan_block_matvec(rows, chunk=chunk)
    k_pad = plan_j["k_pad"]
    lp = np.zeros((k_pad, m * k), np.float32)
    lp[:rows] = left
    dw = jax_segmv.slot_geom(max(m, k))[0]
    yr_ref, yc_ref = jax_segmv.matvec_sym_stream(
        jnp.asarray(lp), _xtab(xc_rows, dw), _xtab(xr_rows, dw),
        jnp.asarray(jax_segmv.pack_chunk_ids(cid, k_pad, chunk, fill=n_c)),
        jnp.asarray(jax_segmv.pack_chunk_ids(rid, k_pad, chunk, fill=n_r)),
        jnp.asarray(jax_segmv.pack_chunk_ids(rxi, k_pad, chunk, fill=n_r)),
        plan_j, m, k, n_r, n_c)
    plan = segmv.plan_matvec_sym(rid, cid, n_r, n_c, "cpu", m)
    yr, yc = segmv.matvec_sym_stream(_t(left), _t(xc_rows), _t(xr_rows),
                                     _i32(cid), _i32(rxi), plan, m, k)
    assert _rel_err(yr.numpy(), np.asarray(yr_ref)) <= REL
    assert _rel_err(yc.numpy(), np.asarray(yc_ref)) <= REL


def _kernel_order(left, x, xi, dst, ns, m, k, transpose, group):
    """The kernel's float32 order, written out: per segment, lane l sums
    the products of rows l, l+G, ... (stable destination order), then
    the halving tree lane l += lane l+h."""
    xd = m if transpose else k
    x_pad = np.concatenate([x, np.zeros((1, xd), np.float32)])
    order = np.argsort(dst, kind="stable")
    out = np.zeros((ns, k if transpose else m), np.float32)
    for s in range(ns):
        rows = order[dst[order] == s]
        lanes = np.zeros((group, out.shape[1]), np.float32)
        for q, r in enumerate(rows):
            a = left[r].reshape(m, k)
            xv = x_pad[min(xi[r], x.shape[0])]
            if transpose:
                p = a[0] * xv[0]
                for i in range(1, m):
                    p = p + a[i] * xv[i]
            else:
                p = a[:, 0] * xv[0]
                for j in range(1, k):
                    p = p + a[:, j] * xv[j]
            lanes[q % group] = lanes[q % group] + p
        h = group // 2
        while h >= 1:
            lanes[:h] = lanes[:h] + lanes[h:2 * h]
            h //= 2
        out[s] = lanes[0]
    return out


@pytest.mark.parametrize("group", [1, 2, 8, 64, 256])
@pytest.mark.parametrize("transpose", [False, True])
def test_plain_sums_in_kernel_order(group, transpose):
    m, k = 4, 3
    rng = np.random.default_rng(group + 7 * transpose)
    rows, ns, n_x = 900, 5, 30
    dst = rng.integers(0, ns, rows)
    dst[dst == 3] = 4  # an empty segment
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    x = rng.standard_normal((n_x, m if transpose else k)).astype(np.float32)
    xi = rng.integers(0, n_x + 1, rows)  # n_x: the zero fill row
    plan = plan_segments(dst, ns, "cpu", group=group)
    out = segmv.segmv_plain(_t(left), _t(x), _i32(xi), plan, m, k,
                            transpose).numpy()
    assert np.array_equal(
        out, _kernel_order(left, x, xi, dst, ns, m, k, transpose, group))

    # float64: the same sums as np.add.at
    x_pad = np.concatenate([x, np.zeros((1, x.shape[1]))]).astype(np.float64)
    a = left.astype(np.float64).reshape(rows, m, k)
    y = (np.einsum("rik,ri->rk", a, x_pad[xi]) if transpose
         else np.einsum("rik,rk->ri", a, x_pad[xi]))
    ref = np.zeros((ns, y.shape[1]))
    np.add.at(ref, dst, y)
    out64 = segmv.segmv_plain(_t(left, torch.float64),
                              _t(x, torch.float64), _i32(xi), plan, m, k,
                              transpose).numpy()
    np.testing.assert_allclose(out64, ref, rtol=1e-12, atol=1e-12)


def test_group_size_and_cpu_entry_points():
    assert [segsum.group_size(r, 10) for r in (30, 90, 700, 28_000)] == [
        1, 2, 16, 256]
    assert segsum.group_size(0, 0) == 1
    with pytest.raises(ValueError):
        plan_segments(np.zeros(3, np.int64), 1, "cpu", group=3)
    rng = np.random.default_rng(1)
    rows, ns, m, k = 200, 7, 9, 3
    dst = rng.integers(0, ns, rows)
    left = _t(rng.standard_normal((rows, m * k)).astype(np.float32))
    w = _t(rng.standard_normal((50, k)).astype(np.float32))
    lid = _i32(rng.integers(0, 50, rows))
    plan = plan_segments(dst, ns, "cpu")
    stats = (segmv.STREAM_STATS, segmv.WTBL_STATS, segmv.SYM_STATS,
             segsum_stream.MATVEC_TBL_STATS)
    before = [s.launches for s in stats]
    a = segmv.block_matvec_wtbl(left, w, plan, lid, m, k)
    b = segmv.block_matvec_stream(left, w.index_select(0, lid), plan, m, k)
    c = segsum_stream.streaming_matvec_tbl(left, w, lid, plan, m, k)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert [s.launches for s in stats] == before


@pytest.mark.parametrize("group", [1, 8, 128])
@pytest.mark.parametrize("m,k", [(9, 9), (6, 9)])
def test_k5_two_passes_equal_plain(m, k, group):
    rng = np.random.default_rng(m + k + group)
    rows, n_r, n_c = 2_000, 12, 10
    rid = rng.integers(0, n_r, rows)  # unsorted
    cid = np.sort(rng.integers(0, n_c, rows))  # CSC: columns sorted
    diag = (rng.random(rows) < 0.1) if m == k else np.zeros(rows, bool)
    rxi = np.where(diag, n_r, rid)
    left = rng.standard_normal((rows, m * k)).astype(np.float32)
    xc = rng.standard_normal((n_c, k)).astype(np.float32)
    xr = rng.standard_normal((n_r, m)).astype(np.float32)
    plan = segmv.plan_matvec_sym(rid, cid, n_r, n_c, "cpu", m, group)
    assert plan.rows.group == plan.cols.group == group
    assert plan.cols.perm is None
    lengths = np.bincount(cid, minlength=n_c)
    assert np.all(np.diff(lengths[plan.col_order.numpy()]) <= 0)
    yr, yc = segmv.matvec_sym_plain(_t(left), _t(xc), _t(xr), _i32(cid),
                                    _i32(rxi), plan, m, k)

    # pass 1's row products, in the kernel's order: p = a[:, 0] x_0, then
    # p + a[:, j] x_j
    a = left.reshape(rows, m, k)
    xg = xc[cid]
    P = a[:, :, 0] * xg[:, None, 0]
    for j in range(1, k):
        P = P + a[:, :, j] * xg[:, None, j]
    # pass 2: K1's plain version over the row plan
    yr2 = segsum.segment_sum_plain(torch.as_tensor(P), plan.rows)
    assert torch.equal(yr2, yr)
    assert np.array_equal(yr.numpy(), _kernel_order(
        left, xc, cid, rid, n_r, m, k, False, group))
    assert np.array_equal(yc.numpy(), _kernel_order(
        left, xr, rxi, cid, n_c, m, k, True, group))


def _k4_tiles(offsets, group, tile_blocks):
    """K4's walk of a plan, as the kernel takes it: one (cta, lo, hi) per
    tile, [lo, hi) the sorted positions whose products the tile computes.
    CTA c owns segments [c*spc, c*spc + spc) (spc = K4_THREADS / group),
    so positions [P0, P1); its tiles lie on a grid of ``tile_blocks``
    from P0 rounded down to a multiple of 4, clipped to [P0, P1)."""
    ns = offsets.shape[0] - 1
    spc = segmv.K4_THREADS // group
    out = []
    for c in range(-(-ns // spc)):
        p0, p1 = offsets[c * spc], offsets[min(c * spc + spc, ns)]
        a0 = p0 & ~3
        for t0 in range(a0, p1 if p1 > p0 else a0, tile_blocks):
            out.append((c, max(t0, p0), min(t0 + tile_blocks, p1)))
    return out


@pytest.mark.parametrize("group", [1, 4, 64, 256])
@pytest.mark.parametrize("permuted", [False, True])
def test_k4_tiles_cover_every_position_once(group, permuted):
    rng = np.random.default_rng(group + permuted)
    ns = 3_000 // group + 7
    dst = rng.integers(0, ns, 5 * ns * group // 4 + 3)
    dst[dst == 5] = 6  # an empty segment
    if not permuted:
        dst = np.sort(dst)
    plan = plan_segments(dst, ns, "cpu", group=group)
    assert (plan.perm is not None) == permuted
    offsets = plan.offsets.numpy()
    for m, k in ((9, 3), (9, 9), (16, 16)):
        tile = segmv.k4_tile_blocks(m, k)
        assert tile % 4 == 0 and 4 <= tile <= segmv.K4_THREADS
        tiles = _k4_tiles(offsets, group, tile)
        hits = np.zeros(plan.rows, np.int64)
        spc = segmv.K4_THREADS // group
        for c, lo, hi in tiles:
            assert lo < hi <= lo + tile
            # a CTA's positions are those of its segments
            assert offsets[c * spc] <= lo and hi <= offsets[
                min(c * spc + spc, ns)]
            # tiles lie on a grid of `tile` from a multiple of 4
            assert (hi - offsets[c * spc] + (offsets[c * spc] & 3)) % tile \
                == 0 or hi == offsets[min(c * spc + spc, ns)]
            hits[lo:hi] += 1
        assert np.all(hits == 1)
    # some CTA starts off the 4-block grid, so its first tile reaches back
    starts = offsets[::segmv.K4_THREADS // group][:-1]
    assert np.any(starts % 4 != 0)
