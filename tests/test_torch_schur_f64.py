"""The float64 instances of K3, K4, K5 and K10 (the FP64_FP64 and
FP64_BF16 Schur stage) on the CPU, where each wrapper takes its plain
version, against the JAX package's float64 stepwise functions.

- The plain versions in float64 against the JAX package's stepwise code
  on the same seeded inputs, to 1e-12 relative to each array's largest
  entry: K3 (``flat_block_mm_nt`` of the gathered rows and
  ``jax.ops.segment_sum``; the base store ``Hpp - sums`` from a base
  index and in place), K4 (``flat_block_mv`` / ``flat_block_mv_t`` of the
  gathered x rows, indices off the table reading zero, and
  ``segment_sum``), K5 (both halves); the K10 wrapper bitwise the code
  ``schur.py`` ran before K10, in float64.
- The plans: K4's tile in float64 is sized by bytes and on a 2-block grid
  (``k4_tile_blocks``); K5's column lanes are capped so that two tiles
  fit shared memory (``sym_group_cap``: 128 at 9x9 in float64, 256 in
  float32), and the float64 plain version follows the capped plan.
- With the size gates forced, FP64_FP64 and FP64_BF16 on the LM slice's
  BAL problem (12, 120, 700) take the kernels' branches (every K3, K4, K5
  and K10 wrapper called with float64 values) and 5 LM iterations of
  PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0) keep the JAX
  package's accept pattern with chi2 within ``LM_TOL`` (1e-9 for
  FP64_FP64, 3e-2 for FP64_BF16, as ``test_torch_precision.py``);
  ``jit_loop`` (uncaptured on the CPU) is bitwise the host loop.

The kernels themselves, and their refusal of other dtypes, are tested on
the card by ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.ops import blockfmt as jax_blockfmt
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.ops.cuda import schur_w, segmv, segsum_stream
from graphite_tpu_torch.ops.cuda.segsum import plan_segments
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.solvers import PCGSchurSolver
from test_torch_schur_w import _before, _bits, _inputs

torch.set_num_threads(1)

TOL = 1e-12


def _close(out, ref, tol=TOL):
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-300)
    assert float(np.abs(out - ref).max(initial=0.0)) <= tol * scale


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _jax_products(ltab, rtab, li, ri, dst, ns, m, k, n):
    """The JAX package's stepwise triple products in float64: the
    gathered rows' per-row products, then ``segment_sum``."""
    prod = jax_blockfmt.flat_block_mm_nt(
        jnp.asarray(ltab[li]), jnp.asarray(rtab[ri]), m, k, n,
        acc_dtype=jnp.float64)
    return np.asarray(jax.ops.segment_sum(prod, jnp.asarray(dst), ns))


@pytest.mark.parametrize("m,k,n", [(9, 3, 9), (3, 2, 4)])
def test_product_plain_f64_matches_jax(m, k, n):
    rng = np.random.default_rng(10 * m + n)
    rows, ns, n_l, n_r = 3_000, 200, 400, 350
    lengths = np.concatenate([rng.integers(0, 12, ns - 2), [700, 900]])
    lengths = lengths[rng.permutation(ns)]
    dst = np.repeat(np.arange(ns), lengths)[:rows]
    rows = dst.size
    ltab = rng.standard_normal((n_l, m * k)) * 10.0 ** rng.integers(
        -3, 3, (n_l, 1))
    rtab = rng.standard_normal((n_r, n * k))
    li = rng.integers(0, n_l, rows)
    ri = rng.integers(0, n_r, rows)
    plan = segsum_stream.plan_products(dst, ns, "cpu")
    assert max(g for g, _, _ in plan.buckets) > 1  # lanes and the tree
    ref = _jax_products(ltab, rtab, li, ri, dst, ns, m, k, n)
    i32 = {"dtype": torch.int32}
    tbl = segsum_stream.streaming_segment_product_sum_rtbl(
        _t(ltab), _t(rtab), plan, m, k, n, _t(li, **i32), _t(ri, **i32))
    stream = segsum_stream.streaming_segment_product_sum(
        _t(ltab[li]), _t(rtab[ri]), plan, m, k, n)
    assert tbl.dtype == stream.dtype == torch.float64
    assert torch.equal(_bits(tbl), _bits(stream))
    _close(tbl.numpy(), ref)
    # the base store: S = Hpp - sums from a base index (-1: +0.0), then a
    # second group subtracted in place
    n_base = 60
    base = rng.standard_normal((n_base, m * n))
    bidx = np.where(rng.random(ns) < 0.3, -1, rng.integers(0, n_base, ns))
    s = segsum_stream.streaming_segment_product_sum_rtbl(
        _t(ltab), _t(rtab), plan, m, k, n, _t(li, **i32), _t(ri, **i32),
        base=_t(base), base_idx=_t(bidx, **i32))
    ref_s = np.where(bidx[:, None] >= 0, base[np.maximum(bidx, 0)],
                     0.0) - ref
    _close(s.numpy(), ref_s)
    again = segsum_stream.streaming_segment_product_sum_rtbl(
        _t(ltab), _t(rtab), plan, m, k, n, _t(li, **i32), _t(ri, **i32),
        base=s)
    assert again is s
    _close(s.numpy(), ref_s - ref)


def _jax_matvec(a, x, xi, dst, ns, m, k, transpose):
    """The JAX package's stepwise block matvec in float64: x rows gathered
    (an index off the table reads zero), per-row products, then
    ``segment_sum``."""
    x_pad = np.concatenate([x, np.zeros((1, x.shape[1]))])
    xg = x_pad[np.where((xi >= 0) & (xi < x.shape[0]), xi, x.shape[0])]
    mv = (jax_blockfmt.flat_block_mv_t if transpose
          else jax_blockfmt.flat_block_mv)
    y = mv(jnp.asarray(a), jnp.asarray(xg), m, k, acc_dtype=jnp.float64)
    return np.asarray(jax.ops.segment_sum(y, jnp.asarray(dst), ns))


@pytest.mark.parametrize("sorted_dst", [True, False])
@pytest.mark.parametrize("m,k,transpose", [(9, 3, False), (9, 3, True),
                                           (4, 2, False)])
def test_matvec_plain_f64_matches_jax(m, k, transpose, sorted_dst):
    rng = np.random.default_rng(m * k + transpose)
    rows, ns = 4_000, 150
    dst = rng.integers(0, ns, rows)
    if sorted_dst:
        dst = np.sort(dst)
    a = rng.standard_normal((rows, m * k))
    n_x = 90
    x = rng.standard_normal((n_x, m if transpose else k))
    xi = rng.integers(-3, n_x + 3, rows)  # some rows read the zero row
    plan = plan_segments(dst, ns, "cpu")
    ref = _jax_matvec(a, x, xi, dst, ns, m, k, transpose)
    xi32 = _t(xi, torch.int32)
    outs = [segsum_stream.streaming_matvec_tbl(_t(a), _t(x), xi32, plan, m,
                                               k, transpose=transpose)]
    if not transpose:
        outs.append(segmv.block_matvec_wtbl(_t(a), _t(x), plan, xi32, m, k))
    x_pad = np.concatenate([x, np.zeros((1, x.shape[1]))])
    xg = x_pad[np.where((xi >= 0) & (xi < n_x), xi, n_x)]
    outs.append(segmv.block_matvec_stream(_t(a), _t(xg), plan, m, k,
                                          transpose))
    for out in outs:
        assert out.dtype == torch.float64
        assert torch.equal(_bits(out), _bits(outs[0]))
        _close(out.numpy(), ref)


@pytest.mark.parametrize("m,k", [(9, 9), (3, 3)])
def test_matvec_sym_plain_f64_matches_jax(m, k):
    rng = np.random.default_rng(m + 7)
    n_r = n_c = 60
    pairs = np.unique(np.sort(rng.integers(0, n_r, (900, 2)), axis=1),
                      axis=0)
    diag = np.stack([np.arange(n_r)] * 2, axis=1)
    pairs = np.unique(np.concatenate([pairs, diag]), axis=0)
    order = np.lexsort((pairs[:, 0], pairs[:, 1]))  # column-sorted
    rid, cid = pairs[order, 0], pairs[order, 1]
    nb = rid.size
    S = rng.standard_normal((nb, m * k))
    xc = rng.standard_normal((n_c, k))
    xr = rng.standard_normal((n_r, m))
    rxi = np.where(rid != cid, rid, n_r)  # diagonal blocks read zero
    plan = segmv.plan_matvec_sym(rid, cid, n_r, n_c, "cpu", m, k=k,
                                 elem_bytes=8)
    yr, yc = segmv.matvec_sym_stream(
        _t(S), _t(xc), _t(xr), _t(cid, torch.int32), _t(rxi, torch.int32),
        plan, m, k)
    assert yr.dtype == yc.dtype == torch.float64
    _close(yr.numpy(), _jax_matvec(S, xc, cid, rid, n_r, m, k, False))
    _close(yc.numpy(), _jax_matvec(S, xr, rxi, cid, n_c, m, k, True))


def test_k4_tile_and_k5_lanes_follow_the_element_size():
    # float32 unchanged: 128 (9, 3) blocks a tile on a 4-block grid
    assert segmv.k4_tile_blocks(9, 3) == segmv.k4_tile_blocks(9, 3, 4) == 128
    for m, k in ((9, 3), (9, 9), (3, 3), (16, 16), (6, 1)):
        for elem, align in ((4, 4), (8, 2)):
            tile = segmv.k4_tile_blocks(m, k, elem)
            assert tile % align == 0 and 4 <= tile <= segmv.K4_MAX_TILE
            per_block = (elem * (segmv.K4_STAGES * m * k
                                 + segmv.K4_PRODUCT_STRIDE)
                         + 4 * (2 * segmv.K4_STAGES + 1))
            assert tile == 4 or tile * per_block <= segmv.K4_TILE_BYTES
    assert segmv.k4_tile_blocks(9, 3, 8) == 96
    # K5: two tiles of G blocks a group in shared memory
    assert segmv.sym_group_cap(9, 9, 4) == 256
    assert segmv.sym_group_cap(9, 9, 8) == 128
    assert segmv.sym_group_cap(16, 16, 4) == 64
    for m in (1, 3, 6, 9, 12, 16):
        for elem in (4, 8):
            g = segmv.sym_group_cap(m, m, elem)
            assert 2 * max(g, 32) * m * m * elem <= segmv.SMEM_BYTES
    # a column site whose lanes the cap lowers: the plan is capped in
    # float64 only, and the plain version follows it
    n_r = 1_000
    cid = np.repeat(np.arange(4), 3_000)
    rid = np.tile(np.arange(3_000) % n_r, 4)
    p32 = segmv.plan_matvec_sym(rid, cid, n_r, 4, "cpu", 9, k=9)
    p64 = segmv.plan_matvec_sym(rid, cid, n_r, 4, "cpu", 9, k=9,
                                elem_bytes=8)
    assert p32.cols.group == 256 and p64.cols.group == 128
    assert p32.rows.group == p64.rows.group


@pytest.mark.parametrize("dp,dl", [(dp, dl) for dp in (3, 6, 9)
                                   for dl in (1, 2, 3)])
def test_k10_wrapper_f64_is_the_code_before_k10(dp, dl):
    hll, hpl, counts = map(torch.as_tensor, _inputs(dp, dl, np.float64))
    plan = schur_w.plan_w(counts.numpy(), "cpu")
    inv_ref, w_ref = _before(hll, hpl, counts.numpy(), dp, dl)
    inv, w = schur_w.schur_w(hll, hpl, plan, dp, dl)
    assert inv.dtype == w.dtype == torch.float64
    assert torch.equal(_bits(inv), _bits(inv_ref))
    assert torch.equal(_bits(w), _bits(w_ref))


# ---- the LM slice with the Venice branches forced -------------------------

LM_SIZE = (12, 120, 700)
LM_TOL = {"FP64_FP64": 1e-9, "FP64_BF16": 3e-2}
WRAPPERS = ("streaming_segment_product_sum_rtbl", "block_matvec_wtbl",
            "matvec_sym_stream", "streaming_matvec_tbl")


@pytest.fixture
def forced(monkeypatch):
    """The size gates lowered, the kernel wrappers (K3, K4, K5 in
    ``schur``, K10 in ``schur_w``) spied on: (wrapper, value dtypes)."""
    monkeypatch.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(torch_schur, "_smv_chunk_rows", lambda rb: 0)
    calls = []

    def spy(owner, name):
        real = getattr(owner, name)

        def wrapped(*args, **kw):
            calls.append((name, {a.dtype for a in args if torch.is_tensor(a)
                                 and a.is_floating_point()}))
            return real(*args, **kw)

        monkeypatch.setattr(owner, name, wrapped)

    for name in WRAPPERS:
        spy(torch_schur, name)
    spy(schur_w, "schur_w")
    return calls


def _port_lm(name, jit_loop=False):
    gp, *_ = torch_bal_io.build_graph(
        torch_synth.make_bal(LM_SIZE, seed=0, noise=0.5),
        precision=getattr(gtt, name))
    return levenberg_marquardt(
        gp.freeze(device="cpu"),
        PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0),
        options=LevenbergMarquardtOptions(iterations=5, jit_loop=jit_loop))


@pytest.mark.parametrize("name", sorted(LM_TOL))
def test_forced_lm_f64_matches_jax(forced, name):
    gj, *_ = jax_build_graph(jax_synth.make_bal(LM_SIZE, seed=0, noise=0.5),
                             precision=getattr(gt, name))
    ref = jax_lm(gj.freeze(), JaxPCGSchur(10, 1.0, 5.0, dense_matvec_limit=0),
                 options=JaxOptions(iterations=5))
    out = _port_lm(name)
    # every kernel branch ran, on float64 values only
    assert {c for c, _ in forced} == set(WRAPPERS) | {"schur_w"}
    assert all(dts == {torch.float64} for _, dts in forced)
    assert len(out.history) == len(ref.history) == 5
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history],
                               rtol=LM_TOL[name])
    assert out.chi2 < out.initial_chi2
    for p in out.params.values():
        assert p.dtype == torch.float64


@pytest.mark.parametrize("name", sorted(LM_TOL))
def test_forced_jit_loop_f64_equals_host_loop(forced, name):
    host = _port_lm(name)
    loop = _port_lm(name, jit_loop=True)
    assert all(dts == {torch.float64} for _, dts in forced)
    assert ([h["accepted"] for h in host.history]
            == [h["accepted"] for h in loop.history])
    assert [h["chi2"] for h in host.history] == [
        h["chi2"] for h in loop.history]
    for k, p in host.params.items():
        assert torch.equal(loop.params[k], p)
