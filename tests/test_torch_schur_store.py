"""S = Hpp - the triple products stored by K3 itself, and the LM device
loop's relinearization written in place, on the CPU (where the wrappers
take their plain versions).

- K3's base store (``streaming_segment_product_sum_rtbl`` with ``base``)
  and its plain version ``product_store_plain`` bitwise the sequence
  ``schur_values`` ran before the store moved into K3 (a zero S, the Hpp
  blocks copied in with ``index_copy_``, minus the sums) on seeded inputs:
  Hpp entries of -0.0, S blocks with no Hpp copy, S blocks with no pair,
  and a second product group subtracted in place (the same ``data_ptr``).
- ``schur_values`` bitwise that old code on float32 problems, K3's
  branch forced and not: the ``mixed_dims`` fixture of
  ``test_torch_schur.py`` (Hpp, Hpl and Hll blocks in one H group, S
  blocks with no pair), ``multitype`` (two product groups into one S
  group: the second store in place) and a BAL problem.
- ``linearize(out=)`` and ``PCGSchurSolver.prepare(out=)`` write into the
  given tensors (the same ``data_ptr``s), bitwise a new call, for a BAL
  set that takes K7's entries, the same set with K7's gate shut, generic
  factor types and an AUTO-differentiated SE3 pose graph.
- ``levenberg_marquardt(jit_loop=True)`` on the CPU (the device loop's
  plain form, which relinearizes in place) bitwise the host loop on a
  seeded BAL problem, with accepted and rejected steps, the loop's state
  tensors kept.

``schur_values`` and the LM slice stay held against the JAX package by
``test_torch_schur.py``, ``test_torch_schur_w.py`` and
``test_torch_lm_slice.py``. K3's store is tested on the card by
``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import g2o, synthetic
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.ops import device_loop
from graphite_tpu_torch.ops.blockfmt import flat_block_mm_nt
from graphite_tpu_torch.ops.cuda import bal as k7
from graphite_tpu_torch.ops.cuda import segsum_stream
from graphite_tpu_torch.ops.cuda.segsum import sorted_segment_sum
from graphite_tpu_torch.ops.streamreduce import product_plan, segment_plan
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.optimizers.lm import cached_device_loop
from graphite_tpu_torch.solvers import PCGSchurSolver
from test_torch_schur import _mixed_dims, _multitype

torch.set_num_threads(1)

MU = 1e-2


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _store_inputs(seed, m=4, k=3, n=2, ns=300, n_base=260):
    """A seeded K3 site: sorted destinations over ``ns`` S blocks (every
    7th with no pair), W and R tables and their index streams, an H group
    of ``n_base`` rows (every 5th entry -0.0) and the Hpp copy: the S
    blocks that have one (every 3rd has none) and their rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.poisson(4, ns)
    lengths[::7] = 0
    dst = np.repeat(np.arange(ns), lengths)
    W = rng.standard_normal((200, m * k)).astype(np.float32)
    R = rng.standard_normal((150, n * k)).astype(np.float32)
    W.reshape(-1)[::11] = -0.0
    li = rng.integers(0, 200, dst.size).astype(np.int32)
    ri = rng.integers(0, 150, dst.size).astype(np.int32)
    base = rng.standard_normal((n_base, m * n)).astype(np.float32)
    base.reshape(-1)[::5] = -0.0
    s_idx = np.setdiff1d(np.arange(ns), np.arange(0, ns, 3))
    h_idx = rng.permutation(n_base)[:s_idx.size]
    plan = segsum_stream.plan_products(dst, ns, "cpu")
    return dict(W=torch.as_tensor(W), R=torch.as_tensor(R),
                li=torch.as_tensor(li), ri=torch.as_tensor(ri),
                base=torch.as_tensor(base), s_idx=torch.as_tensor(s_idx),
                h_idx=torch.as_tensor(h_idx), plan=plan, dims=(m, k, n),
                ns=ns, lengths=lengths)


def _old_sequence(x, sums):
    """``schur_values``' ops before the store moved into K3."""
    m, _, n = x["dims"]
    s = torch.zeros((x["ns"], m * n), dtype=torch.float32)
    s.index_copy_(0, x["s_idx"], x["base"].index_select(0, x["h_idx"]))
    return s - sums


def _base_idx(x):
    idx = torch.full((x["ns"],), -1, dtype=torch.int32)
    idx[x["s_idx"]] = x["h_idx"].to(torch.int32)
    return idx


def _sums(x):
    return segsum_stream.segment_product_sum_plain(
        x["W"], x["R"], x["plan"], *x["dims"], x["li"], x["ri"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_base_store_is_the_old_sequence(seed):
    x = _store_inputs(seed)
    sums = _sums(x)
    ref = _old_sequence(x, sums)
    bidx = _base_idx(x)
    plain = segsum_stream.product_store_plain(sums, x["base"], bidx)
    out = segsum_stream.streaming_segment_product_sum_rtbl(
        x["W"], x["R"], x["plan"], *x["dims"], x["li"], x["ri"],
        base=x["base"], base_idx=bidx)
    _same(plain, ref)
    _same(out, ref)
    # the cases the store must keep: a -0.0 Hpp entry of a block with no
    # pair stays -0.0, a block with neither is +0.0 (0.0 - 0.0)
    bare = torch.as_tensor(x["lengths"] == 0)
    no_hpp = bidx < 0
    assert bool((bare & ~no_hpp).any()) and bool((bare & no_hpp).any())
    assert bool(torch.signbit(ref[bare & ~no_hpp]).any())
    assert not bool(torch.signbit(ref[bare & no_hpp]).any())


@pytest.mark.parametrize("base", ["none", "empty"])
@pytest.mark.parametrize("seed", [0, 1])
def test_base_store_with_no_hpp_group(seed, base):
    """An S group with no Hpp group (two pose types joined only through
    shared landmarks): every index -1 and no base rows, given as None or
    as an empty group. Bitwise a zero S minus the sums: +0.0 - sum."""
    x = _store_inputs(seed)
    sums = _sums(x)
    ref = torch.zeros_like(sums) - sums
    bidx = torch.full((x["ns"],), -1, dtype=torch.int32)
    rows = None if base == "none" else x["base"][:0]
    _same(segsum_stream.product_store_plain(sums, rows, bidx), ref)
    got = segsum_stream.streaming_segment_product_sum_rtbl(
        x["W"], x["R"], x["plan"], *x["dims"], x["li"], x["ri"],
        base=rows, base_idx=bidx)
    _same(got, ref)
    bare = torch.as_tensor(x["lengths"] == 0)
    assert not bool(torch.signbit(got[bare]).any())
    assert bool(torch.signbit(got[~bare]).any())


@pytest.mark.parametrize("seed", [0, 1])
def test_second_group_subtracts_in_place(seed):
    """A later product group into the same S group reads S as its base
    and writes it in place: bitwise ``S - sums``."""
    x, y = _store_inputs(seed), _store_inputs(seed + 10)
    first = _old_sequence(x, _sums(x))
    ref = first - _sums(y)
    s = first.clone()
    ptr = s.data_ptr()
    got = segsum_stream.streaming_segment_product_sum_rtbl(
        y["W"], y["R"], y["plan"], *y["dims"], y["li"], y["ri"], base=s)
    assert got.data_ptr() == ptr
    _same(got, ref)
    _same(segsum_stream.product_store_plain(_sums(y), first.clone(), None),
          ref)


def _schur_values_before(problem, ss, hvals):
    """``schur_values`` as it was before K3 stored S: S starts as the Hpp
    copy, and each product group's sums are subtracted from it."""
    inv_dt = problem.precision.inv_dtype
    hll_inv, hpl_w = torch_schur.landmark_w(problem, ss, hvals)
    s_vals = {key: torch.zeros((ss.s_sizes[key], key[0] * key[1]),
                               dtype=inv_dt) for key in ss.s_keys}
    for hi, (hkey, h_idx, s_idx) in enumerate(ss.hpp_copy):
        src = hvals[hkey].index_select(0, problem.index(("hpp_h", hi), h_idx))
        s_vals[hkey].index_copy_(0, problem.index(("hpp_s", hi), s_idx),
                                 src.to(inv_dt))
    for gi, pg in enumerate(ss.products):
        dpa, dl, dpb = pg["dims"]
        key = pg["dst_key"]
        W = hpl_w[pg["left_key"]]
        R = hvals[pg["right_key"]].to(inv_dt)
        if pg["dst"].shape[0] > torch_schur._chunk_threshold(problem):
            acc = segsum_stream.streaming_segment_product_sum_rtbl(
                W, R, product_plan(problem, ("prod_k3", gi), pg["dst"],
                                   ss.s_sizes[key]), dpa, dl, dpb,
                problem.index32(("prod_l", gi), pg["left"]),
                problem.index32(("prod_r", gi), pg["right"]))
        else:
            left = W.index_select(0, problem.index(("prod_l", gi),
                                                   pg["left"]))
            right = R.index_select(0, problem.index(("prod_r", gi),
                                                    pg["right"]))
            acc = sorted_segment_sum(
                flat_block_mm_nt(left, right, dpa, dl, dpb,
                                 acc_dtype=inv_dt),
                segment_plan(problem, ("prod_dst", gi), pg["dst"],
                             ss.s_sizes[key], dpa * dpb))
        s_vals[key] = s_vals[key] - acc
    return s_vals


def _bal32():
    ds = synthetic.make_bal((6, 60, 300), seed=3, noise=0.5)
    gp, *_ = torch_bal_io.build_graph(ds, precision=gtt.FP32_FP32)
    return gp


FIXTURES = {"mixed_dims": lambda: _mixed_dims("FP32_FP32")[1],
            "multitype": lambda: _multitype("FP32_FP32")[1], "bal": _bal32}


def _damped(fixture):
    pp = FIXTURES[fixture]().freeze(device="cpu")
    ss = torch_schur.build_schur_structure(pp)
    hs = torch_hessian.build_hessian_structure(pp)
    lin = linearize(pp, pp.params0)
    hv = torch_hessian.apply_damping(
        pp, hs, torch_hessian.compute_hessian_values(pp, hs, lin), lin.diag,
        MU, False)
    return pp, ss, hv


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_schur_values_is_the_old_code(fixture, forced, monkeypatch):
    if forced:  # K3's branch (its plain version on the CPU)
        monkeypatch.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
    pp, ss, hv = _damped(fixture)
    stores = []
    k3 = segsum_stream.streaming_segment_product_sum_rtbl

    no_hpp = []

    def counted(*args, **kw):
        stores.append(kw.get("base_idx") is None)
        no_hpp.append(kw.get("base") is None)
        return k3(*args, **kw)

    monkeypatch.setattr(torch_schur, "streaming_segment_product_sum_rtbl",
                        counted)
    after = torch_schur.schur_values(pp, ss, hv)
    before = _schur_values_before(pp, ss, hv)
    assert list(after.s_vals) == ss.s_keys
    for key in ss.s_keys:
        _same(after.s_vals[key], before[key])
    dst_keys = [pg["dst_key"] for pg in ss.products]
    assert len(stores) == (len(ss.products) if forced else 0)
    if forced:  # one store from Hpp per S group, the others in place
        assert stores.count(False) == len(set(dst_keys))
    if fixture == "multitype":
        assert len(dst_keys) > len(set(dst_keys))
        if forced:
            assert stores.count(True) == len(dst_keys) - len(set(dst_keys))
            # its (4, 2) S group has no Hpp group: no base
            assert any(no_hpp)
    if fixture == "mixed_dims":
        (key,) = ss.hpl_keys
        assert not np.array_equal(ss.hpl_h_idx[key],
                                  np.arange(ss.hpl_h_idx[key].shape[0]))


def _sphere():
    g, *_ = g2o.build_graph(synthetic.make_sphere_se3(40, seed=0),
                            precision=gtt.FP32_FP32)
    return g


LIN_CASES = {"bal": (_bal32, True), "bal-gate-shut": (_bal32, False),
             "mixed_dims": (FIXTURES["mixed_dims"], True),
             "sphere-auto": (_sphere, True)}


def _tensors(lin):
    out = [lin.scales, lin.diag, lin.b, lin.chi2]
    for field in ("residuals", "chi2_vec", "chi2_deriv"):
        out += list(getattr(lin, field).values())
    for js in lin.jacobians.values():
        out += list(js or ())
    return out


def _moved(problem):
    """Parameters away from the start (so a second linearization
    differs from the first)."""
    rng = np.random.default_rng(7)
    return {n: p + torch.as_tensor(rng.normal(0, 1e-2, p.shape),
                                   dtype=p.dtype)
            for n, p in problem.params0.items()}


@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_linearize_writes_into_out(case, monkeypatch):
    make, k7_open = LIN_CASES[case]
    if not k7_open:
        monkeypatch.setattr(k7, "gate", lambda problem, name: None)
    problem = make().freeze(device="cpu")
    if case == "bal":
        assert all(k7.gate(problem, n) is not None
                   for n in problem.factor_meta)
    params = _moved(problem)
    out = linearize(problem, problem.params0)
    ptrs = [t.data_ptr() for t in _tensors(out)]
    got = linearize(problem, params, out=out)
    ref = linearize(problem, params)
    assert got is out
    assert [t.data_ptr() for t in _tensors(out)] == ptrs
    for a, b in zip(_tensors(out), _tensors(ref), strict=True):
        _same(a, b)
    assert not torch.equal(out.b, linearize(problem, problem.params0).b)


@pytest.mark.parametrize("case", ["bal", "bal-gate-shut", "mixed_dims"])
def test_prepare_writes_into_out(case, monkeypatch):
    make, k7_open = LIN_CASES[case]
    if not k7_open:
        monkeypatch.setattr(k7, "gate", lambda problem, name: None)
    problem = make().freeze(device="cpu")
    solver = PCGSchurSolver(10, 1.0, 5.0)
    params = _moved(problem)
    out = solver.prepare(problem, linearize(problem, problem.params0),
                         problem.params0)
    ptrs = {k: v.data_ptr() for k, v in out.hvals.items()}
    lin = linearize(problem, params)
    got = solver.prepare(problem, lin, params, out=out)
    ref = solver.prepare(problem, lin, params)
    assert got is out
    assert {k: v.data_ptr() for k, v in out.hvals.items()} == ptrs
    assert list(out.hvals) == list(ref.hvals)
    for key in ref.hvals:
        _same(out.hvals[key], ref.hvals[key])


SOLVERS = {"pcg": lambda: gtt.solvers.PCGSolver(
               10, 1e-6, 5.0, gtt.preconditioners.BlockJacobiPreconditioner()),
           "pcg-schur": lambda: PCGSchurSolver(10, 1.0, 5.0),
           "dense": gtt.solvers.DenseCholeskySolver,
           "dense-schur": gtt.solvers.DenseCholeskySchurSolver,
           "sparse": gtt.solvers.SparseDirectSolver,
           "sparse-schur": gtt.solvers.SparseDirectSchurSolver}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_every_solver_prepares_into_out(name):
    """``prepare(out=)`` is every solver's (the Solver protocol): the
    state lands in ``out``'s tensors, bitwise a new state."""
    problem = _bal32().freeze(device="cpu")
    solver = SOLVERS[name]()
    out = solver.prepare(problem, linearize(problem, problem.params0),
                         problem.params0)
    ptrs = [t.data_ptr() for t in device_loop.leaves(out)]
    params = _moved(problem)
    lin = linearize(problem, params)
    got = solver.prepare(problem, lin, params, out=out)
    ref = solver.prepare(problem, lin, params)
    assert got is out
    assert [t.data_ptr() for t in device_loop.leaves(out)] == ptrs
    for a, b in zip(device_loop.leaves(out), device_loop.leaves(ref),
                    strict=True):
        _same(a, b)


@pytest.mark.parametrize("damping", [1e-4, 1e-9])
def test_jit_loop_on_the_cpu_is_the_host_loop(damping):
    problem = _bal32().freeze(device="cpu")
    solver = PCGSchurSolver(10, 1.0, 5.0)
    opts = dict(iterations=6, initial_damping=damping)
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    jit_opts = LevenbergMarquardtOptions(jit_loop=True, **opts)
    first = levenberg_marquardt(problem, solver, options=jit_opts)
    loop = cached_device_loop(problem, solver, jit_opts)
    state = [t.data_ptr() for t in _tensors(loop.lin)] + [
        t.data_ptr() for t in loop.sstate.hvals.values()]
    again = levenberg_marquardt(problem, solver, options=jit_opts)
    assert cached_device_loop(problem, solver, jit_opts) is loop
    assert [t.data_ptr() for t in _tensors(loop.lin)] + [
        t.data_ptr() for t in loop.sstate.hvals.values()] == state
    accepted = [h["accepted"] for h in host.history]
    assert any(accepted)
    if damping < 1e-6:
        assert not all(accepted)
    for run in (first, again):
        assert [h["accepted"] for h in run.history] == accepted
        assert [h["chi2"] for h in run.history] == [
            h["chi2"] for h in host.history]
        assert (run.chi2, run.initial_chi2, run.mu) == (
            host.chi2, host.initial_chi2, host.mu)
        for n, p in host.params.items():
            _same(run.params[n], p)
