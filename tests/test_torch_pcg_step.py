"""The CG step's vector work (kernel K12's entries, ``ops/cuda/pcg_step``)
and the landmark solve w = Hll^-1 (t - sub) (kernel K13,
``ops/cuda/schur_w.hll_solve``) on the CPU, where each wrapper takes its
plain version, and the pose-only vectors of the Schur path
(``Graph.pose_flat_from_rows``).

- Each plain version is bitwise the op sequence it replaced, kept here
  as the oracle (``_old_*``): ``bjs_apply_plain`` against the inline
  normalisation and the old block-Jacobi-Schur apply (with r = 0, where
  the norm is 0); ``cg_advance_plain`` and ``cg_commit_plain`` against
  ``run_pcg_fixed``'s old step (an accepted, a rejected and a NaN step);
  ``hll_solve_plain`` against ``take_rows`` and ``flat_block_mv``
  (identity and permuted inverse rows, with and without ``sub``; float64
  inverses and landmarks wider than 3, which K13 takes too).
- ``pose_flat_from_rows`` is bitwise ``flat_from_rows(...)[:dim_p]``, and
  ``b_schur``, ``s_matvec`` and the preconditioner's apply bitwise their
  old outputs, on the ``multitype`` fixture of ``test_torch_schur.py``
  (two pose types, two landmark types), ``mixed_dims`` and Ladybug-49 with
  the Venice branches forced (``dense_matvec_limit=0`` and the size gates
  lowered, as ``chip_smoke.py`` phase 9).
- ``run_pcg`` and ``run_pcg_fixed`` return the old loops' x and step
  count bitwise: r = 0, a rejected step (a tiny ``rejection_ratio``), a
  NaN ``rz_new``, the ``tol`` exit and ``max_iter`` reached, float32 and
  float64; and on the forced Ladybug's Schur system with its
  preconditioner.
- Levenberg-Marquardt on the forced Ladybug (FP32_FP32, FP32_BF16,
  FP64_FP64): the trajectory and parameters bitwise the old code's;
  ``jit_loop`` bitwise the host loop; against the JAX package's
  PCGSchurSolver(10, 1.0, 5.0) the same accept pattern, and in float64
  chi2 within 1e-8 (the README's cross-solver rung).
- K2's and K6's plain versions never call a K12 wrapper; the wrappers
  raise off the CPU.

K12 and K13 themselves run on the card: ``test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import contextlib
from typing import Dict

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.graph import PoseSegments
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize as torch_linearize
from graphite_tpu_torch.ops import pcg_loop
from graphite_tpu_torch.ops.blockfmt import flat_block_mv, flat_block_mv_t
from graphite_tpu_torch.ops.cuda import pcg_dense, pcg_mf, pcg_step, schur_w
from graphite_tpu_torch.ops.pcg_loop import (
    SelfNormalizing,
    run_pcg,
    run_pcg_fixed,
    tree_dot,
)
from graphite_tpu_torch.ops.streamreduce import take_rows
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.precision import sqrt_rn
from graphite_tpu_torch.preconditioners import (
    BlockJacobiSchurPreconditioner,
    IdentitySchurPreconditioner,
)
from graphite_tpu_torch.schur import SchurOps
from graphite_tpu_torch.solvers import PCGSchurSolver
from test_torch_pcg_dot import _k6_plain_args
from test_torch_schur import _mixed_dims, _multitype

torch.set_num_threads(1)

MU = 1e-2
LM_ITERS = 10


# ---- the replaced code, kept as the oracle ---------------------------------

def _old_normalized(dot, r):
    rnorm = sqrt_rn(dot(r, r))
    return r / torch.where(rnorm == 0, torch.ones_like(rnorm), rnorm)


def _old_precond(precond):
    """The old loops' M^-1 y: a ``SelfNormalizing`` preconditioner (the
    Schur solver's, whose apply ``_old_code`` makes the old one) called
    on y alone."""
    if isinstance(precond, SelfNormalizing):
        return lambda y: precond.fn(y, None)
    return precond


def _old_run_pcg(b, matvec, precond, max_iter, tol, rejection_ratio):
    dot = tree_dot
    precond = _old_precond(precond)
    x = torch.zeros_like(b)
    r = b
    z = precond(_old_normalized(dot, r))
    p = z
    rz = dot(r, z)
    rz_min = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    k = 0
    while k < max_iter and bool(rz != 0):
        v = matvec(p)
        alpha = rz / dot(p, v)
        x_new = x + alpha * p
        r_new = r - alpha * v
        z_new = precond(_old_normalized(dot, r_new))
        rz_new = dot(r_new, z_new)
        reject = bool((rz_new.abs() > rejection_ratio * rz_min)
                      | torch.isnan(rz_new))
        rz_min = torch.minimum(rz_min, rz_new.abs())
        k += 1
        if reject:
            break
        p = z_new + (rz_new / rz) * p
        x, r, z, rz = x_new, r_new, z_new, rz_new
        if bool(rz.abs() < tol):
            break
    return x, k


def _old_step(state, v_fn, precond, tol, rejection_ratio):
    """One step of the old ``run_pcg_fixed`` on ``state`` (x, r, p, z,
    rz, rz_min, k, done), in place."""
    dot = tree_dot
    x, r, p, z, rz, rz_min, k, done = state
    v = v_fn(p)
    alpha = rz / dot(p, v)
    x_new = x + alpha * p
    r_new = r - alpha * v
    z_new = precond(_old_normalized(dot, r_new))
    rz_new = dot(r_new, z_new)
    reject = ((rz_new.abs() > rejection_ratio * rz_min)
              | torch.isnan(rz_new))
    p_new = z_new + (rz_new / rz) * p
    rz_min.copy_(torch.minimum(rz_min, rz_new.abs()))
    k.add_(1)
    p.copy_(torch.where(reject, p, p_new))
    x.copy_(torch.where(reject, x, x_new))
    r.copy_(torch.where(reject, r, r_new))
    z.copy_(torch.where(reject, z, z_new))
    rz.copy_(torch.where(reject, rz, rz_new))
    done.copy_(reject | (rz.abs() < tol) | (rz == 0))


def _old_apply(problem, ss, state, y):
    z_rows = {}
    for t, inv in state.inv_blocks.items():
        d = problem.vertex_meta[t].vtype.dim
        z_rows[t] = flat_block_mv(inv, problem.rows_view(y, t), d, d,
                                  acc_dtype=inv.dtype)
    return problem.flat_from_rows(z_rows)[: ss.dim_p]


def _old_hll_solve_rows(self, t_rows):
    out = {}
    for t, sel, rows in self._lm_partition():
        d = self.problem.vertex_meta[t].vtype.dim
        gidx = self._cached(
            "hllsolve_gidx", t, lambda sel=sel, rows=rows:
            self.ss.lm_group_index[sel[np.argsort(rows, kind="stable")]])
        inv_flat = take_rows(self.problem, ("hllsolve_gidx", t),
                             self.sv.hll_inv[d], gidx)
        out[t] = flat_block_mv(inv_flat, t_rows[t], d, d,
                               acc_dtype=inv_flat.dtype)
    return out


def _old_landmark_update(self, b, dx_p):
    """``SchurOps.landmark_update`` before K13: every product set
    subtracted from t, then the solve."""
    problem = self.problem
    gdt = self._gdt
    t_rows = {t: problem.rows_view(b, t).to(gdt)
              for t, _, _ in self._lm_partition()}
    for key in self.ss.hpl_keys:
        dp, dl = key
        Hpl = self.hpl(key)
        for pt, lt, sub, prow, lrow in self.hpl_partitions(key):
            ck = ("lu", key, pt, lt)
            Hsub = take_rows(problem, ck + ("sub",), Hpl, sub)
            x_pt = problem.rows_view(dx_p, pt)
            if (sub.shape[0] > torch_schur._smv_chunk_rows(
                    (dp * dl + dp + dl) * 4)
                    and self._nondecreasing(ck, lrow)):
                plan = torch_schur.matvec_plan(problem, ck, lrow,
                                               problem.seg_rows[lt])
                acc = torch_schur.streaming_matvec_tbl(
                    Hsub, x_pt.to(Hsub.dtype),
                    problem.index32(ck + ("pidx",), prow), plan, dp, dl,
                    transpose=True).to(gdt)
            else:
                x = x_pt.index_select(0, problem.index(ck + ("prow",),
                                                       prow))
                y = flat_block_mv_t(Hsub, x, dp, dl, acc_dtype=gdt)
                acc = torch_schur.reduce_rows(y, torch_schur.segment_plan(
                    problem, ck, lrow, problem.seg_rows[lt], dl))
            t_rows[lt] = t_rows[lt] - acc
    return _old_hll_solve_rows(self, t_rows)


@contextlib.contextmanager
def _old_code(problem):
    """The port as before K12, K13 and the pose-only vectors: the old PCG
    loops, preconditioner apply, landmark solve and back-substitution, and
    ``flat_from_rows(...)[:dim_p]`` for the pose vectors."""
    saved = (pcg_loop.run_pcg, pcg_loop.run_pcg_fixed,
             BlockJacobiSchurPreconditioner.apply, SchurOps._hll_solve_rows,
             SchurOps.landmark_update)

    def old_fixed(b, matvec, precond, max_iter, tol, ratio):
        precond = _old_precond(precond)
        x = torch.zeros_like(b)
        r = b.clone()
        z = precond(_old_normalized(tree_dot, r))
        p = z.clone()
        rz = tree_dot(r, z)
        state = (x, r, p, z, rz,
                 torch.full((), float("inf"), dtype=b.dtype),
                 torch.zeros((), dtype=torch.int64), rz == 0)
        pcg_loop.device_loop.while_loop(
            lambda: ~state[7] & (state[6] < max_iter),
            lambda: _old_step(state, matvec, precond, tol, ratio), "cg_step")
        return x, state[6]

    pcg_loop.run_pcg, pcg_loop.run_pcg_fixed = _old_run_pcg, old_fixed
    BlockJacobiSchurPreconditioner.apply = (
        lambda self, problem, ss, state, y, rr:
        _old_apply(problem, ss, state, y))
    SchurOps._hll_solve_rows = _old_hll_solve_rows
    SchurOps.landmark_update = _old_landmark_update
    problem.pose_flat_from_rows = (
        lambda rows, dim_p, dtype=None:
        problem.flat_from_rows(rows, dtype=dtype)[:dim_p])
    try:
        yield
    finally:
        (pcg_loop.run_pcg, pcg_loop.run_pcg_fixed,
         BlockJacobiSchurPreconditioner.apply, SchurOps._hll_solve_rows,
         SchurOps.landmark_update) = saved
        del problem.pose_flat_from_rows


# ---- problems --------------------------------------------------------------

@contextlib.contextmanager
def _forced():
    """The Venice branches at toy size: K3, K4 and K5's plain versions."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
        mp.setattr(torch_schur, "_smv_chunk_rows", lambda rb: 0)
        yield


_PROBLEMS = {}


def _ladybug(precision="FP32_FP32"):
    if precision not in _PROBLEMS:
        ds = torch_synth.make_bal("ladybug", seed=0)
        g, *_ = torch_bal_io.build_graph(ds,
                                         precision=getattr(gtt, precision))
        _PROBLEMS[precision] = g.freeze(device="cpu")
    return _PROBLEMS[precision]


def _fixture(name, precision="FP32_FP32"):
    if name == "ladybug":
        return _ladybug(precision)
    _, gp = {"multitype": _multitype, "mixed_dims": _mixed_dims}[name](
        precision)
    return gp.freeze(device="cpu")


def _schur_state(problem):
    """(ss, SchurOps, block-Jacobi-Schur state) at the start point."""
    hs = torch_hessian.build_hessian_structure(problem)
    ss = torch_schur.build_schur_structure(problem)
    lin = torch_linearize(problem, problem.params0)
    hv = torch_hessian.apply_damping(
        problem, hs, torch_hessian.compute_hessian_values(problem, hs, lin),
        lin.diag, MU, False)
    sv = torch_schur.schur_values(problem, ss, hv)
    ops = SchurOps(problem, ss, hv, sv)
    pstate = BlockJacobiSchurPreconditioner().prepare(problem, ss, sv)
    return ss, ops, pstate, lin


def _vec(n, dtype, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)
    v[::11] = -0.0
    return torch.tensor(v, dtype=dtype)


def _bits(t):
    return t.view({1: torch.uint8, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


FIXTURES = ["multitype", "mixed_dims", "ladybug"]


# ---- the pose-only vectors -------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_pose_flat_from_rows_is_the_flat_vector_cut(name):
    problem = _fixture(name)
    ss = torch_schur.build_schur_structure(problem)
    segs = problem.pose_segments(ss.dim_p)
    assert [s[0] for s in segs.segments] == problem.segment_order[
        :len(segs.segments)]
    assert sum(n * d for _, _, n, d in segs.segments) == ss.dim_p
    rng = np.random.default_rng(1)
    rows = {t: torch.tensor(rng.standard_normal((n, d)), dtype=torch.float64)
            for t, _, n, d in segs.segments}
    for drop in [None] + [s[0] for s in segs.segments]:
        part = {t: v for t, v in rows.items() if t != drop}
        for dtype in (torch.float32, torch.float64):
            ref = problem.flat_from_rows(part, dtype=dtype)[:ss.dim_p]
            got = problem.pose_flat_from_rows(part, ss.dim_p, dtype=dtype)
            assert _same(got, ref)


@pytest.mark.parametrize("name", FIXTURES)
def test_schur_vectors_bitwise_unchanged(name):
    """b_S, S x and the Schur preconditioners' apply (block-Jacobi-Schur
    and the identity, each normalising the residual) bitwise their old
    outputs."""
    problem = _fixture(name)
    with _forced():
        ss, ops, pstate, lin = _schur_state(problem)
        x = _vec(ss.dim_p, lin.b.dtype, 2)
        new = (ops.b_schur(lin.b), ops.s_matvec(x))
        with _old_code(problem):
            old = (ops.b_schur(lin.b), ops.s_matvec(x))
    assert all(_same(a, b) for a, b in zip(new, old))
    pre = BlockJacobiSchurPreconditioner()
    for r in (x, torch.zeros_like(x)):
        rr = tree_dot(r, r)
        got = pre.apply(problem, ss, pstate, r, rr)
        assert _same(got, _old_apply(problem, ss, pstate,
                                     _old_normalized(tree_dot, r)))
        assert _same(IdentitySchurPreconditioner().apply(
            problem, ss, (), r, rr), _old_normalized(tree_dot, r))


# ---- K12's plain versions --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", FIXTURES)
def test_bjs_apply_plain_is_the_old_apply(name, dtype):
    precision = "FP64_FP64" if dtype == torch.float64 else "FP32_FP32"
    problem = _fixture(name, precision)
    ss, _, pstate, _ = _schur_state(problem)
    segs = problem.pose_segments(ss.dim_p)
    for seed, r in enumerate((_vec(ss.dim_p, dtype, 3),
                              torch.zeros(ss.dim_p, dtype=dtype))):
        rr = tree_dot(r, r)
        ref = _old_apply(problem, ss, pstate, _old_normalized(tree_dot, r))
        got = pcg_step.bjs_apply_plain(r, rr, pstate.inv_blocks, segs)
        assert _same(got, ref)
        # the wrapper takes the plain version on the CPU
        assert _same(pcg_step.bjs_apply(r, rr, pstate.inv_blocks, segs),
                     ref)
    # a pose type with no inverses: its segment is 0
    first = segs.segments[0][0]
    part = {t: v for t, v in pstate.inv_blocks.items() if t != first}
    got = pcg_step.bjs_apply_plain(r, tree_dot(r, r), part, segs)
    s, n, d = segs.segments[0][1:]
    assert torch.all(got[s:s + n * d] == 0)


def _spd_system(n, dtype, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    A = A @ A.T + 0.05 * n * np.eye(n)
    return (torch.tensor(A, dtype=dtype),
            torch.tensor(rng.normal(size=n), dtype=dtype),
            torch.tensor(1.0 / np.diag(A), dtype=dtype))


def _state(b, precond):
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(_old_normalized(tree_dot, r))
    rz = tree_dot(r, z)
    return [x, r, z.clone(), z, rz,
            torch.full((), float("inf"), dtype=b.dtype),
            torch.zeros((), dtype=torch.int64), rz == 0]


# (rejection ratio, matvec poison) per case: accepted steps, a rejected
# step, a NaN rz_new
STEP_CASES = {"accepted": (5.0, None), "rejected": (1e-30, None),
              "nan": (5.0, float("nan"))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_advance_and_commit_plain_are_the_old_step(case, dtype):
    ratio, poison = STEP_CASES[case]
    A, b, dinv = _spd_system(40, dtype, 7)

    def matvec(p):
        v = A @ p
        if poison is not None:
            v = v.clone()
            v[3] = poison
        return v

    def precond(y):
        return dinv * y

    old = _state(b, precond)
    new = [t.clone() for t in old]
    for _ in range(3):
        _old_step(old, matvec, precond, 1e-30, ratio)
        x, r, p, z, rz, rz_min, k, done = new
        x_new, r_new = torch.empty_like(b), torch.empty_like(b)
        v = matvec(p)
        pcg_step.cg_advance(x, r, p, v, rz, tree_dot(p, v), x_new, r_new)
        z_new = precond(_old_normalized(tree_dot, r_new))
        pcg_step.cg_commit(x, r, p, z, x_new, r_new, z_new, rz,
                           tree_dot(r_new, z_new), rz_min, k, done,
                           torch.zeros((), dtype=torch.int32), ratio, 1e-30)
        for a, o in zip(new, old):
            if torch.isnan(o).any():  # NaN's bits are the device's
                assert torch.equal(torch.isnan(a), torch.isnan(o))
            else:
                assert _same(a, o)
    assert bool(new[7]) == (case != "accepted")


def test_advance_plain_writes_its_outputs():
    A, b, dinv = _spd_system(20, torch.float32, 8)
    p, v = _vec(20, torch.float32, 9), A @ _vec(20, torch.float32, 9)
    rz, pv = tree_dot(b, b), tree_dot(p, v)
    x_out, r_out = torch.empty(20), torch.empty(20)
    got = pcg_step.cg_advance_plain(torch.zeros(20), b, p, v, rz, pv,
                                    x_out, r_out)
    assert got[0] is x_out and got[1] is r_out
    alpha = rz / pv
    assert _same(x_out, torch.zeros(20) + alpha * p)
    assert _same(r_out, b - alpha * v)


# (max_iter, tol, rejection_ratio, zero b, poison) per case
PCG_CASES = {
    "max-iter": (6, 1e-30, 5.0, False, None),
    "tol": (50, 1e-2, 5.0, False, None),
    "rejected": (50, 1e-30, 1e-4, False, None),
    "nan": (50, 1e-30, 5.0, False, float("nan")),
    "r-zero": (50, 1e-30, 5.0, True, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(PCG_CASES))
def test_run_pcg_bitwise_the_old_loops(case, dtype):
    max_iter, tol, ratio, zero, poison = PCG_CASES[case]
    A, b, dinv = _spd_system(60, dtype, 11)
    if zero:
        b = torch.zeros_like(b)
    calls = [0]

    def matvec(p):
        calls[0] += 1
        v = A @ p
        if poison is not None and calls[0] == 3:
            v = v.clone()
            v[0] = poison
        return v

    def precond(y):
        return dinv * y

    args = (b, matvec, precond, max_iter, tol, ratio)
    calls[0] = 0
    x_ref, k_ref = _old_run_pcg(*args)
    for solve in (run_pcg, run_pcg_fixed):
        calls[0] = 0
        x, k = solve(*args)
        assert int(k) == k_ref and calls[0] == k_ref
        assert _same(x, x_ref)
    assert (k_ref == 0) == zero


@pytest.mark.parametrize("solve", [run_pcg, run_pcg_fixed])
@pytest.mark.parametrize("precision", ["FP32_FP32", "FP64_FP64"])
def test_run_pcg_on_the_schur_system(solve, precision):
    """The forced Ladybug's first Schur system with its block-Jacobi-Schur
    preconditioner taking the normalisation (``SelfNormalizing``): x and
    the step count bitwise the old loop's."""
    problem = _ladybug(precision)
    with _forced():
        ss, ops, pstate, lin = _schur_state(problem)
        b_s = ops.b_schur(lin.b)
        pre = BlockJacobiSchurPreconditioner()
        precond = SelfNormalizing(lambda r, rr: pre.apply(
            problem, ss, pstate, r, rr))
        x, k = solve(b_s, ops.s_matvec, precond, 10, 1.0, 5.0)
        x_ref, k_ref = _old_run_pcg(
            b_s, ops.s_matvec,
            lambda y: _old_apply(problem, ss, pstate, y), 10, 1.0, 5.0)
    assert int(k) == k_ref > 1 and _same(x, x_ref)


# ---- K13's plain version ---------------------------------------------------

@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dl", [1, 2, 3])
def test_hll_solve_plain_is_take_rows_and_block_mv(dl, dtype, permuted, sub):
    rng = np.random.default_rng(dl)
    L = 50
    inv = torch.tensor(rng.standard_normal((L + 1, dl * dl)),
                       dtype=torch.float32)
    idx = rng.permutation(L) if permuted else np.arange(L)
    t = torch.tensor(rng.standard_normal((L, dl)), dtype=dtype)
    s = torch.tensor(rng.standard_normal((L, dl)), dtype=dtype) if sub \
        else None
    problem = _ladybug()
    tag = ("test_hll_solve", dl, permuted)
    ref_inv = take_rows(problem, tag, inv, idx)
    ref = flat_block_mv(ref_inv, t if s is None else t - s, dl, dl,
                        acc_dtype=ref_inv.dtype)
    gidx = None if not permuted else torch.as_tensor(idx)
    for fn in (schur_w.hll_solve_plain, schur_w.hll_solve):
        assert _same(fn(inv, gidx, t, s), ref)


@pytest.mark.parametrize("dl", [1, 4, 6])
@pytest.mark.parametrize("vec_dt,inv_dt", [
    (torch.float32, torch.float64), (torch.float64, torch.float64),
    (torch.float64, torch.float32)])
def test_hll_solve_plain_any_dtype_and_dim(vec_dt, inv_dt, dl):
    """Float64 inverses (FP64_FP64, FP64_BF16) and landmarks wider than 3,
    which K13 takes too: the wrapper on the CPU bitwise ``take_rows`` and
    ``flat_block_mv``, w in the inverses' dtype."""
    rng = np.random.default_rng(10 + dl)
    L = 40
    inv = torch.tensor(rng.standard_normal((L + 1, dl * dl)), dtype=inv_dt)
    idx = rng.permutation(L)
    t = torch.tensor(rng.standard_normal((L, dl)), dtype=vec_dt)
    s = torch.tensor(rng.standard_normal((L, dl)), dtype=vec_dt)
    ref = flat_block_mv(inv[torch.as_tensor(idx)], t - s, dl, dl,
                        acc_dtype=inv_dt)
    got = schur_w.hll_solve(inv, torch.as_tensor(idx), t, s)
    assert got.dtype == inv_dt and _same(got, ref)


def test_hll_solve_gate():
    t = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="float32 / float64"):
        schur_w.hll_solve(torch.zeros(4, 9, dtype=torch.bfloat16), None, t)
    with pytest.raises(NotImplementedError, match="float32 / float64"):
        schur_w.hll_solve(torch.zeros(4, 9), None, t.half())
    with pytest.raises(ValueError, match="do not fit"):
        schur_w.hll_solve(torch.zeros(4, 16), None, t)
    with pytest.raises(ValueError, match="do not fit"):
        schur_w.hll_solve(torch.zeros(3, 9), None, t)


@pytest.mark.parametrize("name", FIXTURES)
def test_landmark_solves_bitwise_unchanged(name):
    """``_hll_solve_rows`` and ``landmark_update`` (its last product set
    subtracted inside the solve) bitwise the old code's."""
    problem = _fixture(name)
    with _forced():
        ss, ops, _, lin = _schur_state(problem)
        dx_p = _vec(ss.dim_p, lin.b.dtype, 4)
        t_rows = {t: problem.rows_view(lin.b, t)
                  for t, _, _ in ops._lm_partition()}
        new = ops._hll_solve_rows(t_rows), ops.landmark_update(lin.b, dx_p)
        old = (_old_hll_solve_rows(ops, t_rows),
               _old_landmark_update(ops, lin.b, dx_p))
    for a, b in zip(new, old):
        assert a.keys() == b.keys()
        assert all(_same(a[t], b[t]) for t in a)


# ---- the LM on the forced Ladybug ------------------------------------------

def _lm(problem, jit_loop=False, iterations=LM_ITERS):
    with _forced():
        return levenberg_marquardt(
            problem, PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0),
            options=LevenbergMarquardtOptions(iterations=iterations,
                                              jit_loop=jit_loop))


def _same_run(a, b):
    assert [h["accepted"] for h in a.history] == [
        h["accepted"] for h in b.history]
    assert [h["chi2"] for h in a.history] == [h["chi2"] for h in b.history]
    assert a.params.keys() == b.params.keys()
    assert all(_same(a.params[n], b.params[n]) for n in a.params)


_RUNS: Dict[str, object] = {}


def _new_run(precision):
    if precision not in _RUNS:
        _RUNS[precision] = _lm(_ladybug(precision))
    return _RUNS[precision]


@pytest.mark.parametrize("precision", ["FP32_FP32", "FP32_BF16",
                                       "FP64_FP64"])
def test_lm_bitwise_the_old_code(precision):
    problem = _ladybug(precision)
    new = _new_run(precision)
    with _old_code(problem):
        old = _lm(problem)
    _same_run(new, old)
    assert new.chi2 < new.initial_chi2


def test_jit_loop_bitwise_the_host_loop():
    _same_run(_lm(_ladybug(), jit_loop=True), _new_run("FP32_FP32"))


@pytest.mark.parametrize("precision", ["FP64_FP64", "FP32_FP32"])
def test_lm_matches_jax(precision):
    """The JAX package's LM on the same Ladybug with its block-sparse S
    matvec: the same accept pattern; in float64 chi2 per iteration within
    1e-8 (the README's cross-solver rung). Float32 runs that sum in other
    orders part by ~1e-3 in chi2 after a few steps on this problem, so
    there the accept pattern and a lowered chi2 are compared."""
    ds = jax_synth.make_bal("ladybug", seed=0)
    gj, *_ = jax_build_graph(ds, precision=getattr(gt, precision))
    ref = jax_lm(gj.freeze(), JaxPCGSchur(10, 1.0, 5.0,
                                          dense_matvec_limit=0),
                 options=JaxOptions(iterations=LM_ITERS))
    out = _new_run(precision)
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    assert out.chi2 < out.initial_chi2 and ref.chi2 < ref.initial_chi2
    if precision == "FP64_FP64":
        np.testing.assert_allclose([h["chi2"] for h in out.history],
                                   [h["chi2"] for h in ref.history],
                                   rtol=1e-8)


# ---- plain on every device, no fallback ------------------------------------

def test_k2_k6_plain_versions_never_call_k12(monkeypatch):
    A, b, dinv = _spd_system(64, torch.float32, 5)
    M = torch.diag(dinv)
    k6_args = _k6_plain_args()
    kw = dict(max_iter=10, tol=1e-30, rejection_ratio=5.0)
    x2, k2 = pcg_dense.dense_pcg_plain(A, M, b, **kw)
    x6, k6 = pcg_mf.solve_pcg_mf_plain(*k6_args, **kw)

    def k12_called(*args, **kwargs):
        raise AssertionError("a plain version called a K12 wrapper")

    for entry in ("cg_advance", "cg_commit", "bjs_apply"):
        monkeypatch.setattr(pcg_step, entry, k12_called)
    with pytest.raises(AssertionError, match="K12 wrapper"):
        run_pcg(b, lambda p: A @ p, lambda y: dinv * y, **kw)
    y2, j2 = pcg_dense.dense_pcg_plain(A, M, b, **kw)
    y6, j6 = pcg_mf.solve_pcg_mf_plain(*k6_args, **kw)
    assert int(j2) == int(k2) > 0 and int(j6) == int(k6) > 0
    assert torch.equal(y2, x2) and torch.equal(y6, x6)


def test_wrappers_raise_off_the_cpu():
    v = torch.empty(9, device="meta")
    s = torch.empty((), device="meta")
    segs = PoseSegments((("cams", 0, 1, 9),), 9)
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        pcg_step.bjs_apply(v, s, {"cams": torch.empty((1, 81),
                                                      device="meta")}, segs)
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        pcg_step.cg_advance(v, v, v, v, s, s, v, v)
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        pcg_step.cg_commit(v, v, v, v, v, v, v, s, s, s, s, s, s, 5.0,
                           1.0)
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        schur_w.hll_solve(torch.empty((4, 9), device="meta"), None,
                          torch.empty((4, 3), device="meta"))
