"""The port's direct solvers vs the JAX package's, float64 on the CPU, each
package on its own frozen copy of the same problem:

- the full symmetric Hessian's exports (``csc_values`` with its CSC
  structure, ``dense_hessian_matrix``, ``hessian_to_dense``) to 1e-12
  relative to the largest entry, on BAL ``mini`` with and without point
  elimination and on a 50-pose SE3 sphere;
- one damped ``solve()`` of every solver on every branch to 1e-10:
  ``DenseCholeskySolver``, ``DenseCholeskySchurSolver``,
  ``SparseDirectSolver`` (host ``splu``, ``on_device=True``,
  ``multifrontal=True``) and ``SparseDirectSchurSolver`` (dense S,
  ``on_device_dim_p=0``); where the JAX package takes its recursive
  ``blocked_cholesky`` (1,024 columns and more) to 1e-8, the cross-solver
  rung of the tolerance ladder;
- five Levenberg-Marquardt iterations with each: the same accept pattern
  and chi2 per iteration to 1e-9;
- a failed factorization: on an indefinite damped system (negative
  identity damping) every Cholesky branch gives ``ok=False`` and a zero
  delta, as the JAX package's ``ok`` does, and the LM loop rejects every
  step; on a singular (all-zero) system every branch, the host ``splu``
  ones included, gives ``ok=False`` and a zero delta. (An LU factors an
  indefinite matrix, so the host branches fail only on a singular one, in
  both packages.)
"""

import dataclasses

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu import solvers as jax_solvers
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import g2o as jax_g2o
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.linearize import linearize as jax_linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import solvers as torch_solvers
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import g2o as torch_g2o
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize as torch_linearize
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)

torch.set_num_threads(1)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def _bal(eliminate, size="mini"):
    ds = jax_synth.make_bal(size, seed=2)
    gj, *_ = jax_bal.build_graph(ds, precision=gt.FP64_FP64,
                                 eliminate_points=eliminate)
    gp, *_ = torch_bal.build_graph(ds, precision=gtt.FP64_FP64,
                                   eliminate_points=eliminate)
    return gj.freeze(), gp.freeze(device="cpu")


def _sphere(n):
    gj, *_ = jax_g2o.build_graph(jax_synth.make_sphere_se3(n, seed=0),
                                 precision=gt.FP64_FP64)
    gp, *_ = torch_g2o.build_graph(torch_synth.make_sphere_se3(n, seed=0),
                                   precision=gtt.FP64_FP64)
    return gj.freeze(), gp.freeze(device="cpu")


PROBLEMS = {
    "bal_schur": lambda: _bal(True),
    "bal_full": lambda: _bal(False),
    "sphere50": lambda: _sphere(50),
    # 1,194 columns: the JAX package's on-device branch takes its
    # blocked Cholesky
    "sphere200": lambda: _sphere(200),
    # dim_p = 1,035: the JAX package's dense Schur branch takes its
    # blocked Cholesky
    "bal_wide": lambda: _bal(True, (115, 300, 1400)),
}


def _damped(pj, pp, damping=1e-3):
    lj = jax_linearize(pj, pj.params0)
    lp = torch_linearize(pp, pp.params0)
    hsj = jax_hessian.build_hessian_structure(pj)
    hsp = torch_hessian.build_hessian_structure(pp)
    hvj = jax_hessian.apply_damping(
        pj, hsj, jax_hessian.compute_hessian_values(pj, hsj, lj), lj.diag,
        damping, False)
    hvp = torch_hessian.apply_damping(
        pp, hsp, torch_hessian.compute_hessian_values(pp, hsp, lp), lp.diag,
        damping, False)
    return hsj, hvj, hsp, hvp


@pytest.mark.parametrize("case", ["bal_schur", "bal_full", "sphere50"])
def test_hessian_exports_match_jax(case):
    pj, pp = PROBLEMS[case]()
    hsj, hvj, hsp, hvp = _damped(pj, pp)
    jax_hessian.ensure_csc_structure(pj, hsj)
    assert torch_hessian.ensure_csc_structure(pp, hsp) is hsp
    assert hsp.nnz == hsj.nnz
    np.testing.assert_array_equal(hsp.csc_indptr, hsj.csc_indptr)
    np.testing.assert_array_equal(hsp.csc_indices, hsj.csc_indices)
    for key in hsj.group_keys:
        np.testing.assert_array_equal(hsp.csc_dst[key], hsj.csc_dst[key])
        np.testing.assert_array_equal(hsp.csc_dst_t[key], hsj.csc_dst_t[key])
    _close(torch_hessian.csc_values(pp, hsp, hvp).numpy(),
           jax_hessian.csc_values(pj, hsj, hvj), 1e-12)
    dense = torch_hessian.dense_hessian_matrix(pp, hsp, hvp).numpy()
    _close(dense, jax_hessian.dense_hessian_matrix(pj, hsj, hvj), 1e-12)
    oracle = torch_hessian.hessian_to_dense(pp, hsp, hvp)
    _close(oracle, jax_hessian.hessian_to_dense(pj, hsj, hvj), 1e-12)
    _close(dense, oracle, 1e-12)


# (name, port solver, JAX solver, problems)
BRANCHES = [
    ("dense", torch_solvers.DenseCholeskySolver(),
     jax_solvers.DenseCholeskySolver(), ["bal_full", "sphere50"]),
    ("dense_schur", torch_solvers.DenseCholeskySchurSolver(),
     jax_solvers.DenseCholeskySchurSolver(), ["bal_schur", "bal_wide"]),
    ("sparse_host", torch_solvers.SparseDirectSolver(),
     jax_solvers.SparseDirectSolver(), ["bal_full", "sphere50"]),
    ("sparse_on_device", torch_solvers.SparseDirectSolver(on_device=True),
     jax_solvers.SparseDirectSolver(on_device=True),
     ["bal_full", "sphere50", "sphere200"]),
    ("sparse_nd", torch_solvers.SparseDirectSolver(multifrontal=True),
     jax_solvers.SparseDirectSolver(multifrontal=True),
     ["bal_full", "sphere50"]),
    ("sparse_schur", torch_solvers.SparseDirectSchurSolver(),
     jax_solvers.SparseDirectSchurSolver(), ["bal_schur", "bal_wide"]),
    ("sparse_schur_host",
     torch_solvers.SparseDirectSchurSolver(on_device_dim_p=0),
     jax_solvers.SparseDirectSchurSolver(on_device_dim_p=0), ["bal_schur"]),
]
SOLVES = [(name, case) for name, _, _, cases in BRANCHES for case in cases]
SOLVERS = {name: (tp, jx) for name, tp, jx, _ in BRANCHES}
# problems on which the JAX branch factors with blocked_cholesky
BLOCKED = {"sphere200", "bal_wide"}


def _solve_pair(name, pj, pp, damping, use_identity):
    tp, jx = SOLVERS[name]
    lj = jax_linearize(pj, pj.params0)
    lp = torch_linearize(pp, pp.params0)
    dj, okj = jx.solve(pj, lj, jx.prepare(pj, lj), damping, use_identity)
    dp, okp = tp.solve(pp, lp, tp.prepare(pp, lp), damping, use_identity)
    assert okp.dtype == torch.bool and okp.device == pp.device
    return np.asarray(dj)[: pj.dim_h], bool(okj), dp, bool(okp)


@pytest.mark.parametrize("name,case", SOLVES)
def test_solve_matches_jax(name, case):
    pj, pp = PROBLEMS[case]()
    dj, okj, dp, okp = _solve_pair(name, pj, pp, 1e-3, False)
    assert okj and okp
    assert dp.shape == (pp.dim_x,) and dp.dtype == torch.float64
    assert not dp[pp.dim_h:].any()
    _close(dp[: pp.dim_h].numpy(), dj, 1e-8 if case in BLOCKED else 1e-10)


LM_CASES = [(name, cases[0]) for name, _, _, cases in BRANCHES]


@pytest.mark.parametrize("name,case", LM_CASES)
def test_lm_trajectory_matches_jax(name, case):
    tp, jx = SOLVERS[name]
    pj, pp = PROBLEMS[case]()
    ref = jax_lm(pj, jx, options=JaxOptions(iterations=5))
    out = levenberg_marquardt(pp, tp,
                              options=LevenbergMarquardtOptions(iterations=5))
    assert len(out.history) == len(ref.history) == 5
    assert ([h["accepted"] for h in out.history]
            == [h["accepted"] for h in ref.history])
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9)
    assert out.chi2 < out.initial_chi2


CHOLESKY = [(name, cases[0]) for name, _, _, cases in BRANCHES
            if name not in ("sparse_host", "sparse_schur_host")]


@pytest.mark.parametrize("name,case", CHOLESKY)
def test_indefinite_system_fails_and_lm_rejects(name, case):
    pj, pp = PROBLEMS[case]()
    # the Jacobi-scaled diagonal is ~1: H - 10 I is indefinite
    dj, okj, dp, okp = _solve_pair(name, pj, pp, -10.0, True)
    assert not okj and not okp
    assert not dp.any()
    tp, jx = SOLVERS[name]
    opts = dict(iterations=3, initial_damping=-10.0, use_identity=True)
    ref = jax_lm(pj, jx, options=JaxOptions(**opts))
    out = levenberg_marquardt(pp, tp,
                              options=LevenbergMarquardtOptions(**opts))
    assert [h["accepted"] for h in out.history] == [False] * 3
    assert [h["accepted"] for h in ref.history] == [False] * 3
    assert out.chi2 == out.initial_chi2
    for key, p in out.params.items():
        assert torch.equal(p, pp.params0[key])


@pytest.mark.parametrize("name", [name for name, *_ in BRANCHES])
def test_singular_system_fails(name):
    tp, _ = SOLVERS[name]
    _, pp = PROBLEMS[dict(SOLVES)[name]]()
    lin = torch_linearize(pp, pp.params0)
    state = tp.prepare(pp, lin)

    def zeros(v):
        if isinstance(v, dict):
            return {k: torch.zeros_like(x) for k, x in v.items()}
        return torch.zeros_like(v)

    state = type(state)(**{f.name: zeros(getattr(state, f.name))
                           for f in dataclasses.fields(state)})
    lin = dataclasses.replace(lin, diag=torch.zeros_like(lin.diag))
    delta, ok = tp.solve(pp, lin, state, 0.0, False)
    assert not bool(ok)
    assert not delta.any()
