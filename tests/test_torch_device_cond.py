"""The port's device-side control flow under ``jit_loop``
(``ops/device_loop.cond``) on the CPU, where a region is its plain
version, ``if bool(pred): body()``:

- ``cond`` runs the body exactly when the predicate is true, nested
  regions too, inside the device-controlled iteration as outside it;
  ``while_loop`` runs it while its predicate holds, no time where it
  starts false, a ``cond`` nested in it too;
- a BAL run with rejected and accepted steps (synthetic "mini", seed 2,
  its start perturbed further, damping 1e-4, float64): the device loop's
  history, parameters and iteration count bitwise the host loop's, and
  the JAX package's ``jit_loop`` run within the tolerances of
  ``test_torch_lm_options.py`` (chi2 1e-9, mu and rho 1e-6; chi2 1e-7 on
  the dense Schur path, whose float64 factorizations part by ~1.4e-8
  here);
- the accepted branch is skipped on a rejected iteration: ``linearize``
  and ``solver.prepare`` run only in accepted iterations, and after LM2's
  stop no iteration runs at all;
- ``run_pcg_fixed`` runs as many CG steps (matvecs) as ``run_pcg``'s step
  count, not ``max_iter``, alone and inside the device loop.

The captured regions (conditional graph nodes) run on the card:
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.solvers import DenseCholeskySchurSolver as JaxDenseSchur
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.ops import device_loop
from graphite_tpu_torch.ops.pcg_loop import run_pcg, run_pcg_fixed
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
    levenberg_marquardt2,
)
from graphite_tpu_torch.optimizers import lm as lm_module
from graphite_tpu_torch.schur import SchurOps
from graphite_tpu_torch.solvers import DenseCholeskySchurSolver, PCGSchurSolver

torch.set_num_threads(1)

# a start far enough from the solution that LM rejects steps: the pattern
# at damping 1e-4 is accept, five rejects, five accepts, a reject
BAL = dict(seed=2, perturb_points=0.5, perturb_cams=0.1)
DAMPING = 1e-4
ITERS = 12


def _flag(value):
    return torch.tensor(value)


@pytest.mark.parametrize("value", [True, False])
def test_cond_runs_the_body_when_true(value):
    runs = []
    device_loop.cond(_flag(value), lambda: runs.append(1))
    assert runs == ([1] if value else [])


@pytest.mark.parametrize("outer,inner", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_cond_nests(outer, inner):
    x = torch.zeros(3)

    def body():
        x.add_(1)
        device_loop.cond(_flag(inner), lambda: x.mul_(10))

    with device_loop.enabled():  # the device-controlled iteration, uncaptured
        device_loop.cond(_flag(outer), body)
    expect = (10.0 if inner else 1.0) if outer else 0.0
    assert x.tolist() == [expect] * 3


@pytest.mark.parametrize("n", [0, 1, 7])
@pytest.mark.parametrize("inside", [False, True])
def test_while_loop_runs_the_body_while_true(n, inside):
    k = torch.zeros((), dtype=torch.int64)
    runs, odd = [], []

    def body():
        runs.append(int(k))
        device_loop.cond(k % 2 == 1, lambda: odd.append(int(k)))
        k.add_(1)

    with device_loop.enabled() if inside else contextlib.nullcontext():
        device_loop.while_loop(lambda: k < n, body)
    assert runs == list(range(n))
    assert odd == list(range(1, n, 2))


def _pattern(res):
    return [h["accepted"] for h in res.history]


# (JAX solver, port solver, chi2 tolerance against the JAX package): the
# dense Schur path factors the damped S, near-singular along the bundle's
# gauge directions, and the two packages' float64 factorizations part by
# ~1.4e-8 on this start (test_torch_lm_options.py notes the same below
# damping ~1e-7)
SOLVERS = {
    "pcg-schur": (lambda: JaxPCGSchur(10, 1.0, 5.0),
                  lambda: PCGSchurSolver(10, 1.0, 5.0), 1e-9),
    "dense-schur": (JaxDenseSchur, DenseCholeskySchurSolver, 1e-7),
}


def _torch_problem():
    g, *_ = torch_bal_io.build_graph(torch_synth.make_bal("mini", **BAL),
                                     precision=gtt.FP64_FP64)
    return g.freeze(device="cpu")


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_rejects_bitwise_host_loop_and_jax(name):
    jax_solver, torch_solver, rtol = SOLVERS[name]
    problem, solver = _torch_problem(), torch_solver()
    opts = dict(iterations=ITERS, initial_damping=DAMPING)
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        jit_loop=True, **opts))
    assert True in _pattern(host) and False in _pattern(host)
    assert _pattern(out) == _pattern(host)
    for key in ("chi2", "mu", "rho", "chi2_before"):
        assert [h[key] for h in out.history] == [h[key] for h in host.history]
    assert (out.iterations, out.accepted_steps, out.chi2, out.mu) == (
        host.iterations, host.accepted_steps, host.chi2, host.mu)
    for n, p in host.params.items():
        assert torch.equal(out.params[n], p)

    gj, *_ = jax_build_graph(jax_synth.make_bal("mini", **BAL),
                             precision=gt.FP64_FP64)
    ref = jax_lm(gj.freeze(), jax_solver(), options=JaxOptions(
        jit_loop=True, **opts))
    assert _pattern(out) == _pattern(ref)
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=rtol)
    for key in ("mu", "rho"):
        np.testing.assert_allclose([h[key] for h in out.history],
                                   [h[key] for h in ref.history], rtol=1e-6)


def _count_accept_branch(monkeypatch, solver_cls):
    """Patch ``try_step``, ``linearize`` (as the LM module calls them) and
    the solver's ``prepare`` to record the device loop's iteration (its
    ``k``) at each call inside an iteration; returns the list of
    (function, iteration) calls of ``linearize`` and ``prepare``, and the
    iterations whose step ran."""
    calls, ran = [], []
    loops = []
    real_step = lm_module._DeviceLoop._step
    real_try_step = lm_module.try_step
    real_linearize = lm_module.linearize
    real_prepare = solver_cls.prepare

    def step(self):
        loops.append(self)
        try:
            real_step(self)
        finally:
            loops.pop()

    def try_step(*args, **kwargs):
        if loops:
            ran.append(int(loops[-1].k))
        return real_try_step(*args, **kwargs)

    def linearize(*args, **kwargs):
        if loops:
            calls.append(("linearize", int(loops[-1].k)))
        return real_linearize(*args, **kwargs)

    def prepare(self, *args, **kwargs):
        if loops:
            calls.append(("prepare", int(loops[-1].k)))
        return real_prepare(self, *args, **kwargs)

    monkeypatch.setattr(lm_module._DeviceLoop, "_step", step)
    monkeypatch.setattr(lm_module, "try_step", try_step)
    monkeypatch.setattr(lm_module, "linearize", linearize)
    monkeypatch.setattr(solver_cls, "prepare", prepare)
    return calls, ran


def test_rejected_iteration_skips_the_accepted_branch(monkeypatch):
    problem, solver = _torch_problem(), PCGSchurSolver(10, 1.0, 5.0)
    opts = LevenbergMarquardtOptions(jit_loop=True, iterations=ITERS,
                                     initial_damping=DAMPING)
    levenberg_marquardt(problem, solver, options=opts)  # builds the loop
    calls, ran = _count_accept_branch(monkeypatch, PCGSchurSolver)
    out = levenberg_marquardt(problem, solver, options=opts)
    accepted = [i for i, a in enumerate(_pattern(out)) if a]
    assert 0 < len(accepted) < ITERS
    assert ran == list(range(ITERS))
    assert calls == [(fn, i) for i in accepted
                     for fn in ("linearize", "prepare")]


def test_no_iteration_runs_after_lm2_stops(monkeypatch):
    g, *_ = torch_bal_io.build_graph(torch_synth.make_bal("mini", seed=2),
                                     precision=gtt.FP64_FP64)
    problem, solver = g.freeze(device="cpu"), PCGSchurSolver(10, 1.0, 5.0)
    opts = LevenbergMarquardtOptions(jit_loop=True, iterations=30)
    levenberg_marquardt2(problem, solver, options=opts)  # builds the loop
    calls, ran = _count_accept_branch(monkeypatch, PCGSchurSolver)
    out = levenberg_marquardt2(problem, solver, options=opts)
    host = levenberg_marquardt2(problem, solver,
                                options=LevenbergMarquardtOptions(
                                    iterations=30))
    assert out.iterations == host.iterations < 30
    assert ran == list(range(out.iterations))
    assert {i for _, i in calls} == {
        i for i, a in enumerate(_pattern(out)) if a}
    assert [h["chi2"] for h in out.history] == [
        h["chi2"] for h in host.history]


def _spd(n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    A = A @ A.T + 0.05 * n * np.eye(n)
    return (torch.tensor(A, dtype=dtype),
            torch.tensor(rng.normal(size=n), dtype=dtype),
            torch.tensor(1.0 / np.diag(A), dtype=dtype))


# (n, seed, dtype, max_iter, tol, rejection_ratio)
PCG_CASES = {
    "converges": (40, 0, torch.float64, 60, 1e-12, 5.0),
    "max_iter": (60, 1, torch.float32, 12, 1e-30, 5.0),
    "rejects": (60, 2, torch.float32, 40, 1e-30, 1.0),
    "zero_rhs": (16, 3, torch.float64, 10, 1e-6, 5.0),
}


@pytest.mark.parametrize("case", sorted(PCG_CASES))
def test_cg_steps_run_equal_run_pcg_steps(case):
    n, seed, dtype, max_iter, tol, ratio = PCG_CASES[case]
    A, b, dinv = _spd(n, seed, dtype)
    if case == "zero_rhs":
        b = torch.zeros_like(b)
    matvecs = []

    def matvec(p):
        matvecs.append(1)
        return A @ p

    _, k_ref = run_pcg(b, matvec, lambda y: dinv * y, max_iter, tol, ratio)
    matvecs.clear()
    x, k = run_pcg_fixed(b, matvec, lambda y: dinv * y, max_iter, tol, ratio)
    assert len(matvecs) == int(k) == k_ref
    assert (k_ref == max_iter) == (case == "max_iter")


def test_cg_steps_in_the_device_loop(monkeypatch):
    """The block-sparse S matvec (``run_pcg_fixed`` under ``jit_loop``):
    the device loop runs the host loop's CG steps, fewer than
    ``max_iter`` per solve."""
    problem = _torch_problem()
    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    matvecs = []
    real = SchurOps.s_matvec

    def s_matvec(self, p):
        matvecs.append(1)
        return real(self, p)

    monkeypatch.setattr(SchurOps, "s_matvec", s_matvec)
    opts = dict(iterations=6, initial_damping=DAMPING)
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    host_steps = len(matvecs)
    matvecs.clear()
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        jit_loop=True, **opts))
    assert [h["chi2"] for h in out.history] == [
        h["chi2"] for h in host.history]
    # the device loop's first call also runs no CG step outside its
    # iterations (its static state is built by linearize and prepare)
    assert len(matvecs) == host_steps < 6 * solver.max_iter
