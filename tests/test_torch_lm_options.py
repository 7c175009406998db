"""The port's Levenberg-Marquardt options vs the JAX package, on the CPU in
float64:

- LM2 (``levenberg_marquardt2``) on the circle: the same stop iteration
  and chi2 per iteration to 1e-9 (relative, or of the initial chi2 where
  chi2 has fallen to rounding noise), in the host loop and under
  ``jit_loop``;
- ``stop_flag`` ends the host loop where the JAX package's does;
- ``verbose``: the same header and as many rows as the JAX package
  prints, in both modes;
- ``profile_dir`` writes a Chrome trace;
- ``jit_loop=True`` on synthetic BAL "mini" (seed 2, the problem of
  ``test_torch_direct_solvers``) with PCG-Schur and dense Schur: the JAX
  package's accept pattern and chi2 per iteration to 1e-9 over 5
  iterations, as there (the damped S is near-singular along the bundle's
  gauge directions: at noise 0.5, or once the damping falls below ~1e-7,
  the two packages' float64 dense solves part by more than 1e-9), and
  over 15 iterations bitwise the port's own host loop (the device-
  controlled iteration runs uncaptured on the CPU, the plain version of
  the CUDA graph);
- one cached device loop serves calls with other iteration counts,
  initial damping and ``verbose``, each bitwise its own host loop;
- the same bitwise equality on every other solver branch: the
  block-sparse S matvec, the host ``splu`` branches (``host_call``), the
  multifrontal factorization, K6's plain version and the generic
  matrix-free PCG (``run_pcg_fixed`` on ``hessian_matvec``);
- ``run_pcg_fixed`` bitwise ``run_pcg`` on seeded SPD systems, with a
  rejected step, convergence and rz == 0.
"""

import json
import os

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.optimizers import levenberg_marquardt2 as jax_lm2
from graphite_tpu.solvers import DenseCholeskySchurSolver as JaxDenseSchur
from graphite_tpu.solvers import DenseCholeskySolver as JaxDense
from graphite_tpu.solvers import PCGSchurSolver as JaxPCGSchur
from graphite_tpu_torch.examples import circle
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import g2o
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.ops.cuda import pcg_mf
from graphite_tpu_torch.ops.pcg_loop import run_pcg, run_pcg_fixed
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
    levenberg_marquardt2,
)
from graphite_tpu_torch.optimizers.lm import device_loops
from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
from graphite_tpu_torch.solvers import (
    DenseCholeskySchurSolver,
    DenseCholeskySolver,
    PCGSchurSolver,
    PCGSolver,
    SparseDirectSchurSolver,
    SparseDirectSolver,
)

from common import build_circle_graph

torch.set_num_threads(1)

RNG = np.random.default_rng(42)
ANGLES = RNG.uniform(0, 2 * np.pi, size=5)
PTS = np.stack([4.0 * np.cos(ANGLES) + RNG.normal(0, 0.3, 5),
                4.0 * np.sin(ANGLES) + RNG.normal(0, 0.3, 5)], axis=1)


def torch_circle(points=PTS):
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(circle.POINT2)
    for i, p in enumerate(points):
        vs.add(10 + i, p)
    fs = g.add_factor_set(circle.circle_factor(auto_diff=True))
    for i in range(len(points)):
        fs.add([10 + i], obs=4.0)
    return g.freeze(device="cpu")


def jax_circle():
    g, *_ = build_circle_graph(PTS)
    return g.freeze()


def _chi2s(res):
    return [h["chi2"] for h in res.history]


def _accepts(res):
    return [h["accepted"] for h in res.history]


@pytest.mark.parametrize("jit_loop", [False, True])
def test_lm2_stops_where_jax_does(jit_loop):
    ref = jax_lm2(jax_circle(), JaxDense(), options=JaxOptions(
        iterations=100, initial_damping=1e-6, jit_loop=jit_loop))
    out = levenberg_marquardt2(torch_circle(), DenseCholeskySolver(),
                               options=LevenbergMarquardtOptions(
                                   iterations=100, initial_damping=1e-6,
                                   jit_loop=jit_loop))
    assert out.iterations == ref.iterations < 100
    assert _accepts(out) == _accepts(ref)
    # chi2 falls to ~1e-30 here: the tolerance is 1e-9 of the initial chi2
    atol = 1e-9 * ref.initial_chi2
    np.testing.assert_allclose(_chi2s(out), _chi2s(ref), rtol=1e-9,
                               atol=atol)
    np.testing.assert_allclose(out.chi2, ref.chi2, rtol=1e-9, atol=atol)
    assert out.run_ok == ref.run_ok


def test_stop_flag(capsys):
    calls = {"jax": 0, "torch": 0}

    def flag(key):
        def stop():
            calls[key] += 1
            return calls[key] >= 3
        return stop

    opts = dict(iterations=20, initial_damping=1e-6)
    ref = jax_lm(jax_circle(), JaxDense(), options=JaxOptions(**opts),
                 stop_flag=flag("jax"))
    out = levenberg_marquardt(torch_circle(), DenseCholeskySolver(),
                              options=LevenbergMarquardtOptions(**opts),
                              stop_flag=flag("torch"))
    assert len(out.history) == len(ref.history) == 3
    np.testing.assert_allclose(_chi2s(out), _chi2s(ref), rtol=1e-9)
    lines = capsys.readouterr().out.splitlines()
    assert lines.count("Stopping optimization due to stop flag") == 2


@pytest.mark.parametrize("jit_loop", [False, True])
def test_verbose_table_matches_jax(jit_loop, capsys):
    opts = dict(iterations=12, initial_damping=1e-6, verbose=True,
                jit_loop=jit_loop)
    ref = jax_lm(jax_circle(), JaxDense(), options=JaxOptions(**opts))
    jax_lines = capsys.readouterr().out.splitlines()
    out = levenberg_marquardt(torch_circle(), DenseCholeskySolver(),
                              options=LevenbergMarquardtOptions(**opts))
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == jax_lines[:2]
    assert len(lines) == len(jax_lines) == 2 + len(ref.history)
    assert len(out.history) == len(ref.history)
    for row, h in zip(lines[2:], out.history):
        fields = row.split()
        assert int(fields[0]) == h["iteration"]
        assert float(fields[2]) == pytest.approx(h["chi2"], rel=1e-9)


@pytest.mark.parametrize("jit_loop", [False, True])
def test_zero_iterations(jit_loop):
    problem = torch_circle()
    out = levenberg_marquardt(problem, DenseCholeskySolver(),
                              options=LevenbergMarquardtOptions(
                                  iterations=0, jit_loop=jit_loop))
    assert out.iterations == 0 and out.history == []
    assert out.chi2 == out.initial_chi2
    for n, p in problem.params0.items():
        assert torch.equal(out.params[n], p)


def test_profile_dir_writes_a_trace(tmp_path):
    out = levenberg_marquardt(
        torch_circle(), DenseCholeskySolver(),
        options=LevenbergMarquardtOptions(iterations=3, initial_damping=1e-6,
                                          profile_dir=str(tmp_path)))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert len(out.history) == 3


SOLVERS = {
    "pcg-schur": (lambda: JaxPCGSchur(10, 1.0, 5.0),
                  lambda: PCGSchurSolver(10, 1.0, 5.0)),
    "dense-schur": (JaxDenseSchur, DenseCholeskySchurSolver),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_jit_loop_matches_jax_and_host_loop(name):
    """The port of ``test_bal_e2e.py::test_bal_jit_loop_matches_python_loop``
    against the JAX package's own ``jit_loop``."""
    jax_solver, torch_solver = SOLVERS[name]
    iters = 5
    gj, *_ = jax_build_graph(jax_synth.make_bal("mini", seed=2),
                             precision=gt.FP64_FP64)
    ref = jax_lm(gj.freeze(), jax_solver(), options=JaxOptions(
        iterations=iters, jit_loop=True))
    gp, *_ = torch_bal_io.build_graph(torch_synth.make_bal("mini", seed=2),
                                      precision=gtt.FP64_FP64)
    problem = gp.freeze(device="cpu")
    solver = torch_solver()
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        iterations=iters, jit_loop=True))
    assert _accepts(out) == _accepts(ref)
    np.testing.assert_allclose(_chi2s(out), _chi2s(ref), rtol=1e-9)
    np.testing.assert_allclose(out.initial_chi2, ref.initial_chi2,
                               rtol=1e-9)
    np.testing.assert_allclose([h["chi2_before"] for h in out.history],
                               [h["chi2_before"] for h in ref.history],
                               rtol=1e-9)
    # rho is a ratio of cancelling differences: 1e-6 is what the 1e-10
    # agreement of the two solves leaves of it (and of mu, made from it)
    for key in ("mu", "rho"):
        np.testing.assert_allclose([h[key] for h in out.history],
                                   [h[key] for h in ref.history], rtol=1e-6)

    # bitwise the host loop, over more iterations
    opts = dict(iterations=15)
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        jit_loop=True, **opts))
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    assert _accepts(out) == _accepts(host)
    assert _chi2s(out) == _chi2s(host)
    assert [h["mu"] for h in out.history] == [h["mu"] for h in host.history]
    for n, p in host.params.items():
        assert torch.equal(out.params[n], p)
    assert (out.chi2, out.mu, out.accepted_steps, out.iterations) == (
        host.chi2, host.mu, host.accepted_steps, host.iterations)


def _bal_problem(eliminate=True):
    g, *_ = torch_bal_io.build_graph(torch_synth.make_bal("mini", seed=0),
                                     precision=gtt.FP32_FP32,
                                     eliminate_points=eliminate)
    return g.freeze(device="cpu")


def _pose_problem():
    g, *_ = g2o.build_graph(torch_synth.make_sphere_se3(60, seed=0),
                            precision=gtt.FP32_FP32)
    return g.freeze(device="cpu")


# every solver branch the device-controlled iteration can take
BRANCHES = {
    "pcg-schur-sparse-s": (_bal_problem, lambda: PCGSchurSolver(
        10, 1.0, 5.0, dense_matvec_limit=0)),
    "sparse-schur-host": (_bal_problem, lambda: SparseDirectSchurSolver(
        on_device_dim_p=0)),
    "sparse-host": (lambda: _bal_problem(False), SparseDirectSolver),
    "multifrontal": (_pose_problem,
                     lambda: SparseDirectSolver(multifrontal=True)),
    "pcg-k6": (_pose_problem, lambda: PCGSolver(
        50, 1e-10, 1e6, BlockJacobiPreconditioner())),
    "pcg-generic": (_pose_problem, lambda: PCGSolver(
        50, 1e-10, 1e6, BlockJacobiPreconditioner())),
}


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_jit_loop_bitwise_host_loop_on_every_branch(name, monkeypatch):
    if name == "pcg-generic":  # K6's gate closed: run_pcg_fixed
        monkeypatch.setattr(pcg_mf, "J_BYTES_LIMIT", 0)
    make, solver = BRANCHES[name]
    problem, solver = make(), solver()
    opts = dict(iterations=6)
    host = levenberg_marquardt(problem, solver,
                               options=LevenbergMarquardtOptions(**opts))
    out = levenberg_marquardt(problem, solver, options=LevenbergMarquardtOptions(
        jit_loop=True, **opts))
    assert _chi2s(out) == _chi2s(host) and _accepts(out) == _accepts(host)
    for n, p in host.params.items():
        assert torch.equal(out.params[n], p)
    assert out.chi2 < out.initial_chi2


def test_jit_loop_takes_each_calls_options(capsys):
    """One cached loop serves calls with other iteration counts, initial
    damping and verbosity: each call bitwise its own host loop."""
    problem, solver = _bal_problem(), PCGSchurSolver(10, 1.0, 5.0)
    runs = []
    for iters, damping, verbose in ((4, 1e-4, False), (4, 1e-1, True),
                                    (6, 1e-4, False)):
        opts = dict(iterations=iters, initial_damping=damping)
        host = levenberg_marquardt(problem, solver,
                                   options=LevenbergMarquardtOptions(**opts))
        capsys.readouterr()
        out = levenberg_marquardt(problem, solver,
                                  options=LevenbergMarquardtOptions(
                                      jit_loop=True, verbose=verbose, **opts))
        printed = capsys.readouterr().out.splitlines()
        assert len(printed) == (2 + iters if verbose else 0)
        assert out.iterations == iters
        assert _chi2s(out) == _chi2s(host) and _accepts(out) == _accepts(host)
        assert [h["mu"] for h in out.history] == [
            h["mu"] for h in host.history]
        for n, p in host.params.items():
            assert torch.equal(out.params[n], p)
        runs.append(out)
    assert len(device_loops(problem)) == 1
    assert runs[0].history[0]["mu"] != runs[1].history[0]["mu"]


def _spd(n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    A = A @ A.T + 0.05 * n * np.eye(n)
    return (torch.tensor(A, dtype=dtype),
            torch.tensor(rng.normal(size=n), dtype=dtype),
            torch.tensor(1.0 / np.diag(A), dtype=dtype))


# (n, seed, dtype, max_iter, tol, rejection_ratio, what the run shows)
PCG_CASES = {
    "converges": (40, 0, torch.float64, 60, 1e-12, 5.0),
    "max_iter": (60, 1, torch.float32, 12, 1e-30, 5.0),
    "rejects": (60, 2, torch.float32, 40, 1e-30, 1.0),
    "zero_rhs": (16, 3, torch.float64, 10, 1e-6, 5.0),
}


@pytest.mark.parametrize("case", sorted(PCG_CASES))
def test_run_pcg_fixed_bitwise_run_pcg(case):
    n, seed, dtype, max_iter, tol, ratio = PCG_CASES[case]
    A, b, dinv = _spd(n, seed, dtype)
    if case == "zero_rhs":
        b = torch.zeros_like(b)

    def matvec(p):
        return A @ p

    def precond(y):
        return dinv * y

    x_ref, k_ref = run_pcg(b, matvec, precond, max_iter, tol, ratio)
    x, k = run_pcg_fixed(b, matvec, precond, max_iter, tol, ratio)
    assert int(k) == k_ref
    assert torch.equal(x, x_ref)
    if case == "zero_rhs":
        assert k_ref == 0
    elif case == "max_iter":
        assert k_ref == max_iter
    else:
        assert 0 < k_ref < max_iter
