"""Factor-parallel sharding of the port (``graphite_tpu_torch.parallel``)
against the JAX package's (``tests/test_sharding.py``): 8 gloo ranks on
the CPU, each a spawned process (``run_ranks``), against the JAX
package's 8-device virtual CPU mesh, on the same frozen problems, with
``test_sharding.py``'s tolerances:

- padding is neutral (chi2 1e-14, b 1e-13);
- the sharded linearization (chi2 1e-13, b and the diagonal 1e-12);
- one LM step with PCGSolver and with PCGSchurSolver (1e-6);
- a full LM run (chi2 1e-9, the same iterations and accepted steps);
- the float64 S values of the sharded Schur stage (1e-12 / 1e-13);
- the (10, 400, 3000) float32 destination-partitioned S at (2e-4, 1e-3),
  here through K3's gathered-stream entry (its plain version on the CPU);
- LM on a larger problem for 5 iterations (chi2 1e-8);
- ``jit_loop`` (the device loop on every rank) against the JAX package's
  ``sharded_lm(..., with_trace=True)``: mini with PCGSchurSolver (chi2
  and each trace row's chi2 1e-9), the larger problem (1e-8) and mini with
  PCGSolver and block-Jacobi, whose collective sits inside the CG loop
  (1e-9); the same iterations, accepted steps and accept flags.

The step and the float32 partition are held against the JAX package's
single-device results, as ``test_sharding.py`` holds its own sharded
runs: its sharded step and its interpret-mode kernel cost a minute of
compiling. ``test_sharding.py``'s bf16-stream case has no counterpart:
the port has no ``stream_dtype`` (left out with the precision policies).

The port's own invariants: world size 1 is bitwise the unsharded run;
all ranks hold bitwise the same results; two runs are bitwise equal; each
product group's partition gives no rank more than 2K/n pairs, in disjoint
destination ranges in rank order; ``jit_loop`` is bitwise the same ranks'
host loop (trace and parameters).
"""

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
import torch_sharding_helpers as helpers
from graphite_tpu.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.linearize import apply_update, compute_chi2, linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions
from graphite_tpu.parallel import (
    make_mesh,
    shard_data,
    sharded_linearize_fn,
    sharded_lm,
)
from graphite_tpu.preconditioners import BlockJacobiPreconditioner
from graphite_tpu.schur import build_schur_structure, schur_values
from graphite_tpu.solvers import PCGSchurSolver, PCGSolver
from graphite_tpu_torch.interop import params_to_numpy
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import linearize as torch_linearize
from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions as TOpts
from graphite_tpu_torch.optimizers import levenberg_marquardt as torch_lm
from graphite_tpu_torch.parallel import run_ranks

torch.set_num_threads(1)

N = 8
MINI = ("mini", 0)
BIG32 = ((10, 400, 3000), 5)
NONMINI = ((8, 60, 300), 3)


def _jax_problem(size, seed, precision, pad=N):
    g, *_ = jax_bal.build_graph(jax_synth.make_bal(size, seed=seed,
                                                   noise=0.5),
                                precision=precision)
    return g.freeze(pad_factors_to=pad)


def _torch_problem(size, seed, precision, pad=N):
    g, *_ = torch_bal.build_graph(torch_synth.make_bal(size, seed=seed,
                                                       noise=0.5),
                                  precision=precision)
    return g.freeze(device="cpu", pad_factors_to=pad)


@pytest.fixture(scope="module")
def mesh():
    import jax

    assert len(jax.devices()) >= N
    return make_mesh(N)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of ``helpers.parity_tasks``."""
    return run_ranks(helpers.parity_tasks, N, "gloo",
                     _torch_problem(*MINI, gtt.FP64_FP64),
                     _torch_problem(*BIG32, gtt.FP32_FP32),
                     _torch_problem(*NONMINI, gtt.FP64_FP64), device="cpu")


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_padding_is_neutral():
    p1 = _torch_problem(*MINI, gtt.FP64_FP64, pad=1)
    p8 = _torch_problem(*MINI, gtt.FP64_FP64)
    assert p8.factor_meta["bal_reprojection"].count % N == 0
    assert p8.factor_meta["bal_reprojection"].count > p1.factor_meta[
        "bal_reprojection"].count
    l1 = torch_linearize(p1, p1.params0)
    l8 = torch_linearize(p8, p8.params0)
    _close(float(l8.chi2), float(l1.chi2), 1e-14)
    _close(l8.b, l1.b, 1e-13, 1e-14)
    import jax

    jp = _jax_problem(*MINI, gt.FP64_FP64)
    lj = jax.jit(lambda params: linearize(jp, params))(jp.params0)
    _close(float(l8.chi2), float(lj.chi2), 1e-13)
    _close(l8.b, lj.b, 1e-12, 1e-13)


def test_sharded_linearize_matches(mesh, ranks):
    problem = _jax_problem(*MINI, gt.FP64_FP64)
    chi2, b, scales, diag = sharded_linearize_fn(problem, mesh)(
        shard_data(problem, mesh), problem.params0)
    out = ranks[0]["linearize"]
    _close(out["chi2"], float(chi2), 1e-13)
    _close(out["b"], b, 1e-12, 1e-13)
    _close(out["diag"], diag, 1e-12, 1e-13)
    _close(out["scales"], scales, 1e-12, 1e-13)


@pytest.mark.parametrize("kind", ["pcg", "pcg-schur"])
def test_sharded_step_matches_single_device(ranks, kind):
    problem = _jax_problem(*MINI, gt.FP64_FP64)
    if kind == "pcg":
        solver = PCGSolver(max_iter=30, tol=1e-12, rejection_ratio=1e6,
                           preconditioner=BlockJacobiPreconditioner())
    else:
        solver = PCGSchurSolver(max_iter=30, tol=1e-12, rejection_ratio=1e6)
    import jax

    def step(params):
        lin = linearize(problem, params)
        sstate = solver.prepare(problem, lin, params)
        delta, _ = solver.solve(problem, lin, sstate, helpers.STEP_MU, False,
                                params)
        new = apply_update(problem, params, lin, delta)
        return lin.chi2, new, compute_chi2(problem, new)

    chi2, ref_params, ref_chi2 = jax.jit(step)(problem.params0)
    out = ranks[0]["step", kind]
    _close(out["chi2_before"], float(chi2), 1e-13)
    _close(out["chi2_after"], float(ref_chi2), 1e-6)
    for k, v in ref_params.items():
        _close(out["params"][k], v, 1e-6, 1e-7)


def test_sharded_full_lm_matches(mesh, ranks):
    problem = _jax_problem(*MINI, gt.FP64_FP64)
    params, chi2, iters, accepted = sharded_lm(
        problem, mesh, PCGSchurSolver(max_iter=10, tol=1.0,
                                      rejection_ratio=5.0),
        LevenbergMarquardtOptions(iterations=10, initial_damping=1e-4))
    out = ranks[0]["lm"]
    _close(out["chi2"], float(chi2), 1e-9)
    assert out["iterations"] == int(iters)
    assert out["accepted"] == int(accepted)


def _jax_schur(problem, mesh=None):
    """S values of ``problem`` at damping 1e-3: single-device, or on the
    mesh as ``test_sharding.py`` runs it."""
    import jax
    from jax.sharding import PartitionSpec as P

    from graphite_tpu.parallel.sharding import data_specs, shard_map

    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)

    def values(p, params):
        lin = linearize(p, params)
        hv = apply_damping(p, hs, compute_hessian_values(p, hs, lin),
                           lin.diag, helpers.STEP_MU, False)
        return schur_values(p, ss, hv).s_vals

    ref = jax.jit(lambda params: values(problem, params))(problem.params0)
    if mesh is None:
        return ref

    def local(data, params):
        return values(problem.shard_replica(data, "factors", n_devices=N),
                      params)

    f = jax.jit(shard_map(
        local, mesh,
        in_specs=(data_specs(problem),
                  jax.tree.map(lambda _: P(), problem.params0)),
        out_specs=jax.tree.map(lambda _: P(), ref)))
    return f(shard_data(problem, mesh), problem.params0)


def test_sharded_schur_values_match_single_device(mesh, ranks):
    s_vals = _jax_schur(_jax_problem(*MINI, gt.FP64_FP64), mesh)
    out = ranks[0]["schur64"]["s_vals"]
    assert out.keys() == s_vals.keys()
    for k, v in s_vals.items():
        _close(out[k], v, 1e-12, 1e-13)


def test_sharded_schur_dst_partition_streaming(ranks):
    """The destination-partitioned stage in float32: each rank reduces
    its segment-aligned slice from gathered streams (K3's entry) and one
    gather places the disjoint ranges. (No bf16 counterpart: the port has
    no ``stream_dtype``.)"""
    s_ref = _jax_schur(_jax_problem(*BIG32, gt.FP32_FP32))
    out = ranks[0]["schur32"]
    for k, v in s_ref.items():
        _close(out["s_vals"][k], v, 2e-4, 1e-3)
    assert out["partitions"], "no destination partition was built"
    for part in out["partitions"]:
        rows = np.diff(part["bounds"])
        K = rows.sum()
        assert rows.max() <= 2 * K / N
        assert (rows > 0).sum() >= N - 1
        seg0, ns = np.asarray(part["seg0"]), np.asarray(part["ns"])
        live = ns > 0
        assert np.all(np.diff(seg0[live]) > 0)
        assert np.all(seg0[live][1:] >= (seg0 + ns)[live][:-1])


def test_sharded_lm_multi_iteration_nonmini(mesh, ranks):
    problem = _jax_problem(*NONMINI, gt.FP64_FP64)
    params, chi2, iters, accepted = sharded_lm(
        problem, mesh, PCGSchurSolver(max_iter=20, tol=1e-10,
                                      rejection_ratio=1e6),
        LevenbergMarquardtOptions(iterations=5, initial_damping=1e-4))
    out = ranks[0]["nonmini"]
    assert out["iterations"] >= 3
    assert out["iterations"] == int(iters)
    _close(out["chi2"], float(chi2), 1e-8)


def _same(a, b, where=""):
    """Bitwise equality of two nested task results."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


def test_ranks_bitwise_equal(ranks):
    """Every rank reads the same sums: the same results, bit for bit
    (the partitions are each rank's view of one plan)."""
    for r in range(1, N):
        _same(ranks[r], ranks[0], f"rank {r}")


def test_two_runs_bitwise_equal(ranks):
    _same(ranks[0]["lm_again"], ranks[0]["lm"])
    assert ranks[0]["lm"]["iterations"] == 10


def _jax_lm_solver(case):
    if case == "pcg-block-jacobi":
        return PCGSolver(max_iter=30, tol=1e-12, rejection_ratio=1e6,
                         preconditioner=BlockJacobiPreconditioner())
    if case == "nonmini":
        return PCGSchurSolver(max_iter=20, tol=1e-10, rejection_ratio=1e6)
    return PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)


# case -> (problem, chi2 tolerance)
JIT_CASES = {"mini": (MINI, 1e-9), "nonmini": (NONMINI, 1e-8),
             "pcg-block-jacobi": (MINI, 1e-9)}


@pytest.mark.parametrize("case", list(JIT_CASES))
def test_sharded_jit_loop_matches_jax(mesh, ranks, case):
    """``sharded_lm(jit_loop=True)`` on 8 ranks against the JAX package's
    ``sharded_lm`` (the whole LM ``while_loop`` in one program on its
    8-device mesh), trace row by row."""
    size, rtol = JIT_CASES[case]
    problem = _jax_problem(*size, gt.FP64_FP64)
    params, chi2, iters, accepted, trace = sharded_lm(
        problem, mesh, _jax_lm_solver(case),
        LevenbergMarquardtOptions(
            iterations=helpers.LM_ITERATIONS[case], initial_damping=1e-4),
        with_trace=True)
    out = ranks[0]["graph"][case]
    _close(out["chi2"], float(chi2), rtol)
    assert out["iterations"] == int(iters)
    assert out["accepted"] == int(accepted)
    trace = np.asarray(trace)
    k = int(iters)
    _close(out["trace"][:k, 0], trace[:k, 0], rtol)
    assert out["trace"][:k, 3].tolist() == trace[:k, 3].tolist()


@pytest.mark.parametrize("case", list(JIT_CASES))
def test_sharded_jit_loop_bitwise_host_loop(ranks, case):
    """The device loop on every rank takes the host loop's steps bit for
    bit: the trace and the final parameters."""
    host = {"mini": "lm", "nonmini": "nonmini",
            "pcg-block-jacobi": "pcg-block-jacobi"}[case]
    graph, loop = ranks[0]["graph"][case], ranks[0][host]
    assert graph["iterations"] >= 3
    _same(graph, loop)


def test_world1_bitwise_unsharded():
    """One rank over gloo: bitwise the unsharded linearization and LM
    run (the collectives sum one term)."""
    problem = _torch_problem(*MINI, gtt.FP64_FP64)
    (out,) = run_ranks(helpers.world1_tasks, 1, "gloo", problem,
                       device="cpu")
    lin = torch_linearize(problem, problem.params0)
    assert out["linearize"]["chi2"] == float(lin.chi2)
    assert np.array_equal(out["linearize"]["b"], lin.b.numpy())
    assert np.array_equal(out["linearize"]["diag"], lin.diag.numpy())
    ref = torch_lm(problem, gtt_solver(), options=TOpts(iterations=10))
    trace = out["lm"]["trace"]
    assert out["lm"]["iterations"] == ref.iterations
    assert trace[:, 0].tolist() == [h["chi2"] for h in ref.history]
    assert trace[:, 3].tolist() == [float(h["accepted"])
                                    for h in ref.history]
    _same(out["lm"]["params"], params_to_numpy(ref.params))


def gtt_solver():
    from graphite_tpu_torch.solvers import PCGSchurSolver as TorchPCGSchur

    return TorchPCGSchur(10, 1.0, 5.0)
