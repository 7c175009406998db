"""The port's two CLIs on the CPU (``--device cpu``), every ``--solver``
choice: each prints its lines, lowers chi2, and returns the same
``LMResult``, bit for bit, as a direct ``levenberg_marquardt`` call on the
same problem and solver."""

import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch.examples import bal as bal_cli
from graphite_tpu_torch.examples import pose_graph as pose_cli
from graphite_tpu_torch.io import bal as bal_io
from graphite_tpu_torch.io import g2o, synthetic
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
from graphite_tpu_torch.solvers import (
    DenseCholeskySolver,
    PCGSolver,
    SparseDirectSolver,
)

torch.set_num_threads(1)


def _same_result(out, ref):
    assert [h["accepted"] for h in out.history] == [
        h["accepted"] for h in ref.history]
    assert [h["chi2"] for h in out.history] == [h["chi2"] for h in ref.history]
    assert (out.chi2, out.initial_chi2) == (ref.chi2, ref.initial_chi2)
    for name, p in ref.params.items():
        assert torch.equal(out.params[name], p)
    assert out.chi2 < out.initial_chi2


@pytest.mark.parametrize("solver", bal_cli.SOLVERS)
def test_bal_cli(solver, capsys):
    argv = ["--synthetic", "mini", "--iterations", "4", "--solver", solver,
            "--device", "cpu"]
    out = bal_cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Loaded problem: 4 cameras, 50 points, 150")
    assert "iters/sec" in lines[-4]
    assert lines[-3] == f"Final chi2: {out.chi2:.10g}"
    assert lines[-2] == f"MSE: {out.chi2 / 150:.10g}"
    assert lines[-1] == f"Half MSE: {0.5 * out.chi2 / 150:.10g}"

    args = bal_cli.parse_args(argv)
    g, *_ = bal_io.build_graph(synthetic.make_bal("mini", seed=0),
                               precision=gtt.FP32_FP32,
                               eliminate_points="schur" in solver)
    ref = levenberg_marquardt(g.freeze(device="cpu"),
                              bal_cli.make_solver(args),
                              options=LevenbergMarquardtOptions(iterations=4))
    _same_result(out, ref)


@pytest.mark.parametrize("solver", pose_cli.SOLVERS)
def test_pose_graph_cli(solver, capsys):
    out = pose_cli.main(["--poses", "100", "--iterations", "4", "--solver",
                         solver, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Pose graph (se3): 100 poses, 104 edges"
    assert "iters/sec" in lines[-2]
    assert lines[-1] == f"chi2: {out.initial_chi2:.6g} -> {out.chi2:.6g}"

    g, *_ = g2o.build_graph(synthetic.make_sphere_se3(100, seed=0),
                            precision=gtt.FP32_FP32)
    solver_obj = {"pcg": PCGSolver(50, 1e-10, 1e6,
                                   BlockJacobiPreconditioner()),
                  "sparse": SparseDirectSolver(),
                  "dense": DenseCholeskySolver()}[solver]
    ref = levenberg_marquardt(g.freeze(device="cpu"), solver_obj,
                              options=LevenbergMarquardtOptions(iterations=4))
    _same_result(out, ref)


def test_cli_defaults_to_the_card():
    assert bal_cli.parse_args([]).device == "cuda"
    assert pose_cli.parse_args([]).device == "cuda"
    with pytest.raises(NotImplementedError, match="A14"):
        bal_cli.main(["--precision", "fp32", "bf16", "--device", "cpu"])
