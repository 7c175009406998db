"""The port's CLIs on the CPU (``--device cpu``):

- BAL and pose graphs, every ``--solver`` choice: each prints its lines,
  lowers chi2, and returns the same ``LMResult``, bit for bit, as a
  direct ``levenberg_marquardt`` call on the same problem and solver;
  with ``--jit-loop`` / ``--lm2`` (and ``--verbose``) the same as a
  direct ``levenberg_marquardt`` / ``levenberg_marquardt2`` call with
  those options;
- ``--precision``: each of the six policies lowers chi2 (BAL and pose
  graph CLIs);
- the circle example: the free points land on radius 4.000000 (float64)
  and points 2 (deactivated factor) and 4 (fixed) keep their values;
- a BAL ``save`` / ``load`` round trip.
"""

import pytest
import torch

import graphite_tpu_torch as gtt
import numpy as np

from graphite_tpu_torch.examples import bal as bal_cli
from graphite_tpu_torch.examples import circle as circle_cli
from graphite_tpu_torch.examples import pose_graph as pose_cli
from graphite_tpu_torch.io import bal as bal_io
from graphite_tpu_torch.io import g2o, synthetic
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
    levenberg_marquardt2,
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


POLICIES = [("fp64", "fp64"), ("fp64", "fp32"), ("fp64", "bf16"),
            ("fp32", "fp32"), ("fp32", "bf16"), ("fp32", "fp16")]


@pytest.mark.parametrize("cli", ["bal", "pose_graph"])
@pytest.mark.parametrize("precision", POLICIES,
                         ids=["-".join(p) for p in POLICIES])
def test_cli_takes_every_policy(cli, precision, capsys):
    if cli == "bal":
        out = bal_cli.main(["--synthetic", "mini", "--iterations", "4",
                            "--precision", *precision, "--device", "cpu"])
    else:
        out = pose_cli.main(["--poses", "100", "--iterations", "4",
                             "--precision", *precision, "--device", "cpu"])
    policy = gtt.Precision.from_names(*precision)
    assert out.chi2 < out.initial_chi2
    for p in out.params.values():
        assert p.dtype == policy.graph_dtype
        assert bool(torch.isfinite(p).all())


@pytest.mark.parametrize("flags", [["--jit-loop"], ["--lm2"],
                                   ["--jit-loop", "--lm2", "--verbose"]])
def test_bal_cli_loop_flags(flags, capsys):
    argv = ["--synthetic", "mini", "--iterations", "12", "--device", "cpu",
            *flags]
    out = bal_cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3] == f"Final chi2: {out.chi2:.10g}"
    if "--verbose" in flags:
        assert any(line.split()[:2] == ["Iteration", "Initial"]
                   for line in lines)
    g, *_ = bal_io.build_graph(synthetic.make_bal("mini", seed=0),
                               precision=gtt.FP32_FP32)
    run = levenberg_marquardt2 if "--lm2" in flags else levenberg_marquardt
    ref = run(g.freeze(device="cpu"),
              bal_cli.make_solver(bal_cli.parse_args(argv)),
              options=LevenbergMarquardtOptions(
                  iterations=12, jit_loop="--jit-loop" in flags))
    _same_result(out, ref)
    if "--lm2" in flags:
        assert out.iterations < 12


def test_pose_graph_cli_jit_loop(capsys):
    argv = ["--poses", "100", "--iterations", "4", "--device", "cpu"]
    host = pose_cli.main(argv)
    out = pose_cli.main(argv + ["--jit-loop"])
    _same_result(out, host)


@pytest.mark.parametrize("precision", ["fp64", "fp32"])
def test_circle_cli(precision, capsys):
    out = circle_cli.main(["--device", "cpu", "--precision", precision,
                           precision])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "points 2 and 4 should remain unchanged."
    pts = [line for line in lines if line.startswith("Optimized point")]
    added = [line for line in lines if line.startswith("Adding point")]
    assert len(pts) == len(added) == 5
    for i in (2, 4):  # deactivated factor, fixed vertex: unchanged
        start = circle_start_points()[i]
        assert pts[i].startswith(
            f"Optimized point {i}=({start[0]:.6f}, {start[1]:.6f})")
        p = out.params["point2"]
        assert torch.equal(p[i], torch.tensor(circle_start_points()[i],
                                              dtype=p.dtype))
    radii = [line.rsplit("radius=", 1)[1] for line in pts]
    if precision == "fp64":
        assert [radii[i] for i in (0, 1, 3)] == ["4.000000"] * 3
    else:  # as the JAX package's float32 run: 4.000000 / 4.000021
        assert all(abs(float(radii[i]) - 4.0) < 1e-4 for i in (0, 1, 3))
    assert "Graph built with 5 vertices and 5 factors." in lines


def circle_start_points():
    rng = np.random.default_rng(0)
    angles = rng.uniform(0.0, 2 * np.pi, 5)
    return np.stack([4.0 * np.cos(angles) + rng.normal(0, 0.3, 5),
                     4.0 * np.sin(angles) + rng.normal(0, 0.3, 5)], axis=1)


def test_bal_save_load_roundtrip(tmp_path):
    ds = synthetic.make_bal("toy", seed=1)
    path = str(tmp_path / "toy.txt")
    bal_io.save(path, ds)
    back = bal_io.load(path)
    for field in ("cameras", "points", "observations", "cam_idx",
                  "point_idx"):
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(ds, field))
