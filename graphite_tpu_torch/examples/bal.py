"""Bundle adjustment on BAL datasets or synthetic BAL-style problems
(counterpart of ``examples/bal.py``): six linear solvers, LM with
configurable damping; prints the final chi2, MSE and half-MSE.

    python -m graphite_tpu_torch.examples.bal problem.txt --solver pcg-schur
    python -m graphite_tpu_torch.examples.bal --synthetic ladybug \\
        --solver sparse-schur --iterations 50
    python -m graphite_tpu_torch.examples.bal --synthetic mini --device cpu
    python -m graphite_tpu_torch.examples.bal --synthetic ladybug \\
        --jit-loop --lm2 --verbose

Runs on the CUDA card unless ``--device cpu``. The full-system solvers
(``pcg``, ``dense``, ``sparse``) keep the points in the system; the
``-schur`` ones eliminate them (unless ``--no-eliminate``).
"""

import argparse
import time

import graphite_tpu_torch as gtt
from graphite_tpu_torch.io import bal as bal_io
from graphite_tpu_torch.io import synthetic
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
    levenberg_marquardt2,
)
from graphite_tpu_torch.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu_torch.solvers import (
    DenseCholeskySchurSolver,
    DenseCholeskySolver,
    PCGSchurSolver,
    PCGSolver,
    SparseDirectSchurSolver,
    SparseDirectSolver,
)

SOLVERS = ["pcg", "pcg-schur", "dense", "dense-schur", "sparse",
           "sparse-schur"]


def make_solver(args):
    if args.solver == "pcg":
        pre = (IdentityPreconditioner()
               if args.pcg_preconditioner == "identity"
               else BlockJacobiPreconditioner())
        return PCGSolver(max_iter=args.pcg_max_iterations,
                         tol=args.pcg_tolerance,
                         rejection_ratio=args.pcg_rejection_ratio,
                         preconditioner=pre)
    if args.solver == "pcg-schur":
        return PCGSchurSolver(max_iter=args.pcg_max_iterations,
                              tol=args.pcg_tolerance,
                              rejection_ratio=args.pcg_rejection_ratio)
    return {"dense": DenseCholeskySolver, "dense-schur":
            DenseCholeskySchurSolver, "sparse": SparseDirectSolver,
            "sparse-schur": SparseDirectSchurSolver}[args.solver]()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="BAL bundle adjustment")
    ap.add_argument("file", nargs="?", help="BAL problem file")
    ap.add_argument("--synthetic", help="synthetic problem name "
                    f"({', '.join(synthetic.BAL_SIZES)}) or C,P,O counts")
    ap.add_argument("--solver", default="pcg-schur", choices=SOLVERS)
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"],
                    metavar=("GRAPH", "SOLVER"))
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--lambda", dest="lmbda", type=float, default=1e-4)
    ap.add_argument("--pcg_max_iterations", type=int, default=10)
    ap.add_argument("--pcg_tolerance", type=float, default=1.0)
    ap.add_argument("--pcg_rejection_ratio", type=float, default=5.0)
    ap.add_argument("--pcg_preconditioner", default="block-jacobi",
                    choices=["identity", "block-jacobi"])
    ap.add_argument("--identity_damping", action="store_true")
    ap.add_argument("--no-eliminate", action="store_true",
                    help="do not Schur-eliminate points")
    ap.add_argument("--huber", type=float, default=None,
                    help="Huber loss delta")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm2", action="store_true",
                    help="LM with the early stop (levenberg_marquardt2)")
    ap.add_argument("--jit-loop", action="store_true",
                    help="the device-controlled LM loop (a CUDA graph on "
                    "the card)")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-iteration table")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    ``LMResult``."""
    args = parse_args(argv)
    precision = gtt.Precision.from_names(*args.precision)

    t0 = time.perf_counter()
    if args.file:
        ds = bal_io.load(args.file)
    else:
        name = args.synthetic or "mini"
        if "," in name:
            name = tuple(int(x) for x in name.split(","))
        ds = synthetic.make_bal(name, seed=args.seed)
    print(f"Loaded problem: {ds.num_cameras} cameras, {ds.num_points} points, "
          f"{ds.num_observations} observations "
          f"({time.perf_counter() - t0:.2f}s)")

    t0 = time.perf_counter()
    loss = gtt.HuberLoss() if args.huber is not None else None
    eliminate = not args.no_eliminate and "schur" in args.solver
    g, *_ = bal_io.build_graph(ds, precision=precision,
                               eliminate_points=eliminate, loss=loss,
                               loss_param=args.huber)
    print(f"Graph built ({time.perf_counter() - t0:.2f}s)")

    t0 = time.perf_counter()
    problem = g.freeze(device=args.device)
    print(f"Structure frozen: dim_h={problem.dim_h} on {problem.device} "
          f"({time.perf_counter() - t0:.2f}s)")

    options = LevenbergMarquardtOptions(
        iterations=args.iterations, initial_damping=args.lmbda,
        use_identity=args.identity_damping, verbose=args.verbose,
        jit_loop=args.jit_loop)
    optimize = levenberg_marquardt2 if args.lm2 else levenberg_marquardt
    t0 = time.perf_counter()
    result = optimize(problem, make_solver(args), options=options)
    dt = time.perf_counter() - t0
    n_obs = ds.num_observations
    print(f"Optimization took {dt:.4f} seconds "
          f"({result.iterations / max(dt, 1e-9):.3f} iters/sec)")
    print(f"Final chi2: {result.chi2:.10g}")
    print(f"MSE: {result.chi2 / n_obs:.10g}")
    print(f"Half MSE: {0.5 * result.chi2 / n_obs:.10g}")
    return result


if __name__ == "__main__":
    main()
