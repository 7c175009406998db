"""Pose-graph optimization (SE2 / SE3) from g2o files or synthetic
problems (counterpart of ``examples/pose_graph.py``): block-Jacobi PCG or
a direct solver, the gauge fixed by fixing the first pose.

    python -m graphite_tpu_torch.examples.pose_graph --poses 2500
    python -m graphite_tpu_torch.examples.pose_graph sphere2500.g2o \\
        --solver sparse
    python -m graphite_tpu_torch.examples.pose_graph --poses 100 --device cpu
    python -m graphite_tpu_torch.examples.pose_graph --poses 2500 --jit-loop

Runs on the CUDA card unless ``--device cpu``.
"""

import argparse
import time

import graphite_tpu_torch as gtt
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

SOLVERS = ["pcg", "sparse", "dense"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="pose-graph optimization")
    ap.add_argument("file", nargs="?", help="g2o file")
    ap.add_argument("--synthetic", choices=["circle2d", "sphere"],
                    default="sphere")
    ap.add_argument("--poses", type=int, default=500)
    ap.add_argument("--solver", default="pcg", choices=SOLVERS)
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"],
                    metavar=("GRAPH", "SOLVER"))
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--lambda", dest="lmbda", type=float, default=1e-4)
    ap.add_argument("--pcg_max_iterations", type=int, default=50)
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
    if args.file:
        ds = g2o.load(args.file)
    elif args.synthetic == "circle2d":
        ds = synthetic.make_pose_graph_2d(args.poses, seed=args.seed)
    else:
        ds = synthetic.make_sphere_se3(args.poses, seed=args.seed)
    print(f"Pose graph ({ds.kind}): {ds.num_vertices} poses, "
          f"{ds.num_edges} edges")

    g, *_ = g2o.build_graph(ds, precision=precision)
    problem = g.freeze(device=args.device)
    if args.solver == "pcg":
        solver = PCGSolver(max_iter=args.pcg_max_iterations, tol=1e-10,
                           rejection_ratio=1e6,
                           preconditioner=BlockJacobiPreconditioner())
    elif args.solver == "sparse":
        solver = SparseDirectSolver()
    else:
        solver = DenseCholeskySolver()

    options = LevenbergMarquardtOptions(iterations=args.iterations,
                                        initial_damping=args.lmbda,
                                        verbose=args.verbose,
                                        jit_loop=args.jit_loop)
    optimize = levenberg_marquardt2 if args.lm2 else levenberg_marquardt
    t0 = time.perf_counter()
    result = optimize(problem, solver, options=options)
    dt = time.perf_counter() - t0
    print(f"Optimization took {dt:.3f}s "
          f"({result.iterations / max(dt, 1e-9):.2f} iters/sec)")
    print(f"chi2: {result.initial_chi2:.6g} -> {result.chi2:.6g}")
    return result


if __name__ == "__main__":
    main()
