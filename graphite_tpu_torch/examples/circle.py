"""Circle fit (counterpart of ``examples/circle.py``): 5 noisy 2D points
fitted to a circle of known radius with unary circle factors (analytic
Jacobians, or ``--auto-diff``), one fixed point, one deactivated factor,
identity-preconditioned PCG and 100 Levenberg-Marquardt iterations.
Points 2 (deactivated factor) and 4 (fixed) keep their values.

    python -m graphite_tpu_torch.examples.circle
    python -m graphite_tpu_torch.examples.circle --auto-diff --device cpu

Runs on the CUDA card unless ``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.preconditioners import IdentityPreconditioner
from graphite_tpu_torch.solvers import PCGSolver

POINT2 = gtt.vertex_type("point2", 2)


def circle_error(p, radius):
    """(F, 1): x^2 + y^2 - radius^2 per point."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
            - radius * radius)[..., None]


def circle_jacobian(p, radius):
    return (torch.stack([2.0 * p[..., 0], 2.0 * p[..., 1]], -1)[..., None, :],)


def circle_factor(auto_diff: bool = False):
    return gtt.factor_type(
        "circle", 1, [POINT2], circle_error,
        jacobian_fn=None if auto_diff else circle_jacobian, obs_shape=())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="circle fit")
    ap.add_argument("--auto-diff", action="store_true",
                    help="differentiate the residual instead of the "
                    "analytic Jacobian")
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"],
                    metavar=("GRAPH", "SOLVER"))
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the example on ``argv`` (default: the command line); returns
    the ``LMResult``."""
    args = parse_args(argv)
    precision = gtt.Precision.from_names(*args.precision)
    rng = np.random.default_rng(args.seed)
    num_vertices = 5
    radius, sigma = 4.0, 0.3
    angles = rng.uniform(0.0, 2 * np.pi, num_vertices)
    pts = np.stack(
        [radius * np.cos(angles) + rng.normal(0, sigma, num_vertices),
         radius * np.sin(angles) + rng.normal(0, sigma, num_vertices)],
        axis=1)

    g = gtt.Graph(precision=precision)
    vs = g.add_vertex_set(POINT2)
    id_offset = 10  # the user's own ids
    for i, p in enumerate(pts):
        print(f"Adding point {i}=({p[0]:.4f}, {p[1]:.4f}) "
              f"with radius={np.hypot(*p):.4f}")
        vs.add(i + id_offset, p)

    fs = g.add_factor_set(circle_factor(args.auto_diff))
    handles = [fs.add([i + id_offset], obs=radius)
               for i in range(num_vertices)]

    # fix the last vertex; move the third constraint to level 1, above the
    # optimization level 0
    vs.set_fixed(num_vertices - 1 + id_offset, True)
    fs.set_active(handles[2], 0x1)

    problem = g.freeze(opt_level=0, device=args.device)
    solver = PCGSolver(max_iter=50, tol=1e-20, rejection_ratio=10.0,
                       preconditioner=IdentityPreconditioner())
    options = LevenbergMarquardtOptions(
        iterations=args.iterations, initial_damping=1e-6, verbose=True)

    print(f"Graph built with {num_vertices} vertices and {fs.count} factors.")
    print("Optimizing!")
    t0 = time.perf_counter()
    result = levenberg_marquardt(problem, solver, options=options)
    print(f"Optimization took {time.perf_counter() - t0:.4f} seconds.")

    final = result.params["point2"].detach().cpu().numpy()
    for i, p in enumerate(final):
        print(f"Optimized point {i}=({p[0]:.6f}, {p[1]:.6f}) "
              f"with radius={np.hypot(*p):.6f}")
    print("points 2 and 4 should remain unchanged.")
    return result


if __name__ == "__main__":
    main()
