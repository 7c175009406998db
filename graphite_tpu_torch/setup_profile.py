"""Host set-up seconds of the port on the card, section by section: build
the graph, freeze it, build the Hessian (and a BAL problem's Schur)
structure, and run the first pass of the solve's stages, which builds
every host plan.

    python -m graphite_tpu_torch.setup_profile                   # all sizes
    python -m graphite_tpu_torch.setup_profile --size venice-big
    python -m graphite_tpu_torch.setup_profile --checkout DIR    # DIR's package

``--checkout DIR`` runs this file in a fresh process that imports
``graphite_tpu_torch`` from the checkout DIR instead (e.g. an older commit
unpacked with ``git archive``), so two versions are timed by the same
code on the same host and card; it uses only entry points both have.
``--profile N`` also prints the N functions of the first pass with the
most cumulative host time (``cProfile``).

The first pass: at Venice-1778 (``venice-big``), linearize, the damped
Hessian, S, b_S, the S matvec's plan and one matvec, and the
back-substitution (``chip_smoke.py`` phase 5's); at Ladybug-49
(``ladybug``, PCG-Schur) and sphere2500 (PCG, block-Jacobi), one LM
iteration. Each size prints one JSON line of seconds, with the card's
name and power limit. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SIZES = ("ladybug", "sphere2500", "venice-big")


def first_pass(problem, size: str):
    """The first pass of the solve's stages at ``size`` (module
    docstring); builds every host plan of the path."""
    import torch

    if size != "venice-big":
        from graphite_tpu_torch.optimizers import (
            LevenbergMarquardtOptions,
            levenberg_marquardt,
        )

        return levenberg_marquardt(
            problem, _solver(size),
            options=LevenbergMarquardtOptions(iterations=1))
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.schur import (
        SchurOps,
        build_schur_structure,
        schur_values,
    )

    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    lin = linearize(problem, problem.params0)
    hv = apply_damping(problem, hs, compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-4, False)
    sv = schur_values(problem, ss, hv)
    ops = SchurOps(problem, ss, hv, sv)
    ops.b_schur(lin.b)
    ops.prepare_matvec()
    ops.s_matvec(torch.zeros(ss.dim_p, device=problem.device))
    ops.landmark_update(lin.b, torch.zeros(ss.dim_p, device=problem.device))
    return lin, hv, sv, ops


def _solver(size: str):
    if size == "sphere2500":
        from graphite_tpu_torch.preconditioners import (
            BlockJacobiPreconditioner,
        )
        from graphite_tpu_torch.solvers import PCGSolver

        return PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner())
    from graphite_tpu_torch.solvers import PCGSchurSolver

    return PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)


def make_graph(size: str):
    """(graph, whether it has a Schur complement) of ``size`` (seed 0,
    FP32_FP32)."""
    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, g2o, synthetic

    if size == "sphere2500":
        g, *_ = g2o.build_graph(synthetic.make_sphere_se3(2500, seed=0),
                                precision=FP32_FP32)
        return g, False
    g, *_ = bal.build_graph(synthetic.make_bal(size, seed=0),
                            precision=FP32_FP32)
    return g, True


def timed_setup(graph, size: str, schur: bool, device="cuda", top: int = 0):
    """Freeze ``graph`` on ``device``, build its Hessian (and with
    ``schur`` its Schur) structure and run ``size``'s first pass, the card
    synchronised; ``top`` > 0 profiles the pass. Returns (problem, the
    pass's result, seconds by section and their total)."""
    import torch

    from graphite_tpu_torch.hessian import build_hessian_structure
    from graphite_tpu_torch.schur import build_schur_structure

    secs = {}
    t0 = time.perf_counter()
    problem = graph.freeze(device=torch.device(device))
    secs["freeze"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_hessian_structure(problem)
    secs["hessian_structure"] = time.perf_counter() - t0
    if schur:
        t0 = time.perf_counter()
        build_schur_structure(problem)
        secs["schur_structure"] = time.perf_counter() - t0
    profiler = None
    if top:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    t0 = time.perf_counter()
    out = first_pass(problem, size)
    if problem.device.type == "cuda":
        torch.cuda.synchronize()
    secs["first_pass_with_plans"] = time.perf_counter() - t0
    if profiler is not None:
        import pstats

        profiler.disable()
        pstats.Stats(profiler, stream=sys.stdout).sort_stats(
            "cumulative").print_stats(top)
    secs["total"] = sum(secs.values())
    return problem, out, secs


def profile_size(size: str, top: int = 0) -> dict:
    """Seconds by section of ``size``'s set-up on the card."""
    t0 = time.perf_counter()
    graph, schur = make_graph(size)
    built = time.perf_counter() - t0
    _, _, secs = timed_setup(graph, size, schur, top=top)
    return {"make_and_build_graph": built, **secs}


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", nargs="+", choices=SIZES, default=list(SIZES))
    ap.add_argument("--checkout", default=None,
                    help="time the graphite_tpu_torch of this checkout")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if args.checkout is not None:
        rest = ["--size", *args.size, "--profile", str(args.profile)]
        code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
                "sys.argv = [sys.argv[2]] + sys.argv[3:]; "
                "runpy.run_path(sys.argv[0], run_name='__main__')")
        return subprocess.run([sys.executable, "-c", code,
                               os.path.abspath(args.checkout),
                               os.path.abspath(__file__), *rest]).returncode

    import torch

    if not torch.cuda.is_available():
        print("setup_profile: no CUDA device available", file=sys.stderr)
        return 1
    import graphite_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        graphite_tpu_torch.__file__)))
    for size in args.size:
        secs = profile_size(size, args.profile)
        print(json.dumps({"setup_profile": {
            "checkout": where, "size": size,
            "seconds": {k: round(v, 4) for k, v in secs.items()},
            "cpu_count": os.cpu_count(), "card": _card()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
