"""Device ms of the port's BAL main path on the card, for comparing two
checkouts in one call: the LM iteration under ``jit_loop`` (the median
accepted and rejected replay, CUDA events), the host loop (the median
device ms and host wall ms of an accepted and of a rejected iteration),
the first-order optimizers' replays (gradient descent, Adam) and the peak
memory, with the run's chi2 and accept pattern, so that two checkouts'
trajectories can be compared bit for bit.

    python -m graphite_tpu_torch.replay_profile                    # Venice-1778
    python -m graphite_tpu_torch.replay_profile --checkout DIR     # DIR's package
    python -m graphite_tpu_torch.replay_profile --size ladybug --iterations 10

``--checkout DIR`` runs this file in a fresh process that imports
``graphite_tpu_torch`` from the checkout DIR instead (e.g. an older commit
unpacked with ``git archive``), as ``setup_profile`` does, so two versions
are timed by the same code on the same host and card; it uses only entry
points both have. Run each side in turns (parent, change, change,
parent). The problem is ``make_bal(size, seed=0)`` under FP32_FP32 with
PCGSchurSolver(10, 1.0, 5.0); LM runs ``--iterations`` iterations from the
start, the graph ``--repeats`` more calls after the capturing one. Prints
one JSON line with the card's name and power limit. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _median(values):
    return statistics.median(values) if values else None


def _drop(problem, loop):
    """Free a cached loop (its graph and pool)."""
    import torch

    for key in [k for k, v in problem._cache.items() if v is loop]:
        del problem._cache[key]
    torch.cuda.empty_cache()


def _split(ms, history):
    """(accepted, rejected) of per-iteration ms."""
    return ([m for m, h in zip(ms, history) if h["accepted"]],
            [m for m, h in zip(ms, history) if not h["accepted"]])


def profile(size: str, iterations: int, repeats: int) -> dict:
    import torch

    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, synthetic
    from graphite_tpu_torch.optimizers import (
        AdamOptions,
        GradientDescentOptions,
        LevenbergMarquardtOptions,
        adam,
        gradient_descent,
        levenberg_marquardt,
    )
    from graphite_tpu_torch.optimizers.lm import cached_device_loop
    from graphite_tpu_torch.solvers import PCGSchurSolver

    t0 = time.perf_counter()
    g, *_ = bal.build_graph(synthetic.make_bal(size, seed=0),
                            precision=FP32_FP32)
    problem = g.freeze(device=torch.device("cuda"))
    del g
    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    out = {"setup_seconds": time.perf_counter() - t0}

    # the host loop, after a first call that builds every plan and kernel
    levenberg_marquardt(problem, solver,
                        options=LevenbergMarquardtOptions(iterations=2))
    torch.cuda.reset_peak_memory_stats()
    host = levenberg_marquardt(
        problem, solver,
        options=LevenbergMarquardtOptions(iterations=iterations))
    hist = host.history[1:]
    dev_acc, dev_rej = _split([h["device_ms"] for h in hist], hist)
    wall_acc, wall_rej = _split([1e3 * h["time"] for h in hist], hist)
    out.update(
        chi2=[h["chi2"] for h in host.history],
        accepted=[h["accepted"] for h in host.history],
        host_device_ms_accepted=_median(dev_acc),
        host_device_ms_rejected=_median(dev_rej),
        host_wall_ms_accepted=_median(wall_acc),
        host_wall_ms_rejected=_median(wall_rej),
        host_peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    # jit_loop: the first call captures, the next ones replay
    opts = LevenbergMarquardtOptions(iterations=iterations, jit_loop=True)
    torch.cuda.reset_peak_memory_stats()
    graph_runs = [levenberg_marquardt(problem, solver, options=opts)]
    loop = cached_device_loop(problem, solver, opts)
    acc, rej = [], []
    for _ in range(repeats):
        run = levenberg_marquardt(problem, solver, options=opts)
        graph_runs.append(run)
        a, r = _split(loop.replay_ms[:run.iterations], run.history)
        acc += a
        rej += r
    out.update(
        graph_bitwise_host=all(
            [h["chi2"] for h in r.history] == out["chi2"]
            and [h["accepted"] for h in r.history] == out["accepted"]
            for r in graph_runs),
        replay_ms_accepted=_median(acc), replay_ms_rejected=_median(rej),
        replays_accepted=len(acc), replays_rejected=len(rej),
        graph_pool_mib=loop.pool_bytes / 2**20,
        graph_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    _drop(problem, loop)
    del loop, graph_runs

    for name, run, options in (
            ("gd", gradient_descent,
             GradientDescentOptions(iterations=iterations,
                                    learning_rate=0.1)),
            ("adam", adam,
             AdamOptions(iterations=iterations, learning_rate=0.3))):
        run(problem, options=options)  # captures
        step_loop = next(v for k, v in problem._cache.items()
                         if isinstance(k, tuple) and k[0] == name)
        ms = []
        for _ in range(repeats):
            _, chi2 = run(problem, options=options)
            ms += list(step_loop.replay_ms)
        out[f"{name}_replay_ms"] = _median(ms)
        out[f"{name}_chi2_last"] = float(chi2[-1])
        _drop(problem, step_loop)
    return out


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="venice-big")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--checkout", default=None,
                    help="time the graphite_tpu_torch of this checkout")
    args = ap.parse_args(argv)
    if args.checkout is not None:
        rest = ["--size", args.size, "--iterations", str(args.iterations),
                "--repeats", str(args.repeats)]
        code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
                "sys.argv = [sys.argv[2]] + sys.argv[3:]; "
                "runpy.run_path(sys.argv[0], run_name='__main__')")
        return subprocess.run([sys.executable, "-c", code,
                               os.path.abspath(args.checkout),
                               os.path.abspath(__file__), *rest]).returncode

    import torch

    if not torch.cuda.is_available():
        print("replay_profile: no CUDA device available", file=sys.stderr)
        return 1
    import graphite_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        graphite_tpu_torch.__file__)))
    result = profile(args.size, args.iterations, args.repeats)
    print(json.dumps({"replay_profile": {
        "checkout": where, "size": args.size, **result,
        "card": _card()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
