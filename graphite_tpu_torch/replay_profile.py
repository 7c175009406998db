"""Device ms of the port's main paths on the card, for comparing two
checkouts in one call: the LM iteration under ``jit_loop`` (the median
accepted and rejected replay, CUDA events), the host loop (the median
device ms and host wall ms of an accepted and of a rejected iteration),
the first-order optimizers' replays (gradient descent, Adam; BAL only)
and the peak memory, with the run's chi2 and accept pattern, so that two
checkouts' trajectories can be compared bit for bit; then the first
``--eager`` iterations from the start as the captured iteration's code
run eagerly, each under ``torch.profiler``, by layer: for each stage of
``stage_profile`` (a ``record_function`` range around each call) its
calls, host ms, the device ms and the kernels of what it launched, and
the iteration's totals.

    python -m graphite_tpu_torch.replay_profile                    # Venice-1778
    python -m graphite_tpu_torch.replay_profile --checkout DIR     # DIR's package
    python -m graphite_tpu_torch.replay_profile --size ladybug --iterations 10
    python -m graphite_tpu_torch.replay_profile --size sphere2500
    python -m graphite_tpu_torch.replay_profile --size ladybug --lm2 --iterations 30
    python -m graphite_tpu_torch.replay_profile --precision fp64 fp64

``--checkout DIR`` runs this file in a fresh process that imports
``graphite_tpu_torch`` from the checkout DIR instead (e.g. an older commit
unpacked with ``git archive``), as ``setup_profile`` does, so two versions
are timed by the same code on the same host and card; it uses only entry
points both have. Run each side in turns (parent, change, change,
parent). The problem is ``make_bal(size, seed=0)`` with
PCGSchurSolver(10, 1.0, 5.0), or for ``sphere2500`` the pose graph
``make_sphere_se3(2500, seed=0)`` with PCGSolver(50, 1e-10, 1e6,
block-Jacobi) (``stage_profile``'s), under the precision policy
``--precision GRAPH SOLVER`` (``Precision.from_names``; default fp32
fp32, FP32_FP32; ``--precision fp64 fp64`` is FP64_FP64); LM runs
``--iterations`` iterations from the start, the graph ``--repeats`` more
calls after the capturing one (a capture that runs out of device memory
is reported as ``graph_error`` and ends the profile).
Prints one JSON line with the card's name and power limit. It needs a
CUDA card.

``--lm2`` times instead what ``chip_smoke.py``'s remask phase checks:
``levenberg_marquardt2`` (the early stop) under ``jit_loop`` on the
problem frozen remaskable, ``--repeats`` + 1 calls (the first captures),
each call's stop iteration, median accepted replay ms, the replays after
the stop and the largest of them over that median (the phase's limit is
5%).
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


def _launches_by_range(prof, prefix: str):
    """From a ``torch.profiler`` trace: for each host range whose name
    starts with ``prefix`` (by name), its calls, host ms, and the device
    ms and kernels (copies and sets left out of the count) of the device
    activities launched inside it; and the same for the whole trace under
    ``"total"``. A device activity belongs to every range open when its
    launch call ran (nested ranges each count it); one whose launch call
    the trace does not hold is counted under ``"unlinked"`` only."""
    import torch

    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = [(e.name()[len(prefix):], e.start_ns(), e.end_ns())
              for e in events
              if e.device_type() == cpu and e.name().startswith(prefix)]
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == cpu
                 and e.name().startswith(("cuda", "cu"))}
    out = {"total": {"calls": 1, "host_ms": 0.0, "device_ms": 0.0,
                     "kernels": 0},
           "unlinked": {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                        "kernels": 0}}
    for name, a, b in ranges:
        row = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                    "device_ms": 0.0, "kernels": 0})
        row["calls"] += 1
        row["host_ms"] += (b - a) / 1e6
    for e in events:
        if e.device_type() != dev:
            continue
        t = launch_at.get(e.linked_correlation_id(),
                          launch_at.get(e.correlation_id()))
        kernel = not e.name().startswith(("Memcpy", "Memset"))
        rows = ([out["unlinked"]] if t is None else [out["total"]] + [
            out[n] for n, a, b in ranges if a <= t <= b])
        for row in rows:
            row["device_ms"] += e.duration_ns() / 1e6
            row["kernels"] += kernel
    return out


def eager_layers(problem, solver, steps: int) -> list:
    """The first ``steps`` LM iterations from the start as the captured
    iteration's code run eagerly (its regions as host branches), each
    under ``torch.profiler`` on its own: [{"accepted", "layers"}], the
    layers from ``_launches_by_range`` over ``stage_profile``'s stages."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    from graphite_tpu_torch.ops import device_loop
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu_torch.optimizers.lm import cached_device_loop
    from graphite_tpu_torch.stage_profile import _stage_targets

    opts = LevenbergMarquardtOptions(iterations=steps, jit_loop=True)
    levenberg_marquardt(problem, solver, options=opts)  # every host plan
    loop = cached_device_loop(problem, solver, opts)
    loop._start(problem.params0, opts.initial_damping)

    def labelled(fn, name):
        def run(*args, **kwargs):
            with record_function("layer: " + name):
                return fn(*args, **kwargs)
        return run

    saved, out = [], []
    try:
        for owner, attr, name in _stage_targets():
            fn = owner.__dict__[attr]
            saved.append((owner, attr, fn))
            setattr(owner, attr, labelled(fn, name))
        for _ in range(steps):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with device_loop.enabled():
                    loop._step()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            layers = _launches_by_range(prof, "layer: ")
            layers["total"]["host_ms"] = wall_ms
            out.append({"accepted": bool(loop.accepted), "layers": layers})
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
    _drop(problem, loop)
    return out


POSE_SIZES = {"sphere2500": 2500}  # size name -> SE3 poses


def lm2_after_stop(size: str, iterations: int, repeats: int,
                   precision) -> dict:
    """LM2's replays after its stop against its accepted ones (``--lm2``):
    for each call, the stop iteration, the median accepted replay ms, the
    after-stop replay ms and max(after) / median(accepted)."""
    import torch

    from graphite_tpu_torch.io import bal, synthetic
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt2,
    )
    from graphite_tpu_torch.optimizers.lm import device_loops
    from graphite_tpu_torch.solvers import PCGSchurSolver

    g, *_ = bal.build_graph(synthetic.make_bal(size, seed=0),
                            precision=precision)
    problem = g.freeze(device=torch.device("cuda"), remaskable=True)
    solver = PCGSchurSolver(10, 1.0, 5.0)
    opts = LevenbergMarquardtOptions(iterations=iterations, jit_loop=True)
    calls = []
    for _ in range(repeats + 1):
        run = levenberg_marquardt2(problem, solver, options=opts)
        ms = device_loops(problem)[-1].replay_ms
        acc, _ = _split(ms[:run.iterations], run.history)
        after = list(ms[run.iterations:])
        calls.append(dict(
            stop=run.iterations, accepted_ms_median=_median(acc),
            after_stop_ms=after,
            after_over_accepted=(max(after) / _median(acc)
                                 if after and acc else None)))
    return {"lm2": calls}


def profile(size: str, iterations: int, repeats: int, eager: int,
            precision) -> dict:
    import torch

    from graphite_tpu_torch.io import bal, g2o, synthetic
    from graphite_tpu_torch.optimizers import (
        AdamOptions,
        GradientDescentOptions,
        LevenbergMarquardtOptions,
        adam,
        gradient_descent,
        levenberg_marquardt,
    )
    from graphite_tpu_torch.optimizers.lm import cached_device_loop
    from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
    from graphite_tpu_torch.solvers import PCGSchurSolver, PCGSolver

    t0 = time.perf_counter()
    if size in POSE_SIZES:
        g, *_ = g2o.build_graph(
            synthetic.make_sphere_se3(POSE_SIZES[size], seed=0),
            precision=precision)
        solver = PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner())
    else:
        g, *_ = bal.build_graph(synthetic.make_bal(size, seed=0),
                                precision=precision)
        solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    problem = g.freeze(device=torch.device("cuda"))
    del g
    out = {"torch": torch.__version__,
           "setup_seconds": time.perf_counter() - t0}

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

    # jit_loop: the first call captures, the next ones replay. A capture
    # that runs out of device memory is reported (``graph_error``) and ends
    # the profile: the eager iterations capture the same loop
    opts = LevenbergMarquardtOptions(iterations=iterations, jit_loop=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        graph_runs = [levenberg_marquardt(problem, solver, options=opts)]
    except torch.OutOfMemoryError as exc:
        out["graph_error"] = str(exc).splitlines()[0]
        return out
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
    if eager:
        out["eager"] = eager_layers(problem, solver, eager)
    if size in POSE_SIZES:
        return out

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
    ap.add_argument("--eager", type=int, default=2,
                    help="eager iterations profiled by layer")
    ap.add_argument("--checkout", default=None,
                    help="time the graphite_tpu_torch of this checkout")
    ap.add_argument("--lm2", action="store_true",
                    help="LM2's after-stop replays against its accepted "
                         "ones (chip_smoke.py's remask check)")
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"],
                    metavar=("GRAPH", "SOLVER"),
                    help="the precision policy (default: fp32 fp32)")
    args = ap.parse_args(argv)
    if args.checkout is not None:
        rest = ["--size", args.size, "--iterations", str(args.iterations),
                "--repeats", str(args.repeats), "--eager", str(args.eager),
                "--precision", *args.precision]
        rest += ["--lm2"] if args.lm2 else []
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

    precision = graphite_tpu_torch.Precision.from_names(*args.precision)
    where = os.path.dirname(os.path.dirname(os.path.abspath(
        graphite_tpu_torch.__file__)))
    result = (lm2_after_stop(args.size, args.iterations, args.repeats,
                             precision)
              if args.lm2 else
              profile(args.size, args.iterations, args.repeats, args.eager,
                      precision))
    print(json.dumps({"replay_profile": {
        "checkout": where, "size": args.size,
        "precision": list(args.precision), **result,
        "card": _card()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
