"""Where the time of a BAL LM run goes: stage timers and a device trace.

    python -m graphite_tpu_torch.stage_profile [--size venice-big]
        [--iterations 6] [--trace 4] [--device cuda]

Builds ``make_bal(size, seed=0)`` in FP32_FP32, freezes it on ``--device``
and runs Levenberg-Marquardt with PCGSchurSolver(10, 1.0, 5.0) twice:

1. ``--iterations`` iterations under a stage timer. Each call of a stage
   (``linearize``, Hessian values, damping, ``schur_values``, ``b_schur``,
   kernel K7's entries for the BAL factors with the K1 row reductions
   beside them (in ``linearize``, and in the Hessian values of the sets
   K7 does not take: K7 sums its own),
   the preconditioner, ``run_pcg`` / ``dense_pcg`` with the S matvecs and
   preconditioner applies inside it, ``landmark_update``, ``compute_chi2``;
   on the pose path the block-Jacobi blocks and inverses, the folding of
   J and ``solve_pcg_mf``, or ``run_pcg`` with ``hessian_matvec``)
   is wrapped so that the device is synchronised before and after it; its
   wall ms are summed per stage. The synchronisation serialises host and
   device, so a stage's time is what it costs alone, not its share of an
   overlapped iteration. Nested stages (inside ``run_pcg``) are also
   counted in their caller.
2. ``--trace`` more iterations, from the parameters the first run ended
   with, under ``torch.profiler`` (CUDA only) with no synchronisation
   added. The device busy share is the length of the union of the time
   intervals of every device activity (kernels, copies, sets) divided by
   the host wall time of that run (the LM call's initial linearization
   included, the profiler's own overhead too). The device time by kernel
   is each kernel name's summed durations over the summed durations of
   all device activities.

Prints one line per stage and per kernel name, then one JSON object with
the same numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch


def _stage_targets():
    """(owner, attribute, stage name) of every wrapped stage."""
    import importlib

    from .ops.cuda import bal as k7
    from .optimizers import lm
    from .preconditioners.block_jacobi_schur import (
        BlockJacobiSchurPreconditioner,
    )
    from .preconditioners.block_jacobi import BlockJacobiPreconditioner
    from .schur import SchurOps
    from .solvers import pcg, pcg_schur

    # the package exports functions under these modules' names
    linearize, hessian = (importlib.import_module(f"{__package__}.{m}")
                          for m in ("linearize", "hessian"))
    return [
        (lm, "linearize", "linearize"),
        (k7, "bal_linearize", "k7.bal_linearize (in linearize)"),
        (k7, "bal_scale_b", "k7.bal_scale_b (in linearize)"),
        (linearize, "_factor_row_reduce",
         "k1 factor rows (in linearize)"),
        (k7, "bal_residual", "k7.bal_residual (in compute_chi2)"),
        (k7, "bal_hessian_sum", "k7.bal_hessian_sum (in hessian_values)"),
        (hessian, "reduce_rows", "k1 hessian rows (in hessian_values)"),
        (lm, "compute_chi2", "compute_chi2"),
        (lm, "apply_update", "apply_update"),
        (pcg_schur, "compute_hessian_values", "hessian_values"),
        (pcg_schur, "apply_damping", "apply_damping"),
        (pcg_schur, "schur_values", "schur_values"),
        (pcg_schur, "pcg", "run_pcg"),
        (pcg_schur, "dense_pcg", "dense_pcg"),
        (pcg_schur, "schur_to_dense", "schur_to_dense"),
        (SchurOps, "b_schur", "b_schur"),
        (SchurOps, "prepare_matvec", "prepare_matvec"),
        (SchurOps, "s_matvec", "s_matvec (in run_pcg)"),
        (SchurOps, "landmark_update", "landmark_update"),
        (SchurOps, "compose_delta", "compose_delta"),
        (BlockJacobiSchurPreconditioner, "prepare", "preconditioner_prepare"),
        (BlockJacobiSchurPreconditioner, "apply",
         "preconditioner_apply (in run_pcg)"),
        (pcg, "fold_jacobians", "fold_jacobians"),
        (pcg, "solve_pcg_mf", "solve_pcg_mf"),
        (pcg, "pcg", "run_pcg"),
        (pcg, "hessian_matvec", "hessian_matvec (in run_pcg)"),
        (BlockJacobiPreconditioner, "prepare", "preconditioner_prepare"),
        (BlockJacobiPreconditioner, "set_damping",
         "preconditioner_set_damping"),
        (BlockJacobiPreconditioner, "apply",
         "preconditioner_apply (in run_pcg)"),
    ]


@contextlib.contextmanager
def stage_timer(device: torch.device):
    """Wraps every stage while open; yields {stage: [calls, total ms]}."""
    table = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def wrap(fn, name):
        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            entry = table.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += 1e3 * (time.perf_counter() - t0)
            return out
        return timed

    saved = []
    try:
        for owner, attr, name in _stage_targets():
            fn = owner.__dict__[attr]
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn, name))
        yield table
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profiler_activities(device) -> list:
    """What ``torch.profiler`` records for a run on ``device``: the host's
    activity, and the card's on CUDA."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def device_trace(run):
    """``run()`` under ``torch.profiler``: (busy share, wall ms, device ms
    by activity name); the share is None when the trace holds no device
    activity."""
    from torch.profiler import profile

    with profile(activities=profiler_activities("cuda")) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
    busy = _union_us(spans) / 1e3 / wall_ms if spans else None
    return busy, wall_ms, by_name


POSE_SIZES = {"sphere2500": 2500}  # size name -> SE3 poses


def _graph_and_solver(size):
    from . import FP32_FP32
    from .io import bal, g2o, synthetic
    from .preconditioners import BlockJacobiPreconditioner
    from .solvers import PCGSchurSolver, PCGSolver

    if size in POSE_SIZES:
        g, *_ = g2o.build_graph(
            synthetic.make_sphere_se3(POSE_SIZES[size], seed=0),
            precision=FP32_FP32)
        return g, PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner())
    g, *_ = bal.build_graph(synthetic.make_bal(size, seed=0),
                            precision=FP32_FP32)
    return g, PCGSchurSolver(10, 1.0, 5.0)


def profile_lm(size, iterations: int, trace: int, device: str = "cuda"):
    """Both runs (see the module docstring); returns their numbers."""
    from .optimizers import LevenbergMarquardtOptions, levenberg_marquardt

    dev = torch.device(device)
    g, solver = _graph_and_solver(size)
    problem = g.freeze(device=dev)

    def run(n, params=None):
        return levenberg_marquardt(
            problem, solver, params,
            options=LevenbergMarquardtOptions(iterations=n))

    run(1)  # builds every cached plan and kernel
    with stage_timer(dev) as stages:
        timed = run(iterations)
    out = dict(size=size, device=str(dev), iterations=len(timed.history),
               accepted=sum(h["accepted"] for h in timed.history),
               stages={k: dict(calls=c, total_ms=ms, ms_per_call=ms / c)
                       for k, (c, ms) in sorted(
                           stages.items(), key=lambda kv: -kv[1][1])})
    if trace and dev.type == "cuda":
        busy, wall_ms, by_name = device_trace(
            lambda: run(trace, timed.params))
        total = sum(by_name.values())
        out.update(trace_iterations=trace, trace_wall_ms=wall_ms,
                   device_ms=total, busy_share=busy,
                   device_share_by_kernel={
                       k: v / total for k, v in sorted(
                           by_name.items(), key=lambda kv: -kv[1])[:20]})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", default="venice-big")
    p.add_argument("--iterations", type=int, default=6)
    p.add_argument("--trace", type=int, default=4)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    out = profile_lm(a.size, a.iterations, a.trace, a.device)
    print(f"[stages] {out['iterations']} iterations, {out['accepted']} "
          f"accepted, synchronised around each stage")
    for name, s in out["stages"].items():
        print(f"[stages] {name}: calls={s['calls']} "
              f"total_ms={s['total_ms']:.3f} "
              f"ms_per_call={s['ms_per_call']:.3f}")
    if "busy_share" in out:
        print(f"[trace] {out['trace_iterations']} iterations: wall_ms="
              f"{out['trace_wall_ms']:.3f} device_ms={out['device_ms']:.3f} "
              f"busy_share={out['busy_share']}")
        for name, share in out["device_share_by_kernel"].items():
            print(f"[trace] {share:.4f} {name[:100]}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
