#!/usr/bin/env python3
"""Smoke run of graphite_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:

1. build the CUDA kernels (K1 ``csrc/segsum.cu``, K2 ``csrc/pcg_dense.cu``)
   from the checkout;
2. K1 vs its plain PyTorch version on the card, at the BAL Ladybug-49
   reduction shapes (seeded random inputs): relative error <= 1e-5, and
   two runs bitwise identical;
3. K2 vs its plain version (``run_pcg``) on the first Schur system of the
   Ladybug-49 LM run (n = 441) and on a random SPD system (n = 1024):
   x within 1e-4 relative, the same number of CG steps;
4. the main path: Ladybug-49 synthetic (seed 0), FP32_FP32,
   Levenberg-Marquardt with PCGSchurSolver(10, 1.0, 5.0) for 10
   iterations on the card and on the CPU (plain versions). The accept
   patterns must be equal, each iteration's chi2 within 1e-3, the final
   chi2 below the initial one, and every kernel launched by the run
   (dense_pcg once per solve).

Prints the kernels' JSON summary and the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Any failure raises
(non-zero exit); without a card it exits 1 at once and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, reps=20):
    """Mean device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def phase_build():
    from graphite_tpu_torch.ops.cuda import pcg_dense, segsum

    t0 = time.perf_counter()
    libs = [segsum.load_kernel(), pcg_dense.load_kernel()]
    total = time.perf_counter() - t0
    print(f"[build] seconds={total:.3f} " + " ".join(
        f"{lib.name}={lib.build_seconds:.3f}s" for lib in libs))
    for lib in libs:
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib.name}: {line.strip()}")


# (rows, segments, width, destinations sorted, site) on the Ladybug-49 path
K1_SHAPES = [
    (86_545, 1_225, 81, True, "schur product scatter (segsum)"),
    (31_843, 7_777, 3, True, "linearize b, points"),
    (31_843, 7_777, 9, True, "hessian Hll"),
    (31_843, 30_622, 27, True, "hessian Hpl"),
    (30_621, 7_776, 3, True, "landmark back-substitution"),
    (31_843, 50, 81, False, "hessian Hpp, permuted"),
    (31_843, 50, 9, False, "linearize b, cameras, permuted"),
    (30_621, 49, 9, False, "b_schur pose rows, permuted"),
]


def phase_k1(device):
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import segsum, segsum_stream

    rng = np.random.default_rng(0)
    # per entry point: ms / plain_ms summed over its shapes (one call each),
    # and the per-shape times beside the shapes
    stats = {name: dict(ms=0.0, plain_ms=0.0, err=0.0, shapes=[],
                        ms_by_shape=[], plain_ms_by_shape=[])
             for name in ("segsum.sorted_segment_sum",
                          "segsum_stream.streaming_segment_sum")}
    for k, ns, d, is_sorted, site in K1_SHAPES:
        seg = rng.integers(0, ns, k)
        if is_sorted:
            seg = np.sort(seg)
        plan = segsum.plan_segments(seg, ns, device)
        vals = torch.as_tensor(rng.standard_normal((k, d)).astype(np.float32),
                               device=device)
        wrapper = (segsum.sorted_segment_sum if "(segsum)" in site
                   else segsum_stream.streaming_segment_sum)
        name = ("segsum.sorted_segment_sum" if "(segsum)" in site
                else "segsum_stream.streaming_segment_sum")
        out = wrapper(vals, plan)
        again = wrapper(vals, plan)
        ref = segsum.segment_sum_plain(vals, plan)
        # the plain version on the CPU sums in the kernel's order
        ref_cpu = segsum.segment_sum_plain(
            vals.cpu(), segsum.plan_segments(seg, ns, "cpu"))
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        ms = device_ms(lambda: wrapper(vals, plan))
        plain_ms = device_ms(lambda: segsum.segment_sum_plain(vals, plan))
        print(f"[k1] {k}x{d}->{ns} {site}: rel_err={err:.3e} "
              f"max_abs_err={abs_err:.3e} bitwise_repeat="
              f"{torch.equal(out, again)} bitwise_vs_cpu_plain="
              f"{torch.equal(out.cpu(), ref_cpu)} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}")
        check(torch.equal(out, again), f"K1 not bitwise repeatable at {site}")
        check(err <= 1e-5, f"K1 rel err {err} > 1e-5 at {site}")
        s = stats[name]
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["err"] = max(s["err"], abs_err)
        s["shapes"].append(f"{k}x{d}->{ns}")
        s["ms_by_shape"].append(ms)
        s["plain_ms_by_shape"].append(plain_ms)
    return stats


def ladybug_problem(device):
    import torch

    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, synthetic

    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=FP32_FP32)
    return g.freeze(device=torch.device(device))


def first_schur_system(problem, solver, mu):
    """S, M and b_S of the first LM iteration's solve (damping ``mu``)."""
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
    )
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.preconditioners.block_jacobi_schur import (
        dense_preconditioner_matrix,
    )
    from graphite_tpu_torch.schur import (
        SchurOps,
        build_schur_structure,
        schur_values,
    )
    from graphite_tpu_torch.solvers.dense_cholesky_schur import schur_to_dense

    lin = linearize(problem, problem.params0)
    state = solver.prepare(problem, lin)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv = apply_damping(problem, hs, state.hvals, lin.diag, mu, False)
    sv = schur_values(problem, ss, hv)
    b_s = SchurOps(problem, ss, hv, sv).b_schur(lin.b)
    pstate = solver.preconditioner.prepare(problem, ss, sv)
    S = schur_to_dense(problem, ss, sv)
    M = dense_preconditioner_matrix(problem, ss, pstate, S.dtype)
    return S, M, b_s.to(S.dtype)


def phase_k2(device, solver, mu):
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import pcg_dense
    from graphite_tpu_torch.ops.pcg_loop import run_pcg

    S, M, b = first_schur_system(ladybug_problem(device), solver, mu)
    rng = np.random.default_rng(1)
    n = 1024
    A = rng.standard_normal((n, n))
    S2 = A @ A.T + n * np.eye(n)
    M2 = np.zeros_like(S2)
    for i in range(0, n, 9):
        M2[i:i + 9, i:i + 9] = np.linalg.inv(S2[i:i + 9, i:i + 9])
    spd = [torch.as_tensor(a.astype(np.float32), device=device)
           for a in (S2, M2, rng.standard_normal(n))]
    kw = dict(max_iter=solver.max_iter, tol=solver.tol,
              rejection_ratio=solver.rejection_ratio)
    result = None
    for label, (Sx, Mx, bx) in (("ladybug first Schur system", (S, M, b)),
                                ("random SPD", spd)):
        x, k = pcg_dense.dense_pcg(Sx, Mx, bx, **kw)
        x_ref, k_ref = pcg_dense.dense_pcg_plain(Sx, Mx, bx, **kw)
        x_cpu, _ = pcg_dense.dense_pcg_plain(Sx.cpu(), Mx.cpu(), bx.cpu(),
                                             **kw)
        err = rel_err(x, x_ref)
        abs_err = float((x - x_ref).abs().max())
        k, k_ref = int(k), int(k_ref)
        ms = device_ms(lambda: pcg_dense.dense_pcg(Sx, Mx, bx, **kw))
        plain_ms = device_ms(lambda: pcg_dense.dense_pcg_plain(Sx, Mx, bx,
                                                               **kw), reps=3)
        # for scale: the same loop with library matvecs and dots
        matmul_ms = device_ms(lambda: run_pcg(
            bx, lambda p: p @ Sx, lambda y: y @ Mx, solver.max_iter,
            solver.tol, solver.rejection_ratio))
        print(f"[k2] n={bx.shape[0]} {label}: rel_err={err:.3e} "
              f"max_abs_err={abs_err:.3e} iterations={k} plain_iterations="
              f"{k_ref} bitwise_vs_cpu_plain={torch.equal(x.cpu(), x_cpu)} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"matmul_run_pcg_ms={matmul_ms:.4f}")
        check(err <= 1e-4, f"K2 rel err {err} > 1e-4 ({label})")
        check(k == k_ref, f"K2 took {k} steps, plain {k_ref} ({label})")
        if result is None:
            result = dict(ms=ms, plain_ms=plain_ms, err=abs_err,
                          shapes=[f"n={bx.shape[0]}"], ms_by_shape=[ms],
                          plain_ms_by_shape=[plain_ms])
    return result


def run_lm(device, solver, iterations):
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )

    problem = ladybug_problem(device)
    return problem, levenberg_marquardt(
        problem, solver,
        options=LevenbergMarquardtOptions(iterations=iterations))


def phase_slice(solver, iterations, all_stats):
    import torch

    for stats in all_stats:
        stats.reset()
        stats.record_events = True
    problem, gpu = run_lm("cuda", solver, iterations)
    torch.cuda.synchronize()
    launches = {s.name: s.launches for s in all_stats}
    kernel_ms = {s.name: s.total_ms() for s in all_stats}
    for stats in all_stats:
        stats.record_events = False

    t0 = time.perf_counter()
    _, cpu = run_lm("cpu", solver, iterations)
    cpu_s = time.perf_counter() - t0

    acc_gpu = [h["accepted"] for h in gpu.history]
    acc_cpu = [h["accepted"] for h in cpu.history]
    chi_gpu = [h["chi2"] for h in gpu.history]
    chi_cpu = [h["chi2"] for h in cpu.history]
    print(f"[slice] cuda initial_chi2={gpu.initial_chi2!r} chi2={chi_gpu}")
    print(f"[slice] cuda accepted={acc_gpu}")
    print(f"[slice] cpu initial_chi2={cpu.initial_chi2!r} chi2={chi_cpu}")
    print(f"[slice] cpu accepted={acc_cpu} (cpu run {cpu_s:.1f} s)")
    rel = [abs(a - b) / abs(b) for a, b in zip(chi_gpu, chi_cpu)]
    print(f"[slice] max per-iteration chi2 rel diff={max(rel):.3e} "
          f"bitwise_equal_trajectory={chi_gpu == chi_cpu}")
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check(acc_gpu == acc_cpu, "accept patterns differ")
    check(max(rel) <= 1e-3, f"chi2 differs by {max(rel)} > 1e-3")
    check(abs(gpu.initial_chi2 - cpu.initial_chi2)
          <= 1e-3 * abs(cpu.initial_chi2), "initial chi2 differs")
    check(gpu.chi2 < gpu.initial_chi2, "final chi2 not below initial")
    for name, p in gpu.params.items():
        check(p.shape == problem.params0[name].shape
              and bool(torch.isfinite(p).all()), f"bad parameters {name}")

    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    host_ms = [1e3 * h["time"] for h in gpu.history[1:]]
    print(f"[slice] ms per LM iteration (median of iterations 1..): "
          f"device={statistics.median(dev_ms):.3f} "
          f"host={statistics.median(host_ms):.3f} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    for name in launches:
        print(f"[slice] kernel {name}: launches={launches[name]} "
              f"total_ms={kernel_ms[name]:.4f}")
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(launches["pcg_dense.dense_pcg"] == len(gpu.history),
          "dense_pcg must launch once per solve")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from graphite_tpu_torch.ops.cuda import pcg_dense, segsum, segsum_stream
    from graphite_tpu_torch.solvers import PCGSchurSolver

    print(f"[env] python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)}")
    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    phase_build()
    k1 = phase_k1("cuda")
    k2 = phase_k2("cuda", solver, mu=1e-4)
    all_stats = [segsum.STATS, segsum_stream.STATS, pcg_dense.STATS]
    launches = phase_slice(solver, 10, all_stats)

    measured = {**k1, "pcg_dense.dense_pcg": k2}
    sources = {
        "segsum.sorted_segment_sum": (
            "graphite_tpu_torch/csrc/segsum.cu",
            "graphite_tpu/ops/pallas/segsum.py:70"),
        "segsum_stream.streaming_segment_sum": (
            "graphite_tpu_torch/csrc/segsum.cu",
            "graphite_tpu/ops/pallas/segsum_stream.py:147"),
        "pcg_dense.dense_pcg": (
            "graphite_tpu_torch/csrc/pcg_dense.cu",
            "graphite_tpu/ops/pallas/pcg_dense.py:35"),
    }
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches[name],
                    max_abs_err=measured[name]["err"],
                    ms=measured[name]["ms"],
                    plain_ms=measured[name]["plain_ms"],
                    shapes=measured[name]["shapes"],
                    ms_by_shape=measured[name]["ms_by_shape"],
                    plain_ms_by_shape=measured[name]["plain_ms_by_shape"])
               for name, (source, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
