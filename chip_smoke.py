#!/usr/bin/env python3
"""Smoke run of graphite_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its numbers and its wall seconds on lines of their
own:

1. build the CUDA kernels from the checkout, one nvcc per source, all
   started together: K1 ``csrc/segsum.cu``, K2 ``csrc/pcg_dense.cu``, K3
   ``csrc/segprod.cu``, K4 / K5 ``csrc/segmv.cu``, K6 ``csrc/pcg_mf.cu``;
2. K1 vs its plain PyTorch version on the card, at the BAL Ladybug-49
   reduction shapes (seeded random inputs; each label names the plan's
   lanes per segment, ``group``): relative error <= 1e-5, two runs
   bitwise identical, and bitwise equal to the plain version on the CPU;
   K1's and ``index_add_``'s times also replayed from a CUDA graph, which
   leaves out the host's launch work (``device_only``);
3. K2 vs its plain version (``run_pcg``) on the first Schur system of the
   Ladybug-49 LM run (n = 441) and on a random SPD system (n = 1024):
   x within 1e-4 relative, the same number of CG steps;
4. the Ladybug-49 path: synthetic (seed 0), FP32_FP32, Levenberg-Marquardt
   with PCGSchurSolver(10, 1.0, 5.0) for 10 iterations on the card and on
   the CPU (plain versions). The accept patterns must be equal, each
   iteration's chi2 within 1e-3, the final chi2 below the initial one, and
   K1 and K2 launched by the run (dense_pcg once per solve);
4a. K6 vs its plain version on the card, on the inputs of the first LM
   solve of sphere2500 (``make_sphere_se3(2500, seed=0)``, SE3,
   block-Jacobi and identity) and of the 2500-pose SE2 circle: x within
   1e-5 relative, the same number of CG steps, two runs bitwise
   identical; also prints whether it equals the CPU plain version
   bitwise;
4b. the sphere2500 path: FP32_FP32, Levenberg-Marquardt (damping 1e-4)
   with PCGSolver(50, 1e-10, 1e6, block-Jacobi) for 30 iterations on the
   card and on the CPU: accept patterns equal, chi2 within 1e-3 per
   iteration, final chi2 below the initial one, finite unit quaternions,
   K6 launched once per solve and no ``run_pcg`` host loop; ms per
   iteration, K6's time and launches, peak memory;
4c. K1 vs its plain version at every reduction site of that run (the
   factor rows of linearize, which JtPv shares, and the block-Jacobi
   blocks, per slot; seeded values): relative error <= 1e-5, two runs
   bitwise identical, bitwise equal to the CPU plain version;
4d. sphere2500 with the K6 gate closed (``pcg_mf.J_BYTES_LIMIT = 0``),
   10 iterations on the card and on the CPU: ``run_pcg`` on
   ``hessian_matvec``, K1 launched, the same checks;
5. the BAL Venice-1778 problem (993,923 points, 5,001,946 observations,
   dim_p 16,002) frozen on the card, with its host set-up seconds;
6. K1, K3 (by index, and from gathered streams), K4 and K5 vs their
   plain versions on the card at Venice-1778's own shapes (indices and
   segment plans of the frozen problem, values of its first
   linearization, or seeded where the site has none or its values are
   intermediate): relative error <= 1e-5, two runs bitwise identical,
   and bitwise equal to the plain version on the CPU. K3's label counts
   its segments by lanes; K3 also times its best library route, two
   calls (``torch.bmm`` on the gathered streams, then ``index_add_``),
   as a yardstick: no single PyTorch call computes its function;
7. the Venice-1778 path: 10 LM iterations of PCGSchurSolver(10, 1.0, 5.0)
   on the card (the block-sparse branch): final chi2 below the initial
   one, finite parameters, K1, K3, K4 and K5 launched, the S matvec kernel
   once per CG matvec; ms per iteration, kernel times, peak memory;
8. Venice-1778 on the CPU for 2 LM iterations: the accept pattern equal to
   the card's and chi2 within 1e-3 per iteration;
9. Ladybug-49 with the Venice branches forced (``dense_matvec_limit=0``,
   the Schur gates lowered), 10 iterations on the card and on the CPU:
   accept patterns equal, chi2 within 1e-3, K3, K4 and K5 launched, with
   each kernel's launches and total ms.

Prints the kernels' JSON summary and the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. K1's, K3's, K4's and
K5's lines also print their times before their redesign (``was_ms``,
PERF.md's kernel table). Each kernel's entry
holds its launches on every main path, its time, its plain version's
time, the library call's time where one PyTorch call computes the same
function (``index_add_`` for K1, a cuSPARSE SpMV through ``torch.mv`` on
a CSR copy of the blocks for K4 and K5) and its bound: the larger of its
bytes over the HBM rate and its float32 operations over the float32 peak
(each summed over the same shapes as the times). Any failure raises
(non-zero exit); without a card it exits 1 at once and prints no result.
"""

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
import warnings

VENICE = "venice-big"  # make_bal size name of BAL Venice-1778
DEVICE = "cuda"


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


# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3
# bandwidth and the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved_bytes, ops):
    """The least time the card could take for a call: (ms if only its
    bytes moved, ms if only its float32 operations ran). Each input is
    counted read once and each output written once."""
    return dict(bytes_ms=1e3 * moved_bytes / HBM_BYTES_PER_S,
                ops_ms=1e3 * ops / FP32_OPS_PER_S)


def bound_fields(b):
    """``bound_ms`` and ``bound_by`` of a ``bound`` (or a sum of them)."""
    by = "bytes" if b["bytes_ms"] >= b["ops_ms"] else "operations"
    return dict(bound_ms=max(b["bytes_ms"], b["ops_ms"]), bound_by=by)


def csr_from_blocks(blocks, brow, bcol, n_brows, n_bcols):
    """A float32 CSR matrix of (n_brows*m, n_bcols*k) scalars holding the
    (m, k) blocks ``blocks`` at block rows / columns ``brow`` / ``bcol``
    (int64 tensors on the blocks' device). Built once per site, outside
    any timing: the library yardstick of K4 and K5 is one ``torch.mv`` on
    it (cuSPARSE SpMV)."""
    import torch

    nb, m, k = blocks.shape
    dev = blocks.device
    order = torch.argsort(brow * n_bcols + bcol)
    brow, bcol, blocks = brow[order], bcol[order], blocks[order]
    count = torch.bincount(brow, minlength=n_brows)
    start = torch.cumsum(count, 0) - count
    q = torch.arange(nb, device=dev) - start[brow]  # place in block row
    i = torch.arange(m, device=dev).view(1, m, 1)
    j = torch.arange(k, device=dev).view(1, 1, k)
    base = (m * k * start[brow] + q * k).view(nb, 1, 1)
    pos = (base + i * (count[brow] * k).view(nb, 1, 1) + j).reshape(-1)
    values = torch.empty(nb * m * k, dtype=torch.float32, device=dev)
    values[pos] = blocks.reshape(-1).float()
    cols = torch.empty(nb * m * k, dtype=torch.int32, device=dev)
    cols[pos] = (bcol.view(nb, 1, 1) * k + j).expand(nb, m, k).reshape(
        -1).int()
    del pos
    row_start = (m * k * start).view(-1, 1) + (
        torch.arange(m, device=dev).view(1, m) * (count * k).view(-1, 1))
    crow = torch.cat([row_start.reshape(-1),
                      torch.tensor([nb * m * k], device=dev)]).int()
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, values,
                                       (n_brows * m, n_bcols * k),
                                       check_invariants=False)


def phase_build():
    from graphite_tpu_torch.ops.cuda import (
        pcg_dense,
        pcg_mf,
        segmv,
        segsum,
        segsum_stream,
    )

    loaders = (segsum.load_kernel, pcg_dense.load_kernel,
               segsum_stream.load_product_kernel, segmv.load_kernel,
               pcg_mf.load_kernel)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        libs = list(pool.map(lambda load: load(), loaders))
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

# K1's, K3's, K4's and K5's times before their redesign (the "was" times
# of PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700 W), by (rows,
# width, permuted) or by name, printed beside this run's
WAS_MS = {
    (86_545, 81, False): "0.0370",
    (31_843, 3, False): "0.0258-0.0409", (31_843, 9, False): "0.0258-0.0409",
    (31_843, 27, False): "0.0258-0.0409", (30_621, 3, False): "0.0258-0.0409",
    (31_843, 81, True): "0.0458-0.0520", (31_843, 9, True): "0.0458-0.0520",
    (30_621, 9, True): "0.0458-0.0520",
    (2_744, 6, True): "0.0238 / 0.0272 (slot 0 / 1)",
    (2_744, 36, True): "0.0361 / 0.0233 (slot 0 / 1)",
    (5_001_946, 3, False): "0.0527", (5_001_946, 27, False): "1.0773",
    (5_001_946, 9, False): "0.1424", (5_001_946, 9, True): "0.4465",
    (5_001_946, 81, True): "0.8255",
    "s_matvec": "0.9215",
    "schur_values": "32.8372", "schur_values, gathered streams": "32.4457",
    "b_schur": "0.6013", "b_schur (kernel-6 form)": "0.5902",
    "back-substitution": "0.5524",
}


def was_ms(plan, width):
    return WAS_MS.get((plan.rows, width, plan.perm is not None))


def phase_k1(device):
    import numpy as np
    import torch

    from graphite_tpu_torch.kernel_sweep import graph_ms
    from graphite_tpu_torch.ops.cuda import segsum, segsum_stream

    rng = np.random.default_rng(0)
    stats = {}  # entry point -> one record per shape
    for k, ns, d, is_sorted, site in K1_SHAPES:
        seg = rng.integers(0, ns, k)
        if is_sorted:
            seg = np.sort(seg)
        plan = segsum.plan_segments(seg, ns, device, width=d)
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
            vals.cpu(), segsum.plan_segments(seg, ns, "cpu", width=d))
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        ms = device_ms(lambda: wrapper(vals, plan))
        plain_ms = device_ms(lambda: segsum.segment_sum_plain(vals, plan))
        library = k1_library(vals, torch.as_tensor(seg, device=device), ns)
        lib = device_ms(library, 10)
        # at these sizes the times above are mostly the host's launch
        # work; replayed from a CUDA graph, only the device's is left
        graph = graph_ms(lambda: wrapper(vals, plan))
        lib_graph = graph_ms(library)
        shape = f"{k}x{d}->{ns} group {plan.group}"
        print(f"[k1] {shape} {site}: rel_err={err:.3e} "
              f"max_abs_err={abs_err:.3e} bitwise_repeat="
              f"{torch.equal(out, again)} bitwise_vs_cpu_plain="
              f"{torch.equal(out.cpu(), ref_cpu)} ms={ms:.4f} "
              f"was_ms={was_ms(plan, d)} plain_ms={plain_ms:.4f} "
              f"index_add_ms={lib:.4f} device_only: ms={graph:.4f} "
              f"index_add_ms={lib_graph:.4f}")
        check(torch.equal(out, again), f"K1 not bitwise repeatable at {site}")
        check(torch.equal(out.cpu(), ref_cpu),
              f"K1 differs from the CPU plain version at {site}")
        check(err <= 1e-5, f"K1 rel err {err} > 1e-5 at {site}")
        stats.setdefault(name, []).append(dict(
            err=abs_err, ms=ms, plain_ms=plain_ms, shape=shape,
            library_ms=lib, **k1_bound(vals, plan)))
    return stats


def k1_bound(vals, plan):
    """K1 reads the values, the segment offsets and (unsorted) the sort
    permutation once, writes the sums once, and adds each value once."""
    return bound(nbytes(vals, plan.offsets_i32, plan.perm_i32)
                 + 4 * plan.num_segments * vals.shape[1], vals.numel())


def input_order_ids(plan):
    """The destination of each value row, in the values' own order."""
    import torch

    if plan.perm is None:
        return plan.seg
    ids = torch.empty_like(plan.seg)
    ids[plan.perm] = plan.seg
    return ids


def k1_library(vals, seg, num_segments):
    """The library call computing K1's sums: ``index_add_`` (float
    atomics) of the rows by their destinations ``seg`` (input order)."""
    import torch

    return lambda: torch.zeros(
        (num_segments, vals.shape[1]), device=vals.device).index_add_(
            0, seg, vals)


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
        if result is None:  # the main path's system
            n = bx.shape[0]
            # per CG step two (n, n) matvecs, three dots, a norm's
            # division and three vector updates; the start costs one
            # matvec and two dots
            ops = (k + 1) * (2 * n * n + 2 * 2 * n + n) + k * (
                2 * n * n + 2 * n + 6 * n)
            result = dict(err=abs_err, ms=ms, plain_ms=plain_ms,
                          shape=f"n={n}, {k} CG steps", library_ms=None,
                          **bound(nbytes(Sx, Mx, bx, x), ops))
    return {"pcg_dense.dense_pcg": [result]}


def run_lm(problem, solver, iterations, params=None):
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )

    return levenberg_marquardt(
        problem, solver, params,
        options=LevenbergMarquardtOptions(iterations=iterations))


def all_stats():
    """The launch counts of every kernel entry point."""
    from graphite_tpu_torch.ops.cuda import (
        pcg_dense,
        pcg_mf,
        segmv,
        segsum,
        segsum_stream,
    )

    return [segsum.STATS, segsum_stream.STATS, pcg_dense.STATS,
            segsum_stream.PRODUCT_STATS, segsum_stream.PRODUCT_RTBL_STATS,
            segsum_stream.MATVEC_TBL_STATS, segmv.STREAM_STATS,
            segmv.WTBL_STATS, segmv.SYM_STATS, pcg_mf.STATS]


def count_launches(run, record_events=True):
    """``run()`` with every launch count set to 0 just before it and read
    just after: (its result, launches and total kernel ms by entry)."""
    import torch

    stats = all_stats()
    for s in stats:
        s.reset()
        s.record_events = record_events
    try:
        out = run()
        torch.cuda.synchronize()
        launches = {s.name: s.launches for s in stats}
        kernel_ms = {s.name: s.total_ms() for s in stats}
    finally:
        for s in stats:
            s.record_events = False
            s.events.clear()
    return out, launches, kernel_ms


def compare_runs(tag, gpu, cpu):
    """CUDA vs CPU LM trajectories over the CPU run's iterations: equal
    accept patterns, chi2 within 1e-3 per iteration."""
    n = len(cpu.history)
    acc_gpu = [h["accepted"] for h in gpu.history[:n]]
    acc_cpu = [h["accepted"] for h in cpu.history]
    chi_gpu = [h["chi2"] for h in gpu.history[:n]]
    chi_cpu = [h["chi2"] for h in cpu.history]
    print(f"[{tag}] cuda initial_chi2={gpu.initial_chi2!r} chi2={chi_gpu}")
    print(f"[{tag}] cuda accepted={acc_gpu}")
    print(f"[{tag}] cpu initial_chi2={cpu.initial_chi2!r} chi2={chi_cpu}")
    print(f"[{tag}] cpu accepted={acc_cpu}")
    rel = [abs(a - b) / abs(b) for a, b in zip(chi_gpu, chi_cpu)]
    print(f"[{tag}] max per-iteration chi2 rel diff={max(rel):.3e} "
          f"bitwise_equal_trajectory="
          f"{chi_gpu == chi_cpu and gpu.initial_chi2 == cpu.initial_chi2}")
    check(len(gpu.history) >= n, f"{tag}: iteration counts differ")
    check(acc_gpu == acc_cpu, f"{tag}: accept patterns differ")
    check(max(rel) <= 1e-3, f"{tag}: chi2 differs by {max(rel)} > 1e-3")
    check(abs(gpu.initial_chi2 - cpu.initial_chi2)
          <= 1e-3 * abs(cpu.initial_chi2), f"{tag}: initial chi2 differs")


def check_solution(tag, problem, result):
    import torch

    check(result.chi2 < result.initial_chi2,
          f"{tag}: final chi2 not below initial")
    for name, p in result.params.items():
        check(p.shape == problem.params0[name].shape
              and bool(torch.isfinite(p).all()),
              f"{tag}: bad parameters {name}")


def print_launches(tag, launches, kernel_ms):
    for name in launches:
        if launches[name]:
            print(f"[{tag}] kernel {name}: launches={launches[name]} "
                  f"total_ms={kernel_ms[name]:.4f}")


def phase_slice(solver, iterations):
    problem = ladybug_problem(DEVICE)
    gpu, launches, kernel_ms = count_launches(
        lambda: run_lm(problem, solver, iterations))
    t1 = time.perf_counter()
    cpu = run_lm(ladybug_problem("cpu"), solver, iterations)
    print(f"[slice] cpu run {time.perf_counter() - t1:.1f} s")
    compare_runs("slice", gpu, cpu)
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("slice", problem, gpu)

    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    host_ms = [1e3 * h["time"] for h in gpu.history[1:]]
    print(f"[slice] ms per LM iteration (median of iterations 1..): "
          f"device={statistics.median(dev_ms):.3f} "
          f"host={statistics.median(host_ms):.3f} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    print_launches("slice", launches, kernel_ms)
    for name in ("segsum.sorted_segment_sum",
                 "segsum_stream.streaming_segment_sum",
                 "pcg_dense.dense_pcg"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(launches["pcg_dense.dense_pcg"] == len(gpu.history),
          "dense_pcg must launch once per solve")
    return launches


POSES = 2500  # sphere2500's pose count


def pose_problem(device, kind="se3"):
    """The SE3 sphere2500 graph (``make_sphere_se3(2500, seed=0)``) or the
    2500-pose SE2 circle, FP32_FP32, the first pose fixed."""
    import torch

    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import g2o, synthetic

    ds = (synthetic.make_sphere_se3(POSES, seed=0) if kind == "se3"
          else synthetic.make_pose_graph_2d(POSES, seed=0))
    g, *_ = g2o.build_graph(ds, precision=FP32_FP32)
    return g.freeze(device=torch.device(device))


def pose_solver(precond="bj"):
    """The pose path's solver: PCGSolver(50, 1e-10, 1e6) with block-Jacobi
    (or identity) preconditioning."""
    from graphite_tpu_torch.preconditioners import (
        BlockJacobiPreconditioner,
        IdentityPreconditioner,
    )
    from graphite_tpu_torch.solvers import PCGSolver

    return PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()
                     if precond == "bj" else IdentityPreconditioner())


def first_k6_inputs(problem, solver, mu):
    """The arguments the first LM solve (damping ``mu``) hands K6's
    wrapper, taken from the solver's own call."""
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.solvers import pcg as pcg_solver

    seen = []
    real = pcg_solver.solve_pcg_mf

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    pcg_solver.solve_pcg_mf = capture
    try:
        lin = linearize(problem, problem.params0)
        solver.solve(problem, lin, solver.prepare(problem, lin), mu, False)
    finally:
        pcg_solver.solve_pcg_mf = real
    check(len(seen) == 1, "the pose solve did not take the K6 branch")
    return seen[0]


def k6_bound(site, jf, b, damp, minv, steps):
    """K6 reads J', the slot rows, the row CSR, b, damp and the inverse
    blocks once and writes x once. Per CG step: J' p and J'^T v (a
    multiply-add per J' entry and incidence), damp * p, three dots, the
    norm's division, the block preconditioner and three vector updates;
    the start preconditions once and takes two dots."""
    N = site.n * site.d
    moved = nbytes(jf, site.rows, site.desc, site.csr_off, site.inc_j,
                   site.inc_v, site.inc_e, b, damp, minv) + 4 * N
    jp = sum(2 * blk.F * blk.arity * blk.E * site.d for blk in site.blocks)
    jtv = 2 * site.d * int(site.inc_e.sum()) + 3 * N
    pre = N + (2 * site.d * N if minv is not None else 0)
    step = jp + jtv + 3 * 2 * N + pre + 6 * N
    return bound(moved, steps * step + pre + 2 * 2 * N)


def phase_k6():
    """K6 vs its plain version on the first LM solve of sphere2500 (SE3,
    block-Jacobi and identity) and of the 2500-pose SE2 circle."""
    import torch

    from graphite_tpu_torch.ops.cuda import pcg_mf

    records = []
    for kind, precond in (("se3", "bj"), ("se3", "identity"), ("se2", "bj")):
        problem = pose_problem(DEVICE, kind)
        (site, jf, b, damp, minv), kw = first_k6_inputs(
            problem, pose_solver(precond), 1e-4)
        args = (site, jf, b, damp, minv)
        x, k = pcg_mf.solve_pcg_mf(*args, **kw)
        again, k2 = pcg_mf.solve_pcg_mf(*args, **kw)
        ref, k_ref = pcg_mf.solve_pcg_mf_plain(*args, **kw)
        x_cpu, k_cpu = pcg_mf.solve_pcg_mf_plain(
            on_cpu(site), jf.cpu(), b.cpu(), damp.cpu(),
            None if minv is None else minv.cpu(), **kw)
        torch.cuda.synchronize()
        k, k2, k_ref, k_cpu = int(k), int(k2), int(k_ref), int(k_cpu)
        err = rel_err(x, ref)
        abs_err = float((x - ref).abs().max())
        ms = device_ms(lambda: pcg_mf.solve_pcg_mf(*args, **kw))
        plain_ms = device_ms(lambda: pcg_mf.solve_pcg_mf_plain(*args, **kw),
                             reps=3)
        work = k6_bound(site, jf, b, damp, minv, k)
        label = (f"{kind} n={site.n} d={site.d} "
                 f"F={[blk.F for blk in site.blocks]} {precond}, {k} CG "
                 f"steps")
        print(f"[k6] {label}: rel_err={err:.3e} max_abs_err={abs_err:.3e} "
              f"iterations={k} plain_iterations={k_ref} cpu_iterations="
              f"{k_cpu} bitwise_repeat={torch.equal(x, again)} "
              f"bitwise_vs_cpu_plain={torch.equal(x.cpu(), x_cpu)} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound={bound_fields(work)}")
        check(torch.equal(x, again) and k == k2,
              f"K6 not bitwise repeatable ({label})")
        check(k == k_ref > 0, f"K6 took {k} steps, plain {k_ref} ({label})")
        check(err <= 1e-5, f"K6 rel err {err} > 1e-5 ({label})")
        records.append(dict(err=abs_err, ms=ms, plain_ms=plain_ms,
                            shape=label, library_ms=None, **work))
    return {"pcg_mf.solve_pcg_mf": records}


def check_quaternions(tag, result):
    import torch

    q = result.params["se3_pose"][:, 3:]
    norm_err = float((q.double().norm(dim=1) - 1.0).abs().max())
    print(f"[{tag}] max | |q| - 1 | = {norm_err:.3e}")
    check(bool(torch.isfinite(q).all()) and norm_err <= 1e-5,
          f"{tag}: quaternions not finite and unit")


def phase_pose(iterations):
    """sphere2500 through LM + PCGSolver on the card and on the CPU."""
    import torch

    from graphite_tpu_torch.solvers import pcg as pcg_solver

    solver = pose_solver()
    problem = pose_problem(DEVICE)
    loops = [0]
    real = pcg_solver.run_pcg

    def counted(*args, **kwargs):
        loops[0] += 1
        return real(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    pcg_solver.run_pcg = counted
    try:
        gpu, launches, kernel_ms = count_launches(
            lambda: run_lm(problem, solver, iterations))
    finally:
        pcg_solver.run_pcg = real
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    cpu = run_lm(pose_problem("cpu"), solver, iterations)
    print(f"[sphere2500] cpu run {time.perf_counter() - t1:.1f} s")
    compare_runs("sphere2500", gpu, cpu)
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("sphere2500", problem, gpu)
    check_quaternions("sphere2500", gpu)
    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    host_ms = [1e3 * h["time"] for h in gpu.history[1:]]
    print(f"[sphere2500] dim_h={problem.dim_h} ms per LM iteration (median "
          f"of iterations 1..): device={statistics.median(dev_ms):.3f} "
          f"host={statistics.median(host_ms):.3f} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    print(f"[sphere2500] peak device memory max_memory_allocated="
          f"{peak / 2**30:.4f} GiB; run_pcg host loops={loops[0]}")
    print_launches("sphere2500", launches, kernel_ms)
    check(launches["pcg_mf.solve_pcg_mf"] == len(gpu.history),
          "K6 must launch once per solve")
    check(loops[0] == 0, "run_pcg ran on the K6 branch")
    check(launches["segsum_stream.streaming_segment_sum"] > 0,
          "K1 never launched on the pose path")
    return launches, problem


def phase_pose_generic(iterations):
    """sphere2500 with the K6 gate closed (``J_BYTES_LIMIT = 0``): run_pcg
    on hessian_matvec, JtPv reducing through K1; CUDA vs CPU."""
    from graphite_tpu_torch.ops.cuda import pcg_mf

    solver = pose_solver()
    gate = pcg_mf.J_BYTES_LIMIT
    pcg_mf.J_BYTES_LIMIT = 0
    try:
        problem = pose_problem(DEVICE)
        gpu, launches, _ = count_launches(
            lambda: run_lm(problem, solver, iterations), record_events=False)
        cpu = run_lm(pose_problem("cpu"), solver, iterations)
    finally:
        pcg_mf.J_BYTES_LIMIT = gate
    compare_runs("sphere2500-generic", gpu, cpu)
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("sphere2500-generic", problem, gpu)
    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    print(f"[sphere2500-generic] ms per LM iteration (median of iterations "
          f"1..): device={statistics.median(dev_ms):.3f}")
    print(f"[sphere2500-generic] launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(launches["pcg_mf.solve_pcg_mf"] == 0, "K6 launched, gate closed")
    check(launches["segsum_stream.streaming_segment_sum"] > 0,
          "K1 never launched on the generic pose branch")
    return launches


def phase_venice_setup():
    """BAL Venice-1778 frozen on the card, its structures and one pass of
    the solve's stages (which builds every host plan)."""
    import torch

    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu_torch.io import bal, synthetic
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.schur import (
        SchurOps,
        build_schur_structure,
        schur_values,
    )

    secs = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        secs[name] = round(now - t, 3)
        t = now

    ds = synthetic.make_bal(VENICE, seed=0)
    lap("make_bal")
    g, *_ = bal.build_graph(ds, precision=FP32_FP32)
    lap("build_graph")
    problem = g.freeze(device=torch.device(DEVICE))
    lap("freeze")
    hs = build_hessian_structure(problem)
    lap("hessian_structure")
    ss = build_schur_structure(problem)
    lap("schur_structure")
    lin = linearize(problem, problem.params0)
    hv = apply_damping(problem, hs, compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-4, False)
    sv = schur_values(problem, ss, hv)
    ops = SchurOps(problem, ss, hv, sv)
    ops.b_schur(lin.b)
    ops.prepare_matvec()
    ops.s_matvec(torch.zeros(ss.dim_p, device=problem.device))
    ops.landmark_update(lin.b, torch.zeros(ss.dim_p, device=problem.device))
    torch.cuda.synchronize()
    lap("first_pass_with_plans")

    sizes = (ds.cameras.shape[0], ds.points.shape[0],
             ds.observations.shape[0])
    print(f"[venice] cameras, points, observations={sizes} "
          f"dim_h={problem.dim_h} dim_p={ss.dim_p} "
          f"s_blocks={ss.s_sizes} "
          f"products={[(g['dims'], g['dst'].shape[0]) for g in ss.products]} "
          f"hpl_blocks={ {k: v.shape[0] for k, v in ss.hpl_pose.items()} }")
    print(f"[venice] host set-up seconds {secs} "
          f"total={sum(secs.values()):.1f}")
    check(sizes == synthetic.BAL_SIZES[VENICE], f"Venice sizes {sizes}")
    check(ss.dim_p == 9 * sizes[0], f"dim_p {ss.dim_p}")
    return ds, problem, lin, hv, sv, ops


def measure(tag, label, kernel, plain, cpu_plain, reps, plain_reps, work,
            library=None, was=None):
    """A kernel vs its plain version on the card (and on the CPU) at one
    shape, ``work`` its ``bound``, ``library`` (or None) the one PyTorch
    call computing the same function, ``was`` (or None) its time before
    its redesign; returns its numbers."""
    import torch

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    out, again, ref = tup(kernel()), tup(kernel()), tup(plain())
    torch.cuda.synchronize()
    err = max(rel_err(o, r) for o, r in zip(out, ref))
    abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    repeat = all(torch.equal(o, a) for o, a in zip(out, again))
    del again, ref
    cpu_ref = tup(cpu_plain())
    vs_cpu = all(torch.equal(o.cpu(), c) for o, c in zip(out, cpu_ref))
    del out, cpu_ref
    ms = device_ms(kernel, reps)
    plain_ms = device_ms(plain, plain_reps)
    lib_ms = None if library is None else device_ms(library, reps)
    print(f"[{tag}] {label}: rel_err={err:.3e} max_abs_err={abs_err:.3e} "
          f"bitwise_repeat={repeat} bitwise_vs_cpu_plain={vs_cpu} "
          f"ms={ms:.4f} "
          + ("" if was is None else f"was_ms={was} ")
          + f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
          f"bound_ms={bound_fields(work)}")
    check(repeat, f"{tag} not bitwise repeatable at {label}")
    check(vs_cpu, f"{tag} differs from the CPU plain version at {label}")
    check(err <= 1e-5, f"{tag} rel err {err} > 1e-5 at {label}")
    return dict(err=abs_err, ms=ms, plain_ms=plain_ms, shape=label,
                library_ms=lib_ms, **work)


def on_cpu(obj):
    """A copy of a plan or site dataclass with its tensors on the CPU."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu()
        for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


def k1_sites(problem, path):
    """(label, plan, width) of every K1 reduction a path ran on
    ``problem``, from its cached segment plans: the factor rows of
    ``linearize`` (and of ``JtPv``, which shares their plans), the Hessian
    value groups and the block-Jacobi blocks."""
    from graphite_tpu_torch.hessian import build_hessian_structure

    sites = []
    for tag, plan in problem._cache["segment_plans"].items():
        if tag[0] in ("rows", "bj_blocks"):
            _, fname, s = tag
            vt = problem.factor_meta[fname].ftype.vertex_types[s]
            label, d = ((f"linearize rows of {vt.name}", vt.dim)
                        if tag[0] == "rows" else
                        (f"block-Jacobi blocks of {vt.name}", vt.dim ** 2))
            if problem.factor_meta[fname].ftype.arity > 1:
                label += f" slot {s}"
        elif tag[0] in ("hess_d", "hess_t"):
            cm = build_hessian_structure(problem).contribs[tag[1]]
            key = cm.direct_group if tag[0] == "hess_d" else cm.trans_group
            label, d = f"hessian group {key}", key[0] * key[1]
        else:  # the Schur sites below their gates: not on these paths
            continue
        label += ", permuted" if plan.perm is not None else ""
        sites.append((f"{path} {plan.rows}x{d}->{plan.num_segments} group "
                      f"{plan.group} {label}", plan, d))
    return sites


def phase_k1_sites(problem, path, seed):
    """K1 vs its plain version at every reduction site of ``path`` on
    ``problem`` (seeded values)."""
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import segsum_stream
    from graphite_tpu_torch.ops.cuda.segsum import segment_sum_plain

    rng = np.random.default_rng(seed)
    records = []
    for label, plan, d in k1_sites(problem, path):
        vals = torch.as_tensor(
            rng.standard_normal((plan.rows, d)).astype(np.float32),
            device=problem.device)
        cvals, cplan = vals.cpu(), on_cpu(plan)
        records.append(measure(
            "k1", label,
            lambda: segsum_stream.streaming_segment_sum(vals, plan),
            lambda: segment_sum_plain(vals, plan),
            lambda: segment_sum_plain(cvals, cplan), 10, 3,
            k1_bound(vals, plan),
            k1_library(vals, input_order_ids(plan), plan.num_segments),
            was_ms(plan, d)))
        del vals, cvals, cplan
    check(records, f"no K1 site on the {path} path")
    return {"segsum_stream.streaming_segment_sum": records}


def product_lanes_label(plan):
    """How many segments of a K3 plan take each number of lanes, as
    {lanes: segments}."""
    return "{" + ", ".join(f"{g}: {segs.shape[0]}"
                           for g, _, segs in plan.buckets) + "}"


def phase_venice_kernels(problem, lin, hv, sv, ops):
    """K1, K3, K4 and K5 vs their plain versions at Venice-1778's
    shapes."""
    import numpy as np
    import torch

    from graphite_tpu_torch import schur
    from graphite_tpu_torch.ops.cuda import segmv, segsum_stream
    from graphite_tpu_torch.ops.cuda.segsum import plan_segments
    from graphite_tpu_torch.ops.streamreduce import (
        matvec_plan,
        product_plan,
        take_rows,
    )

    ss = ops.ss
    rng = np.random.default_rng(2)
    # K1: every row reduction of linearize and the Hessian values
    results = phase_k1_sites(problem, "Venice", 3)

    def add(name, r):
        results.setdefault(name, []).append(r)

    def cpu(*ts):
        return [None if t is None else t.cpu() for t in ts]

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=problem.device)

    def spmv(csr, x):
        return lambda: torch.mv(csr, x.reshape(-1))

    # K3: the Schur triple products, W and Hpl read by index
    (pg,) = ss.products
    dpa, dl, dpb = pg["dims"]
    ns = ss.s_sizes[pg["dst_key"]]
    W = schur.hpl_w_values(problem, ss, hv, sv.hll_inv)[pg["left_key"]]
    R = hv[pg["right_key"]]
    plan = product_plan(problem, ("prod_k3", 0), pg["dst"], ns)
    li = problem.index32(("prod_l", 0), pg["left"])
    ri = problem.index32(("prod_r", 0), pg["right"])
    cW, cR, cli, cri = cpu(W, R, li, ri)
    cplan = segsum_stream.plan_products(pg["dst"], ns, "cpu")
    label = (f"{plan.rows}x({dpa},{dl},{dpb})->{ns}, segments by lanes "
             f"{product_lanes_label(plan)} schur_values")
    # K3 reads W, Hpl and both index streams once, writes S once; each
    # product is dpa*dl*dpb multiply-adds
    work = bound(nbytes(W, R, li, ri, plan.segments.offsets_i32)
                 + 4 * ns * dpa * dpb, 2 * plan.rows * dpa * dl * dpb)
    add("segsum_stream.streaming_segment_product_sum_rtbl", measure(
        "k3", label,
        lambda: segsum_stream.streaming_segment_product_sum_rtbl(
            W, R, plan, dpa, dl, dpb, li, ri),
        lambda: segsum_stream.segment_product_sum_plain(
            W, R, plan, dpa, dl, dpb, li, ri),
        lambda: segsum_stream.segment_product_sum_plain(
            cW, cR, cplan, dpa, dl, dpb, cli, cri), 5, 2, work,
        was=WAS_MS["schur_values"]))
    del cW, cR
    # the same products from gathered streams (no path calls this entry):
    # K3 reads both streams once, writes S once
    Wg, Rg = W.index_select(0, li.long()), R.index_select(0, ri.long())
    del W, R
    cWg, cRg = cpu(Wg, Rg)
    work = bound(nbytes(Wg, Rg, plan.segments.offsets_i32)
                 + 4 * ns * dpa * dpb, 2 * plan.rows * dpa * dl * dpb)
    add("segsum_stream.streaming_segment_product_sum", measure(
        "k3", label + ", gathered streams",
        lambda: segsum_stream.streaming_segment_product_sum(
            Wg, Rg, plan, dpa, dl, dpb),
        lambda: segsum_stream.segment_product_sum_plain(
            Wg, Rg, plan, dpa, dl, dpb),
        lambda: segsum_stream.segment_product_sum_plain(
            cWg, cRg, cplan, dpa, dl, dpb), 5, 2, work,
        was=WAS_MS["schur_values, gathered streams"]))
    del cWg, cRg, cli, cri
    # no single PyTorch call computes K3's function; its best library
    # route is two calls on the gathered streams: the per-row products
    # (torch.bmm, a (rows, dpa*dpb) buffer), then index_add_ into S
    seg = plan.segments.seg
    two_calls = device_ms(lambda: torch.zeros(
        (ns, dpa * dpb), device=problem.device).index_add_(0, seg, torch.bmm(
            Wg.view(-1, dpa, dl), Rg.view(-1, dpb, dl).transpose(1, 2)).view(
                -1, dpa * dpb)), 3)
    print(f"[k3] {label}: library yardstick, two calls (torch.bmm on the "
          f"gathered streams, then index_add_): ms={two_calls:.4f}")
    del Wg, Rg
    torch.cuda.empty_cache()

    # K4: b_schur, its kernel-6 form, the back-substitution
    key = ss.hpl_keys[0]
    dp, dl = key
    ((pt, lt, sub, prow, lrow),) = ops.hpl_partitions(key)
    A = take_rows(problem, ("bschur", key, pt, lt, "sub"), ops.hpl(key), sub)
    n_pt, n_lt = problem.seg_rows[pt], problem.seg_rows[lt]
    w = ops._hll_solve_rows({lt: problem.rows_view(lin.b, lt)})[lt]
    plan_b = matvec_plan(problem, ("bschur", key, pt, lt), prow, n_pt)
    lid = problem.index32(("bschur", key, pt, lt, "lid"), lrow)
    cplan_b = plan_segments(prow, n_pt, "cpu")
    cA, cw, clid = cpu(A, w, lid)
    label = (f"{A.shape[0]}x({dp},{dl})->{n_pt}, w[{n_lt}] by index, "
             f"group {plan_b.group}, tiles of "
             f"{segmv.k4_tile_blocks(dp, dl)} b_schur")
    rows_k4 = A.shape[0]
    blocks = A.view(rows_k4, dp, dl)

    def k4_work(x, xi, mplan, out_rows, out_dim):
        """K4 reads the blocks, x, its index and the plan once, writes the
        sums once; each block is dp*dl multiply-adds."""
        return bound(nbytes(A, x, xi, mplan.offsets_i32,
                            mplan.perm_i32) + 4 * out_rows * out_dim,
                     2 * rows_k4 * dp * dl)

    csr = csr_from_blocks(blocks, dev(prow), dev(lrow), n_pt, n_lt)
    add("segmv.block_matvec_wtbl", measure(
        "k4", label,
        lambda: segmv.block_matvec_wtbl(A, w, plan_b, lid, dp, dl),
        lambda: segmv.segmv_plain(A, w, lid, plan_b, dp, dl),
        lambda: segmv.segmv_plain(cA, cw, clid, cplan_b, dp, dl), 10, 3,
        k4_work(w, lid, plan_b, n_pt, dp), spmv(csr, w), WAS_MS["b_schur"]))
    wg = w.index_select(0, lid)
    cwg = wg.cpu()
    csr = csr_from_blocks(blocks, dev(prow),
                          torch.arange(rows_k4, device=problem.device),
                          n_pt, rows_k4)
    add("segmv.block_matvec_stream", measure(
        "k4", label.replace("by index", "gathered") + " (kernel-6 form)",
        lambda: segmv.block_matvec_stream(A, wg, plan_b, dp, dl),
        lambda: segmv.segmv_plain(A, wg, None, plan_b, dp, dl),
        lambda: segmv.segmv_plain(cA, cwg, None, cplan_b, dp, dl), 10, 3,
        k4_work(wg, None, plan_b, n_pt, dp), spmv(csr, wg),
        WAS_MS["b_schur (kernel-6 form)"]))
    x = torch.as_tensor(rng.standard_normal((n_pt, dp)).astype(np.float32),
                        device=problem.device)
    plan_l = matvec_plan(problem, ("lu", key, pt, lt), lrow, n_lt)
    pidx = problem.index32(("lu", key, pt, lt, "pidx"), prow)
    cplan_l = plan_segments(lrow, n_lt, "cpu")
    cx, cpidx = cpu(x, pidx)
    csr = csr_from_blocks(blocks.transpose(1, 2), dev(lrow), dev(prow),
                          n_lt, n_pt)
    add("segsum_stream.streaming_matvec_tbl", measure(
        "k4", f"{A.shape[0]}x({dp},{dl})^T->{n_lt}, x[{n_pt}] by index, "
        f"group {plan_l.group} back-substitution",
        lambda: segsum_stream.streaming_matvec_tbl(A, x, pidx, plan_l, dp,
                                                   dl, transpose=True),
        lambda: segmv.segmv_plain(A, x, pidx, plan_l, dp, dl, True),
        lambda: segmv.segmv_plain(cA, cx, cpidx, cplan_l, dp, dl, True),
        10, 3, k4_work(x, pidx, plan_l, n_lt, dl), spmv(csr, x),
        WAS_MS["back-substitution"]))
    del A, cA, w, cw, wg, cwg, blocks, csr

    # K5: the PCG's S matvec
    skey = (dp, dp)
    ((rt, ct, sub, rrow, crow, off),) = ops.s_sites(skey)
    splan, cid, rxi = ops.sym_site(skey, rt, ct)
    S = take_rows(problem, ("smv", skey, rt, ct, "ysub"), sv.s_vals[skey],
                  sub)
    xv = torch.as_tensor(rng.standard_normal(ss.dim_p).astype(np.float32),
                         device=problem.device)
    xc, xr = problem.rows_view(xv, ct), problem.rows_view(xv, rt)
    cplan_s = segmv.plan_matvec_sym(rrow, crow, problem.seg_rows[rt],
                                    problem.seg_rows[ct], "cpu", dp)
    cS, cxc, cxr, ccid, crxi = cpu(S, xc, xr, cid, rxi)
    n_r, n_c = problem.seg_rows[rt], problem.seg_rows[ct]
    # K5 reads S, both x tables, both indices and both plans once, writes
    # both halves once; every block once forward, the off-diagonal ones
    # once transposed
    work = bound(
        nbytes(S, xc, xr, cid, rxi, splan.rows.offsets_i32,
               splan.rows.perm_i32, splan.cols.offsets_i32,
               splan.cols.perm_i32) + 4 * dp * (n_r + n_c),
        2 * dp * dp * (S.shape[0] + off.size))
    # library: one SpMV of the whole symmetric S (both halves summed,
    # which is what s_matvec makes of K5's two outputs)
    check(rt == ct, "K5's site is not on the diagonal of S")
    S3, offt = S.view(-1, dp, dp), dev(off)
    csr = csr_from_blocks(
        torch.cat([S3, S3.index_select(0, offt).transpose(1, 2)]),
        dev(np.concatenate([rrow, crow[off]])),
        dev(np.concatenate([crow, rrow[off]])), n_r, n_c)
    del S3, offt
    check(splan.cols.perm is None, "K5's column plan is not in stored order")
    add("segmv.matvec_sym_stream", measure(
        "k5", f"{S.shape[0]}x({dp},{dp})->{n_r}, "
        f"{off.size} off-diagonal, one read of S, groups "
        f"{splan.rows.group} (rows, K1) / {splan.cols.group} (columns) "
        f"s_matvec",
        lambda: segmv.matvec_sym_stream(S, xc, xr, cid, rxi, splan, dp, dp),
        lambda: segmv.matvec_sym_plain(S, xc, xr, cid, rxi, splan, dp, dp),
        lambda: segmv.matvec_sym_plain(cS, cxc, cxr, ccid, crxi, cplan_s,
                                       dp, dp), 20, 5, work, spmv(csr, xc),
        WAS_MS["s_matvec"]))
    del S, cS, csr
    torch.cuda.empty_cache()
    return results


def merge_measured(*parts):
    """Every phase's records of each entry point, in phase order."""
    out = {}
    for part in parts:
        for name, records in part.items():
            out.setdefault(name, []).extend(records)
    return out


def phase_venice_slice(problem, solver, iterations):
    import torch

    from graphite_tpu_torch.schur import SchurOps

    matvecs = [0]
    s_matvec = SchurOps.s_matvec

    def counted(self, x):
        matvecs[0] += 1
        return s_matvec(self, x)

    torch.cuda.reset_peak_memory_stats()
    SchurOps.s_matvec = counted
    try:
        gpu, launches, kernel_ms = count_launches(
            lambda: run_lm(problem, solver, iterations))
    finally:
        SchurOps.s_matvec = s_matvec
    peak = torch.cuda.max_memory_allocated()
    check_solution("venice", problem, gpu)
    hist = gpu.history
    print(f"[venice] cuda initial_chi2={gpu.initial_chi2!r} "
          f"chi2={[h['chi2'] for h in hist]}")
    print(f"[venice] cuda accepted={[h['accepted'] for h in hist]}")
    dev_ms = [h["device_ms"] for h in hist]
    acc = [h["device_ms"] for h in hist[1:] if h["accepted"]]
    rej = [h["device_ms"] for h in hist[1:] if not h["accepted"]]
    print(f"[venice] ms per LM iteration (median of iterations 1..): "
          f"device={statistics.median(dev_ms[1:]):.3f} "
          f"accepted={statistics.median(acc) if acc else None} "
          f"rejected={statistics.median(rej) if rej else None} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    print(f"[venice] peak device memory max_memory_allocated="
          f"{peak / 2**30:.3f} GiB; CG matvecs={matvecs[0]}")
    print_launches("venice", launches, kernel_ms)
    k3 = (launches["segsum_stream.streaming_segment_product_sum_rtbl"]
          + launches["segsum_stream.streaming_segment_product_sum"])
    check(k3 > 0, "K3 never launched on the Venice path")
    for name in ("segsum_stream.streaming_segment_sum",
                 "segmv.block_matvec_wtbl",
                 "segsum_stream.streaming_matvec_tbl",
                 "segmv.matvec_sym_stream"):
        check(launches[name] > 0, f"{name} never launched on the Venice path")
    check(launches["segmv.matvec_sym_stream"] == matvecs[0],
          "matvec_sym_stream must launch once per CG matvec")
    return gpu, launches


def phase_venice_cpu(ds, params0, gpu, solver, iterations):
    """The CPU run starts from the card run's parameters (``params0``,
    NumPy, handed over by ``interop``)."""
    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.interop import params_from_numpy
    from graphite_tpu_torch.io import bal

    g, *_ = bal.build_graph(ds, precision=FP32_FP32)
    cpu = run_lm(g.freeze(device="cpu"), solver, iterations,
                 params_from_numpy(params0))
    compare_runs("venice-cpu", gpu, cpu)


def phase_forced(iterations):
    """Ladybug-49 with every Venice branch forced, CUDA vs CPU."""
    from graphite_tpu_torch import schur
    from graphite_tpu_torch.solvers import PCGSchurSolver

    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    gates = schur.CHUNK_THRESHOLD, schur._smv_chunk_rows
    schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = 0, (lambda rb: 0)
    try:
        problem = ladybug_problem(DEVICE)
        gpu, launches, kernel_ms = count_launches(
            lambda: run_lm(problem, solver, iterations))
        cpu = run_lm(ladybug_problem("cpu"), solver, iterations)
    finally:
        schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = gates
    compare_runs("forced", gpu, cpu)
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("forced", problem, gpu)
    print_launches("forced", launches, kernel_ms)
    for name in ("segsum_stream.streaming_segment_product_sum_rtbl",
                 "segmv.block_matvec_wtbl",
                 "segsum_stream.streaming_matvec_tbl",
                 "segmv.matvec_sym_stream"):
        check(launches[name] > 0, f"{name} never launched (forced)")


# (kernel, source, {entry point: TPU kernel body it replaces})
KERNELS = [
    ("K1", "graphite_tpu_torch/csrc/segsum.cu", {
        "segsum.sorted_segment_sum": "graphite_tpu/ops/pallas/segsum.py:70",
        "segsum_stream.streaming_segment_sum":
            "graphite_tpu/ops/pallas/segsum_stream.py:147"}),
    ("K2", "graphite_tpu_torch/csrc/pcg_dense.cu", {
        "pcg_dense.dense_pcg": "graphite_tpu/ops/pallas/pcg_dense.py:35"}),
    ("K3", "graphite_tpu_torch/csrc/segprod.cu", {
        "segsum_stream.streaming_segment_product_sum":
            "graphite_tpu/ops/pallas/segsum_stream.py:327",
        "segsum_stream.streaming_segment_product_sum_rtbl":
            "graphite_tpu/ops/pallas/segsum_stream.py:489"}),
    ("K4", "graphite_tpu_torch/csrc/segmv.cu", {
        "segsum_stream.streaming_matvec_tbl":
            "graphite_tpu/ops/pallas/segsum_stream.py:639",
        "segmv.block_matvec_wtbl": "graphite_tpu/ops/pallas/segmv.py:425",
        "segmv.block_matvec_stream": "graphite_tpu/ops/pallas/segmv.py:176"}),
    ("K5", "graphite_tpu_torch/csrc/segmv.cu", {
        "segmv.matvec_sym_stream": "graphite_tpu/ops/pallas/segmv.py:303"}),
    ("K6", "graphite_tpu_torch/csrc/pcg_mf.cu", {
        "pcg_mf.solve_pcg_mf": "graphite_tpu/ops/pallas/pcg_mf.py:121"}),
]


def summed(records, key):
    """The sum of ``key`` over records, or None if any record lacks it."""
    vals = [r[key] for r in records]
    return None if any(v is None for v in vals) else sum(vals)


def kernels_json(measured, launches_by_path):
    """One entry per kernel: its times summed over the measured shapes of
    all its entry points (one call each), the bound and the library call
    over the same shapes, and its launches on every main path."""
    out = []
    for kernel, source, entries in KERNELS:
        recs = [r for e in entries for r in measured.get(e, [])]
        by_path = {path: sum(launches[e] for e in entries)
                   for path, launches in launches_by_path.items()}
        work = dict(bytes_ms=sum(r["bytes_ms"] for r in recs),
                    ops_ms=sum(r["ops_ms"] for r in recs))
        out.append(dict(
            name=kernel + ": " + ", ".join(entries), route="cuda",
            source=source, replaces=", ".join(entries.values()),
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["err"] for r in recs),
            ms=sum(r["ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(bound_fields(r)["bound_ms"] for r in recs),
            bound_by=bound_fields(work)["bound_by"],
            library_ms=summed(recs, "library_ms"),
            entry_points=[dict(
                name=e, replaces=r,
                launches={p: launches[e]
                          for p, launches in launches_by_path.items()},
                shapes=[m["shape"] for m in measured[e]],
                ms_by_shape=[m["ms"] for m in measured[e]],
                plain_ms_by_shape=[m["plain_ms"] for m in measured[e]],
                bound_ms_by_shape=[bound_fields(m)["bound_ms"]
                                   for m in measured[e]],
                library_ms_by_shape=[m["library_ms"] for m in measured[e]])
                for e, r in entries.items() if e in measured]))
    return out


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{name}] phase seconds={time.perf_counter() - t0:.1f}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from graphite_tpu_torch.interop import params_to_numpy
    from graphite_tpu_torch.solvers import PCGSchurSolver

    t_start = time.perf_counter()
    print(f"[env] python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)}")
    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    timed("build", phase_build)
    k1 = timed("k1", phase_k1, DEVICE)
    k2 = timed("k2", phase_k2, DEVICE, solver, 1e-4)
    ladybug_launches = timed("slice", phase_slice, solver, 10)
    k6 = timed("k6", phase_k6)
    pose_launches, pose = timed("sphere2500", phase_pose, 30)
    pose_k1 = timed("sphere2500-k1", phase_k1_sites, pose, "sphere2500", 4)
    del pose
    generic_launches = timed("sphere2500-generic", phase_pose_generic, 10)

    ds, problem, lin, hv, sv, ops = timed("venice-setup", phase_venice_setup)
    venice_measured = timed("venice-kernels", phase_venice_kernels, problem,
                            lin, hv, sv, ops)
    del lin, hv, sv, ops
    torch.cuda.empty_cache()
    params0 = params_to_numpy(problem.params0)
    gpu, venice_launches = timed("venice", phase_venice_slice, problem,
                                 solver, 10)
    del problem
    torch.cuda.empty_cache()
    timed("venice-cpu", phase_venice_cpu, ds, params0, gpu, solver, 2)
    del ds
    timed("forced", phase_forced, 10)

    measured = merge_measured(k1, k2, k6, pose_k1, venice_measured)
    print(json.dumps({"kernels": kernels_json(
        measured, {"ladybug-49": ladybug_launches,
                   "sphere2500": pose_launches,
                   "sphere2500-generic": generic_launches,
                   "venice-1778": venice_launches})}))
    print(f"[done] total seconds={time.perf_counter() - t_start:.1f}")

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
