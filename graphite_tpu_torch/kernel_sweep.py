"""Device times of the port's kernels at the main paths' shapes, a
launch's host time, and the cost of a cluster's synchronisation.

    python -m graphite_tpu_torch.kernel_sweep

On a CUDA card (it exits 1 without one), from seeded random inputs:

1. host microseconds per call (the median of seven runs of 400 calls),
   the device left to run behind: the K1 wrapper at a Ladybug-49 camera
   site (30,621x9 rows into 49), one ``torch.zeros`` + ``index_add_`` of
   the same rows, and the pieces of a launch (``torch.empty``, ``torch.cuda.current_stream().cuda_stream``,
   the raw stream pointer, entering ``torch.cuda.device`` and
   ``launches.on_device``);
2. K1's device time at each forced group (lanes per segment: 1, 8, ...,
   256) at Ladybug-49's and Venice-1778's permuted camera shapes and at
   Ladybug's product scatter, beside ``index_add_``;
3. K5's device time on a random S of Venice-1778's size (1,580,797 9x9
   blocks over 1,778 block columns, sorted, random block rows) at each
   forced group, whole and by pass (pass 1 with and without the
   longest-first column order; pass 2, K1 over the row products);
4. K3's device time at Venice-1778's triple-product shape (17,048,613
   rows of (9, 3, 9) into 1,580,797 S blocks: 1,778 diagonal ones of
   ~2,813 rows, the others Poisson(7.63); W and Hpl tables of 4,995,188
   rows read by random index), whole, its long segments alone and its
   short ones alone;
5. K4's device time at Venice-1778's two sites, by blocks per tile (32,
   64, 128, 256): the back-substitution (4,995,188 (9, 3)^T blocks into
   993,923 sorted landmark rows, x read by pose index) and b_S (the same
   blocks into 1,778 pose rows through the sort permutation, w read by
   sorted landmark index);
6. the cost of one synchronisation of a thread-block cluster of 1, 2, 4,
   8 and 16 CTAs, at K6's and K2's block sizes: a release/acquire cluster
   barrier and a fence-free exchange (each CTA stores one float into every
   CTA's shared memory with st.async and waits on its mbarrier), from
   1,010 against 10 back to back in one launch;
7. K6 (the whole matrix-free PCG) on the first LM solve of sphere2500
   (SE3 block-Jacobi, SE3 identity) and of the 2500-pose SE2 circle, and
   K2 (the whole dense PCG) on Ladybug-49's first Schur system (n = 441,
   PCGSchurSolver(10, 1.0, 5.0)) and a random SPD system (n = 1,024, 10
   steps, its slices streamed), each at every cluster size; K6
   also with J' staged in shared memory and read from global memory only;
   and each kernel's sync floor: its barriers and exchanges per solve
   times their cost at the cluster size its wrapper picks;
8. K9 (the PCG's dot) at Venice-1778's dim_p (16,002, float32 and
   float64) and sphere2500's n d (14,994) on a cluster of 1, 2, 4, 8 and
   16 CTAs, beside ``torch.dot``;
9. K10 (the landmark inverses and W = Hpl Hll^-1) at Venice-1778's
   shape (993,923 3x3 Hll blocks, Poisson(5.03) (9, 3) Hpl blocks a
   landmark: ~5.0 M) beside its plain version and its bytes bound;
10. K7's Hessian sum at Venice-1778's three sites (5,001,946 factors of
   random cameras and sorted points: Hpp, 1,779 camera blocks through the
   sort permutation, the plan's 32 lanes; Hpl, one block a distinct
   (point, camera) pair, and Hll, 993,924 point blocks, both sorted, one
   lane), float32 and float64 (J, dL and the sums in the graph's type),
   whole, with its loads alone and with its products alone (the kernel's
   own loop either way: ``gt_bal_hessian_sum_probe``), beside its bytes
   bound;
11. the same sites' Hessian sum whole in each of K7's seven (graph,
   storage) instances (J stored in float32, bf16 or fp16 on a float32
   graph; float64, float32, bf16 or fp16 on a float64 one), through the
   wrapper alone, beside its bytes bound.

Device times are CUDA-event means over 20 calls captured in one CUDA
graph and replayed, so no host time is in them. Prints one line per
measurement, the card's name and power limit first. ``--sections 10 2``
runs those sections alone.
"""

from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .ops.cuda import bal as k7
from .ops.cuda import (
    dot,
    launches,
    pcg_dense,
    pcg_mf,
    schur_w,
    segmv,
    segsum,
    segsum_stream,
)
from .precision import Precision

GROUPS = (1, 8, 16, 32, 64, 128, 256)
# (rows, segments, width, destinations sorted, site)
K1_SHAPES = [
    (86_545, 1_225, 81, True, "Ladybug schur product scatter"),
    (31_843, 50, 81, False, "Ladybug hessian Hpp"),
    (31_843, 50, 9, False, "Ladybug linearize b, cameras"),
    (5_001_946, 1_779, 9, False, "Venice linearize b, cameras"),
    (5_001_946, 1_779, 81, False, "Venice hessian Hpp"),
]


def graph_ms(fn, reps=20):
    """Device ms of ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed once between two events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm the graph pool's allocations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=400, rounds=7):
    """Host microseconds per call of ``fn()``: the median over ``rounds``
    runs of ``reps`` calls (the host is shared, so single runs spread)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def host_costs(rng, dev):
    seg = rng.integers(0, 49, 30_621)
    vals = torch.as_tensor(
        rng.standard_normal((30_621, 9)).astype(np.float32), device=dev)
    plan = segsum.plan_segments(seg, 49, dev, width=9)
    sid = torch.as_tensor(seg, device=dev)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    def on_device():
        with launches.on_device(vals.device):
            pass

    costs = {
        "k1_wrapper": lambda: segsum_stream.streaming_segment_sum(vals, plan),
        "zeros_index_add": lambda: torch.zeros(
            (49, 9), device=dev).index_add_(0, sid, vals),
        "empty": lambda: torch.empty((49, 9), device=dev),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "stream_ptr": lambda: launches.stream_ptr(dev),
        "device_context": device_ctx,
        "on_device": on_device,
    }
    print("[host] us per call: " + " ".join(
        f"{name}={host_us(fn):.2f}" for name, fn in costs.items()),
        flush=True)


def k1_groups(rng, dev):
    for k, ns, d, is_sorted, site in K1_SHAPES:
        seg = rng.integers(0, ns, k)
        if is_sorted:
            seg = np.sort(seg)
        vals = torch.as_tensor(rng.standard_normal((k, d)).astype(np.float32),
                               device=dev)
        sid = torch.as_tensor(seg, device=dev)
        chosen = segsum.plan_segments(seg, ns, dev, width=d).group
        lib_ms = graph_ms(lambda: torch.zeros((ns, d), device=dev).index_add_(
            0, sid, vals))
        line = (f"[k1] {k}x{d}->{ns} {site}: group_rule={chosen} "
                f"index_add_ms={lib_ms:.4f}")
        for g in GROUPS:
            plan = segsum.plan_segments(seg, ns, dev, group=g)
            ms = graph_ms(lambda: segsum_stream.streaming_segment_sum(vals,
                                                                      plan))
            line += f" g{g}={ms:.4f}"
        print(line, flush=True)
        del vals, sid


def k5_groups(rng, dev):
    rows, n = 1_580_797, 1_778
    rid = rng.integers(0, n, rows)
    cid = np.sort(rng.integers(0, n, rows))
    rxi = np.where(rid == cid, n, rid).astype(np.int32)
    S = torch.as_tensor(rng.standard_normal((rows, 81)).astype(np.float32),
                        device=dev)
    xc, xr = (torch.as_tensor(rng.standard_normal((n, 9)).astype(np.float32),
                              device=dev) for _ in range(2))
    cid_t = torch.as_tensor(cid.astype(np.int32), device=dev)
    rxi_t = torch.as_tensor(rxi, device=dev)
    lib = segmv.load_kernel()
    P = torch.empty((rows, 9), device=dev)
    yc = torch.empty((n, 9), device=dev)
    for g in GROUPS[2:]:
        plan = segmv.plan_matvec_sym(rid, cid, n, n, dev, 9, group=g)
        cols = plan.cols

        def pass1(order):
            lib.check(lib.lib.gt_segmv_sym_f32(
                S.data_ptr(), 9, 9, xc.data_ptr(), n, cid_t.data_ptr(),
                xr.data_ptr(), n, rxi_t.data_ptr(), None,
                cols.offsets_i32.data_ptr(), order, yc.data_ptr(), n,
                cols.group.bit_length() - 1, P.data_ptr(),
                launches.stream_ptr(dev)), "pass 1")

        whole = graph_ms(lambda: segmv.matvec_sym_stream(
            S, xc, xr, cid_t, rxi_t, plan, 9, 9))
        ordered = graph_ms(lambda: pass1(plan.col_order.data_ptr()))
        unordered = graph_ms(lambda: pass1(None))
        pass2 = graph_ms(lambda: segsum.launch_segsum(P, plan.rows, None,
                                                      "pass 2"))
        print(f"[k5] {rows}x(9,9)->{n} group {g}: ms={whole:.4f} "
              f"pass1={ordered:.4f} pass1_unordered={unordered:.4f} "
              f"pass2={pass2:.4f}", flush=True)


VENICE_CAMERAS, VENICE_POINTS, VENICE_OBS = 1_778, 993_923, 5_001_946
VENICE_HPL = 4_995_188  # Hpl blocks (observations of distinct pairs)


def k3_venice(rng, dev):
    n_off = 1_580_797 - VENICE_CAMERAS
    diag = rng.poisson(VENICE_OBS / VENICE_CAMERAS, VENICE_CAMERAS)
    lengths = np.concatenate([diag, rng.poisson(7.63, n_off)])
    lengths = lengths[rng.permutation(lengths.size)]
    long_seg = lengths > 64
    W, R = (torch.as_tensor(
        rng.standard_normal((VENICE_HPL, 27)).astype(np.float32), device=dev)
        for _ in range(2))
    for label, keep in (("whole", np.ones_like(long_seg)),
                        ("long segments", long_seg),
                        ("short segments", ~long_seg)):
        seg_len = lengths[keep]
        dst = np.repeat(np.arange(seg_len.size), seg_len)
        plan = segsum_stream.plan_products(dst, seg_len.size, dev)
        li, ri = (torch.as_tensor(
            rng.integers(0, VENICE_HPL, dst.size).astype(np.int32),
            device=dev) for _ in range(2))
        ms = graph_ms(lambda: segsum_stream.streaming_segment_product_sum_rtbl(
            W, R, plan, 9, 3, 9, li, ri), reps=5)
        lanes = {g: segs.shape[0] for g, _, segs in plan.buckets}
        print(f"[k3] {dst.size}x(9,3,9)->{seg_len.size} {label}, segments "
              f"by lanes {lanes}: ms={ms:.4f}", flush=True)
        del plan, li, ri


def k4_venice(rng, dev):
    A = torch.as_tensor(
        rng.standard_normal((VENICE_HPL, 27)).astype(np.float32), device=dev)
    lrow = np.sort(rng.integers(0, VENICE_POINTS, VENICE_HPL))
    prow = rng.integers(0, VENICE_CAMERAS, VENICE_HPL)
    x = torch.as_tensor(
        rng.standard_normal((VENICE_CAMERAS, 9)).astype(np.float32),
        device=dev)
    w = torch.as_tensor(
        rng.standard_normal((VENICE_POINTS, 3)).astype(np.float32),
        device=dev)
    pidx = torch.as_tensor(prow.astype(np.int32), device=dev)
    lid = torch.as_tensor(lrow.astype(np.int32), device=dev)
    plan_l = segsum.plan_segments(lrow, VENICE_POINTS, dev)
    plan_b = segsum.plan_segments(prow, VENICE_CAMERAS, dev)
    lib = segmv.load_kernel()
    out_l = torch.empty((VENICE_POINTS, 3), device=dev)
    out_b = torch.empty((VENICE_CAMERAS, 9), device=dev)

    def k4(xt, xi, plan, out, transpose, tile):
        lib.check(lib.lib.gt_segmv_f32(
            A.data_ptr(), xi.data_ptr(), xt.data_ptr(), xt.shape[0],
            None if plan.perm_i32 is None else plan.perm_i32.data_ptr(),
            plan.offsets_i32.data_ptr(), out.data_ptr(), plan.num_segments,
            9, 3, transpose, plan.group.bit_length() - 1, tile,
            launches.stream_ptr(dev)), "K4")

    chosen = segmv.k4_tile_blocks(9, 3)
    for site, args in (
            (f"{VENICE_HPL}x(9,3)^T->{VENICE_POINTS} back-substitution "
             f"group {plan_l.group}", (x, pidx, plan_l, out_l, 1)),
            (f"{VENICE_HPL}x(9,3)->{VENICE_CAMERAS} b_schur group "
             f"{plan_b.group}, permuted", (w, lid, plan_b, out_b, 0))):
        line = f"[k4] {site}, tile rule {chosen}:"
        for tile in (32, 64, 128, 256):
            ms = graph_ms(lambda: k4(*args, tile))
            line += f" t{tile}={ms:.4f}"
        print(line, flush=True)


CLUSTERS = (1, 2, 4, 8, 16)


@functools.cache
def sync_costs(dev):
    """us per release/acquire cluster barrier and per fence-free exchange,
    by (kind, threads) and cluster size (measured once a device)."""
    lib = pcg_mf.load_kernel()
    costs = {}
    for threads in (pcg_mf.THREADS, pcg_mf.THREADS_F64, pcg_dense.THREADS):
        for kind, fn in (("barrier", lib.lib.gt_pcg_mf_cluster_barriers),
                         ("exchange", lib.lib.gt_pcg_mf_cluster_exchanges)):
            row = {}
            for c in CLUSTERS:
                def run(reps):
                    lib.check(fn(c, threads, reps, launches.stream_ptr(dev)),
                              kind)

                few = graph_ms(lambda: run(10), reps=5)
                many = graph_ms(lambda: run(1010), reps=5)
                row[c] = 1e3 * (many - few) / 1000
            costs[kind, threads] = row
            print(f"[sync] {kind} threads={threads} us: " + " ".join(
                f"c{c}={us:.4f}" for c, us in row.items()), flush=True)
    return costs


def sync_floor_ms(costs, threads, cluster, barriers, exchanges):
    return 1e-3 * (barriers * costs["barrier", threads][cluster]
                   + exchanges * costs["exchange", threads][cluster])


def k6_inputs(dev, kind, precond, mu=1e-4):
    """K6's arguments on the first LM solve (damping mu) of sphere2500
    (SE3) or the 2500-pose SE2 circle, as ``PCGSolver`` builds them."""
    from . import FP32_FP32
    from .io import g2o, synthetic
    from .linearize import linearize
    from .preconditioners import BlockJacobiPreconditioner
    from .preconditioners.block_jacobi import row_inverse_blocks

    ds = (synthetic.make_sphere_se3(2500, seed=0) if kind == "se3"
          else synthetic.make_pose_graph_2d(2500, seed=0))
    g, *_ = g2o.build_graph(ds, precision=FP32_FP32)
    problem = g.freeze(device=dev)
    lin = linearize(problem, problem.params0)
    site = pcg_mf.plan_pcg_mf(problem, lin)
    damping = torch.tensor(mu, device=dev)
    minv = None
    if precond == "bj":
        pre = BlockJacobiPreconditioner()
        state = pre.set_damping(problem, lin, pre.prepare(problem, lin),
                                damping, False)
        minv = row_inverse_blocks(problem, state, site.vt_name)
    damp = lin.diag.clamp(1e-6, 1e32) * damping
    rows = site.vt_name
    return (site, pcg_mf.fold_jacobians(problem, lin, site),
            problem.rows_view(lin.b, rows).reshape(-1).contiguous(),
            problem.rows_view(damp, rows).reshape(-1).contiguous(), minv)


def k6_clusters(dev):
    costs = sync_costs(dev)
    lib = pcg_mf.load_kernel()
    kw = dict(max_iter=50, tol=1e-10, rejection_ratio=1e6)
    for kind, precond in (("se3", "bj"), ("se3", "identity"), ("se2", "bj")):
        args = k6_inputs(dev, kind, precond)
        site, jf, b, damp, minv = args
        _, steps = pcg_mf.solve_pcg_mf(*args, **kw)
        steps = int(steps)
        rule = pcg_mf.cluster_size(site.n * site.d)
        line = (f"[k6] {kind} {precond} n={site.n} d={site.d}, {steps} CG "
                f"steps, cluster rule {rule}:")
        for c in CLUSTERS:
            ms = graph_ms(lambda: pcg_mf.solve_pcg_mf(*args, **kw,
                                                      cluster=c))
            line += f" c{c}={ms:.4f}"
        work = torch.empty(pcg_mf.work_floats(site), device=dev)
        x = torch.empty_like(b)
        iters = torch.empty(1, dtype=torch.int32, device=dev)

        def direct(stage_j):
            lib.check(lib.lib.gt_pcg_mf_f32(
                jf.data_ptr(), site.rows.data_ptr(), site.desc.data_ptr(),
                len(site.blocks), site.csr_off.data_ptr(),
                site.inc_j.data_ptr(), site.inc_e.data_ptr(), b.data_ptr(),
                damp.data_ptr(), None if minv is None else minv.data_ptr(),
                work.data_ptr(), x.data_ptr(), iters.data_ptr(), site.n,
                site.d, kw["max_iter"], kw["tol"], kw["rejection_ratio"],
                rule, stage_j, launches.stream_ptr(dev)), "K6")

        # per solve: the set-up and r.z barriers, one r.z barrier a step and
        # the last; the first r.r exchange, then p.Hp and r.r each step
        barriers, exchanges = steps + 3, 2 * steps + 1
        floor = sync_floor_ms(costs, pcg_mf.THREADS, rule, barriers,
                              exchanges)
        line += (f" j_staged={graph_ms(lambda: direct(1)):.4f}"
                 f" j_global={graph_ms(lambda: direct(0)):.4f}"
                 f" sync_floor_ms={floor:.4f} ({barriers} barriers, "
                 f"{exchanges} exchanges)")
        print(line, flush=True)
        del args, site, jf, b, damp, minv, work


def ladybug_schur_system(dev, mu=1e-4):
    """S, M and b_S of Ladybug-49's first LM solve (PCGSchurSolver(10,
    1.0, 5.0), damping mu), as the solver hands them to K2."""
    from . import FP32_FP32
    from .hessian import apply_damping, build_hessian_structure
    from .io import bal, synthetic
    from .linearize import linearize
    from .preconditioners.block_jacobi_schur import (
        dense_preconditioner_matrix,
    )
    from .schur import SchurOps, build_schur_structure, schur_values
    from .solvers import PCGSchurSolver
    from .solvers.dense_cholesky_schur import schur_to_dense

    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=FP32_FP32)
    problem = g.freeze(device=dev)
    solver = PCGSchurSolver(10, 1.0, 5.0)
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


def k2_clusters(rng, dev):
    costs = sync_costs(dev)
    n = 1024
    A = rng.standard_normal((n, n))
    S2 = A @ A.T + n * np.eye(n)
    M2 = np.zeros_like(S2)
    for i in range(0, n, 9):
        M2[i:i + 9, i:i + 9] = np.linalg.inv(S2[i:i + 9, i:i + 9])
    spd = [torch.as_tensor(a.astype(np.float32), device=dev)
           for a in (S2, M2, rng.standard_normal(n))]
    for label, args, kw in (
            ("Ladybug-49 first Schur system", ladybug_schur_system(dev),
             dict(max_iter=10, tol=1.0, rejection_ratio=5.0)),
            ("random SPD", spd,
             dict(max_iter=10, tol=1e-12, rejection_ratio=5.0))):
        n = args[2].shape[0]
        _, steps = pcg_dense.dense_pcg(*args, **kw)
        steps = int(steps)
        rule = pcg_dense.cluster_size(n)
        line = f"[k2] n={n} {label}, {steps} CG steps, cluster rule {rule}:"
        for c in CLUSTERS:
            ms = graph_ms(lambda: pcg_dense.dense_pcg(*args, **kw,
                                                      cluster=c))
            line += f" c{c}={ms:.4f}"
        # per solve: the set-up and last barriers; two exchanges to start,
        # three a step
        barriers, exchanges = 2, 3 * steps + 2
        floor = sync_floor_ms(costs, pcg_dense.THREADS, rule, barriers,
                              exchanges)
        line += (f" sync_floor_ms={floor:.4f} ({barriers} barriers, "
                 f"{exchanges} exchanges)")
        print(line, flush=True)


def k9_clusters(rng, dev):
    for label, n, dtype in (("Venice dim_p", 16_002, torch.float32),
                            ("Venice dim_p", 16_002, torch.float64),
                            ("sphere2500 n d", 14_994, torch.float32)):
        u, v = (torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                device=dev) for _ in range(2))
        line = (f"[k9] {label} n={n} {str(dtype)[6:]}, cluster rule "
                f"{dot.cluster_size(n)}:")
        for c in CLUSTERS:
            ms = graph_ms(lambda: dot._launch(u, v, c), reps=200)
            line += f" c{c}={ms:.5f}"
        ms = graph_ms(lambda: torch.dot(u, v), reps=200)
        print(line + f" torch.dot={ms:.5f}", flush=True)


def k10_venice(rng, dev):
    L, dp, dl = 993_923, 9, 3
    counts = rng.poisson(5.03, L)
    a = torch.as_tensor(rng.standard_normal((L, dl, dl)),
                        dtype=torch.float32, device=dev)
    hll = (a @ a.transpose(1, 2)
           + dl * torch.eye(dl, device=dev)).reshape(L, dl * dl)
    plan = schur_w.plan_w(counts, dev)
    hpl = torch.randn(plan.rows, dp * dl, device=dev)
    ms = graph_ms(lambda: schur_w.schur_w(hll, hpl, plan, dp, dl))

    def plain():
        inv = schur_w.hll_inverse_plain(hll, dl)
        return schur_w.hpl_w_plain(hpl, inv, plan, dp, dl)

    plain_ms = graph_ms(plain, reps=5)
    moved = 2 * 4 * (hll.numel() + hpl.numel())
    print(f"[k10] L={L} K={plan.rows} ({dp},{dl}): ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bytes bound ms={1e3 * moved / 3.35e12:.4f}"
          f" ({moved / ms / 1e6:.0f} GB/s)", flush=True)


def k7_venice_sites(rng):
    """(factors, sites) at Venice-1778: random cameras and sorted points;
    each site (name, slot pair, segment of each factor, blocks with the
    trash row)."""
    F = VENICE_OBS
    cam = rng.integers(0, VENICE_CAMERAS, F)
    pt = np.sort(rng.integers(0, VENICE_POINTS, F))
    order = np.lexsort((cam, pt))
    cam, pt = cam[order], pt[order]
    # Hpl's block of a factor: its (point, camera) pair's, in factor order
    pair = pt.astype(np.int64) * VENICE_CAMERAS + cam
    hpl = np.concatenate([[0], np.cumsum(pair[1:] != pair[:-1])])
    return F, [("Hpp (9, 9)", (0, 0), cam, VENICE_CAMERAS + 1),
               ("Hpl (9, 3)", (0, 1), hpl, int(hpl[-1]) + 2),
               ("Hll (3, 3)", (1, 1), pt, VENICE_POINTS + 1)]


def k7_sum_bytes(jc, jp, dL, s, t, plan, out):
    """Bytes a Hessian sum must move: the J it reads, dL, the plan's
    offsets and permutation, and the blocks it writes."""
    used = (jc, jp) if s != t else ((jc,) if s == 0 else (jp,))
    return (sum(x.numel() * x.element_size() for x in used)
            + dL.numel() * dL.element_size()
            + 4 * (plan.num_segments + 1)
            + (4 * plan.rows if plan.perm is not None else 0)
            + out.numel() * out.element_size())


def k7_site_label(site, plan, F, n):
    return (f"{site}: {F} rows -> {n} blocks, group {plan.group}, "
            + ("permuted" if plan.perm is not None else "sorted"))


def k7_sums_venice(rng, dev):
    F, sites = k7_venice_sites(rng)
    lib = k7.load_kernel()
    for dt in (torch.float32, torch.float64):
        suffix = "_f64" if dt == torch.float64 else ""
        jc = torch.randn((F, 18), dtype=dt, device=dev)
        jp = torch.randn((F, 6), dtype=dt, device=dev)
        dL = torch.rand(F, dtype=dt, device=dev)
        for site, (s, t), seg, n in sites:
            width = (9, 3)[s] * (9, 3)[t]
            plan = segsum.plan_segments(seg, n, dev, width=width)
            out = torch.empty((n, width), dtype=dt, device=dev)

            def probe(mode, entry=f"gt_bal_hessian_sum_probe{suffix}"):
                perm = plan.perm_i32
                lib.check(getattr(lib.lib, entry)(
                    jc.data_ptr(), jp.data_ptr(), dL.data_ptr(),
                    None if perm is None else perm.data_ptr(),
                    plan.offsets_i32.data_ptr(), out.data_ptr(), n,
                    k7.PAIRS.index((s, t)), plan.group.bit_length() - 1, mode,
                    launches.stream_ptr(dev)), "bal_hessian_sum probe")

            whole = graph_ms(lambda: k7.bal_hessian_sum(
                jc, jp, dL, plan, s, t, False, out, False))
            loads = graph_ms(lambda: probe(1))
            products = graph_ms(lambda: probe(2))
            moved = k7_sum_bytes(jc, jp, dL, s, t, plan, out)
            print(f"[k7-sum] {k7_site_label(site, plan, F, n)} "
                  f"{str(dt)[6:]}: ms={whole:.4f} loads_alone={loads:.4f} "
                  f"products_alone={products:.4f} "
                  f"bytes_bound_ms={1e3 * moved / 3.35e12:.4f}", flush=True)
            del plan, out
        del jc, jp, dL
        torch.cuda.empty_cache()


def k7_sums_instances(rng, dev):
    """Section 11: the Hessian sum whole at Venice's sites in each
    (graph, storage) instance, through the wrapper alone."""
    F, sites = k7_venice_sites(rng)
    for graph, (_, storages) in k7.GRAPH_INSTANCES.items():
        dL = torch.rand(F, dtype=graph, device=dev)
        for storage in storages:
            sums = Precision(graph, storage).inv_dtype
            jc = torch.randn((F, 18), dtype=graph, device=dev).to(storage)
            jp = torch.randn((F, 6), dtype=graph, device=dev).to(storage)
            for site, (s, t), seg, n in sites:
                width = (9, 3)[s] * (9, 3)[t]
                plan = segsum.plan_segments(seg, n, dev, width=width)
                out = torch.empty((n, width), dtype=sums, device=dev)
                ms = graph_ms(lambda: k7.bal_hessian_sum(
                    jc, jp, dL, plan, s, t, False, out, False))
                moved = k7_sum_bytes(jc, jp, dL, s, t, plan, out)
                print(f"[k7-sum-instance] {k7_site_label(site, plan, F, n)} "
                      f"graph={str(graph)[6:]} storage={str(storage)[6:]}: "
                      f"ms={ms:.4f} "
                      f"bytes_bound_ms={1e3 * moved / 3.35e12:.4f}",
                      flush=True)
                del plan, out
            del jc, jp
            torch.cuda.empty_cache()
        del dL


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", type=int, nargs="+",
                    default=list(range(1, 12)),
                    help="the sections to run (default: all)")
    sections = set(ap.parse_args(argv).sections)
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    steps = {1: lambda: host_costs(rng, dev), 2: lambda: k1_groups(rng, dev),
             3: lambda: k5_groups(rng, dev), 4: lambda: k3_venice(rng, dev),
             5: lambda: k4_venice(rng, dev), 6: lambda: sync_costs(dev),
             7: lambda: (k6_clusters(dev), k2_clusters(rng, dev)),
             8: lambda: k9_clusters(rng, dev),
             9: lambda: k10_venice(rng, dev),
             10: lambda: k7_sums_venice(rng, dev),
             11: lambda: k7_sums_instances(rng, dev)}
    for section, step in steps.items():
        if section in sections:
            step()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
