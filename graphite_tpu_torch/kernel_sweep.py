"""Device times of K1, K3, K4 and K5 at the main paths' shapes, and a
launch's host time.

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
   sorted landmark index).

Device times are CUDA-event means over 20 calls captured in one CUDA
graph and replayed, so no host time is in them. Prints one line per
measurement, the card's name and power limit first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .ops.cuda import launches, segmv, segsum, segsum_stream

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


def main():
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
    host_costs(rng, dev)
    k1_groups(rng, dev)
    k5_groups(rng, dev)
    torch.cuda.empty_cache()
    k3_venice(rng, dev)
    torch.cuda.empty_cache()
    k4_venice(rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
