"""K1's and K5's device time by lanes per segment, and a launch's host time.

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
   longest-first column order; pass 2, K1 over the row products).

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
