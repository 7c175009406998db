"""Spawned ranks on one host: ``run_ranks(fn, world, backend, *args)``
starts ``world`` processes (the ``spawn`` method: each imports only this
package and the module of ``fn``), joins them in one process group whose
rendezvous is a file in a fresh temporary directory (no port to pick or
collide on), calls ``fn(mesh, *args)`` on every rank and returns the
results by rank. A rank that raises fails the whole call with its
traceback; every process is ended before the call returns. Each rank
closes its mesh (``Mesh.close``: its K8 arena, collectively) before it
leaves the process group, after a failure too.

``fn`` and ``args`` are pickled: ``fn`` must be importable by name (a
module-level function), and results come back pickled too (move tensors
to the CPU first where the receiver has no card).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback

# seconds a rank may take to start, run and post its result
TIMEOUT = 1800.0


def _rank_main(rank, world, backend, init_method, device, fn, args_path,
               out):
    try:
        import torch
        import torch.distributed as dist

        from .sharding import make_mesh

        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        mesh = None
        try:
            # pickled here: a put pickles in a feeder thread, which would
            # lose the error
            with open(args_path, "rb") as f:
                args = pickle.load(f)
            mesh = make_mesh(device=device)
            result = pickle.dumps(fn(mesh, *args))
        except BaseException:
            # posted before the close, which waits for the peers: the
            # parent ends every rank after a failure
            out.put((rank, False, traceback.format_exc()))
            if mesh is not None:
                mesh.close()
            dist.destroy_process_group()
            return
        mesh.close()  # the K8 arena, before the group it was exchanged on
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, *args, device=None,
              timeout: float = TIMEOUT) -> list:
    """``[fn(mesh_r, *args) for each rank r]``, run in ``world`` spawned
    processes over ``backend`` ("gloo" or "nccl"); ``device`` is each
    rank's device (None: the current CUDA card; "cuda:{rank}" is not
    implied, so nccl ranks on several cards pass a device per rank
    themselves)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results = {}
    with tempfile.TemporaryDirectory(prefix="graphite_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        # the arguments go by file, pickled by value: through the start
        # pipe, a large payload blocks each start until the previous child
        # has imported its modules (and the start method's own pickler
        # would pass every tensor through shared memory)
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, init_method, device,
                                   fn, args_path, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(results) < world:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    # a rank that exited cleanly has posted (its queue is
                    # flushed at exit): only a failed exit is fatal here
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"run_ranks: a rank exited with code {dead[0]} "
                            f"before posting its result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"run_ranks: no result within {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{value}")
                results[rank] = pickle.loads(value)
            for p in procs:
                p.join(timeout=60)
        finally:
            # after a failure the other ranks may wait in a collective
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [results[r] for r in range(world)]
