"""What the spawned ranks of the sharding tests run
(``test_torch_sharding.py``, ``test_torch_gpu.py``). A rank imports this
module by name, so it imports no JAX: only torch, NumPy and the port.
Every task returns NumPy arrays and Python numbers."""

import numpy as np
import torch

from graphite_tpu_torch import schur
from graphite_tpu_torch.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.ops.cuda import segsum_stream
from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions
from graphite_tpu_torch.parallel import (
    shard_data,
    sharded_linearize_fn,
    sharded_lm,
    sharded_lm_step_fn,
)
from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
from graphite_tpu_torch.solvers import PCGSchurSolver, PCGSolver

STEP_MU = 1e-3
# the LM runs of the parity tests, by case: (problem, solver, iterations)
LM_SOLVERS = {
    "mini": lambda: PCGSchurSolver(max_iter=10, tol=1.0,
                                   rejection_ratio=5.0),
    "nonmini": lambda: PCGSchurSolver(max_iter=20, tol=1e-10,
                                      rejection_ratio=1e6),
    "pcg-block-jacobi": lambda: PCGSolver(
        max_iter=30, tol=1e-12, rejection_ratio=1e6,
        preconditioner=BlockJacobiPreconditioner()),
}
LM_ITERATIONS = {"mini": 10, "nonmini": 5, "pcg-block-jacobi": 10}
SOLVERS = {
    "pcg": lambda: PCGSolver(max_iter=30, tol=1e-12, rejection_ratio=1e6,
                             preconditioner=BlockJacobiPreconditioner()),
    "pcg-schur": lambda: PCGSchurSolver(max_iter=30, tol=1e-12,
                                        rejection_ratio=1e6),
}


def _np(x):
    return x.detach().cpu().numpy()


def _params(params):
    return {k: _np(v) for k, v in params.items()}


def lm_run(problem, mesh, solver, iterations, damping=1e-4,
           jit_loop=False):
    """sharded_lm with its trace: (params, chi2, iterations, accepted,
    trace [chi2, mu, rho, accepted] per iteration); ``jit_loop``: the
    device loop."""
    params, chi2, k, acc, trace = sharded_lm(
        problem, mesh, solver,
        LevenbergMarquardtOptions(iterations=iterations,
                                  initial_damping=damping,
                                  jit_loop=jit_loop),
        with_trace=True)
    return dict(params=_params(params), chi2=float(chi2), iterations=k,
                accepted=acc, trace=_np(trace))


def schur_of_replica(problem, mesh, damping=STEP_MU):
    """S values of this rank's replica at its first linearization, and
    the destination partitions of its product stage."""
    p = problem.shard_replica(shard_data(problem, mesh), mesh)
    lin = linearize(p, p.params0)
    hs = build_hessian_structure(p)
    ss = schur.build_schur_structure(p)
    hv = apply_damping(p, hs, compute_hessian_values(p, hs, lin), lin.diag,
                       damping, False)
    sv = schur.schur_values(p, ss, hv)
    parts = [dict(bounds=part.bounds, seg0=list(part.seg0),
                  ns=list(part.ns))
             for _, part in sorted(p._cache.get("sharded_partitions",
                                                {}).items())]
    return dict(s_vals={k: _np(v) for k, v in sv.s_vals.items()},
                partitions=parts)


def parity_tasks(mesh, mini, big32, nonmini):
    """Everything ``test_torch_sharding.py`` compares with the JAX
    package's 8-device mesh, on one set of ranks."""
    torch.set_num_threads(1)
    out = {}
    chi2, b, scales, diag = sharded_linearize_fn(mini, mesh)(
        shard_data(mini, mesh), mini.params0)
    out["linearize"] = dict(chi2=float(chi2), b=_np(b), scales=_np(scales),
                            diag=_np(diag))
    for kind, make in SOLVERS.items():
        new_params, before, after = sharded_lm_step_fn(
            mini, mesh, make(), STEP_MU)(shard_data(mini, mesh),
                                         mini.params0)
        out["step", kind] = dict(params=_params(new_params),
                                 chi2_before=float(before),
                                 chi2_after=float(after))
    lm_solver = LM_SOLVERS["mini"]()
    out["lm"] = lm_run(mini, mesh, lm_solver, LM_ITERATIONS["mini"])
    out["lm_again"] = lm_run(mini, mesh, lm_solver, LM_ITERATIONS["mini"])
    out["schur64"] = schur_of_replica(mini, mesh)
    out["schur32"] = schur_of_replica(big32, mesh)
    out["nonmini"] = lm_run(nonmini, mesh, LM_SOLVERS["nonmini"](),
                            LM_ITERATIONS["nonmini"])
    # the device loop (jit_loop) of each case, and the host loop of the
    # PCG case (its collective inside the CG loop)
    problems = {"mini": mini, "nonmini": nonmini, "pcg-block-jacobi": mini}
    out["pcg-block-jacobi"] = lm_run(
        mini, mesh, LM_SOLVERS["pcg-block-jacobi"](),
        LM_ITERATIONS["pcg-block-jacobi"])
    out["graph"] = {case: lm_run(problems[case], mesh, LM_SOLVERS[case](),
                                 LM_ITERATIONS[case], jit_loop=True)
                    for case in LM_SOLVERS}
    return out


def world1_tasks(mesh, mini):
    """At world size 1: the linearization and the LM run."""
    torch.set_num_threads(1)
    chi2, b, scales, diag = sharded_linearize_fn(mini, mesh)(
        shard_data(mini, mesh), mini.params0)
    return dict(linearize=dict(chi2=float(chi2), b=_np(b), diag=_np(diag)),
                lm=lm_run(mini, mesh, PCGSchurSolver(10, 1.0, 5.0), 10))


def forced_lm(mesh, problem, iterations):
    """sharded_lm with every large-problem branch forced
    (``dense_matvec_limit=0``, the Schur gates lowered), and this rank's
    K3 gathered-stream launches in the run."""
    torch.set_num_threads(1)
    gates = schur.CHUNK_THRESHOLD, schur._smv_chunk_rows
    schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = 0, (lambda rb: 0)
    before = segsum_stream.PRODUCT_STATS.launches
    try:
        out = lm_run(problem, mesh, PCGSchurSolver(10, 1.0, 5.0,
                                                   dense_matvec_limit=0),
                     iterations)
    finally:
        schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = gates
    out["k3_gathered"] = segsum_stream.PRODUCT_STATS.launches - before
    return out


def world1_card(mesh, problem, iterations):
    """At world size 1 (nccl on the card): ``sharded_lm``'s host loop, and
    its ``jit_loop`` run (one iteration captured with the collectives in
    it)."""
    from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions

    solver = PCGSchurSolver(10, 1.0, 5.0)
    out = {"host": lm_run(problem, mesh, solver, iterations)}
    params, chi2, k, acc, trace = sharded_lm(
        problem, mesh, solver,
        LevenbergMarquardtOptions(iterations=iterations, jit_loop=True),
        with_trace=True)
    out["graph"] = dict(params=_params(params), chi2=float(chi2),
                        iterations=k, accepted=acc, trace=_np(trace))
    return out


def loaded_jax_modules(mesh):
    """The JAX modules (and the JAX package's) a spawned rank has
    loaded."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "graphite_tpu"))


# ---- K8 (ops/cuda/allreduce): its host bookkeeping and the card ----------

def exchange_task(mesh, disagree_rank):
    """K8's handle exchange over the mesh's group with made-up handles:
    every rank's payload by rank; then the same with rank
    ``disagree_rank`` growing at another call (the message every rank
    raises, or None)."""
    from graphite_tpu_torch.ops.cuda import allreduce as k8

    def payload(tag):
        return dict(rank=mesh.rank, half_bytes=k8.ALIGN, tag=tag,
                    handle=bytes([mesh.rank]) * k8.HANDLE_BYTES)

    handles = k8.check_payloads(
        k8.exchange(payload("linearize.b"), mesh.world, mesh.group),
        mesh.rank)
    tag = "JtPv" if mesh.rank == disagree_rank else "linearize.b"
    try:
        k8.check_payloads(k8.exchange(payload(tag), mesh.world, mesh.group),
                          mesh.rank)
        error = None
    except RuntimeError as e:
        error = str(e)
    return dict(handles=handles, error=error)


def plain_sums(mesh, values):
    """K8's plain version on this rank's row of ``values`` (world, n):
    the sum and the gather."""
    from graphite_tpu_torch.ops.cuda import allreduce as k8

    x = torch.as_tensor(values[mesh.rank])
    return dict(sum=_np(k8.allreduce_plain(x, mesh.rank, mesh.world)),
                gather=_np(k8.gather_plain(x, mesh.rank, mesh.world)))


# (shape, dtype) of the card tests' K8 calls
K8_CASES = [((1,), torch.float64), ((1000,), torch.float32),
            ((3, 4097), torch.float64), ((123457,), torch.float32),
            ((70000, 9), torch.float32), ((5,), torch.int64), ((0,),
                                                              torch.float32)]


def k8_inputs(rank, shape, dtype, seed=0):
    """A rank's seeded input: normal values with every 7th entry -0.0
    (for integers: values in [-1000, 1000))."""
    g = np.random.default_rng([seed, rank])
    n = int(np.prod(shape))
    if dtype == torch.int64:
        return torch.as_tensor(g.integers(-1000, 1000, n)).reshape(shape)
    v = g.standard_normal(n)
    v[::7] = -0.0
    return torch.as_tensor(v, dtype=dtype).reshape(shape)


def _bits(t):
    t = t.detach().cpu().contiguous()
    view = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(view[t.dtype]) if t.dtype in view else t


def k8_vs_plain(mesh):
    """Each case on the card: K8's sum and gather against the plain
    version (gloo on the same CUDA tensors) bit for bit, a second K8 call
    bitwise the first; the launches counted; the device's epoch equal to
    the eager calls."""
    from graphite_tpu_torch.ops.cuda import allreduce as k8

    out = dict(cases=[], launches=0)
    before = k8.STATS.launches + k8.GATHER_STATS.launches
    for shape, dtype in K8_CASES:
        x = k8_inputs(mesh.rank, shape, dtype).to(mesh.device)
        got = [mesh.allreduce(x, "case"), mesh.gather(x, "case")]
        again = [mesh.allreduce(x, "case"), mesh.gather(x, "case")]
        plain = [k8.allreduce_plain(x, mesh.rank, mesh.world),
                 k8.gather_plain(x, mesh.rank, mesh.world)]
        out["cases"].append(dict(
            shape=shape, dtype=str(dtype),
            bitwise=all(torch.equal(_bits(a), _bits(b))
                        for a, b in zip(got, plain)),
            repeat=all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(got, again)),
            sum=_np(got[0]), gather_shape=tuple(got[1].shape)))
    out["launches"] = (k8.STATS.launches + k8.GATHER_STATS.launches
                       - before)
    transport = mesh.transport()
    out["epoch"] = transport.status()["epoch"]
    out["eager_calls"] = transport.book.eager_calls
    return out


def k8_timeout(mesh, skipping_rank):
    """Rank ``skipping_rank`` leaves out one call: the others' K8 call
    gives up after ``SPIN_SECONDS`` (lowered to 2 s) and raises; returns
    the message (None on the rank that left it out) and the seconds."""
    import time

    from graphite_tpu_torch.ops.cuda import allreduce as k8

    x = torch.ones(10, device=mesh.device)
    mesh.allreduce(x, "first")  # the arena exists on every rank
    k8.SPIN_SECONDS = 2.0
    t0 = time.perf_counter()
    error = None
    if mesh.rank != skipping_rank:
        try:
            mesh.allreduce(x, "left out by a peer")
        except RuntimeError as e:
            error = str(e)
    return dict(error=error, seconds=time.perf_counter() - t0)


def host_and_graph(mesh, problem, iterations):
    """``sharded_lm`` on this rank, host loop and ``jit_loop`` (PCG-Schur
    and PCG with block-Jacobi), and the device loop's K8 launches."""
    from graphite_tpu_torch.optimizers.lm import device_loops
    from graphite_tpu_torch.parallel.sharding import _replica

    out = {}
    for case in ("mini", "pcg-block-jacobi"):
        out[case] = dict(
            host=lm_run(problem, mesh, LM_SOLVERS[case](), iterations),
            graph=lm_run(problem, mesh, LM_SOLVERS[case](), iterations,
                         jit_loop=True))
    loops = device_loops(_replica(problem, mesh))
    out["k8_in_graphs"] = sum(
        loop.capture.launches(loop.replays).get("allreduce.allreduce", 0)
        for loop in loops)
    # a closed mesh frees the arena the graphs hold: the next jit_loop run
    # captures again, on a new arena
    mesh.close()
    solver = LM_SOLVERS["mini"]()
    first = lm_run(problem, mesh, solver, iterations, jit_loop=True)
    (loop,) = [v for v in device_loops(_replica(problem, mesh))
               if v.solver is solver]
    mesh.close()
    out["after_close"] = dict(
        first=first, again=lm_run(problem, mesh, solver, iterations,
                                  jit_loop=True),
        recaptured=[v for v in device_loops(_replica(problem, mesh))
                    if v.solver is solver][0] is not loop)
    return out
