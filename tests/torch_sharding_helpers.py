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


def lm_run(problem, mesh, solver, iterations, damping=1e-4):
    """sharded_lm with its trace: (params, chi2, iterations, accepted,
    trace [chi2, mu, rho, accepted] per iteration)."""
    params, chi2, k, acc, trace = sharded_lm(
        problem, mesh, solver,
        LevenbergMarquardtOptions(iterations=iterations,
                                  initial_damping=damping),
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
    lm_solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    out["lm"] = lm_run(mini, mesh, lm_solver, 10)
    out["lm_again"] = lm_run(mini, mesh, lm_solver, 10)
    out["schur64"] = schur_of_replica(mini, mesh)
    out["schur32"] = schur_of_replica(big32, mesh)
    out["nonmini"] = lm_run(nonmini, mesh, PCGSchurSolver(
        max_iter=20, tol=1e-10, rejection_ratio=1e6), 5)
    try:
        sharded_lm(mini, mesh, lm_solver,
                   LevenbergMarquardtOptions(iterations=2, jit_loop=True))
        out["jit_loop"] = None
    except ValueError as e:
        out["jit_loop"] = str(e)
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
