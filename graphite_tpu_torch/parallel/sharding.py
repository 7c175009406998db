"""Factor-parallel execution over ``torch.distributed`` (counterpart of
``graphite_tpu/parallel/sharding.py``).

One process per rank. Every factor set's leading F dimension is split
into contiguous slices (rank r holds rows ``[r F/n, (r+1) F/n)``), the
vertices and the solver's vectors stay whole on every rank, and each
cross-factor reduction (b, the scaling diagonal, chi2, ``J^T v``, the
Hessian and block-Jacobi blocks) is summed over the ranks:

- ``Graph.freeze(pad_factors_to=n)`` pads every factor set with disabled
  factors, so the slices are equal;
- ``shard_data`` cuts a rank's slice out of the frozen problem;
- ``Problem.shard_replica(data, mesh)`` binds it: the same
  single-device code runs on the slice, its row reductions on K1 through
  plans the host builds for that slice, and every cross-factor site calls
  ``problem.allreduce``;
- the Schur triple products are split by destination range (``schur.py``):
  each rank reduces about K/n of every product group with K3 and one
  gather places the disjoint ranges; Hll^-1, W, b_S, the PCG on S and the
  back-substitution stay replicated.

The collectives add in one fixed order, the ranks' (``Mesh.allreduce``:
row 0 + row 1 + ...), so every rank reads the same sums, takes the same LM
decisions and holds bitwise the same parameters. On a CUDA mesh each one
is a launch of kernel K8 (``ops/cuda/allreduce``: the ranks map each
other's arenas through CUDA IPC), several ranks on one card or one rank
per card alike; a CUDA graph holds it, so ``sharded_lm(jit_loop=True)``
runs the whole LM loop on the device, as the JAX package runs it in one
program, with no host read between iterations. On a CPU mesh each one is
K8's plain version: one ``all_reduce`` of a zeroed ``(world, ...)``
buffer, its rows added in rank order. There is no fallback from one to the
other. ``Mesh.close()`` frees the arena (collectively).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..graph import FactorArrays, GraphData, VertexArrays
from ..linearize import apply_update, compute_chi2, linearize
from ..ops.cuda import allreduce as k8
from ..optimizers.lm import levenberg_marquardt

FACTOR_AXIS = "factors"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of an initialised process group: its rank, the world
    size, the backend, and the device its tensors live on. A process
    group has one axis, the factors', so the ``axis`` arguments below
    are taken for the JAX package's signatures and name nothing.

    On a CUDA mesh the collectives are K8's (``transport``, made at the
    first call: every rank makes it there); ``close()`` frees it."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: Optional[object] = None  # None: the default group
    _transport: list = dataclasses.field(default_factory=list, init=False,
                                         repr=False, compare=False)

    def transport(self) -> "k8.Transport":
        """This rank's K8 arena (made at the first call on the card)."""
        if not self._transport:
            self._transport.append(k8.Transport(self.rank, self.world,
                                                self.device, self.group))
        return self._transport[0]

    def gather(self, x: torch.Tensor, tag: str = "gather") -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` (the same shape on every
        rank); ``tag`` names the call in K8's errors."""
        if x.device.type == "cpu":
            return k8.gather_plain(x, self.rank, self.world, self.group)
        return self.transport().gather(x, tag)

    def allreduce(self, x: torch.Tensor,
                  tag: str = "allreduce") -> torch.Tensor:
        """The sum of every rank's ``x``, added in rank order."""
        if x.device.type == "cpu":
            return k8.allreduce_plain(x, self.rank, self.world, self.group)
        return self.transport().allreduce(x, tag)

    def transport_token(self):
        """The K8 arena a capture made now would hold (None: none yet, or
        a CPU mesh); a graph captured with another is stale."""
        return self._transport[0] if self._transport else None

    def check(self, what: str) -> None:
        """Raise if a K8 call of this rank timed out waiting for a peer
        (read after a captured run; ``what`` names it)."""
        if self._transport:
            self._transport[0].check(what)

    def close(self) -> None:
        """Collective: free this rank's K8 arena, after every rank's last
        collective (and the last replay of a graph that holds one)."""
        if self._transport:
            self._transport.pop().close()


def make_mesh(n_devices: Optional[int] = None, axis: str = FACTOR_AXIS,
              device=None, group=None) -> Mesh:
    """The mesh of this process in the initialised process group
    (``torch.distributed.init_process_group``). ``n_devices``, when given,
    must be the world size; ``axis`` is ignored (see ``Mesh``).
    ``device``: where this rank's tensors live;
    by default the current CUDA card (the nccl backend needs one card per
    rank; gloo also takes several ranks on one card, or ``"cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed."
                           "init_process_group first")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "device='cpu' for ranks on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=dist.get_rank(group), world=world,
                backend=str(dist.get_backend(group)),
                device=torch.device(device), group=group)


def data_specs(problem, axis: str = FACTOR_AXIS) -> GraphData:
    """The layout of ``problem.data``, leaf by leaf: ``axis`` for a leaf
    split on its first dimension over the ranks (every factor array),
    None for a leaf every rank holds whole (every vertex array)."""

    def spec(tree, value):
        return dataclasses.replace(tree, **{
            f.name: (None if getattr(tree, f.name) is None
                     else tuple(value for _ in getattr(tree, f.name))
                     if isinstance(getattr(tree, f.name), tuple) else value)
            for f in dataclasses.fields(tree)})

    return GraphData(
        vertices={n: spec(v, None) for n, v in problem.data.vertices.items()},
        factors={n: spec(f, axis) for n, f in problem.data.factors.items()})


def shard_data(problem, mesh: Mesh, axis: str = FACTOR_AXIS) -> GraphData:
    """This rank's ``GraphData`` on ``mesh.device``: rows ``[r F/n,
    (r+1) F/n)`` of every factor array, every vertex array whole."""
    specs = data_specs(problem, axis)

    def cut(leaf, spec, F):
        if leaf is None:
            return None
        if isinstance(leaf, tuple):
            return tuple(cut(a, s, F) for a, s in zip(leaf, spec))
        if spec is None:
            return leaf.to(mesh.device)
        n = F // mesh.world
        return leaf[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)

    factors = {}
    for name, fa in problem.data.factors.items():
        F = problem.factor_meta[name].count
        if F % mesh.world:
            raise ValueError(
                f"shard_data: factor set '{name}' has {F} factors, not a "
                f"multiple of {mesh.world} ranks; freeze with "
                f"pad_factors_to={mesh.world}")
        factors[name] = FactorArrays(**{
            f.name: cut(getattr(fa, f.name),
                        getattr(specs.factors[name], f.name), F)
            for f in dataclasses.fields(FactorArrays)})
    vertices = {name: VertexArrays(**{
        f.name: cut(getattr(va, f.name), None, 0)
        for f in dataclasses.fields(VertexArrays)})
        for name, va in problem.data.vertices.items()}
    return GraphData(vertices=vertices, factors=factors)


def _replica(problem, mesh: Mesh, data=None):
    """This rank's replica of ``problem`` (Schur stage sharded over the
    ranks), built once per mesh and cached on ``problem`` with its plans;
    ``data`` given: a replica bound to that data (not cached)."""
    if data is not None:
        return problem.shard_replica(data, mesh)
    key = ("shard_replica", mesh.rank, mesh.world, mesh.device,
           id(mesh.group))
    p = problem._cache.get(key)
    if p is None:
        p = problem.shard_replica(shard_data(problem, mesh), mesh)
        problem._cache[key] = p
    p.mesh = mesh  # the plans are the rank's; the collectives this mesh's
    return p


def _on(params, device):
    return {n: v.to(device) for n, v in params.items()}


def sharded_linearize_fn(problem, mesh: Mesh, axis: str = FACTOR_AXIS):
    """One linearization on this rank's slice: ``f(data, params) ->
    (chi2, b, scales, diag)``, each summed over the ranks. ``data`` None
    takes ``shard_data`` of ``problem`` (its plans cached). ``axis`` is
    ignored (see ``Mesh``)."""

    def f(data, params):
        p = _replica(problem, mesh, data)
        lin = linearize(p, _on(params, mesh.device))
        return lin.chi2, lin.b, lin.scales, lin.diag

    return f


def sharded_lm_step_fn(problem, mesh: Mesh, solver, damping: float,
                       use_identity: bool = False, axis: str = FACTOR_AXIS):
    """One LM trial step (linearize, solve, update, chi2) at a fixed
    damping: ``f(data, params) -> (new_params, chi2_before,
    chi2_after)``. ``axis`` is ignored (see ``Mesh``)."""

    def f(data, params):
        p = _replica(problem, mesh, data)
        params = _on(params, mesh.device)
        lin = linearize(p, params)
        sstate = solver.prepare(p, lin, params)
        mu = torch.as_tensor(damping, dtype=p.precision.graph_dtype,
                             device=mesh.device)
        delta, _ = solver.solve(p, lin, sstate, mu, use_identity, params)
        new_params = apply_update(p, params, lin, delta)
        return new_params, lin.chi2, compute_chi2(p, new_params)

    return f


def sharded_lm(problem, mesh: Mesh, solver, options, params=None,
               axis: str = FACTOR_AXIS, with_trace: bool = False):
    """Levenberg-Marquardt on this rank's slice of ``problem``: the
    counterpart of ``levenberg_marquardt(..., jit_loop=...)`` on the
    rank's replica (its plans built on the first call and cached on
    ``problem``). Every rank reads the same all-reduced chi2 and gain, so
    every rank takes the same decisions. With ``options.jit_loop`` each
    rank runs the device loop (``optimizers/lm._DeviceLoop``): on the card
    one iteration captured as a CUDA graph, its collectives K8 launches
    inside the graph and its conditional regions, and replayed with no
    host read, as the JAX package runs the whole ``while_loop`` in one
    program; every rank must make the same call.

    Returns (params, chi2, iterations, accepted_steps), plus the
    (options.iterations, 4) trace of [chi2, mu, rho, accepted] per
    iteration (zero rows past the last) when ``with_trace``. ``axis`` is
    ignored (see ``Mesh``)."""
    p = _replica(problem, mesh)
    params = _on(params if params is not None else problem.params0,
                 mesh.device)
    res = levenberg_marquardt(p, solver, params, options)
    gdt = p.precision.graph_dtype
    out = (res.params, torch.tensor(res.chi2, dtype=gdt),
           res.iterations, res.accepted_steps)
    if not with_trace:
        return out
    trace = torch.zeros((options.iterations, 4), dtype=gdt)
    for i, h in enumerate(res.history):
        trace[i] = torch.tensor([h["chi2"], h["mu"], h["rho"],
                                 float(h["accepted"])], dtype=gdt)
    return out + (trace,)
