"""Levenberg-Marquardt (counterpart of ``graphite_tpu/optimizers/lm.py``).

- gain ratio ``rho = (chi2 - chi2_new) / (sum dx*(mu*dx + b) + 1e-3)``;
- accept: ``mu *= clamp(1 - (2 rho - 1)^3, 1/3, 2/3)``, ``nu = 2``,
  relinearize and refresh the solver state;
- reject: restore the parameters, ``mu *= nu``, ``nu *= 2``;
- a failed solve makes chi2_new = max float, hence a rejected step;
- stop on a non-finite mu, rho == 0, the stop flag, or (LM2,
  ``levenberg_marquardt2``) ``early_stop_bad_steps`` accepted steps in a
  row whose relative decrease is below ``early_stop_relative``.

Two modes:

- ``jit_loop=False``: a host loop. Each iteration reads its scalars back
  once (the accept branch is taken on the host); on CUDA each history
  entry also holds the iteration's device time from CUDA events.
- ``jit_loop=True``: the device-controlled iteration (``_DeviceLoop``),
  the counterpart of the JAX package's ``lax.while_loop``. The LM state
  lives in static tensors and one iteration updates it in place with no
  host read. Its control flow is the JAX package's, as conditional
  regions (``ops/device_loop.cond``, ``_DeviceLoop._step``): the step
  runs only while the ``run`` flag holds (the ``while_loop``'s exit), and
  after it the accepted branch (relinearize, refresh the solver) and the
  rejected one (restore the parameters) each run only on their side of
  the accept flag (``lax.cond``; the accepted branch relinearizes into
  the loop's own tensors, ``linearize(out=)`` and ``prepare(out=)``: a
  solver that can store its state in place does, another copies it in);
  inside the PCG solvers the CG step is
  a loop (``device_loop.while_loop``) that runs until the solve is done.
  On a CUDA problem the iteration is captured once as a CUDA graph, each
  region as a conditional graph node (``ops/device_loop.Capture``, after
  one eager warm-up that runs every region once and builds every host
  plan), cached on the problem per (solver, the options that shape the
  step: ``use_identity`` and the early stop), and replayed
  ``iterations`` times with no read in between: a replay
  after a stop runs nothing but the test of the flag. After each replay
  the iteration's row [chi2, mu, rho, accepted] is copied into a trace of
  the run's length, and the history comes from that trace in one readback
  at the end. On a CPU problem the same iteration runs uncaptured, each
  region as its plain ``if`` (a loop as its ``while``): the plain version
  of the captured one.
  Remasking (``Problem.remask``) writes the masks in place, so the cached
  graph stays valid. On a sharded replica (``parallel.sharded_lm``) every
  rank builds, warms up, captures and replays the same iteration, so every
  rank issues the same collectives (K8 launches on the card, inside the
  graph and its regions) in the same order.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Optional

import torch

from ..linearize import (
    apply_update,
    backup_parameters,
    compute_chi2,
    linearize,
    restore_parameters,
)
from ..ops import device_loop
from ..ops.cuda import launches as launch_stats


@dataclasses.dataclass
class LevenbergMarquardtOptions:
    iterations: int = 10
    initial_damping: float = 1e-4
    verbose: bool = False
    use_identity: bool = False
    jit_loop: bool = False
    # levenberg_marquardt2's early stop; None disables it
    early_stop_bad_steps: Optional[int] = None
    early_stop_relative: float = 1e-3
    # write a torch.profiler Chrome trace of the run into this directory
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class LMResult:
    params: Any
    chi2: float
    initial_chi2: float
    mu: float
    iterations: int
    accepted_steps: int
    run_ok: bool
    # per iteration: dict(iteration, chi2_before, chi2, mu, rho, accepted,
    # time (host seconds), device_ms (CUDA events; None on the CPU)); under
    # jit_loop time is the run's wall (its replays after a stop included)
    # over the iterations that ran, as in the JAX package, and device_ms
    # the mean replay of those iterations
    history: list


def try_step(problem, solver, lin, sstate, params, mu, chi2,
             use_identity: bool):
    """One damped solve from ``params`` (linearized as ``lin``, damping
    ``mu``, cost ``chi2``) and its gain test, all on the device: (accept,
    new parameters, new chi2, rho). A failed solve gives new chi2 = max
    float, hence a rejected step."""
    gdt = problem.precision.graph_dtype
    delta_x, ok = solver.solve(problem, lin, sstate, mu, use_identity,
                               params=params)
    new_params = apply_update(problem, params, lin, delta_x)
    new_chi2 = torch.where(ok, compute_chi2(problem, new_params),
                           torch.finfo(gdt).max)
    dx = delta_x[: problem.dim_h]
    bb = lin.b[: problem.dim_h]
    # summed in float64 (like chi2, see linearize.compute_chi2)
    gain = (dx * (mu * dx + bb)).sum(dtype=torch.float64).to(gdt)
    denom = torch.where(ok, gain + 1e-3, torch.ones_like(mu))
    rho = (chi2 - new_chi2) / denom
    accept = ok & torch.isfinite(new_chi2) & (rho > 0)
    return accept, new_params, new_chi2, rho


def lm_step(problem, solver, lin, sstate, params, mu, chi2,
            use_identity: bool):
    """``try_step`` with the accept decision read back: (accept (bool),
    new parameters, new chi2, rho)."""
    accept, new_params, new_chi2, rho = try_step(
        problem, solver, lin, sstate, params, mu, chi2, use_identity)
    return bool(accept), new_params, new_chi2, rho


def _damping_factor(rho):
    t = 2.0 * rho - 1.0
    return (1.0 - t * t * t).clamp(1.0 / 3.0, 2.0 / 3.0)


def _still_running(options, run, mu, rho, num_bad):
    """The ``run`` flag after an iteration (the JAX package's rule)."""
    run = run & torch.isfinite(mu) & (rho != 0)
    if options.early_stop_bad_steps is not None:
        run = run & (num_bad < options.early_stop_bad_steps)
    return run


def _low_progress(options, chi2, new_chi2):
    """LM2: the step's decrease is below ``early_stop_relative`` of
    chi2."""
    return (chi2 - new_chi2) < chi2 * options.early_stop_relative


def _profiled(problem, solver, params, options, stop_flag):
    """The run under ``torch.profiler``, its Chrome trace written into
    ``options.profile_dir``."""
    import os

    from ..stage_profile import profiler_activities

    inner = dataclasses.replace(options, profile_dir=None)
    os.makedirs(options.profile_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=profiler_activities(problem.device)) as prof:
        result = levenberg_marquardt(problem, solver, params, inner,
                                     stop_flag)
        if problem.device.type == "cuda":
            torch.cuda.synchronize(problem.device)
    prof.export_chrome_trace(os.path.join(
        options.profile_dir, f"lm_trace_{os.getpid()}_{time.time_ns()}.json"))
    return result


def levenberg_marquardt(problem, solver, params=None,
                        options: Optional[LevenbergMarquardtOptions] = None,
                        stop_flag=None) -> LMResult:
    options = options or LevenbergMarquardtOptions()
    params = params if params is not None else problem.params0
    if options.profile_dir:
        return _profiled(problem, solver, params, options, stop_flag)
    if options.jit_loop:
        return _device_loop(problem, solver, options).run(params, options)

    gdt = problem.precision.graph_dtype
    dev = problem.device
    on_cuda = dev.type == "cuda"

    t0 = time.perf_counter()
    lin = linearize(problem, params)
    sstate = solver.prepare(problem, lin, params)
    backup = backup_parameters(problem, params)
    mu = torch.full((), options.initial_damping, dtype=gdt, device=dev)
    nu = torch.full((), 2.0, dtype=gdt, device=dev)
    chi2 = lin.chi2
    run = torch.ones((), dtype=torch.bool, device=dev)
    num_bad = torch.zeros((), dtype=torch.int64, device=dev)
    initial_chi2 = float(chi2)
    total = time.perf_counter() - t0

    if options.verbose:
        hdr = (f"{'Iteration':>12} {'Initial Chi2':>18} {'Current Chi2':>18} "
               f"{'Lambda':>14} {'Time':>12} {'Total Time':>12}")
        print(hdr)
        print("-" * len(hdr))

    history = []
    accepted_steps = 0
    run_ok = True
    for i in range(options.iterations):
        t0 = time.perf_counter()
        if on_cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        prev_chi2 = chi2
        accept, new_params, new_chi2, rho = lm_step(
            problem, solver, lin, sstate, params, mu, chi2,
            options.use_identity)
        low = _low_progress(options, prev_chi2, new_chi2)

        if accept:
            params = new_params
            backup = backup_parameters(problem, params)
            lin = linearize(problem, params)
            sstate = solver.prepare(problem, lin, params)
            mu = mu * _damping_factor(rho).to(gdt)
            nu = torch.full((), 2.0, dtype=gdt, device=dev)
            chi2 = new_chi2
            num_bad = torch.where(low, num_bad + 1, 0)
            accepted_steps += 1
        else:
            params = restore_parameters(problem, new_params, backup)
            mu = mu * nu
            nu = nu * 2.0
        run = _still_running(options, run, mu, rho, num_bad)
        c, c_prev, m, r, go = torch.stack(
            [chi2, prev_chi2, mu, rho, run.to(gdt)]).tolist()
        device_ms = None
        if on_cuda:
            ev1.record()
            ev1.synchronize()
            device_ms = ev0.elapsed_time(ev1)
        dt = time.perf_counter() - t0
        total += dt
        history.append(dict(iteration=i, chi2_before=c_prev, chi2=c, mu=m,
                            rho=r, accepted=accept, time=dt,
                            device_ms=device_ms))
        if options.verbose:
            print(f"{i:>12d} {c_prev:>18.10g} {c:>18.10g} "
                  f"{m:>14.6g} {dt:>12.4g} {total:>12.4g}")
        if not go:
            if not math.isfinite(m):
                print("Damping factor is infinite, terminating optimization")
                run_ok = False
            elif r == 0:
                print("Rho is zero, terminating optimization")
            break
        if stop_flag is not None and stop_flag():
            print("Stopping optimization due to stop flag")
            break

    return LMResult(params=params, chi2=float(chi2),
                    initial_chi2=initial_chi2, mu=float(mu),
                    iterations=len(history), accepted_steps=accepted_steps,
                    run_ok=run_ok, history=history)


def levenberg_marquardt2(problem, solver, params=None,
                         options: Optional[LevenbergMarquardtOptions] = None,
                         stop_flag=None) -> LMResult:
    """LM with the early stop: 3 accepted steps in a row whose relative
    decrease is below ``early_stop_relative``."""
    options = options or LevenbergMarquardtOptions()
    options = dataclasses.replace(options, early_stop_bad_steps=3)
    return levenberg_marquardt(problem, solver, params, options, stop_flag)


# ---- the device-controlled iteration (jit_loop) --------------------------

def _cloned(tree):
    """A copy of a state tree with every tensor cloned (the static buffers
    of the device loop own their memory)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _cloned(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cloned(v) for v in tree)
    return tree


class _DeviceLoop:
    """The LM state in static tensors and the iteration that updates it
    (see the module docstring). Built once per (problem, solver, the
    options that shape the step); ``run(params, options)`` starts from
    ``params`` with the call's damping and runs its ``iterations``."""

    def __init__(self, problem, solver, options: LevenbergMarquardtOptions):
        # only the fields of _loop_key are read from these options
        self.problem, self.solver, self.step_options = problem, solver, options
        gdt = problem.precision.graph_dtype
        dev = problem.device
        params = {n: p.clone() for n, p in problem.params0.items()}
        lin = linearize(problem, params)
        sstate = solver.prepare(problem, lin, params)
        self.params = params
        self.backup = _cloned(backup_parameters(problem, params))
        self.lin = _cloned(lin)
        self.sstate = _cloned(sstate)

        def scalar(v, dtype=gdt):
            return torch.full((), v, dtype=dtype, device=dev)

        self.mu, self.nu, self.chi2 = scalar(0.0), scalar(2.0), scalar(0.0)
        self.rho = scalar(1.0)
        self.accepted = scalar(False, torch.bool)
        self.run_flag = scalar(True, torch.bool)
        self.num_accepted = scalar(0, torch.int64)
        self.num_bad = scalar(0, torch.int64)
        self.k = scalar(0, torch.int64)
        self.initial_chi2 = scalar(0.0)
        # the iteration's [chi2, mu, rho, accepted], copied into the run's
        # trace after each iteration
        self.row = torch.zeros(4, dtype=gdt, device=dev)
        self.capture = None
        self.capture_seconds = 0.0
        self.capture_launches = {}
        self.pool_bytes = 0
        self.replays = 0  # replays of the capture over the loop's life
        self.replay_ms = []  # the last run's device ms of each replay
        if dev.type == "cuda":
            self._capture()
        # the collectives' arena the graph holds (a sharded replica's)
        self.transport = self._transport_token()

    def _transport_token(self):
        mesh = self.problem.mesh
        return None if mesh is None else mesh.transport_token()

    def stale(self) -> bool:
        """Whether the graph holds a collectives' arena that is gone (its
        mesh closed, or the replica bound to another mesh since)."""
        return self.transport is not self._transport_token()

    def _relinearize(self, params) -> None:
        """The linearization and the solver state at ``params``, written
        into the loop's own (``linearize`` and ``prepare`` with ``out``):
        neither reads what it writes (``linearize`` reads ``params`` only,
        ``prepare`` the new linearization)."""
        problem = self.problem
        linearize(problem, params, out=self.lin)
        self.solver.prepare(problem, self.lin, params, out=self.sstate)

    def _step(self) -> None:
        """One iteration, in place, with no host read: the JAX package's
        ``_lm_iteration`` as regions (``device_loop.cond``). The whole
        iteration is one region on the run flag (``"lm_run"``, the
        ``while_loop``'s exit), so that a replay after a stop runs one
        test and nothing else. Inside it, four regions at one depth: the
        step (solve, update, chi2, rho, accept), then the accepted branch
        (relinearize, refresh the solver) on accept, the rejected one
        (restore the parameters) on not accept (``lax.cond``), and the
        bookkeeping.

        The branches follow the step's region instead of nesting in it: a
        nested body is captured on a stream of its own, and the caching
        allocator reuses a block only on the stream that freed it, so the
        accepted branch's temporaries (``linearize``, the Hessian) could
        not reuse the step's (nested, Venice-1778's graph pool grew by
        half: PERF.md). For the same reason the step and the bookkeeping
        are regions (on the run flag, true inside ``"lm_run"``) and not
        the outer region's body itself."""
        problem, options = self.problem, self.step_options
        gdt = problem.precision.graph_dtype
        run, step = self.run_flag, {}

        def try_it():
            accept, new_params, new_chi2, rho = try_step(
                problem, self.solver, self.lin, self.sstate, self.params,
                self.mu, self.chi2, options.use_identity)
            step.update(new_params=new_params, new_chi2=new_chi2,
                        low=_low_progress(options, self.chi2, new_chi2))
            self.accepted.copy_(accept)
            self.rho.copy_(rho)

        def on_accept():
            # try_step is done with the old linearization and state
            new_params = step["new_params"]
            self._relinearize(new_params)
            device_loop.copy_into(self.params, new_params)
            device_loop.copy_into(self.backup,
                                  backup_parameters(problem, new_params))
            self.mu.copy_(self.mu * _damping_factor(self.rho).to(gdt))
            self.nu.fill_(2.0)
            self.chi2.copy_(step["new_chi2"])
            self.num_bad.copy_(torch.where(step["low"], self.num_bad + 1, 0))
            self.num_accepted.add_(1)

        def on_reject():
            device_loop.copy_into(self.params, restore_parameters(
                problem, step["new_params"], self.backup))
            self.mu.copy_(self.mu * self.nu)
            self.nu.copy_(self.nu * 2.0)

        def update():
            self.row.copy_(torch.stack([self.chi2, self.mu, self.rho,
                                        self.accepted.to(gdt)]))
            self.k.add_(1)
            self.run_flag.copy_(_still_running(
                options, self.run_flag, self.mu, self.rho, self.num_bad))

        def iteration():
            device_loop.cond(run, try_it, "lm_iteration")
            device_loop.cond(self.accepted, on_accept, "lm_accept")
            device_loop.cond(~self.accepted, on_reject, "lm_reject")
            device_loop.cond(run, update, "lm_update")

        device_loop.cond(run, iteration, "lm_run")

    def _capture(self) -> None:
        """Warm up (one eager iteration on a side stream, every region run:
        every host plan gets built), then capture one iteration. The
        warm-up writes the state; every run starts by resetting it
        (``_start``)."""
        dev = self.problem.device
        # the Schur complement needs IEEE float32 products (pcg_schur.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), device_loop.enabled(
                warmup=True) as warm:
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_stats.snapshot()
        cap = device_loop.Capture(dev)
        cap.record(self._step, warm.regions)
        after = launch_stats.snapshot()
        self.capture_launches = {n: after[n] - before.get(n, 0)
                                 for n in after if after[n] - before.get(n, 0)}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture = cap
        self.capture_seconds = time.perf_counter() - t0

    def _start(self, params, initial_damping: float) -> None:
        """Reset the state to the start of a run from ``params``."""
        problem = self.problem
        device_loop.copy_into(self.params,
                              {n: params[n] for n in self.params})
        self._relinearize(self.params)
        device_loop.copy_into(self.backup,
                              backup_parameters(problem, self.params))
        self.mu.fill_(initial_damping)
        self.nu.fill_(2.0)
        self.chi2.copy_(self.lin.chi2)
        self.initial_chi2.copy_(self.lin.chi2)
        self.rho.fill_(1.0)
        self.accepted.fill_(False)
        self.run_flag.fill_(True)
        for t in (self.num_accepted, self.num_bad, self.k, self.row):
            t.zero_()

    def run(self, params, options: LevenbergMarquardtOptions) -> LMResult:
        """A run of ``options.iterations`` iterations from ``params`` with
        ``options.initial_damping``, printed when ``options.verbose``."""
        dev = self.problem.device
        gdt = self.problem.precision.graph_dtype
        on_cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        self._start(params, options.initial_damping)
        trace = torch.zeros((options.iterations, 4), dtype=gdt, device=dev)
        device_ms = None
        if on_cuda:
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(options.iterations + 1)]
            sync_mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "a prototype feature"
                if not self.capture.host_calls:
                    # no host read between replays: any sync raises
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    events[0].record()
                    for i, ev in enumerate(events[1:]):
                        self.capture.replay()
                        trace[i].copy_(self.row)
                        ev.record()
                finally:
                    torch.cuda.set_sync_debug_mode(sync_mode)
            self.replays += options.iterations
        else:
            with device_loop.enabled():
                for i in range(options.iterations):
                    self._step()
                    trace[i].copy_(self.row)
        # one batched readback
        scalars = torch.stack([
            self.chi2, self.initial_chi2, self.mu, self.k.to(gdt),
            self.num_accepted.to(gdt), self.run_flag.to(gdt)]).tolist()
        trace = trace.tolist()
        if self.problem.mesh is not None:
            # a sharded replica's collectives (K8) report a peer that never
            # came in their error word: read once, after the replays
            self.problem.mesh.check("the LM device loop's run")
        wall = time.perf_counter() - t0
        chi2, initial_chi2, mu, k, num_accepted, run = scalars
        k = int(k)
        if on_cuda:
            self.replay_ms = [a.elapsed_time(b)
                              for a, b in zip(events, events[1:])]
            device_ms = sum(self.replay_ms[:k]) / max(k, 1)
        history = []
        prev = initial_chi2
        for i in range(k):
            c_i, mu_i, rho_i, acc_i = trace[i]
            history.append(dict(iteration=i, chi2_before=prev, chi2=c_i,
                                mu=mu_i, rho=rho_i, accepted=bool(acc_i),
                                time=wall / max(k, 1), device_ms=device_ms))
            prev = c_i
        if options.verbose and history:
            hdr = (f"{'Iteration':>12} {'Initial Chi2':>18} "
                   f"{'Current Chi2':>18} {'Lambda':>14} {'Rho':>12}")
            print(hdr)
            print("-" * len(hdr))
            for h in history:
                print(f"{h['iteration']:>12d} {h['chi2_before']:>18.10g} "
                      f"{h['chi2']:>18.10g} {h['mu']:>14.6g} "
                      f"{h['rho']:>12.6g}")
        return LMResult(
            params={n: p.clone() for n, p in self.params.items()},
            chi2=chi2, initial_chi2=initial_chi2, mu=mu, iterations=k,
            accepted_steps=int(num_accepted), run_ok=bool(run),
            history=history)


def _loop_key(solver, options):
    """The options that shape the captured step; the iteration count, the
    initial damping and ``verbose`` are the call's own."""
    return ("lm_device_loop", id(solver), options.use_identity,
            options.early_stop_bad_steps, options.early_stop_relative)


def _device_loop(problem, solver, options) -> _DeviceLoop:
    """The device loop of (solver, the options that shape the step)
    cached on ``problem``."""
    key = _loop_key(solver, options)
    loop = problem._cache.get(key)
    if (loop is None or loop.solver is not solver
            or loop.problem is not problem or loop.stale()):
        loop = _DeviceLoop(problem, solver, options)
        problem._cache[key] = loop
    return loop


def cached_device_loop(problem, solver,
                       options: LevenbergMarquardtOptions):
    """The device loop a ``jit_loop`` run of (solver, options) on
    ``problem`` reuses, or None: its ``capture`` (the CUDA graph pieces;
    ``capture.regions`` its conditional regions, ``capture.region_runs()``
    how often each ran, ``capture.launches(replays)`` the launches the
    replays ran), ``capture_seconds`` (the warm-up and the capture),
    ``capture_launches`` (each kernel wrapper's launches captured: a replay
    runs those outside the regions and those of the regions it enters),
    ``pool_bytes`` (the memory the capture reserved, its regions' pools
    included), ``replays`` (replays over the loop's life) and
    ``replay_ms`` (the last run's device ms per replay, those after a stop
    included: each runs only the test of the run flag)."""
    return problem._cache.get(_loop_key(solver, options))


def device_loops(problem) -> list:
    """Every device loop cached on ``problem``."""
    return [v for v in problem._cache.values() if isinstance(v, _DeviceLoop)]
