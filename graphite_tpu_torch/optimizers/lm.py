"""Levenberg-Marquardt as a host loop (counterpart of
``graphite_tpu/optimizers/lm.py``, non-jit mode).

- gain ratio ``rho = (chi2 - chi2_new) / (sum dx*(mu*dx + b) + 1e-3)``;
- accept: ``mu *= clamp(1 - (2 rho - 1)^3, 1/3, 2/3)``, ``nu = 2``,
  relinearize and refresh the solver state;
- reject: restore the parameters, ``mu *= nu``, ``nu *= 2``;
- a failed solve makes chi2_new = max float, hence a rejected step;
- stop on a non-finite mu or rho == 0.

Each iteration reads its scalars back to the host once (the accept branch
is taken on the host). On CUDA each history entry also holds the
iteration's device time from CUDA events.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import torch

from ..linearize import (
    apply_update,
    backup_parameters,
    compute_chi2,
    linearize,
    restore_parameters,
)


@dataclasses.dataclass
class LevenbergMarquardtOptions:
    iterations: int = 10
    initial_damping: float = 1e-4
    use_identity: bool = False


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
    # time (host seconds), device_ms (CUDA events; None on the CPU))
    history: list


def lm_step(problem, solver, lin, sstate, params, mu, chi2,
            use_identity: bool):
    """One damped solve from ``params`` (linearized as ``lin``, damping
    ``mu``, cost ``chi2``) and its gain test: (accept, new parameters,
    new chi2, rho). A failed solve gives new chi2 = max float, hence a
    rejected step."""
    gdt = problem.precision.graph_dtype
    delta_x, ok = solver.solve(problem, lin, sstate, mu, use_identity,
                               params=params)
    new_params = apply_update(problem, params, lin, delta_x)
    big = torch.tensor(torch.finfo(gdt).max, dtype=gdt, device=problem.device)
    new_chi2 = torch.where(ok, compute_chi2(problem, new_params), big)
    dx = delta_x[: problem.dim_h]
    bb = lin.b[: problem.dim_h]
    # summed in float64 (like chi2, see linearize.compute_chi2)
    gain = (dx * (mu * dx + bb)).sum(dtype=torch.float64).to(gdt)
    denom = torch.where(ok, gain + 1e-3, torch.ones_like(mu))
    rho = (chi2 - new_chi2) / denom
    accept = bool(ok & torch.isfinite(new_chi2) & (rho > 0))
    return accept, new_params, new_chi2, rho


def levenberg_marquardt(problem, solver, params=None,
                        options: Optional[LevenbergMarquardtOptions] = None
                        ) -> LMResult:
    options = options or LevenbergMarquardtOptions()
    params = params if params is not None else problem.params0
    gdt = problem.precision.graph_dtype
    dev = problem.device
    on_cuda = dev.type == "cuda"

    lin = linearize(problem, params)
    sstate = solver.prepare(problem, lin, params)
    backup = backup_parameters(problem, params)
    mu = torch.tensor(options.initial_damping, dtype=gdt, device=dev)
    nu = torch.tensor(2.0, dtype=gdt, device=dev)
    chi2 = lin.chi2
    initial_chi2 = float(chi2)

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

        if accept:
            t = 2.0 * rho - 1.0
            alpha = (1.0 - t * t * t).clamp(1.0 / 3.0, 2.0 / 3.0)
            params = new_params
            backup = backup_parameters(problem, params)
            lin = linearize(problem, params)
            sstate = solver.prepare(problem, lin, params)
            mu = mu * alpha.to(gdt)
            nu = torch.tensor(2.0, dtype=gdt, device=dev)
            chi2 = new_chi2
            accepted_steps += 1
        else:
            params = restore_parameters(problem, new_params, backup)
            mu = mu * nu
            nu = nu * 2.0
        c, c_prev, m, r = torch.stack([chi2, prev_chi2, mu, rho]).tolist()
        device_ms = None
        if on_cuda:
            ev1.record()
            ev1.synchronize()
            device_ms = ev0.elapsed_time(ev1)
        dt = time.perf_counter() - t0
        history.append(dict(iteration=i, chi2_before=c_prev, chi2=c, mu=m,
                            rho=r, accepted=accept, time=dt,
                            device_ms=device_ms))
        if not math.isfinite(m):
            print("Damping factor is infinite, terminating optimization")
            run_ok = False
            break
        if r == 0:
            print("Rho is zero, terminating optimization")
            break

    return LMResult(params=params, chi2=float(chi2),
                    initial_chi2=initial_chi2, mu=float(mu),
                    iterations=len(history), accepted_steps=accepted_steps,
                    run_ok=run_ok, history=history)
