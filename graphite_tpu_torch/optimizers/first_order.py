"""The device loop of the first-order optimizers (``gradient_descent``,
``adam``): the counterpart of the JAX package's ``lax.scan`` over the
iterations, with one read of the history at the end.

The optimizer's state lives in static tensors (the parameters, a step
counter ``k``, the chi2 history of the run's length, and the optimizer's
own state); ``step()`` is one iteration that updates them in place with
no host read, and writes the iteration's chi2 at position ``k`` of the
history. On a CUDA problem the first call builds the state, runs one
eager step (every host plan gets built) and captures ``step()`` once as a
CUDA graph (``ops/device_loop.Capture``); every run resets the state and
replays the graph ``iterations`` times under
``torch.cuda.set_sync_debug_mode("error")``. On a CPU problem the same
``step()`` runs uncaptured, so the two devices run the same operations.
A loop is cached on ``problem._cache`` under the JAX package's key.
"""

from __future__ import annotations

import time
import warnings

import torch

from ..ops import device_loop
from ..ops.cuda import launches as launch_stats


class StepLoop:
    """One optimizer's state in static tensors and its captured step;
    ``run(params)`` runs ``iterations`` steps from ``params``.

    After a CUDA run: ``capture_seconds`` (the warm-up and the capture),
    ``capture_launches`` (each kernel wrapper's launches in one replay),
    ``pool_bytes`` (the memory the capture reserved), ``replays`` (over
    the loop's life) and ``replay_ms`` (the last run's device ms per
    replay, CUDA events)."""

    def __init__(self, problem, iterations: int):
        gdt = problem.precision.graph_dtype
        dev = problem.device
        self.problem = problem
        self.iterations = iterations
        self.params = {n: p.clone() for n, p in problem.params0.items()}
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.hist = torch.zeros(iterations, dtype=gdt, device=dev)
        self._slots = torch.arange(iterations, device=dev)
        self.capture = None
        self.capture_seconds = 0.0
        self.capture_launches = {}
        self.pool_bytes = 0
        self.replays = 0
        self.replay_ms = []
        if dev.type == "cuda":
            self._capture()

    def step(self) -> None:
        """One iteration on the static state, in place, with no host
        read."""
        raise NotImplementedError

    def _reset_state(self) -> None:
        """Zero the optimizer's own state at the start of a run."""

    def _advance(self, chi2: torch.Tensor, new_params) -> None:
        """Record ``chi2`` at position ``k`` of the history (a unique
        position, no atomics), take the new parameters, count the step."""
        torch.where(self._slots == self.k, chi2, self.hist, out=self.hist)
        for name, p in self.params.items():
            p.copy_(new_params[name])
        self.k.add_(1)

    def _capture(self) -> None:
        """Warm up (one eager step on a side stream: every host plan gets
        built), then capture one step."""
        dev = self.problem.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), device_loop.enabled():
            self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_stats.snapshot()
        cap = device_loop.Capture(dev)
        cap.record(self.step)
        after = launch_stats.snapshot()
        self.capture_launches = {n: after[n] - before.get(n, 0)
                                 for n in after if after[n] - before.get(n, 0)}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture = cap
        self.capture_seconds = time.perf_counter() - t0

    def run(self, params):
        """``iterations`` steps from ``params``: (the final parameters, the
        chi2 history as a tensor on the problem's device, the history as
        a list: the run's one readback)."""
        for name, p in self.params.items():
            p.copy_(params[name])
        self.k.zero_()
        self.hist.zero_()
        self._reset_state()
        if self.problem.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(self.iterations + 1)]
            sync_mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "a prototype feature"
                torch.cuda.set_sync_debug_mode("error")
                try:
                    events[0].record()
                    for ev in events[1:]:
                        self.capture.replay()
                        ev.record()
                finally:
                    torch.cuda.set_sync_debug_mode(sync_mode)
            self.replays += self.iterations
        else:
            with device_loop.enabled():
                for _ in range(self.iterations):
                    self.step()
        values = self.hist.tolist()
        if self.problem.device.type == "cuda":
            self.replay_ms = [a.elapsed_time(b)
                              for a, b in zip(events, events[1:])]
        return ({n: p.clone() for n, p in self.params.items()},
                self.hist.clone(), values)


def cached_loop(problem, key, build) -> StepLoop:
    """The loop cached on ``problem`` under ``key``, built by ``build()``
    on first use."""
    loop = problem._cache.get(key)
    if loop is None:
        loop = problem._cache[key] = build()
    return loop
