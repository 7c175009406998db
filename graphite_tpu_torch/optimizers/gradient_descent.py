"""Gradient descent on the factor graph (counterpart of
``graphite_tpu/optimizers/gradient_descent.py``).

Each iteration relinearizes and steps ``delta_x = lr * b`` (``b = -grad(1/2
chi2)`` of the scaled system); no line search, no accept / reject. The
history holds each iteration's chi2 before its step. The iterations run
as the device loop of ``first_order.py``: captured once as a CUDA graph
on the card and replayed, uncaptured on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..linearize import apply_update, linearize
from .first_order import StepLoop, cached_loop


@dataclasses.dataclass
class GradientDescentOptions:
    iterations: int = 10
    learning_rate: float = 1e-3
    verbose: bool = False
    jit_loop: bool = True  # ignored, as in the JAX package


class GradientDescentLoop(StepLoop):
    def __init__(self, problem, learning_rate: float, iterations: int):
        self.learning_rate = learning_rate
        super().__init__(problem, iterations)

    def step(self) -> None:
        lin = linearize(self.problem, self.params)
        new_params = apply_update(self.problem, self.params, lin,
                                  self.learning_rate * lin.b)
        self._advance(lin.chi2, new_params)


def gradient_descent(problem, params=None,
                     options: Optional[GradientDescentOptions] = None):
    """(final parameters, chi2 history (iterations,) on the problem's
    device)."""
    options = options or GradientDescentOptions()
    params = params if params is not None else problem.params0
    lr, iters = options.learning_rate, options.iterations
    loop = cached_loop(problem, ("gd", lr, iters),
                       lambda: GradientDescentLoop(problem, lr, iters))
    pf, hist, values = loop.run(params)
    if options.verbose:
        for i, c in enumerate(values):
            print(f"gd iter {i:>6d} chi2 {c:.10g}")
    return pf, hist
