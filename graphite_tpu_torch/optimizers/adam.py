"""Adam on the factor graph (counterpart of
``graphite_tpu/optimizers/adam.py``).

Gradient ``g = -b``, bias-corrected first and second moments, ``delta =
-lr * m_hat / (sqrt(v_hat) + eps)`` applied through the graph update;
relinearizes every iteration. The iterations run as the device loop of
``first_order.py`` (the step counter is a device tensor, so the captured
graph bakes in no step number).

The card and the CPU take the same IEEE operations: the moment updates
are separate multiplies and adds (no fused multiply-add), ``b1**t`` and
``b2**t`` are taken in float64 and rounded, and ``sqrt(v_hat)`` is
correctly rounded (``precision.sqrt_rn``; PyTorch's float32 CUDA sqrt is
not).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..linearize import apply_update, linearize
from ..precision import sqrt_rn
from .first_order import StepLoop, cached_loop


@dataclasses.dataclass
class AdamOptions:
    iterations: int = 10
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    verbose: bool = False


class AdamLoop(StepLoop):
    def __init__(self, problem, options: AdamOptions):
        gdt = problem.precision.graph_dtype
        self.lr, self.b1, self.b2, self.eps = (
            options.learning_rate, options.beta1, options.beta2,
            options.epsilon)
        self.m = torch.zeros(problem.dim_x, dtype=gdt, device=problem.device)
        self.v = torch.zeros_like(self.m)
        super().__init__(problem, options.iterations)

    def _reset_state(self) -> None:
        self.m.zero_()
        self.v.zero_()

    def step(self) -> None:
        gdt = self.problem.precision.graph_dtype
        b1, b2 = self.b1, self.b2
        lin = linearize(self.problem, self.params)
        g = -lin.b
        m = self.m * b1 + g * (1 - b1)
        v = self.v * b2 + g * (1 - b2) * g
        t = (self.k + 1).to(torch.float64)
        m_hat = m / (1 - torch.pow(b1, t).to(gdt))
        v_hat = v / (1 - torch.pow(b2, t).to(gdt))
        delta = -self.lr * m_hat / (sqrt_rn(v_hat) + self.eps)
        new_params = apply_update(self.problem, self.params, lin, delta)
        self.m.copy_(m)
        self.v.copy_(v)
        self._advance(lin.chi2, new_params)


def adam(problem, params=None, options: Optional[AdamOptions] = None):
    """(final parameters, chi2 history (iterations,) on the problem's
    device)."""
    options = options or AdamOptions()
    params = params if params is not None else problem.params0
    key = ("adam", options.learning_rate, options.beta1, options.beta2,
           options.epsilon, options.iterations)
    loop = cached_loop(problem, key, lambda: AdamLoop(problem, options))
    pf, hist, values = loop.run(params)
    if options.verbose:
        for i, c in enumerate(values):
            print(f"adam iter {i:>6d} chi2 {c:.10g}")
    return pf, hist
