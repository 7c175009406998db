"""Gradient descent and Adam of the port vs the JAX package, on the CPU.

- On ``make_bal("mini", seed=0, noise=0.5)``, each package on its own
  frozen problem: the chi2 history and the final parameters agree to
  rtol 1e-10 under FP64_FP64 and to the tolerance ladder's 1e-3 under
  FP32_FP32 (the JAX package's float32 chi2 sums in float32, the port's
  in float64; measured: 2.5e-6 for GD, 1.9e-5 for Adam).
- The JAX package's own oracles (``tests/test_gd_adam_ba.py``) on the
  port: the convergence thresholds (GD chi2 below 2% of its start after
  100 iterations at lr 0.1, a descent in more than 90% of them; Adam
  below 5% after 300 at lr 0.3) and the trajectory of a straight-line
  reimplementation of the update rules (rtol 1e-12 for GD, 1e-10 for
  Adam).
- The loop is cached under the JAX package's key and reused; a second run
  from other parameters restarts the state (the moments included);
  ``verbose`` prints the JAX package's lines.
- Started from parameters carried over from the JAX package
  (``interop.params_from_numpy``): the same history.
"""

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.optimizers import AdamOptions as JaxAdamOptions
from graphite_tpu.optimizers import GradientDescentOptions as JaxGDOptions
from graphite_tpu.optimizers import adam as jax_adam
from graphite_tpu.optimizers import gradient_descent as jax_gd
from graphite_tpu_torch.interop import params_from_numpy
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import synthetic as torch_synth
from graphite_tpu_torch.linearize import apply_update, linearize
from graphite_tpu_torch.optimizers import (
    AdamOptions,
    GradientDescentOptions,
    adam,
    gradient_descent,
)
from graphite_tpu_torch.precision import sqrt_rn

torch.set_num_threads(1)

RTOL = {"FP64_FP64": 1e-10, "FP32_FP32": 1e-3}


def _problem(policy="FP64_FP64"):
    ds = torch_synth.make_bal("mini", seed=0, noise=0.5)
    g, *_ = torch_bal.build_graph(ds, precision=getattr(gtt, policy))
    return g.freeze(device="cpu")


def _jax_problem(policy="FP64_FP64"):
    ds = jax_synth.make_bal("mini", seed=0, noise=0.5)
    g, *_ = jax_bal.build_graph(ds, precision=getattr(gt, policy))
    return g.freeze()


def _runs(name, policy, iterations, lr):
    if name == "gd":
        out = gradient_descent(_problem(policy), options=GradientDescentOptions(
            iterations=iterations, learning_rate=lr))
        ref = jax_gd(_jax_problem(policy), options=JaxGDOptions(
            iterations=iterations, learning_rate=lr))
    else:
        out = adam(_problem(policy), options=AdamOptions(
            iterations=iterations, learning_rate=lr))
        ref = jax_adam(_jax_problem(policy), options=JaxAdamOptions(
            iterations=iterations, learning_rate=lr))
    return out, ref


@pytest.mark.parametrize("policy", ["FP64_FP64", "FP32_FP32"])
@pytest.mark.parametrize("name,iterations,lr", [("gd", 40, 0.1),
                                                ("adam", 60, 0.3)])
def test_matches_jax(name, iterations, lr, policy):
    (pf, hist), (jpf, jhist) = _runs(name, policy, iterations, lr)
    assert hist.dtype == getattr(gtt, policy).graph_dtype
    assert hist.shape == (iterations,)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist),
                               rtol=RTOL[policy])
    for vname, p in jpf.items():
        ref = np.asarray(p)
        np.testing.assert_allclose(pf[vname].numpy(), ref, rtol=RTOL[policy],
                                   atol=RTOL[policy] * np.abs(ref).max())


def test_gd_converges_on_bal():
    _, hist = gradient_descent(_problem(), options=GradientDescentOptions(
        iterations=100, learning_rate=0.1))
    h = hist.numpy()
    assert h[-1] < 0.02 * h[0]
    assert np.mean(np.diff(h) < 0) > 0.9


def test_adam_converges_on_bal():
    _, hist = adam(_problem(), options=AdamOptions(iterations=300,
                                                   learning_rate=0.3))
    h = hist.numpy()
    assert h[-1] < 0.05 * h[0]


def test_gd_trajectory_matches_python_reimplementation():
    """delta_x = alpha * b each iteration."""
    problem = _problem()
    lr, iters = 0.1, 20
    _, hist = gradient_descent(problem, options=GradientDescentOptions(
        iterations=iters, learning_rate=lr))
    p = problem.params0
    ref = []
    for _ in range(iters):
        lin = linearize(problem, p)
        ref.append(float(lin.chi2))
        p = apply_update(problem, p, lin, lr * lin.b)
    np.testing.assert_allclose(hist.numpy(), np.asarray(ref), rtol=1e-12)


def test_adam_trajectory_matches_python_reimplementation():
    """g = -b, bias-corrected moments, step = -lr*m_hat/(sqrt(v_hat)+eps)."""
    problem = _problem()
    lr, b1, b2, eps, iters = 0.3, 0.9, 0.999, 1e-8, 25
    _, hist = adam(problem, options=AdamOptions(
        iterations=iters, learning_rate=lr, beta1=b1, beta2=b2,
        epsilon=eps))
    p = problem.params0
    m = torch.zeros(problem.dim_x, dtype=torch.float64)
    v = torch.zeros(problem.dim_x, dtype=torch.float64)
    ref = []
    for t in range(iters):
        lin = linearize(problem, p)
        ref.append(float(lin.chi2))
        g = -lin.b
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        m_hat = m / (1 - b1 ** (t + 1))
        v_hat = v / (1 - b2 ** (t + 1))
        p = apply_update(problem, p, lin,
                         -lr * m_hat / (torch.sqrt(v_hat) + eps))
    np.testing.assert_allclose(hist.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize("name", ["gd", "adam"])
def test_loop_is_cached_and_restarts(name):
    problem = _problem("FP32_FP32")
    if name == "gd":
        opts = GradientDescentOptions(iterations=8, learning_rate=0.1)
        run, key = gradient_descent, ("gd", 0.1, 8)
    else:
        opts = AdamOptions(iterations=8, learning_rate=0.3)
        run, key = adam, ("adam", 0.3, 0.9, 0.999, 1e-8, 8)
    p1, h1 = run(problem, options=opts)
    loop = problem._cache[key]
    p2, h2 = run(problem, options=opts)
    assert problem._cache[key] is loop
    assert torch.equal(h1, h2)
    for vname in p1:
        assert torch.equal(p1[vname], p2[vname])
    # from the first run's end: a new run, its history starting there
    p3, h3 = run(problem, p1, options=opts)
    assert float(h3[0]) == float(linearize(problem, p1).chi2)
    assert float(h3[-1]) < float(h1[-1])


def test_starts_from_jax_parameters():
    """The JAX package's parameters carried over through NumPy give the
    same history as the port's own start."""
    problem = _problem()
    jp = _jax_problem()
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jp.params0.items()})
    opts = GradientDescentOptions(iterations=5, learning_rate=0.1)
    _, h_own = gradient_descent(problem, options=opts)
    _, h_jax = gradient_descent(problem, params, options=opts)
    np.testing.assert_allclose(h_jax.numpy(), h_own.numpy(), rtol=1e-14)


@pytest.mark.parametrize("name", ["gd", "adam"])
def test_verbose_prints_each_iteration(name, capsys):
    problem = _problem("FP32_FP32")
    if name == "gd":
        _, hist = gradient_descent(problem, options=GradientDescentOptions(
            iterations=3, learning_rate=0.1, verbose=True))
    else:
        _, hist = adam(problem, options=AdamOptions(
            iterations=3, learning_rate=0.3, verbose=True))
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{name} iter {i:>6d} chi2 {c:.10g}"
                     for i, c in enumerate(hist.tolist())]


def test_adam_step_rounds_like_the_card():
    """The moments' bias corrections come from float64 powers rounded to
    the graph dtype, and sqrt is correctly rounded: the float32 step
    equals the float64 formula's operations rounded one by one."""
    problem = _problem("FP32_FP32")
    _, hist = adam(problem, options=AdamOptions(iterations=2,
                                                learning_rate=0.3))
    lin = linearize(problem, problem.params0)
    g = -lin.b
    m = g * (1 - 0.9)
    v = g * (1 - 0.999) * g
    m_hat = m / (1 - torch.tensor(0.9, dtype=torch.float64).to(torch.float32))
    v_hat = v / (1 - torch.tensor(0.999, dtype=torch.float64)
                 .to(torch.float32))
    p = apply_update(problem, problem.params0, lin,
                     -0.3 * m_hat / (sqrt_rn(v_hat) + 1e-8))
    assert float(hist[1]) == float(linearize(problem, p).chi2)
