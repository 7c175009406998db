"""Partial-state backup / restore and API parity of the port (counterpart
of ``tests/test_state_backup.py``), on the CPU:

- a vertex type whose ``save_state`` keeps only its first component:
  ``restore_parameters`` restores that component and keeps the others;
  through the LM (host loop and ``jit_loop``) a rejected step restores
  only it, as in the JAX package: the same accept pattern and chi2 to
  1e-9 under FP64_FP64;
- the LM converges on the circle problem (the JAX test's thresholds);
- ``Problem.get_vertex`` by global id; ``VertexSet.clear`` /
  ``FactorSet.clear`` (handles restart at 0);
- ``HuberLoss`` at zero delta stays finite;
- checkpoints: a round trip (parameters bitwise, extras, ``dtype``), and
  a checkpoint written by the JAX package loaded by the port and the
  reverse, parameters bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import checkpoint as jax_checkpoint
from graphite_tpu.optimizers import LevenbergMarquardtOptions as JaxOptions
from graphite_tpu.optimizers import levenberg_marquardt as jax_lm
from graphite_tpu.solvers import DenseCholeskySolver as JaxDense
from graphite_tpu_torch.io import checkpoint
from graphite_tpu_torch.linearize import (
    backup_parameters,
    restore_parameters,
)
from graphite_tpu_torch.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu_torch.solvers import DenseCholeskySolver

torch.set_num_threads(1)

POINT2 = gtt.vertex_type("point2", 2)
CIRCLE = gtt.factor_type(
    "circle_auto", 1, [POINT2],
    lambda p, obs: (p[..., 0] ** 2 + p[..., 1] ** 2 - obs ** 2)[..., None],
    obs_shape=())
# only the first component is backed up: a revert restores x[0] and keeps
# the current x[1]
PARTIAL = gtt.vertex_type(
    "partial2", 2,
    save_state=lambda x: x[..., :1],
    load_state=lambda x, s: torch.cat([s, x[..., 1:]], dim=-1))
JAX_PARTIAL = gt.vertex_type(
    "partial2", 2,
    save_state=lambda x: x[:1],
    load_state=lambda x, s: x.at[:1].set(s))

PARTIAL_SUM = gtt.factor_type(
    "f", 1, [PARTIAL], lambda p, o: (p[..., 0] + p[..., 1] - o)[..., None],
    obs_shape=())
# a nonlinear factor on the partial type, so the LM rejects steps
PARTIAL_RING = gtt.factor_type(
    "ring", 1, [PARTIAL],
    lambda p, o: (p[..., 0] * p[..., 0] * p[..., 1] - o)[..., None],
    obs_shape=())
JAX_PARTIAL_RING = gt.factor_type(
    "ring", 1, [JAX_PARTIAL],
    lambda p, o: jnp.array([p[0] * p[0] * p[1] - o]), obs_shape=())


def test_partial_state_restore():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(PARTIAL)
    vs.add(0, [1.0, 2.0])
    g.add_factor_set(PARTIAL_SUM).add([0], obs=5.0)
    problem = g.freeze(device="cpu")
    backup = backup_parameters(problem, problem.params0)
    moved = {"partial2": torch.tensor([[10.0, 20.0]], dtype=torch.float64)}
    restored = restore_parameters(problem, moved, backup)
    np.testing.assert_array_equal(restored["partial2"].numpy()[0],
                                  [1.0, 20.0])


def _partial_lm_graph(graph, vtype, ftype, precision):
    g = graph(precision=precision)
    vs = g.add_vertex_set(vtype)
    for i in range(4):
        vs.add(i, [3.0 + 0.1 * i, -0.5 + 0.5 * i])
    fs = g.add_factor_set(ftype)
    for i in range(4):
        fs.add([i], obs=2.0 + i)
    return g


@pytest.mark.parametrize("jit_loop", [False, True])
def test_lm_with_partial_state_matches_jax(jit_loop):
    problem = _partial_lm_graph(gtt.Graph, PARTIAL, PARTIAL_RING,
                                gtt.FP64_FP64).freeze(device="cpu")
    jp = _partial_lm_graph(gt.Graph, JAX_PARTIAL, JAX_PARTIAL_RING,
                           gt.FP64_FP64).freeze()
    out = levenberg_marquardt(problem, DenseCholeskySolver(),
                              options=LevenbergMarquardtOptions(
                                  iterations=30, initial_damping=10.0,
                                  jit_loop=jit_loop))
    ref = jax_lm(jp, JaxDense(), options=JaxOptions(
        iterations=30, initial_damping=10.0))
    acc = [h["accepted"] for h in out.history]
    assert acc == [h["accepted"] for h in ref.history]
    assert not all(acc)  # a rejected step restored the partial state
    np.testing.assert_allclose([h["chi2"] for h in out.history],
                               [h["chi2"] for h in ref.history], rtol=1e-9,
                               atol=1e-20)
    np.testing.assert_allclose(out.params["partial2"].numpy(),
                               np.asarray(ref.params["partial2"]),
                               rtol=1e-9)


def test_lm_circle_converges():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(POINT2)
    for i in range(4):
        vs.add(i, [3.0 + 0.1 * i, 0.5 * i])
    fs = g.add_factor_set(CIRCLE)
    for i in range(4):
        fs.add([i], obs=2.0)
    res = levenberg_marquardt(
        g.freeze(device="cpu"), DenseCholeskySolver(),
        options=LevenbergMarquardtOptions(iterations=80,
                                          initial_damping=1e-6))
    r = np.sqrt((res.params["point2"].numpy() ** 2).sum(axis=1))
    np.testing.assert_allclose(r, 2.0, rtol=5e-3)
    assert res.chi2 < 1e-3


def test_get_vertex_by_global_id():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(POINT2)
    vs.add(42, [1.0, 2.0])
    vs.add(7, [3.0, 4.0])
    fs = g.add_factor_set(CIRCLE)
    fs.add([42], obs=1.0)
    fs.add([7], obs=1.0)
    problem = g.freeze(device="cpu")
    np.testing.assert_array_equal(
        problem.get_vertex(problem.params0, "point2", 7).numpy(), [3.0, 4.0])
    np.testing.assert_array_equal(
        problem.get_vertex(problem.params0, "point2", 42).numpy(),
        [1.0, 2.0])


def test_clear():
    g = gtt.Graph(precision=gtt.FP64_FP64)
    vs = g.add_vertex_set(POINT2)
    vs.add(0, [1.0, 2.0])
    fs = g.add_factor_set(CIRCLE)
    fs.add([0], obs=1.0)
    vs.clear()
    fs.clear()
    assert vs.count == 0 and fs.count == 0
    vs.add(0, [5.0, 6.0])
    assert fs.add([0], obs=2.0) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_huber_zero_delta_no_nan(dtype):
    loss = gtt.HuberLoss()
    x = torch.tensor([0.0, 1.0, 100.0], dtype=dtype)
    d = torch.zeros(3, dtype=dtype)
    assert bool(torch.isfinite(loss.value(x, d)).all())
    assert bool(torch.isfinite(loss.derivative(x, d)).all())


def _one_point(graph, point, factor, precision):
    g = graph(precision=precision)
    vs = g.add_vertex_set(point)
    vs.add(0, [1.5, -2.5])
    vs.add(1, [0.25, 3.0])
    g.add_factor_set(factor).add([0], obs=1.0)
    return g


def test_checkpoint_roundtrip(tmp_path):
    problem = _one_point(gtt.Graph, POINT2, CIRCLE,
                         gtt.FP64_FP64).freeze(device="cpu")
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, problem.params0, mu=np.asarray(1e-4), iteration=7,
                    m=torch.arange(3.0))
    params, extra = checkpoint.load(path, device="cpu")
    assert torch.equal(params["point2"], problem.params0["point2"])
    assert float(extra["mu"]) == 1e-4
    assert int(extra["iteration"]) == 7
    np.testing.assert_array_equal(extra["m"], [0.0, 1.0, 2.0])
    p32, _ = checkpoint.load(path, dtype=torch.float32, device="cpu")
    assert p32["point2"].dtype == torch.float32
    assert torch.equal(p32["point2"],
                       problem.params0["point2"].to(torch.float32))


def test_checkpoint_between_packages(tmp_path):
    from common import CIRCLE_AUTO, POINT2 as JAX_POINT2

    problem = _one_point(gtt.Graph, POINT2, CIRCLE,
                         gtt.FP64_FP64).freeze(device="cpu")
    jp = _one_point(gt.Graph, JAX_POINT2, CIRCLE_AUTO,
                    gt.FP64_FP64).freeze()
    # written by the JAX package, loaded by the port
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path, jp.params0, mu=np.asarray(0.5))
    params, extra = checkpoint.load(path, device="cpu")
    np.testing.assert_array_equal(params["point2"].numpy(),
                                  np.asarray(jp.params0["point2"]))
    assert float(extra["mu"]) == 0.5
    # written by the port, loaded by the JAX package
    path = str(tmp_path / "torch.npz")
    checkpoint.save(path, problem.params0, iteration=3)
    jparams, jextra = jax_checkpoint.load(path)
    np.testing.assert_array_equal(np.asarray(jparams["point2"]),
                                  problem.params0["point2"].numpy())
    assert int(jextra["iteration"]) == 3
