"""The landmark inverses and W = Hpl Hll^-1 (kernel K10's wrapper
``ops/cuda/schur_w.schur_w`` and ``schur.landmark_w``) on the CPU, where
the wrapper takes its plain versions ``hll_inverse_plain`` and
``hpl_w_plain``.

- The plain versions against the JAX package's ``spd_inverse_flat`` and
  ``flat_block_mm_nn`` on the ``jnp.repeat``-expanded inverse (as
  ``graphite_tpu/schur.py`` computes W) on the same seeded inputs, for
  dl in 1..3 and dp in {3, 6, 9}: float64 to 1e-12 and float32 to 1e-6,
  relative to each array's largest entry (XLA may contract a product and
  a sum into one rounding).
- The wrapper bitwise the code ``schur.py`` ran before K10 (the inverse,
  ``repeat_interleave`` and ``flat_block_mm_nn``), at the same dims, with
  landmarks that have no Hpl block and -0.0 entries; with
  ``write_inverse=False``; the inverses alone.
- ``landmark_w`` bitwise that code on float32 problems whose Hpl rows are
  gathered (the ``mixed_dims`` fixture of ``test_torch_schur.py``) and
  whose landmark dim has two Hpl groups (``multitype``: K10 once per
  group, the first storing the inverses), and ``schur_values`` bitwise
  before and after on those and a BAL problem, with K3's branch forced
  and not.
- The wrapper raises off its dtypes and dims and on a device other than
  ``cpu`` or ``cuda`` (no fallback); the gate reads dtype and dim only.

K10 itself is tested on the card by ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu.ops import batched_linalg as jax_linalg
from graphite_tpu.ops import blockfmt as jax_blockfmt
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic
from graphite_tpu_torch.linearize import linearize as torch_linearize
from graphite_tpu_torch.ops.batched_linalg import spd_inverse_flat
from graphite_tpu_torch.ops.blockfmt import flat_block_mm_nn
from graphite_tpu_torch.ops.cuda import schur_w
from graphite_tpu_torch.ops.streamreduce import take_rows
from test_torch_schur import _mixed_dims, _multitype

torch.set_num_threads(1)

MU = 1e-2
TOL = {"float64": 1e-12, "float32": 1e-6}


def _inputs(dp, dl, dtype, seed=0, L=40):
    """Seeded SPD Hll blocks, Hpl blocks sorted by landmark (every 5th
    landmark has none, one has 9), every 7th Hpl entry and one Hll
    off-diagonal -0.0."""
    rng = np.random.default_rng(seed + 10 * dp + dl)
    a = rng.standard_normal((L, dl, dl))
    hll = (a @ a.transpose(0, 2, 1) + dl * np.eye(dl)).reshape(L, dl * dl)
    if dl > 1:
        hll[3, 1] = -0.0
    counts = rng.integers(1, 6, L)
    counts[::5] = 0
    counts[7] = 9
    K = int(counts.sum())
    hpl = rng.standard_normal((K, dp * dl)) * 10.0 ** rng.integers(-2, 3, (
        K, 1))
    hpl.reshape(-1)[::7] = -0.0
    return hll.astype(dtype), hpl.astype(dtype), counts


def _w_before(inv, hpl, counts, dp, dl):
    """W as ``schur.py`` computed it before K10, from the inverses."""
    inv_exp = torch.repeat_interleave(
        inv, torch.as_tensor(counts), dim=0, output_size=hpl.shape[0])
    return flat_block_mm_nn(hpl, inv_exp, dp, dl, dl, acc_dtype=inv.dtype)


def _before(hll, hpl, counts, dp, dl):
    """The inverse and W as ``schur.py`` computed them before K10."""
    inv = spd_inverse_flat(hll, dl)
    return inv, _w_before(inv, hpl, counts, dp, dl)


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


DIMS = [(dp, dl) for dp in (3, 6, 9) for dl in (1, 2, 3)]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("dp,dl", DIMS)
def test_plain_matches_jax(dp, dl, dtype):
    hll, hpl, counts = _inputs(dp, dl, dtype)
    plan = schur_w.plan_w(counts, "cpu")
    inv = schur_w.hll_inverse_plain(torch.as_tensor(hll), dl)
    w = schur_w.hpl_w_plain(torch.as_tensor(hpl), inv, plan, dp, dl)
    inv_j = jax_linalg.spd_inverse_flat(jnp.asarray(hll), dl)
    exp_j = jnp.repeat(inv_j, jnp.asarray(counts), axis=0,
                       total_repeat_length=hpl.shape[0])
    w_j = jax_blockfmt.flat_block_mm_nn(jnp.asarray(hpl), exp_j, dp, dl, dl,
                                        acc_dtype=jnp.dtype(dtype))
    assert inv.dtype == w.dtype == getattr(torch, dtype)
    _close(inv.numpy(), np.asarray(inv_j), TOL[dtype])
    _close(w.numpy(), np.asarray(w_j), TOL[dtype])


@pytest.mark.parametrize("dp,dl", DIMS)
def test_wrapper_is_the_code_before_k10(dp, dl):
    hll, hpl, counts = map(torch.as_tensor, _inputs(dp, dl, np.float32))
    plan = schur_w.plan_w(counts.numpy(), "cpu")
    assert plan.rows == hpl.shape[0]
    assert torch.equal(plan.offsets[1:].long(), torch.cumsum(counts, 0))
    inv_ref, w_ref = _before(hll, hpl, counts.numpy(), dp, dl)
    inv, w = schur_w.schur_w(hll, hpl, plan, dp, dl)
    assert torch.equal(_bits(inv), _bits(inv_ref))
    assert torch.equal(_bits(w), _bits(w_ref))
    # the landmarks with no block keep their inverses; at dl = 1 a -0.0
    # entry of Hpl times its positive 1x1 inverse stays -0.0
    assert torch.isfinite(inv[counts == 0]).all()
    if dl == 1:
        assert bool((_bits(w) == _bits(torch.tensor(-0.0))).any())
    none, w2 = schur_w.schur_w(hll, hpl, plan, dp, dl, write_inverse=False)
    assert none is None and torch.equal(_bits(w2), _bits(w_ref))
    alone, no_w = schur_w.schur_w(hll, None, None, 0, dl)
    assert no_w is None and torch.equal(_bits(alone), _bits(inv_ref))


def _landmark_w_before(problem, ss, hvals):
    """``landmark_w`` as ``schur.py`` computed it before K10."""
    inv_dt = problem.precision.inv_dtype
    hll_inv, hpl_w = {}, {}
    for d in ss.lm_dims:
        hll = take_rows(problem, ("lm_h_idx", d), hvals[(d, d)],
                        ss.lm_h_idx[d])
        hll_inv[d] = spd_inverse_flat(hll.to(inv_dt), d)
    for key in ss.hpl_keys:
        dp, dl = key
        hpl = take_rows(problem, ("hpl_h", key), hvals[key],
                        ss.hpl_h_idx[key])
        gi = ss.lm_group_index[ss.hpl_lm[key]]
        counts = np.bincount(gi, minlength=ss.lm_h_idx[dl].shape[0])
        hpl_w[key] = _w_before(hll_inv[dl], hpl.to(inv_dt), counts, dp, dl)
    return hll_inv, hpl_w


def _bal32():
    ds = synthetic.make_bal((6, 60, 300), seed=3, noise=0.5)
    gp, *_ = torch_bal_io.build_graph(ds, precision=gtt.FP32_FP32)
    return None, gp


FIXTURES = {"mixed_dims": lambda: _mixed_dims("FP32_FP32"),
            "multitype": lambda: _multitype("FP32_FP32"), "bal": _bal32}


def _damped(fixture):
    _, gp = FIXTURES[fixture]()
    pp = gp.freeze(device="cpu")
    ss = torch_schur.build_schur_structure(pp)
    hs = torch_hessian.build_hessian_structure(pp)
    lin = torch_linearize(pp, pp.params0)
    hv = torch_hessian.apply_damping(
        pp, hs, torch_hessian.compute_hessian_values(pp, hs, lin), lin.diag,
        MU, False)
    return pp, ss, hv


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_landmark_w_is_the_code_before_k10(fixture, monkeypatch):
    pp, ss, hv = _damped(fixture)
    calls = []
    orig = schur_w.schur_w

    def counted(*args, **kw):
        calls.append(kw.get("write_inverse", True))
        return orig(*args, **kw)

    monkeypatch.setattr(schur_w, "schur_w", counted)
    hll_inv, hpl_w = torch_schur.landmark_w(pp, ss, hv)
    ref_inv, ref_w = _landmark_w_before(pp, ss, hv)
    assert list(hll_inv) == list(ref_inv) and list(hpl_w) == list(ref_w)
    for d in ref_inv:
        assert torch.equal(_bits(hll_inv[d]), _bits(ref_inv[d]))
    for key in ref_w:
        assert torch.equal(_bits(hpl_w[key]), _bits(ref_w[key]))
    # one wrapper call per Hpl group, the first of each dim storing the
    # inverses
    dims = [key[1] for key in ss.hpl_keys]
    assert len(calls) == len(ss.hpl_keys)
    assert sum(calls) == len(set(dims)) == len(ss.lm_dims)
    if fixture == "mixed_dims":
        (key,) = ss.hpl_keys
        assert not np.array_equal(ss.hpl_h_idx[key],
                                  np.arange(ss.hpl_h_idx[key].shape[0]))
    if fixture == "multitype":
        assert dims.count(3) == 2


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_schur_values_bitwise_before_and_after(fixture, forced,
                                               monkeypatch):
    if forced:  # K3's branch (its plain version on the CPU)
        monkeypatch.setattr(torch_schur, "CHUNK_THRESHOLD", 0)
    pp, ss, hv = _damped(fixture)
    after = torch_schur.schur_values(pp, ss, hv)
    assert ("product_plans" in pp._cache) == forced
    monkeypatch.setattr(torch_schur, "landmark_w", _landmark_w_before)
    before = torch_schur.schur_values(pp, ss, hv)
    for d in before.hll_inv:
        assert torch.equal(_bits(after.hll_inv[d]), _bits(before.hll_inv[d]))
    for key in before.s_vals:
        assert torch.equal(_bits(after.s_vals[key]),
                           _bits(before.s_vals[key]))


def test_float64_sites_keep_the_plain_code(monkeypatch):
    """FP64 inverses never reach the wrapper (``gate``)."""

    def k10_called(*args, **kw):
        raise AssertionError("a float64 site called the K10 wrapper")

    _, gp = _mixed_dims()
    pp = gp.freeze(device="cpu")
    ss = torch_schur.build_schur_structure(pp)
    hs = torch_hessian.build_hessian_structure(pp)
    lin = torch_linearize(pp, pp.params0)
    hv = torch_hessian.apply_damping(
        pp, hs, torch_hessian.compute_hessian_values(pp, hs, lin), lin.diag,
        MU, False)
    monkeypatch.setattr(schur_w, "schur_w", k10_called)
    hll_inv, hpl_w = torch_schur.landmark_w(pp, ss, hv)
    ref_inv, ref_w = _landmark_w_before(pp, ss, hv)
    for key in ref_w:
        assert hpl_w[key].dtype == torch.float64
        assert torch.equal(hpl_w[key], ref_w[key])


def test_gate_reads_dtype_and_dim():
    assert schur_w.gate(torch.float32, 3) and schur_w.gate(torch.float32, 1)
    assert not schur_w.gate(torch.float64, 3)
    assert not schur_w.gate(torch.float32, 4)
    assert not schur_w.gate(torch.bfloat16, 2)


def test_wrapper_raises_off_its_dtypes_and_devices():
    hll, hpl, counts = map(torch.as_tensor, _inputs(9, 3, np.float32))
    plan = schur_w.plan_w(counts.numpy(), "cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        schur_w.schur_w(hll.double(), hpl.double(), plan, 9, 3)
    with pytest.raises(NotImplementedError, match="float32"):
        schur_w.schur_w(hll, hpl.bfloat16(), plan, 9, 3)
    with pytest.raises(NotImplementedError, match="dl 1..3"):
        schur_w.schur_w(hll[:, :4].reshape(-1, 16).contiguous(), None, None,
                        0, 4)
    with pytest.raises(ValueError, match="do not fit"):
        schur_w.schur_w(hll, hpl, plan, 6, 3)
    with pytest.raises(ValueError, match="neither"):
        schur_w.schur_w(hll, hpl, None, 9, 3)
    meta = [t.to("meta") for t in (hll, hpl)]
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        schur_w.schur_w(meta[0], meta[1], plan, 9, 3)
