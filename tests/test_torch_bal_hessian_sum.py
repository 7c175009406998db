"""Kernel K7's fused Hessian sum (``ops/cuda/bal.py``, ``bal_hessian_sum``)
on the CPU, where it runs its plain version.

The entry forms each factor's ``J_s^T dL J_t`` for one slot pair and sums
the products into their blocks on a K1 plan, in K1's lane order; the
first writer of a group stores the sums, a later one adds them. Before it,
``compute_hessian_values`` materialised the (F, 81 / 27 / 9) product rows,
summed them with K1 and added the sums to a zero-filled group. Here the
entry is held bitwise to that composition (``_composition``: the product
rows as the generic branch forms them, ``segsum.segment_sum_plain``, the
add to zeros or to the group):

- at every Hessian site of small BAL problems (6 cameras, 60 points, 300
  observations; one camera fixed, so its slots are masked and its rows
  hold -0.0; ten factors disabled), under float32, bf16 and fp16 storage
  and the default, Huber and Cauchy losses;
- on a destination-sorted site with one lane per segment (observations
  sorted by point), on a permuted site with 32 lanes forced, on a
  transposed site (points ordered before cameras, so the camera-point
  blocks are (3, 9)), on a group with two contributions (two factor sets:
  the second adds), and on one rank's slice of the factors (the plan of
  ``Problem.shard_slice``'s rows).

Through ``compute_hessian_values`` the K7 branch is bitwise the generic
branch (the gate forced shut) on the sorted, transposed and two-set
graphs, launches one sum per site and no K1 reduction. The sum and
``bal_scale_b`` raise, before they look for a card, for a pair of graph,
storage and sum dtypes that has no instance.

The kernel forms only the distinct entries (i <= k) of the symmetric
sites (0, 0) and (1, 1) and stores each to (i, k) and (k, i). What that
rests on is held here under all six policies (the FP64 ones too): the
plain product rows of those sites are bitwise symmetric blocks (signed
zeros compared as bit patterns; the fixed camera's rows are all zeros),
and the upper triangle's columns summed by ``segment_sum_ordered`` and
mirrored are bitwise the full ``bal_hessian_sum_plain``, stored and
added, on plans of 1, 2, 32 and 256 lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import graphite_tpu_torch as gtt
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch.io import synthetic
from graphite_tpu_torch.linearize import linearize
from graphite_tpu_torch.models import bal as bal_model
from graphite_tpu_torch.ops.blockfmt import flat_block_mm_tn
from graphite_tpu_torch.ops.cuda import bal as k7
from graphite_tpu_torch.ops.cuda import segsum

torch.set_num_threads(1)

SIZE = (6, 60, 300)
POLICIES = ["FP32_FP32", "FP32_BF16", "FP32_FP16"]
ALL_POLICIES = POLICIES + ["FP64_FP64", "FP64_FP32", "FP64_BF16"]
LOSSES = {"default": (None, None), "huber": (gtt.HuberLoss(), 2.0),
          "cauchy": (gtt.CauchyLoss(), 1.5)}
FIXED_CAMERA = 5
DISABLED = 10


def _problem(policy="FP32_FP32", loss="default", order="cameras_first",
             fixed=True, two_sets=False):
    """A BAL graph built by hand: ``order`` "cameras_first" (points
    eliminated), "points_first" (points added first and not eliminated:
    the camera-point blocks are stored transposed) or "sorted" (the
    observations sorted by point); ``two_sets`` splits the observations
    over two factor sets of the same type."""
    ds = synthetic.make_bal(SIZE, seed=3, noise=0.5)
    ids = np.stack([ds.cam_idx, ds.num_cameras + ds.point_idx], axis=1)
    obs = ds.observations
    if order == "sorted":
        perm = np.lexsort((ids[:, 0], ids[:, 1]))
        ids, obs = ids[perm], obs[perm]
    fn, param = LOSSES[loss]
    g = gtt.Graph(precision=getattr(gtt, policy))
    vsets = {}
    for vt in ((bal_model.POINT, bal_model.CAMERA) if order == "points_first"
               else (bal_model.CAMERA, bal_model.POINT)):
        vsets[vt.name] = g.add_vertex_set(vt)
    cams, pts = vsets[bal_model.CAMERA.name], vsets[bal_model.POINT.name]
    cams.add_batch(np.arange(ds.num_cameras), ds.cameras)
    pts.add_batch(ds.num_cameras + np.arange(ds.num_points), ds.points)
    pts.set_eliminate(order != "points_first")
    ftype = bal_model.REPROJECTION if fn is None else dataclasses.replace(
        bal_model.REPROJECTION, loss=fn)
    types = [ftype] + ([dataclasses.replace(ftype, name="second")]
                       if two_sets else [])
    cut = np.linspace(0, len(ids), len(types) + 1).astype(int)
    for ft, a, b in zip(types, cut[:-1], cut[1:]):
        fs = g.add_factor_set(ft)
        kw = {} if param is None else {"loss_params": np.full(b - a, param)}
        fs.add_batch(ids[a:b], obs=obs[a:b], **kw)
        if fixed:
            for h in range(DISABLED):
                fs.set_active(h, 0x80)
    if fixed:
        cams.set_fixed(FIXED_CAMERA)
    return g.freeze(device="cpu")


def _bits(t):
    return t.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16}[t.element_size()])


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _rows(jc, jp, dL, s, t, transposed):
    """The product rows of one slot pair as the generic branch forms them
    (``compute_hessian_values``): float32 products of the stored J, times
    dL, then the (ds, dt) -> (dt, ds) transpose of a transposed site."""
    acc = torch.float32
    J, dims = (jc, jp), (9, 3)
    ds, dt = dims[s], dims[t]
    rows = (flat_block_mm_tn(J[s], J[t].to(acc), ds, 2, dt, acc_dtype=acc)
            * dL.to(acc)[:, None]).to(torch.float32)
    if transposed:
        rows = rows.reshape(-1, ds, dt).transpose(1, 2).reshape(-1, ds * dt)
    return rows


def _composition(jc, jp, dL, plan, s, t, transposed, prev):
    """The group after the site: ``prev`` (zeros for its first writer)
    plus the K1 sums of the rows."""
    return prev + segsum.segment_sum_plain(
        _rows(jc, jp, dL, s, t, transposed), plan)


def _sites(problem, hs):
    """(factor set, s, t, transposed, group key, per-factor block index)
    of every Hessian site, in ``compute_hessian_values``' order."""
    out = []
    for cm in hs.contribs:
        for key, idx, tr in ((cm.direct_group, cm.direct_idx, False),
                             (cm.trans_group, cm.trans_idx, True)):
            if idx is not None:
                out.append((cm.fname, cm.s, cm.t, tr, key, idx))
    return out


def _check_sites(problem, group=None, rows=None):
    """Every site of ``problem`` through the entry and through the
    composition, groups threaded from site to site as
    ``compute_hessian_values`` does; ``group`` forces the lanes per
    segment, ``rows`` takes a slice of each set's factors (a rank's)."""
    lin = linearize(problem, problem.params0)
    hs = torch_hessian.build_hessian_structure(problem)
    groups, refs, kinds = {}, {}, []
    for fname, s, t, tr, key, idx in _sites(problem, hs):
        jc, jp = lin.jacobians[fname]
        dL = lin.chi2_deriv[fname]
        if rows is not None:
            jc, jp, dL, idx = jc[rows], jp[rows], dL[rows], idx[rows]
        width = key[0] * key[1]
        plan = segsum.plan_segments(idx, hs.group_sizes[key] + 1, "cpu",
                                    group=group, width=width)
        first = key not in groups
        if first:
            groups[key] = torch.empty((plan.num_segments, width))
            refs[key] = torch.zeros((plan.num_segments, width))
        out = k7.bal_hessian_sum(jc, jp, dL, plan, s, t, tr, groups[key],
                                 not first)
        assert out is groups[key]
        refs[key] = _composition(jc, jp, dL, plan, s, t, tr, refs[key])
        _same(groups[key], refs[key])
        kinds.append((key, tr, plan.perm is None, plan.group, first))
    return lin, kinds


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("policy", POLICIES)
def test_every_site_bitwise_the_composition(policy, loss):
    problem = _problem(policy, loss)
    lin, kinds = _check_sites(problem)
    assert len(kinds) == 3
    jc = lin.jacobians["bal_reprojection"][0]
    assert jc.dtype == getattr(gtt, policy).solver_dtype
    # the fixed camera's masked slots: rows of -0.0 entries
    jcf = jc.float()
    assert bool(((jcf == 0) & torch.signbit(jcf)).any())


def _kind(kind, policy):
    """(problem, forced group, factor rows) of one kind of site."""
    if kind == "sorted":
        return _problem(policy, order="sorted", fixed=False), None, None
    if kind == "group32":
        return _problem(policy), 32, None
    if kind == "transposed":
        return _problem(policy, order="points_first"), None, None
    if kind == "two_sets":
        return _problem(policy, two_sets=True), None, None
    # one rank's rows of two: the second half of each set's factors
    return _problem(policy), None, slice(SIZE[2] // 2, SIZE[2])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["sorted", "group32", "transposed",
                                  "two_sets", "shard"])
def test_site_kinds_bitwise_the_composition(kind, policy):
    problem, group, rows = _kind(kind, policy)
    _, kinds = _check_sites(problem, group, rows)
    if kind == "sorted":
        # the camera-point and point-point sites: sorted, one lane
        assert [(k, sorted_, g) for k, _, sorted_, g, _ in kinds[1:]] == [
            ((9, 3), True, 1), ((3, 3), True, 1)]
    elif kind == "group32":
        assert {(sorted_, g) for _, _, sorted_, g, _ in kinds} == {
            (False, 32)}
    elif kind == "transposed":
        assert [(k, tr) for k, tr, *_ in kinds] == [
            ((9, 9), False), ((3, 9), True), ((3, 3), False)]
    elif kind == "two_sets":
        # each group's second writer adds
        assert [first for *_, first in kinds] == [True] * 3 + [False] * 3


@pytest.mark.parametrize("kind", ["sorted", "transposed", "two_sets"])
def test_hessian_values_bitwise_the_generic_branch(kind, monkeypatch):
    problem = {"sorted": lambda: _problem(order="sorted", fixed=False),
               "transposed": lambda: _problem(order="points_first"),
               "two_sets": lambda: _problem(two_sets=True)}[kind]()
    lin = linearize(problem, problem.params0)
    hs = torch_hessian.build_hessian_structure(problem)
    calls = []
    real = k7.bal_hessian_sum

    def counted(*args):
        calls.append(args[4:7])
        return real(*args)

    def refuse(*args):
        raise AssertionError("K1 reduced a K7 set's Hessian rows")

    with monkeypatch.context() as m:
        m.setattr(k7, "bal_hessian_sum", counted)
        m.setattr(torch_hessian, "reduce_rows", refuse)
        hv = torch_hessian.compute_hessian_values(problem, hs, lin)
    assert len(calls) == len(_sites(problem, hs))
    with monkeypatch.context() as m:
        m.setattr(k7, "gate", lambda problem, name: None)
        ref = torch_hessian.compute_hessian_values(problem, hs, lin)
    assert list(hv) == list(ref) == hs.group_keys
    for key in ref:
        _same(hv[key], ref[key])


def test_entry_refuses_what_it_does_not_take():
    problem = _problem()
    lin = linearize(problem, problem.params0)
    jc, jp = lin.jacobians["bal_reprojection"]
    dL = lin.chi2_deriv["bal_reprojection"]
    hs = torch_hessian.build_hessian_structure(problem)
    _, s, t, tr, key, idx = _sites(problem, hs)[0]
    plan = segsum.plan_segments(idx, hs.group_sizes[key] + 1, "meta")
    out = torch.empty((plan.num_segments, 81), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        k7.bal_hessian_sum(jc.to("meta"), jp.to("meta"), dL.to("meta"),
                           plan, s, t, tr, out, False)


# (graph dtype, storage dtype, the sums' dtype) with no K7 instance: a
# float16 graph, float64 storage in a float32 graph, a float64 graph's
# sums of float32 J into float64 (FP64_FP32's are float32) and of bf16 J
# into float32 (FP64_BF16's are float64)
NO_INSTANCE = [(torch.float16, torch.float16, torch.float16),
               (torch.float32, torch.float64, torch.float64),
               (torch.float64, torch.float32, torch.float64),
               (torch.float64, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("graph,storage,sums", NO_INSTANCE)
def test_entries_refuse_dtypes_without_an_instance(graph, storage, sums):
    """``bal_scale_b`` and ``bal_hessian_sum`` raise for a dtype pair with
    no K7 instance before they look for a card."""
    problem = _problem()
    hs = torch_hessian.build_hessian_structure(problem)
    _, s, t, tr, key, idx = _sites(problem, hs)[0]
    plan = segsum.plan_segments(idx, hs.group_sizes[key] + 1, "meta")
    F = problem.data.factors["bal_reprojection"].ids[0].shape[0]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    jc, jp = meta((F, 18), storage), meta((F, 6), storage)
    dL = meta((F,), graph)
    out = meta((plan.num_segments, key[0] * key[1]), sums)
    with pytest.raises(NotImplementedError, match="no kernel for"):
        k7.bal_hessian_sum(jc, jp, dL, plan, s, t, tr, out, False)
    if storage == sums:  # a graph dtype or storage with no scale_b instance
        rows = meta((F,), torch.int64)
        with pytest.raises(NotImplementedError, match="no kernel for"):
            k7.bal_scale_b(meta((F, 18), graph), meta((F, 6), graph),
                           meta((F, 2), graph), dL, None, None, rows, rows,
                           storage)


@pytest.mark.parametrize("group", [1, 4, 32, 256])
def test_ordered_segment_sum_is_k1s_plain_version(group):
    """``segment_sum_ordered`` (the K7 sum's plain version sums with it, so
    that it has the same bits on the card) is bitwise ``segment_sum_plain``
    on the CPU: unsorted destinations, empty segments, -0.0 rows."""
    rng = np.random.default_rng(group)
    seg = rng.integers(0, 40, 700)
    seg[seg == 7] = 8  # segment 7 empty
    vals = torch.as_tensor(rng.standard_normal((700, 5)).astype(np.float32))
    vals[::9] = -0.0
    plan = segsum.plan_segments(seg, 41, "cpu", group=group)
    _same(segsum.segment_sum_ordered(vals, plan),
          segsum.segment_sum_plain(vals, plan))


def _sum_inputs(policy, loss="default"):
    """(problem, stored J (jc, jp), dL, Hessian structure) at the first
    linearization point of ``_problem(policy, loss)``."""
    problem = _problem(policy, loss)
    lin = linearize(problem, problem.params0)
    jc, jp = lin.jacobians["bal_reprojection"]
    return (problem, (jc, jp), lin.chi2_deriv["bal_reprojection"],
            torch_hessian.build_hessian_structure(problem))


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_symmetric_sites_rows_are_bitwise_symmetric(policy, loss):
    """Each factor's (9, 9) and (3, 3) product of the symmetric sites is
    a bitwise symmetric block in the graph dtype and in the sums' dtype:
    entry (k, i) is (i, k)'s products with their factors swapped."""
    problem, (jc, jp), dL, _ = _sum_inputs(policy, loss)
    inv = problem.precision.inv_dtype
    for s, d in ((0, 9), (1, 3)):
        rows = k7.hessian_rows_plain(jc, jp, dL, s, s, False)
        assert rows.dtype == problem.precision.graph_dtype
        # the fixed camera's masked slot, and any zero column: exact zeros,
        # -0.0 among them
        assert bool(((rows == 0) & torch.signbit(rows)).any())
        for r in (rows, rows.to(inv)):
            blocks = r.reshape(-1, d, d)
            _same(blocks, blocks.transpose(1, 2))


@pytest.mark.parametrize("group", [1, 2, 32, 256])
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_upper_triangle_mirrored_is_the_plain_sum(policy, group):
    """The symmetric sites' upper-triangle columns (i <= k) summed on a
    plan of ``group`` lanes with ``segment_sum_ordered`` and stored to
    both (i, k) and (k, i) are bitwise ``bal_hessian_sum_plain``'s blocks,
    stored into a new group and added to one."""
    problem, (jc, jp), dL, hs = _sum_inputs(policy)
    inv = problem.precision.inv_dtype
    rng = np.random.default_rng(group)
    sites = [x for x in _sites(problem, hs) if x[1] == x[2]]
    assert [(s, key) for _, s, _, _, key, _ in sites] == [
        (0, (9, 9)), (1, (3, 3))]
    for _, s, t, tr, key, idx in sites:
        d = key[0]
        plan = segsum.plan_segments(idx, hs.group_sizes[key] + 1, "cpu",
                                    group=group, width=d * d)
        assert plan.group == group
        pairs = [(i, k) for i in range(d) for k in range(i, d)]
        rows = k7.hessian_rows_plain(jc, jp, dL, s, t, tr).to(inv)
        upper = segsum.segment_sum_ordered(
            rows[:, [i * d + k for i, k in pairs]], plan)
        mirrored = torch.empty((plan.num_segments, d * d), dtype=inv)
        for e, (i, k) in enumerate(pairs):
            mirrored[:, i * d + k] = upper[:, e]
            mirrored[:, k * d + i] = upper[:, e]
        stored = k7.bal_hessian_sum_plain(
            jc, jp, dL, plan, s, t, tr, torch.empty_like(mirrored), False)
        _same(stored, mirrored)
        prev = torch.as_tensor(
            rng.standard_normal(mirrored.shape)).to(inv)
        added = k7.bal_hessian_sum_plain(jc, jp, dL, plan, s, t, tr,
                                         prev.clone(), True)
        _same(added, prev + mirrored)
