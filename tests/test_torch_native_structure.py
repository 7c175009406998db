"""The port's host library (``graphite_tpu_torch/native``) and the builders
wired through it, against their plain NumPy versions and the JAX package.

- Every native entry point equals its plain NumPy version and the JAX
  package's native function (``graphite_tpu.native.structure``), at 1
  and at 4 threads: values and dtypes, bit for bit. The inputs are large
  enough (2^20-2^21 elements) that the threaded passes split their work.
- Every ``hostops`` entry equals its ``_numpy`` plain version in values,
  and the JAX package's ``hostops`` in values and dtype: the native entry
  against its native path, the plain version against its NumPy path.
- ``build_hessian_structure`` and ``build_schur_structure`` equal the JAX
  package's field by field (values) and the port's build with every
  ``hostops`` entry swapped for its plain version (values and dtype), at
  ``make_bal("mini")``, Ladybug-49 with its observations added in a
  shuffled order, the ``mixed_dims`` fixture of ``test_torch_schur.py``
  and a small SE3 pose graph (Hessian only), also with
  ``MAX_PAIR_CODES`` lowered so that the stepwise Schur path runs.
- ``freeze`` with non-contiguous vertex ids equals one with contiguous
  ids; the unknown-id error is the JAX package's; ``io/bal.load`` equals
  the JAX package's on the real-format fixture and on a ``.gz``.
"""

import dataclasses
import gzip

import numpy as np
import pytest

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu import hessian as jax_hessian
from graphite_tpu import hostops as jax_hostops
from graphite_tpu import schur as jax_schur
from graphite_tpu.io import bal as jax_bal
from graphite_tpu.io import g2o as jax_g2o
from graphite_tpu.io import synthetic as jax_synthetic
from graphite_tpu.models import bal as jax_bal_model
from graphite_tpu.native import structure as jax_native
from graphite_tpu_torch import hessian as torch_hessian
from graphite_tpu_torch import hostops
from graphite_tpu_torch import schur as torch_schur
from graphite_tpu_torch.io import bal as torch_bal
from graphite_tpu_torch.io import g2o as torch_g2o
from graphite_tpu_torch.models import bal as torch_bal_model
from graphite_tpu_torch.native import structure as native
from test_torch_schur import _mixed_dims

THREADS = (1, 4)
BIG = (1 << 21) + 5  # above every threaded pass's serial limit


def _same(a, b, what=""):
    """Equal values and dtype."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_tuple(a, b, what=""):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, (what, i)
        else:
            _same(x, y, f"{what}[{i}]")


def _values_tuple(a, b, what=""):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}[{i}]")


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's hostops with its native library turned off (its
    NumPy path, as its own tests reach it)."""
    monkeypatch.setattr(jax_hostops, "_NS", None)
    monkeypatch.setattr(jax_hostops, "_NS_CHECKED", True)


@pytest.fixture
def plain_hostops(monkeypatch):
    """Every port hostops entry swapped for its plain NumPy version."""
    for name, fn in hostops.PLAIN_VERSIONS.items():
        monkeypatch.setattr(hostops, name, fn)


def _keys(rng, n, hi):
    return rng.integers(0, hi, size=n, dtype=np.int64)


# ---- native entry points --------------------------------------------------

@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", ["200k", "big", "empty", "single", "dups"])
def test_sort_unique(threads, case):
    rng = np.random.default_rng(0)
    codes = {"200k": _keys(rng, 200_000, 1 << 40),
             "big": _keys(rng, BIG, 1 << 40),
             "empty": np.zeros(0, dtype=np.int64),
             "single": np.asarray([7], dtype=np.int64),
             "dups": np.full(300_000, 1 << 35, dtype=np.int64)}[case]
    out = native.sort_unique(codes, threads=threads)
    _same(out, hostops.sorted_unique_numpy(codes), "plain")
    if codes.size:  # the JAX wrapper's native call needs a non-empty input
        _same(out, jax_native.sort_unique(codes), "jax")
    _same(out, native.sort_unique(codes, threads=1), "threads")


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n_queries", [0, 1, 50_000, (1 << 20) + 3])
def test_searchsorted(threads, n_queries):
    rng = np.random.default_rng(1)
    uniq = np.unique(_keys(rng, 200_000, 1 << 40))
    q = _keys(rng, n_queries, 1 << 40)
    q[: n_queries // 2] = uniq[rng.integers(0, uniq.size, n_queries // 2)]
    out = native.searchsorted(uniq, q, threads=threads)
    _same(out, hostops.searchsorted_numpy(uniq, q), "plain")
    _same(out, jax_native.searchsorted(uniq, q), "jax")


def _attach(rng, n_pose, per_lm):
    """An unsorted attach list: ``per_lm[l]`` poses (with repeats) of each
    landmark l, shuffled."""
    att_lm = np.repeat(np.arange(per_lm.size), per_lm)
    att_pose = _keys(rng, att_lm.size, n_pose)
    order = rng.permutation(att_lm.size)
    return att_lm[order], att_pose[order]


# (poses, attaches per landmark): 30,000 attaches, 240,000 pairs (no
# thread splits); 1,088,000 attaches, 2,164,000 pairs (every split taken)
ATTACH_CASES = {
    "small": (40, np.full(2_000, 15)),
    "big": (1_000, np.concatenate([np.full(530_000, 2), np.full(700, 40)])),
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(ATTACH_CASES))
def test_attach_sort_and_pair_fills(threads, case):
    n_pose, per_lm = ATTACH_CASES[case]
    n_lm = per_lm.size
    rng = np.random.default_rng(2)
    att_lm, att_pose = _attach(rng, n_pose, per_lm)
    order, counts, total = native.attach_sort(att_lm, att_pose, n_lm,
                                              threads=threads)
    _same_tuple((order, counts), jax_native.attach_sort(
        att_lm, att_pose, n_lm)[:2], "attach_sort vs jax")
    assert total == jax_native.attach_sort(att_lm, att_pose, n_lm)[2]
    (p_order, p_counts, _, ai, bi, pair_lm, pair_codes, pose_a,
     pose_b) = hostops.attach_pairs_numpy(att_lm, att_pose, n_lm, n_pose)
    _same(order, p_order, "attach_sort vs plain")
    _same(counts, p_counts, "counts vs plain")
    assert total == pair_codes.size

    pose_s = att_pose[order]
    out = native.pair_fill(counts, pose_s, n_pose, total, threads=threads)
    _values_tuple(out, (ai, bi, pair_lm, pair_codes), "pair_fill vs plain")
    _same_tuple(out, jax_native.pair_fill(counts, pose_s, n_pose, total),
                "pair_fill vs jax")

    out2 = native.pair_fill2(counts, pose_s, n_pose, total, threads=threads)
    _values_tuple(out2, (ai, bi, pair_lm, pair_codes, pose_a, pose_b),
                  "pair_fill2 vs plain")
    _same_tuple(out2, jax_native.pair_fill2(counts, pose_s, n_pose, total),
                "pair_fill2 vs jax")

    vals = rng.integers(0, 1 << 30, size=att_lm.size).astype(np.int32)
    vals_s = vals[order]
    out3 = native.pair_fill_vals(counts, pose_s, n_pose, total, vals_s,
                                 threads=threads)
    _values_tuple(out3, (vals_s[ai], vals_s[bi], pair_lm, pair_codes),
                  "pair_fill_vals vs plain")
    _same_tuple(out3, jax_native.pair_fill_vals(counts, pose_s, n_pose,
                                                total, vals_s),
                "pair_fill_vals vs jax")

    hpp = np.unique(_keys(rng, 300, n_pose * n_pose))
    out4 = native.pair_fill_sorted(counts, pose_s, vals_s, n_pose, total,
                                   hpp, threads=threads)
    _same_tuple(out4, jax_native.pair_fill_sorted(counts, pose_s, vals_s,
                                                  n_pose, total, hpp),
                "pair_fill_sorted vs jax")
    plan = hostops.schur_pair_plan_numpy(att_lm, att_pose, n_lm, n_pose,
                                         vals, hpp)
    _same_tuple(out4, plan[1:], "pair_fill_sorted vs plain")
    if threads > 1:
        _same_tuple(out4, native.pair_fill_sorted(
            counts, pose_s, vals_s, n_pose, total, hpp, threads=1),
            "threads 1 vs 4")


UNIQUE_CASES = {
    "packed small keys": lambda r: _keys(r, 300_000, 1 << 22),
    "packed 41-bit keys": lambda r: r.integers(1 << 40, 1 << 41, 300_000),
    # 43-bit keys, 2^21 + 5 codes: three chunks merged and remapped
    "chunked": lambda r: r.integers(1 << 42, 1 << 43, BIG),
    "chunked, every key repeated": lambda r: r.integers(
        1 << 42, (1 << 42) + 997, BIG),
    "struct payload": lambda r: r.integers(1 << 61, 1 << 62, 100_000),
    "all duplicates": lambda r: np.full(5_000, 5, dtype=np.int64),
    "single": lambda r: np.asarray([0], dtype=np.int64),
    "empty": lambda r: np.zeros(0, dtype=np.int64),
}


@pytest.mark.parametrize("case", sorted(UNIQUE_CASES))
def test_sort_unique_inverse(case):
    codes = UNIQUE_CASES[case](np.random.default_rng(3))
    out = native.sort_unique_inverse(codes)
    _same_tuple(out, hostops.unique_inverse_numpy(codes), "plain")
    _same_tuple(out, jax_native.sort_unique_inverse(codes), "jax")


@pytest.mark.parametrize("n", [0, 1, 200_000])
def test_unique_inverse_bounded(n):
    bound = 97 * 97
    codes = _keys(np.random.default_rng(4), n, bound)
    out = native.unique_inverse_bounded(codes, bound)
    _same_tuple(out, hostops.unique_inverse_numpy(codes), "plain")
    _same_tuple(out, jax_native.unique_inverse_bounded(codes, bound), "jax")


@pytest.mark.parametrize("n", [0, 1, 200_000])
def test_counting_sort_perm(n):
    keys = _keys(np.random.default_rng(5), n, 97)
    out = native.counting_sort_perm(keys, 97)
    _same(out, hostops.stable_argsort_numpy(keys, 97), "plain")
    _same(out, jax_native.counting_sort_perm(keys, 97), "jax")


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", [0, 200_000, BIG])
def test_counting_sort_apply3(threads, n):
    rng = np.random.default_rng(6)
    keys = _keys(rng, n, 1_000).astype(np.int32)
    p = [rng.integers(0, 1 << 30, n).astype(np.int32) for _ in range(3)]
    out = native.counting_sort_apply3_i32(keys, 1_000, *p, threads=threads)
    _same_tuple(out, hostops.sort_apply3_numpy(keys, 1_000, *p), "plain")
    _same_tuple(out, jax_native.counting_sort_apply3_i32(keys, 1_000, *p),
                "jax")


def test_inputs_out_of_range_raise():
    with pytest.raises(ValueError):
        native.counting_sort_perm(np.asarray([0, 5]), 5)
    with pytest.raises(ValueError):
        native.unique_inverse_bounded(np.asarray([-1]), 4)
    with pytest.raises(ValueError):
        native.attach_sort(np.asarray([0, 3]), np.asarray([0, 0]), 3)
    with pytest.raises(ValueError):
        native.sort_unique(np.asarray([2, -3]))
    with pytest.raises(ValueError):
        native.pair_fill(np.asarray([2]), np.asarray([0, 1]), 2, 4)


# ---- hostops entries ------------------------------------------------------

def _hostops_cases():
    rng = np.random.default_rng(7)
    n_lm, n_pose = 400, 37
    att_lm, att_pose = _attach(rng, n_pose, np.full(n_lm, 15))
    vals = rng.integers(0, 1 << 20, att_lm.size).astype(np.int32)
    hpp = np.unique(_keys(rng, 150, n_pose * n_pose))
    codes = _keys(rng, 20_000, 1 << 40)
    keys = _keys(rng, 20_000, 50)
    k32 = keys.astype(np.int32)
    p = [rng.integers(0, 1 << 20, keys.size).astype(np.int32)
         for _ in range(3)]
    sorted_order = np.lexsort((att_pose, att_lm))
    return {
        "sorted_unique": (codes,),
        "searchsorted": (np.unique(codes), codes[::3]),
        "unique_inverse": (codes,),
        "unique_inverse bounded": (keys, 50),
        "stable_argsort": (keys, 50),
        "schur_pair_plan": (att_lm, att_pose, n_lm, n_pose, vals, hpp),
        "schur_pair_plan sorted": (att_lm[sorted_order],
                                   att_pose[sorted_order], n_lm, n_pose,
                                   vals, hpp),
        "attach_pairs_vals": (att_lm, att_pose, n_lm, n_pose, vals),
        "sort_apply3": (k32, 50, *p),
        "attach_pairs": (att_lm, att_pose, n_lm, n_pose),
        "attach_pairs empty": (att_lm[:0], att_pose[:0], 5, n_pose),
    }


HOSTOPS_CASES = sorted(_hostops_cases())


def _as_tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", HOSTOPS_CASES)
def test_hostops_entry(case, request):
    args = _hostops_cases()[case]
    name = case.split()[0]
    out = _as_tuple(getattr(hostops, name)(*args))
    jax_out = _as_tuple(getattr(jax_hostops, name)(*args))
    plain = _as_tuple(hostops.PLAIN_VERSIONS[name](*args))
    _values_tuple([x for x in out if x is not None],
                  [x for x in plain if x is not None], "plain")
    if name == "attach_pairs" and not args[0].size:
        return  # the JAX package takes its NumPy path on an empty list
    _same_tuple(out, jax_out, "jax native path")
    request.getfixturevalue("jax_numpy_path")
    jax_plain = getattr(jax_hostops, name)(*args)
    if name == "schur_pair_plan":
        assert jax_plain is None  # the JAX NumPy path is stepwise
        return
    _same_tuple(plain, _as_tuple(jax_plain), "jax numpy path")


def test_schur_pair_plan_matches_stepwise(monkeypatch):
    """The fused plan against ``attach_pairs`` + the bounded unique + a
    stable sort by destination; above the lowered gate the plan is
    None."""
    rng = np.random.default_rng(8)
    n_lm, n_pose = 400, 37
    att_lm, att_pose = _attach(rng, n_pose, np.full(n_lm, 15))
    vals = rng.integers(0, 1 << 20, att_lm.size).astype(np.int32)
    hpp = np.unique(_keys(rng, 150, n_pose * n_pose))
    att_order, left, right, mid, dst, s_codes, hpp_pos = (
        hostops.schur_pair_plan(att_lm, att_pose, n_lm, n_pose, vals, hpp))

    (order2, _, _, ai, bi, pair_lm, pair_codes, _, _) = hostops.attach_pairs(
        att_lm, att_pose, n_lm, n_pose)
    _same(att_order, order2, "att_order")
    s_codes2, s_inv = hostops.unique_inverse(
        np.concatenate([hpp, pair_codes]), bound=n_pose * n_pose)
    _same(s_codes, s_codes2, "s_codes")
    _same(hpp_pos, s_inv[:hpp.size], "hpp_pos")
    pair_pos = s_inv[hpp.size:]
    order = hostops.stable_argsort(pair_pos, s_codes2.size)
    vals_s = vals[order2]
    np.testing.assert_array_equal(dst, pair_pos[order])
    _same(left, vals_s[ai][order], "left")
    _same(right, vals_s[bi][order], "right")
    np.testing.assert_array_equal(mid, pair_lm[order])

    monkeypatch.setattr(hostops, "MAX_PAIR_CODES", n_pose * n_pose - 1)
    assert hostops.schur_pair_plan(att_lm, att_pose, n_lm, n_pose, vals,
                                   hpp) is None
    assert hostops.schur_pair_plan_numpy(att_lm, att_pose, n_lm, n_pose,
                                         vals, hpp) is None


# ---- the builders -----------------------------------------------------------

def _bal_graphs(ds, shuffle_seed=None):
    """The BAL graph of ``ds`` in both packages; with ``shuffle_seed``, the
    observations are added in a shuffled order (``build_graph`` adds them
    sorted by point)."""
    if shuffle_seed is None:
        gj, *_ = jax_bal.build_graph(ds, precision=gt.FP64_FP64)
        gp, *_ = torch_bal.build_graph(ds, precision=gtt.FP64_FP64)
        return gj, gp
    order = np.random.default_rng(shuffle_seed).permutation(
        ds.num_observations)
    ids = np.stack([ds.cam_idx[order], ds.num_cameras + ds.point_idx[order]],
                   axis=1)
    graphs = []
    for pkg, model, prec in ((gt, jax_bal_model, gt.FP64_FP64),
                             (gtt, torch_bal_model, gtt.FP64_FP64)):
        g = pkg.Graph(precision=prec)
        cams = g.add_vertex_set(model.CAMERA)
        pts = g.add_vertex_set(model.POINT)
        cams.add_batch(np.arange(ds.num_cameras), ds.cameras)
        pts.add_batch(ds.num_cameras + np.arange(ds.num_points), ds.points)
        pts.set_eliminate(True)
        g.add_factor_set(model.REPROJECTION).add_batch(
            ids, obs=ds.observations[order])
        graphs.append(g)
    return tuple(graphs)


def _se3_graphs():
    gj, *_ = jax_g2o.build_graph(jax_synthetic.make_sphere_se3(150, seed=1),
                                 precision=gt.FP64_FP64)
    gp, *_ = torch_g2o.build_graph(jax_synthetic.make_sphere_se3(150, seed=1),
                                   precision=gtt.FP64_FP64)
    return gj, gp


PROBLEMS = {
    "mini": lambda: _bal_graphs(jax_synthetic.make_bal("mini", seed=3,
                                                       noise=0.5)),
    "ladybug shuffled": lambda: _bal_graphs(
        jax_synthetic.make_bal("ladybug", seed=0), shuffle_seed=11),
    "mixed_dims": _mixed_dims,
    "se3": _se3_graphs,
}


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


def _assert_tree(port, ref, path, dtype):
    """``port`` equals ``ref`` over the port's fields and keys: array
    values (and dtypes where ``dtype``), scalars, keys."""
    if isinstance(port, np.ndarray):
        if dtype:
            _same(port, ref, path)
        else:
            np.testing.assert_array_equal(port, np.asarray(ref),
                                          err_msg=path)
    elif isinstance(port, dict):
        if dtype:
            assert set(port) == set(ref), path
        for k in port:
            _assert_tree(port[k], ref[k], f"{path}.{k}", dtype)
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (x, y) in enumerate(zip(port, ref)):
            _assert_tree(x, y, f"{path}[{i}]", dtype)
    elif dataclasses.is_dataclass(port):
        for name in _fields(port):
            _assert_tree(getattr(port, name), getattr(ref, name),
                         f"{path}.{name}", dtype)
    else:
        assert port == ref, (path, port, ref)


def _port_structures(gp, schur):
    pp = gp.freeze(device="cpu")
    hs = torch_hessian.build_hessian_structure(pp)
    ss = torch_schur.build_schur_structure(pp) if schur else None
    return pp, hs, ss


@pytest.mark.parametrize("stepwise", [False, True], ids=["fused", "stepwise"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_structures_match_jax_and_plain(problem, stepwise, monkeypatch):
    if stepwise:
        monkeypatch.setattr(hostops, "MAX_PAIR_CODES", 0)
    gj, gp = PROBLEMS[problem]()
    schur = problem != "se3"
    pj = gj.freeze()
    _, hs, ss = _port_structures(gp, schur)
    _assert_tree(hs, jax_hessian.build_hessian_structure(pj), "hessian",
                 dtype=False)
    if schur:
        _assert_tree(ss, jax_schur.build_schur_structure(pj), "schur",
                     dtype=False)

    with monkeypatch.context() as m:
        for name, fn in hostops.PLAIN_VERSIONS.items():
            m.setattr(hostops, name, fn)
        _, hs_plain, ss_plain = _port_structures(gp, schur)
    _assert_tree(hs, hs_plain, "hessian vs plain", dtype=True)
    if schur:
        _assert_tree(ss, ss_plain, "schur vs plain", dtype=True)


def test_structures_independent_of_gate(monkeypatch):
    """The fused plan and the stepwise path give the same structure."""
    gj, gp = PROBLEMS["ladybug shuffled"]()
    _, _, fused = _port_structures(gp, True)
    monkeypatch.setattr(hostops, "MAX_PAIR_CODES", 0)
    _, _, stepwise = _port_structures(gp, True)
    _assert_tree(fused, stepwise, "schur", dtype=True)


def test_plans_match_plain(plain_hostops):
    """A reduction plan's permutation is the plain stable argsort's."""
    from graphite_tpu_torch.ops.cuda import segsum

    seg = np.random.default_rng(9).integers(0, 300, 50_000)
    plan = segsum.host_plan(seg, 300)
    for name, fn in hostops.PLAIN_VERSIONS.items():
        assert getattr(hostops, name) is fn, name
    native_perm = native.counting_sort_perm(seg, 300)
    _same(plan[1], native_perm, "perm")


def test_setup_laps():
    _, gp = PROBLEMS["mini"]()
    pp, _, _ = _port_structures(gp, True)
    laps = pp._cache["setup_laps"]
    names = {k: [label for label, _ in v] for k, v in laps.items()}
    assert names["freeze"] == ["pad", "active_factors", "vertex_active",
                               "assign_columns", "trash_pad",
                               "device_arrays"]
    assert names["hessian_structure"] == [
        "collect_codes", "unique_and_groups", "contrib_maps", "diag_lookup"]
    assert names["schur_structure"] == [
        "hessian_structure", "lm_groups", "hpl_groups", "attach_pairs",
        "s_sparsity", "hpp_copy", "products", "diag_and_block_maps"]
    assert all(s >= 0.0 for v in laps.values() for _, s in v)


# ---- freeze -------------------------------------------------------------------

def _pose_chain(pkg, models, ids):
    """A 2-pose-type chain of SE3 poses with the given global ids."""
    g = pkg.Graph(precision=pkg.FP64_FP64)
    vs = g.add_vertex_set(models.SE3)
    poses = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1.0]), (len(ids), 1))
    poses[:, 0] = np.arange(len(ids))
    vs.add_batch(np.asarray(ids), poses)
    vs.set_fixed(int(ids[0]), True)
    fs = g.add_factor_set(models.SE3_BETWEEN)
    a = np.asarray(ids[:-1])
    b = np.asarray(ids[1:])
    meas = np.tile(np.asarray([1.0, 0, 0, 0, 0, 0, 1.0]), (a.size, 1))
    fs.add_batch(np.stack([b, a], axis=1), obs=meas)
    return g


def _pose_models():
    from graphite_tpu.models import pose_graph as jax_pg
    from graphite_tpu_torch.models import pose_graph as torch_pg

    return jax_pg, torch_pg


HOST_ARRAYS = ("factor_ids", "factor_mask", "slot_mask", "vertex_active",
               "vertex_col_offset", "vertex_block_id", "vertex_active_row")


def test_freeze_non_contiguous_ids():
    """Rising ids with gaps (the sort path) give the arrays of contiguous
    ids (the fast path); ids added out of order give the JAX package's."""
    jax_pg, torch_pg = _pose_models()
    n = 40
    pc = _pose_chain(gtt, torch_pg, list(range(100, 100 + n))).freeze(
        device="cpu")
    ps = _pose_chain(gtt, torch_pg, list(np.arange(n) * 7 + 3)).freeze(
        device="cpu")
    for name in HOST_ARRAYS:
        _assert_tree(getattr(ps.host, name), getattr(pc.host, name), name,
                     dtype=True)
    _same(ps.block_offsets, pc.block_offsets, "block_offsets")

    shuffled = list(np.random.default_rng(10).permutation(n) * 7 + 3)
    pp = _pose_chain(gtt, torch_pg, shuffled).freeze(device="cpu")
    pj = _pose_chain(gt, jax_pg, shuffled).freeze()
    for name in HOST_ARRAYS:
        _assert_tree(getattr(pp.host, name), getattr(pj.host, name), name,
                     dtype=False)
    _same(pp.block_offsets, pj.block_offsets, "block_offsets")


@pytest.mark.parametrize("contiguous", [True, False])
def test_freeze_unknown_id_error(contiguous):
    jax_pg, torch_pg = _pose_models()
    ids = [5, 6, 7, 8] if contiguous else [5, 9, 7, 20]
    messages = []
    for pkg, models, kw in ((gt, jax_pg, {}), (gtt, torch_pg,
                                               {"device": "cpu"})):
        g = _pose_chain(pkg, models, ids)
        fs = g.factor_sets[models.SE3_BETWEEN.name]
        fs.add_batch(np.asarray([[ids[0], 1234]]),
                     obs=np.asarray([[1.0, 0, 0, 0, 0, 0, 1.0]]))
        with pytest.raises(KeyError) as err:
            g.freeze(**kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "unknown vertex id 1234" in messages[1]


def test_freeze_host_arrays_match_jax():
    gj, gp = PROBLEMS["ladybug shuffled"]()
    pj, pp = gj.freeze(), gp.freeze(device="cpu")
    for name in ("factor_ids", "factor_mask", "slot_mask", "vertex_active",
                 "vertex_col_offset", "vertex_block_id",
                 "vertex_active_row", "global_ids"):
        _assert_tree(getattr(pp.host, name), getattr(pj.host, name), name,
                     dtype=False)
    _same(pp.block_offsets, pj.block_offsets, "block_offsets")
    _same(pp.block_dims, pj.block_dims, "block_dims")


# ---- io/bal ---------------------------------------------------------------------

def _assert_datasets(a, b):
    for f in ("cameras", "points", "cam_idx", "point_idx", "observations"):
        _same(getattr(a, f), getattr(b, f), f)


def test_bal_load_fixture():
    path = "tests/fixtures/bal_head_real_format.txt"
    ds = torch_bal.load(path)
    _assert_datasets(ds, jax_bal.load(path))
    _assert_datasets(ds, torch_bal.load_numpy(path))
    from graphite_tpu_torch.native import bal_loader

    assert bal_loader.load(path) is not None  # the native parser took it


def test_bal_load_gz(tmp_path):
    ds = jax_synthetic.make_bal("mini", seed=5)
    txt = tmp_path / "mini.txt"
    torch_bal.save(str(txt), torch_bal.BALDataset(
        ds.cameras, ds.points, ds.cam_idx, ds.point_idx, ds.observations))
    gz = tmp_path / "mini.txt.gz"
    gz.write_bytes(gzip.compress(txt.read_bytes()))
    from graphite_tpu_torch.native import bal_loader

    assert bal_loader.load(str(gz)) is None  # the NumPy parser takes it
    for path in (txt, gz):
        port = torch_bal.load(str(path))
        _assert_datasets(port, jax_bal.load(str(path)))
        _same(port.observations, ds.observations, "round trip")


def test_setup_profile_sections_on_cpu():
    """``setup_profile.timed_setup`` (``chip_smoke.py``'s set-up timer)
    times each section of Ladybug-49's set-up and returns the problem
    with its structures and the first LM iteration's result."""
    from graphite_tpu_torch import setup_profile

    graph, schur = setup_profile.make_graph("ladybug")
    problem, result, secs = setup_profile.timed_setup(
        graph, "ladybug", schur, device="cpu")
    assert list(secs) == ["freeze", "hessian_structure", "schur_structure",
                          "first_pass_with_plans", "total"]
    assert secs["total"] == pytest.approx(sum(
        v for k, v in secs.items() if k != "total"))
    assert {"hessian_structure", "schur_structure",
            "segment_plans"} <= set(problem._cache)
    assert len(result.history) == 1  # one LM iteration
