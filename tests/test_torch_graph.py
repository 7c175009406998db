"""Host data of the PyTorch port vs the JAX package: synthetic datasets and
parsed BAL files are identical, and ``Graph.freeze`` gives exactly the
same host structure (column offsets, row segments, factor rows, masks)."""

import bz2
import gzip

import numpy as np
import pytest
import torch

import graphite_tpu as gt
import graphite_tpu_torch as gtt
from graphite_tpu.io import synthetic as jax_synth
from graphite_tpu.io import bal as jax_bal_io
from graphite_tpu.io.bal import build_graph as jax_build_graph
from graphite_tpu_torch.io import bal as torch_bal_io
from graphite_tpu_torch.io import synthetic as torch_synth

torch.set_num_threads(1)


@pytest.mark.parametrize("size,seed", [("toy", 0), ("mini", 3),
                                       ((12, 120, 700), 0),
                                       ((7, 40, 300), 5)])
def test_make_bal_identical(size, seed):
    a = jax_synth.make_bal(size, seed=seed, noise=0.5)
    b = torch_synth.make_bal(size, seed=seed, noise=0.5)
    for field in ("cameras", "points", "cam_idx", "point_idx",
                  "observations"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert torch_synth.BAL_SIZES == jax_synth.BAL_SIZES


@pytest.mark.parametrize("suffix", ["", ".gz", ".bz2"])
def test_bal_load_identical(tmp_path, suffix):
    ds = jax_synth.make_bal((5, 30, 90), seed=2, noise=0.5)
    plain = tmp_path / "problem.txt"
    jax_bal_io.save(str(plain), ds)
    path = tmp_path / f"problem.txt{suffix}"
    opener = {"": None, ".gz": gzip.open, ".bz2": bz2.open}[suffix]
    if opener is not None:
        with opener(path, "wb") as f:
            f.write(plain.read_bytes())
    a = jax_bal_io.load(str(path))
    b = torch_bal_io.load(str(path))
    for field in ("cameras", "points", "cam_idx", "point_idx",
                  "observations"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        np.testing.assert_array_equal(getattr(b, field), getattr(ds, field))


def _frozen(fixed_cameras=(), fixed_points=()):
    ds = jax_synth.make_bal((12, 120, 700), seed=0, noise=0.5)
    gj, camsj, ptsj, fsj = jax_build_graph(ds, precision=gt.FP64_FP64)
    gp, camsp, ptsp, fsp = torch_bal_io.build_graph(
        ds, precision=gtt.FP64_FP64)
    for c in fixed_cameras:
        camsj.set_fixed(c)
        camsp.set_fixed(c)
    for p in fixed_points:
        ptsj.set_fixed(ds.num_cameras + p)
        ptsp.set_fixed(ds.num_cameras + p)
    np.testing.assert_array_equal(fsj.input_order, fsp.input_order)
    return gj.freeze(), gp.freeze()


@pytest.mark.parametrize("fixed", [((), ()), ((0, 5), (3, 77))])
def test_freeze_host_structure_identical(fixed):
    pj, pp = _frozen(*fixed)
    assert pp.dim_h == pj.dim_h and pp.pad == pj.pad
    assert pp.elimination_block == pj.elimination_block
    assert pp.elimination_col == pj.elimination_col
    np.testing.assert_array_equal(pp.block_offsets, pj.block_offsets)
    np.testing.assert_array_equal(pp.block_dims, pj.block_dims)
    np.testing.assert_array_equal(pp.block_vertex.type_codes,
                                  pj.block_vertex.type_codes)
    np.testing.assert_array_equal(pp.block_vertex.local_ids,
                                  pj.block_vertex.local_ids)
    assert pp.seg_start == pj.seg_start
    assert pp.seg_rows == pj.seg_rows
    assert pp.segment_order == pj.segment_order
    for name in pj.row_vertex:
        np.testing.assert_array_equal(pp.row_vertex[name],
                                      pj.row_vertex[name])
    for field in ("vertex_col_offset", "vertex_block_id", "vertex_active",
                  "vertex_active_row", "vertex_fixed", "factor_ids",
                  "factor_mask", "slot_mask", "global_ids"):
        a, b = getattr(pj.host, field), getattr(pp.host, field)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    for name, faj in pj.data.factors.items():
        fap = pp.data.factors[name]
        for s in range(len(faj.rows)):
            np.testing.assert_array_equal(fap.rows[s].numpy(),
                                          np.asarray(faj.rows[s]))
            np.testing.assert_array_equal(fap.ids[s].numpy(),
                                          np.asarray(faj.ids[s]))
        np.testing.assert_array_equal(fap.slot_mask.numpy(),
                                      np.asarray(faj.slot_mask))
        np.testing.assert_array_equal(fap.obs.numpy(), np.asarray(faj.obs))
    for name in pj.params0:
        np.testing.assert_array_equal(pp.params0[name].numpy(),
                                      np.asarray(pj.params0[name]))


def test_rows_view_round_trip():
    _, pp = _frozen()
    x = torch.arange(pp.dim_x, dtype=torch.float64)
    rows = {name: pp.rows_view(x, name) for name in pp.segment_order}
    back = pp.flat_from_rows(rows)
    assert torch.equal(back[: pp.dim_h], x[: pp.dim_h])
    assert torch.all(back[pp.dim_h:] == 0)
    padded = pp.rows_view_padded(x, "bal_point")
    assert padded.shape == (pp.seg_rows["bal_point"] + 1, 3)
    assert torch.all(padded[-1] == 0)
