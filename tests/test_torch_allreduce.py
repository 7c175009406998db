"""K8's host bookkeeping (``graphite_tpu_torch/ops/cuda/allreduce.py``),
which needs no card: the arena's sizing, the halves' parity and the epoch
the eager calls advance, the refusal to grow while a stream captures, and
the handle exchange over gloo (4 CPU ranks). Also the plain version, K8's
oracle: the rank-order sum and the gather, with -0.0 summed to +0.0 as
the zeroed buffer's ``all_reduce`` adds it (K8 adds each row to +0 for
the same bits). The kernel itself runs on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import torch_sharding_helpers as helpers
from graphite_tpu_torch.ops.cuda import allreduce as k8
from graphite_tpu_torch.parallel import run_ranks


def test_arena_sizing():
    book = k8.ArenaBook(rank=0, world=2)
    # the first call makes the arena, even for an empty tensor
    assert book.grow_to(0, False, "chi2") == k8.ALIGN
    book.reset(k8.ALIGN)
    assert book.grow_to(8, False, "chi2") is None
    assert book.grow_to(k8.ALIGN, False, "b") is None
    # Venice's Hpl values: 5,001,946 x 27 float32, rounded up to ALIGN
    hpl = 5_001_946 * 27 * 4
    grown = book.grow_to(hpl, False, "hessian Hpl")
    assert grown % k8.ALIGN == 0 and hpl <= grown < hpl + k8.ALIGN
    assert k8.arena_bytes(grown) == k8.HEADER_BYTES + 2 * grown
    with pytest.raises(ValueError, match="1 to 8 ranks"):
        k8.ArenaBook(rank=0, world=k8.MAX_WORLD + 1)


def test_parity_and_epoch_accounting():
    half = 3 * k8.ALIGN
    # call e (the arena's first is 1) writes half e & 1
    assert [k8.half_offset(e, half) for e in range(1, 5)] == [
        k8.HEADER_BYTES + half, k8.HEADER_BYTES,
        k8.HEADER_BYTES + half, k8.HEADER_BYTES]
    book = k8.ArenaBook(rank=1, world=4)
    book.reset(half)
    epochs = []
    for _ in range(5):
        book.eager_calls += 1
        epochs.append(book.expected_epoch())
    assert epochs == [1, 2, 3, 4, 5]
    # a captured call runs on replays the host does not count
    book.captured = True
    assert book.expected_epoch() is None
    # a new arena starts at epoch 0 again
    book.reset(2 * half)
    assert (book.eager_calls, book.expected_epoch(), book.captured) == (
        0, 0, False)
    assert [book.tag_id(t) for t in ("b", "chi2", "b")] == [0, 1, 0]


def test_oversize_request_raises_while_capturing():
    book = k8.ArenaBook(rank=0, world=2)
    book.reset(k8.ALIGN)
    # a call that fits is captured as it is
    assert book.grow_to(k8.ALIGN, True, "linearize.b") is None
    with pytest.raises(RuntimeError, match="capturing"):
        book.grow_to(k8.ALIGN + 1, True, "hessian Hpl")
    assert book.half_bytes == k8.ALIGN


def test_handle_exchange_over_gloo():
    out = run_ranks(helpers.exchange_task, 4, "gloo", 2, device="cpu")
    expected = [bytes([r]) * k8.HANDLE_BYTES for r in range(4)]
    for r, o in enumerate(out):
        assert o["handles"] == expected, f"rank {r}"
        # every rank sees rank 2 grow at another call, and raises
        assert "disagree" in o["error"] and "'JtPv'" in o["error"]
    with pytest.raises(RuntimeError, match="handle has 3 bytes"):
        k8.check_payloads([dict(rank=0, half_bytes=1, tag="b",
                                handle=b"abc")], 0)


def test_plain_version_rank_order_and_signed_zero():
    values = np.array([[1e16, -0.0, 2.5, -0.0],
                       [1.0, -0.0, -2.5, 3.0],
                       [-1e16, -0.0, 1.0, -0.0]])
    out = run_ranks(helpers.plain_sums, 3, "gloo", values, device="cpu")
    # rank order: (1e16 + 1) - 1e16 = 0 in float64, not 1
    expected = ((values[0] + 0.0) + (values[1] + 0.0)) + (values[2] + 0.0)
    for o in out:
        assert np.array_equal(o["sum"], expected)
        assert o["sum"][0] == 0.0
        # every -0.0 comes back +0.0, as K8 gives it
        assert not np.signbit(o["sum"]).any()
        assert not np.signbit(o["gather"][:, 1]).any()
        assert np.array_equal(o["gather"], values + 0.0)


def test_transport_refuses_cpu_tensors_and_other_dtypes():
    """K8 takes CUDA tensors of float32, float64 or int64 only (a CPU
    mesh sends its tensors to the plain version instead)."""
    t = k8.Transport(0, 2, "cpu")
    with pytest.raises(ValueError, match="x on cpu"):
        t.allreduce(torch.ones(3))
    with pytest.raises(NotImplementedError, match="int64"):
        t.gather(torch.ones(3, dtype=torch.float16))
