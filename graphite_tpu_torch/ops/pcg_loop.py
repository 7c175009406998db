"""Preconditioned CG iteration (counterpart of
``graphite_tpu/ops/pcg_loop.py``): ``run_pcg``, a host loop, and
``run_pcg_fixed``, the same steps with no host read. The solvers call
``pcg``, which takes ``run_pcg_fixed`` inside the device-controlled LM
iteration (``ops/device_loop``) and ``run_pcg`` elsewhere.

Semantics: the residual is normalized before each preconditioner
application; a step with |rz_new| > rejection_ratio * rz_min (or a NaN
rz_new) is rejected, keeping the previous x, r, p, z and rz, and ends the
loop; rz_min starts at +inf and is a running minimum of |rz_new|; the loop
ends on |rz_new| < tol and never starts an iteration while rz == 0.

Every inner product is ``tree_dot``: float32 (the operands' dtype), as in
the JAX package, summed in one fixed order, so a CPU run and a CUDA run
take the same steps; that order is K2's (``ops/cuda/pcg_dense``), so every
PCG branch of the solver rounds its dots alike. ``tree_dot`` is kernel K9's
wrapper (``ops/cuda/dot``: one launch a dot on the card) and
``tree_dot_plain`` its plain version; ``run_pcg`` and ``run_pcg_fixed``
take another through ``dot=`` (K2's and K6's plain versions pass
``tree_dot_plain``, so they stay plain on the card).

A step's vector work is kernel K12 (``ops/cuda/pcg_step``): the x and r
update (``cg_advance``) and the rejection test, p's update and the kept
state written in place (``cg_commit``); with another ``dot`` the step
takes their plain versions on every device. A ``SelfNormalizing``
preconditioner (the Schur ones: block-Jacobi-Schur's apply is K12's
``bjs_apply``) takes the residual and its r.r and normalises it itself.
``run_pcg`` and ``run_pcg_fixed`` share the step and differ only in who
drives the loop: the host, reading the exit flag once a step, or the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..precision import sqrt_rn
from . import device_loop
from .cuda import pcg_step
from .cuda.dot import tree_dot


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of a vector (of each row of a matrix: over the last axis) in a
    fixed order, the same on every device: each group of 32 consecutive
    entries (zero-padded) by a halving tree, as a warp's shuffle-down
    reduction adds them, then the group sums the same way, until one is
    left (at least two levels). Up to 1,024 entries this is K2's
    ``block_sum`` order."""
    levels = 0
    while levels < 2 or v.shape[-1] > 1:
        n = v.shape[-1]
        w = v.new_zeros(v.shape[:-1] + (-(-n // 32) * 32,))
        w[..., :n] = v
        w = w.reshape(*v.shape[:-1], -1, 32)
        for o in (16, 8, 4, 2, 1):
            w = w[..., :o] + w[..., o:2 * o]
        v = w[..., 0]
        levels += 1
    return v[..., 0]


def tree_dot_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u . v: the elementwise products summed by ``tree_sum`` (K9's plain
    version)."""
    return tree_sum(u * v)


def tree_matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x with each row's products summed by ``tree_sum``: the same bits
    on every device (a BLAS matvec sums in an order of its own, which
    differs between cuBLAS and the CPU's BLAS)."""
    return tree_sum(A * x)


def _halve32(v: torch.Tensor) -> torch.Tensor:
    """One ``tree_sum`` level: the zero-padded groups of 32 by a halving
    tree."""
    w = v.new_zeros(-(-v.shape[0] // 32) * 32)
    w[: v.shape[0]] = v
    w = w.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        w = w[:, :o] + w[:, o:2 * o]
    return w[:, 0]


def tree_sum_chunked(v: torch.Tensor, ctas: int,
                     chunk: int = 1024) -> torch.Tensor:
    """``tree_sum`` as a cluster of ``ctas`` CTAs takes it: each CTA sums
    its consecutive share of whole ``chunk``-entry chunks (1,024 in K6:
    ``tree_sum``'s first two levels; 32 in K2: the first) on its own, then
    every CTA finishes the tree over all the chunk sums. It is bitwise
    ``tree_sum`` for every ``ctas``, which is what lets K2 and K6 split a
    dot over a cluster; nothing on the main path calls it."""
    levels = {32: 1, 1024: 2}[chunk]
    n_chunks = max(-(-v.shape[0] // chunk), 1)
    per = -(-n_chunks // ctas)
    sums = []
    for cta in range(ctas):
        for c in range(cta * per, min((cta + 1) * per, n_chunks)):
            w = v[c * chunk:(c + 1) * chunk]
            for _ in range(levels):
                w = _halve32(w)
            sums.append(w)
    v = torch.cat(sums)
    while levels < 2 or v.shape[0] > 1:
        v = _halve32(v)
        levels += 1
    return v[0]


def normalize(r: torch.Tensor, rr: torch.Tensor) -> torch.Tensor:
    """r over its norm, ``rr`` = r.r: the correctly rounded square root
    (``sqrt_rn``), or 1 where it is 0. The preconditioner's input."""
    rnorm = sqrt_rn(rr)
    return r / torch.where(rnorm == 0, torch.ones_like(rnorm), rnorm)


@dataclasses.dataclass(frozen=True)
class SelfNormalizing:
    """A preconditioner that takes the residual before ``normalize``:
    ``fn(r, rr)`` is M^-1 ``normalize(r, rr)`` (the Schur
    preconditioners' ``apply``). A step passes any other preconditioner
    ``normalize(r, rr)``."""

    fn: Callable


def _cg(b, matvec, precond, tol, rejection_ratio, dot):
    """The CG state, in tensors the steps write in place, and its step:
    (x, k, done, step). ``dot`` None: K9's dot and K12's advance and
    commit (``ops/cuda/pcg_step``), their plain versions on the CPU;
    another ``dot``: it and K12's plain versions, on every device."""
    if dot is None:
        dot, advance, commit = (tree_dot, pcg_step.cg_advance,
                                pcg_step.cg_commit)
    else:
        advance, commit = pcg_step.cg_advance_plain, pcg_step.cg_commit_plain

    def precondition(r):
        rr = dot(r, r)
        if isinstance(precond, SelfNormalizing):
            return precond.fn(r, rr)
        return precond(normalize(r, rr))

    x = torch.zeros_like(b)
    r = b.clone()
    z = precondition(r)
    p = z.clone()
    rz = dot(r, z)
    rz_min = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = rz == 0
    ticket = torch.zeros((), dtype=torch.int32, device=b.device)
    x_new, r_new = torch.empty_like(b), torch.empty_like(b)

    def step():
        v = matvec(p)
        advance(x, r, p, v, rz, dot(p, v), x_new, r_new)
        z_new = precondition(r_new)
        commit(x, r, p, z, x_new, r_new, z_new, rz, dot(r_new, z_new),
               rz_min, k, done, ticket, rejection_ratio, tol)

    return x, k, done, step


def run_pcg(b: torch.Tensor, matvec: Callable, precond: Callable,
            max_iter: int, tol: float, rejection_ratio: float,
            dot: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
    """Solve ``A x = b``; returns (x, number of CG steps taken). ``dot``:
    the inner product, ``tree_dot`` (K9) by default. ``run_pcg_fixed``'s
    steps, driven by the host: one read of the exit flag a step."""
    x, _, done, step = _cg(b, matvec, precond, tol, rejection_ratio, dot)
    k = 0
    while k < max_iter and not bool(done):
        step()
        k += 1
    return x, k


def run_pcg_fixed(b: torch.Tensor, matvec: Callable, precond: Callable,
                  max_iter: int, tol: float, rejection_ratio: float,
                  dot: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``run_pcg`` with no host read, as the JAX package's ``while_loop``:
    one CG step run while ``~done & (k < max_iter)``
    (``device_loop.while_loop``: on the card a "while" graph node, the
    step captured once), the flag set by ``run_pcg``'s own tests (rz == 0,
    a rejected or NaN step, |rz| < tol). A step does ``run_pcg``'s float
    operations in its order and writes x, r, p, z, rz, rz_min, k and done
    in place (``pcg_step.cg_commit``), a rejected step's values kept; so x
    and the step count (a 0-d int64 tensor) are bitwise ``run_pcg``'s
    (with the same ``dot``), and no step runs after the exit."""
    x, k, done, step = _cg(b, matvec, precond, tol, rejection_ratio, dot)
    device_loop.while_loop(lambda: ~done & (k < max_iter), step, "cg_step")
    return x, k


def pcg(b: torch.Tensor, matvec: Callable, precond: Callable,
        max_iter: int, tol: float, rejection_ratio: float
        ) -> Tuple[torch.Tensor, object]:
    """``run_pcg_fixed`` inside the device-controlled LM iteration,
    ``run_pcg`` elsewhere: (x, the CG steps taken)."""
    solve = run_pcg_fixed if device_loop.active() else run_pcg
    return solve(b, matvec, precond, max_iter, tol, rejection_ratio)
