"""Block-Jacobi preconditioner on the Schur system (counterpart of
``graphite_tpu/preconditioners/block_jacobi_schur.py``): the inverted
diagonal blocks of S per pose vertex type. Damping is already in S. Also
the identity on the Schur system (``IdentitySchurPreconditioner``). A
Schur preconditioner's ``apply`` takes the CG residual and its r.r and
returns M^-1 ``pcg_loop.normalize(y, rr)`` (``pcg_loop.SelfNormalizing``);
block-Jacobi-Schur's is kernel K12's ``bjs_apply`` (``ops/cuda/pcg_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..ops.batched_linalg import spd_inverse
from ..ops.cuda import pcg_step
from ..ops.pcg_loop import normalize


@dataclasses.dataclass
class BlockJacobiSchurState:
    inv_blocks: Dict[str, torch.Tensor]  # pose type -> (n_rows, d*d) flat


def _pose_type_rows(problem, ss):
    """Per pose type: (S key, S-diagonal block index per type row)."""
    cache = problem._cache
    if "bjs_rows" not in cache:
        out = {}
        pose_ids = np.arange(ss.n_pose_blocks)
        types = np.asarray(ss.block_type)[pose_ids]
        for t in np.unique(types):
            sel = pose_ids[types == t]
            sel = sel[np.argsort(ss.block_row[sel], kind="stable")]
            keys = ss.s_diag_key[sel]
            if np.any(keys < 0) or not np.all(keys == keys[0]):
                raise ValueError(f"pose type '{t}' lacks S diagonal blocks")
            out[str(t)] = (ss.s_keys[int(keys[0])], ss.s_diag_idx[sel])
        cache["bjs_rows"] = out
    return cache["bjs_rows"]


@dataclasses.dataclass(frozen=True)
class BlockJacobiSchurPreconditioner:
    def prepare(self, problem, ss, sv) -> BlockJacobiSchurState:
        inv_blocks = {}
        for t, (key, idxs) in _pose_type_rows(problem, ss).items():
            blocks = sv.s_vals[key].index_select(
                0, problem.index(("bjs_idx", t), idxs))
            inv_blocks[t] = spd_inverse(
                blocks.reshape(-1, key[0], key[1])).reshape(blocks.shape)
        return BlockJacobiSchurState(inv_blocks=inv_blocks)

    def apply(self, problem, ss, state: BlockJacobiSchurState,
              y: torch.Tensor, rr: torch.Tensor) -> torch.Tensor:
        """z = M^-1 ``pcg_loop.normalize(y, rr)`` on (dim_p,) vectors, rr =
        y.y: kernel K12's ``bjs_apply`` on the card, one launch for every
        pose type."""
        return pcg_step.bjs_apply(y, rr, state.inv_blocks,
                                  problem.pose_segments(ss.dim_p))


@dataclasses.dataclass(frozen=True)
class IdentitySchurPreconditioner:
    """No preconditioning of the Schur system: ``PCGSchurSolver`` then
    takes its dense ``tree_matvec`` branch or its block-sparse one (the
    fused dense PCG, K2, preconditions with block-Jacobi-Schur only)."""

    def prepare(self, problem, ss, sv):
        return ()

    def apply(self, problem, ss, state, y: torch.Tensor,
              rr: torch.Tensor) -> torch.Tensor:
        """``pcg_loop.normalize(y, rr)``, rr = y.y."""
        return normalize(y, rr)


def dense_preconditioner_matrix(problem, ss, state: BlockJacobiSchurState,
                                dtype) -> torch.Tensor:
    """Dense (dim_p, dim_p) block-diagonal matrix of the inverted S
    diagonal blocks (the M of the fused dense PCG)."""
    n = ss.dim_p
    cache = problem._cache
    if "bjs_dense_idx" not in cache:
        out = {}
        pose_ids = np.arange(ss.n_pose_blocks)
        types = np.asarray(ss.block_type)[pose_ids]
        for t in np.unique(types):
            sel = pose_ids[types == t]
            sel = sel[np.argsort(ss.block_row[sel], kind="stable")]
            off = ss.pose_offsets[sel]
            d = int(ss.pose_dims[sel[0]])
            idx = ((off[:, None, None] + np.arange(d)[None, :, None]) * n
                   + off[:, None, None] + np.arange(d)[None, None, :])
            out[str(t)] = idx.reshape(-1)
        cache["bjs_dense_idx"] = out
    m = torch.zeros(n * n, dtype=dtype, device=problem.device)
    for t, blocks in state.inv_blocks.items():
        idx = problem.index(("bjs_dense_idx", t), cache["bjs_dense_idx"][t])
        m.index_copy_(0, idx, blocks.reshape(-1).to(dtype))
    return m.reshape(n, n)
