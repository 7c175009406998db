"""Nested-dissection multifrontal block Cholesky (counterpart of
``graphite_tpu/ops/nd_multifrontal.py``).

The sparse factorization of the full H as level-batched dense linear
algebra:

- HOST (once per problem, NumPy; a copy of the JAX package's, giving the
  same integer plans): a nested-dissection tree over the block adjacency
  graph by recursive BFS-median bisection (BFS levels are vertex
  separators), dense frontal matrices per tree node, and the index maps
  of the assembly, the extend-add and the triangular solves.
- DEVICE: one pass per tree depth, deepest first. The fronts of a depth
  are batched into (n_l, W, W) tensors (padded to the level's widest
  front; dead columns carry an identity diagonal) and factored in
  float64 with batched ``torch.linalg.cholesky_ex``,
  ``solve_triangular`` and ``bmm``; their Schur updates are extend-added
  into the levels above.

The assembly writes each H entry to one front position: an indexed copy.
The extend-add and the right-hand-side updates have repeated destinations
(sibling fronts share ancestor blocks). They are not scattered with
atomics: each level's contributions are summed by destination with
``reduce_rows`` (kernel K1 on the card), in the order the plan lists
them, from a host plan built once (``nd_sum_sites``), and the sums are
then added at unique positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .cuda.segsum import SegmentPlan, plan_segments
from .streamreduce import reduce_rows

# ---------------------------------------------------------------------------
# Host: graph machinery
# ---------------------------------------------------------------------------


def _build_adjacency(n: int, rows: np.ndarray, cols: np.ndarray):
    """CSR adjacency (both directions, no self loops) over block ids."""
    m = rows != cols
    a = np.concatenate([rows[m], cols[m]])
    b = np.concatenate([cols[m], rows[m]])
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, a + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, b


def _bfs_levels(indptr, indices, nodes, start):
    """BFS level number per node of the induced subgraph (dict)."""
    inset = {v: None for v in nodes}
    level = {start: 0}
    frontier = [start]
    lv = 0
    while frontier:
        lv += 1
        nxt = []
        for u in frontier:
            for v in indices[indptr[u]:indptr[u + 1]]:
                if v in inset and v not in level:
                    level[v] = lv
                    nxt.append(v)
        frontier = nxt
    return level


@dataclasses.dataclass
class _TreeNode:
    own: np.ndarray      # block ids eliminated at this node
    children: List[int]
    depth: int = 0
    bd: Optional[np.ndarray] = None  # ancestor block ids in the front


def build_nd_tree(n_blocks: int, rows: np.ndarray, cols: np.ndarray,
                  leaf: int = 24) -> List[_TreeNode]:
    """Nested-dissection tree over the block graph. Returns nodes with
    `own` / `children` / `depth` filled; node 0 is the root."""
    indptr, indices = _build_adjacency(n_blocks, rows, cols)
    nodes: List[_TreeNode] = []

    def dissect(sub: np.ndarray) -> int:
        me = len(nodes)
        if sub.shape[0] <= leaf:
            nodes.append(_TreeNode(own=sub, children=[]))
            return me
        # connected components first (empty separator between them)
        inset = {v: None for v in sub}
        seen = set()
        comps = []
        for s in sub:
            if s in seen:
                continue
            lvl = _bfs_levels(indptr, indices, sub, s)
            comp = [v for v in lvl if v not in seen]
            seen.update(comp)
            comps.append((np.array(sorted(comp)), lvl))
        if len(comps) > 1:
            # disconnected: recurse on large components; pack small ones
            # (no mutual fill) into shared leaf nodes by block locality
            nodes.append(_TreeNode(own=np.empty(0, dtype=sub.dtype),
                                   children=[]))
            kids = []
            small = sorted((c for c, _ in comps if c.shape[0] <= leaf),
                           key=lambda c: int(c[0]))
            batch: list = []
            cnt = 0
            for c in small:
                if cnt + c.shape[0] > leaf and batch:
                    kids.append(len(nodes))
                    nodes.append(_TreeNode(
                        own=np.concatenate(batch), children=[]))
                    batch, cnt = [], 0
                batch.append(c)
                cnt += c.shape[0]
            if batch:
                kids.append(len(nodes))
                nodes.append(_TreeNode(own=np.concatenate(batch),
                                       children=[]))
            for c, _ in comps:
                if c.shape[0] > leaf:
                    kids.append(dissect(c))
            nodes[me].children = kids
            return me
        # pseudo-peripheral start: BFS twice
        _, lvl0 = comps[0][0], comps[0][1]
        far = max(lvl0, key=lvl0.get)
        lvl = _bfs_levels(indptr, indices, sub, far)
        maxlv = max(lvl.values())
        if maxlv < 4:
            # hub graph (e.g. BAL cameras: BFS diameter ~4, median
            # levels hold half the nodes): separate by removing the
            # top-degree hubs instead — the remainder's components
            # become the children (for bipartite BA this rediscovers
            # the Schur elimination structure: cameras = separator)
            inset = {v: None for v in sub}
            deg = {v: sum(1 for u in indices[indptr[v]:indptr[v + 1]]
                          if u in inset) for v in sub}
            order_d = sorted(sub, key=lambda v: -deg[v])
            n_hub = max(1, min(len(sub) // 4,
                               int(np.sqrt(len(sub))) * 2))
            hubs = set(order_d[:n_hub])
            rest = np.array(sorted(v for v in sub if v not in hubs))
            sep = np.array(sorted(hubs))
            if rest.shape[0] == 0:
                nodes.append(_TreeNode(own=sub, children=[]))
                return me
            nodes.append(_TreeNode(own=sep, children=[]))
            nodes[me].children = [dissect(rest)]
            return me
        # median BFS level = separator (true separator: BFS edges only
        # join adjacent levels)
        counts = np.zeros(maxlv + 1, dtype=np.int64)
        for v, l in lvl.items():
            counts[l] += 1
        half = counts.sum() // 2
        cut = int(np.searchsorted(np.cumsum(counts), half))
        cut = min(max(cut, 1), maxlv - 1)
        sep = np.array(sorted(v for v, l in lvl.items() if l == cut))
        a = np.array(sorted(v for v, l in lvl.items() if l < cut))
        b = np.array(sorted(v for v, l in lvl.items() if l > cut))
        nodes.append(_TreeNode(own=sep, children=[]))
        kids = []
        if a.shape[0]:
            kids.append(dissect(a))
        if b.shape[0]:
            kids.append(dissect(b))
        nodes[me].children = kids
        return me

    dissect(np.arange(n_blocks, dtype=np.int64))

    # depths (root = 0)
    def set_depth(i, d):
        nodes[i].depth = d
        for c in nodes[i].children:
            set_depth(c, d + 1)

    set_depth(0, 0)

    # boundaries bottom-up: bd(n) = (N(own) ∪ bd(children)) \ subtree-own,
    # which by the separator property is a subset of n's ancestors' own
    owner = np.full(n_blocks, -1, dtype=np.int64)
    for i, nd in enumerate(nodes):
        owner[nd.own] = i
    depth_of = np.array([nd.depth for nd in nodes])

    order = sorted(range(len(nodes)), key=lambda i: -nodes[i].depth)
    for i in order:
        nd = nodes[i]
        cand = set()
        for v in nd.own:
            cand.update(indices[indptr[v]:indptr[v + 1]].tolist())
        for c in nd.children:
            cand.update(nodes[c].bd.tolist())
        nd.bd = np.array(sorted(
            v for v in cand if depth_of[owner[v]] < nd.depth
        ), dtype=np.int64)
    return nodes


# ---------------------------------------------------------------------------
# Host: symbolic factorization plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NDPlan:
    """Everything the numeric phase needs (static host arrays);
    ``sites`` holds their device tensors and sum plans (``nd_sites``)."""

    levels: List[dict]       # per depth (deepest first)
    dim_h: int
    n_nodes: int
    sites: Optional[list] = dataclasses.field(default=None, repr=False,
                                              compare=False)


def build_nd_plan(problem, hs, leaf: int = 24) -> NDPlan:
    """Symbolic multifrontal plan from the Hessian block structure."""
    offsets = np.asarray(problem.block_offsets)
    n_cols = int(max(hs.block_rows.max(initial=-1),
                     hs.block_cols.max(initial=-1))) + 1
    full_off = np.concatenate([offsets[:n_cols],
                               [int(offsets[n_cols])
                                if n_cols < offsets.shape[0]
                                else problem.dim_h]])
    dims = np.diff(full_off)

    nodes = build_nd_tree(n_cols, hs.block_rows, hs.block_cols, leaf=leaf)
    owner = np.full(n_cols, -1, dtype=np.int64)
    for i, nd in enumerate(nodes):
        owner[nd.own] = i
    depth_of = np.array([nd.depth for nd in nodes])
    max_depth = int(depth_of.max())

    # per node: front column layout (scalar): own scalars then bd scalars
    col_pos: List[Dict[int, int]] = [None] * len(nodes)
    s_dim = np.zeros(len(nodes), dtype=np.int64)
    b_dim = np.zeros(len(nodes), dtype=np.int64)
    for i, nd in enumerate(nodes):
        pos = {}
        p = 0
        for blk in nd.own:
            pos[blk] = p
            p += int(dims[blk])
        s_dim[i] = p
        for blk in nd.bd:
            pos[blk] = p
            p += int(dims[blk])
        b_dim[i] = p - s_dim[i]
        col_pos[i] = pos

    # nodes per level (deepest level first), index within level
    by_level: List[List[int]] = [[] for _ in range(max_depth + 1)]
    idx_in_level = np.zeros(len(nodes), dtype=np.int64)
    for i, nd in enumerate(nodes):
        idx_in_level[i] = len(by_level[nd.depth])
        by_level[nd.depth].append(i)

    # original block -> assembling node = deeper of the two owners
    o_r = owner[hs.block_rows]
    o_c = owner[hs.block_cols]
    deeper = np.where(depth_of[o_r] >= depth_of[o_c], o_r, o_c)

    levels = []
    for d in range(max_depth, -1, -1):
        nl = by_level[d]
        s_max = int(max((s_dim[i] for i in nl), default=0))
        b_max = int(max((b_dim[i] for i in nl), default=0))
        s_max = max(s_max, 1)
        W = s_max + b_max
        n_l = len(nl)

        # ---- assembly maps per H group ----
        asm = []
        for gi, key in enumerate(hs.group_keys):
            dr, dc = key
            sel = np.nonzero((hs.group_of_block == gi)
                             & np.isin(deeper, nl))[0]
            if sel.shape[0] == 0:
                continue
            g_idx = hs.index_in_group[sel]
            node = deeper[sel]
            li = idx_in_level[node]

            def fpos(n, blk):
                # bd columns live at s_max + bd-local offset (the own
                # region is padded to the level's s_max)
                p = col_pos[n][blk]
                return p if p < s_dim[n] else p - int(s_dim[n]) + s_max

            fr = np.array([fpos(n, r) for n, r in
                           zip(node, hs.block_rows[sel])])
            fc = np.array([fpos(n, c) for n, c in
                           zip(node, hs.block_cols[sel])])
            rr = np.arange(dr)[None, :, None]
            cc = np.arange(dc)[None, None, :]
            dst = ((li[:, None, None] * W + fr[:, None, None] + rr) * W
                   + fc[:, None, None] + cc)
            offd = hs.block_rows[sel] != hs.block_cols[sel]
            o = np.nonzero(offd)[0]
            dst_t = ((li[o][:, None, None] * W + fc[o][:, None, None]
                      + cc) * W + fr[o][:, None, None] + rr)
            asm.append(dict(
                group=key,
                g_idx=g_idx.astype(np.int64),
                dst=dst.reshape(sel.shape[0], dr * dc).astype(np.int64),
                o_sel=o.astype(np.int64),
                dst_t=dst_t.reshape(o.shape[0], dr * dc).astype(np.int64),
            ))

        # ---- dead-diagonal identity (padding columns) ----
        eye = np.zeros((n_l, W), dtype=np.float32)
        for k, i in enumerate(nl):
            live = int(s_dim[i] + b_dim[i])
            eye[k, int(s_dim[i]):s_max] = 1.0  # dead own cols
            eye[k, s_max + int(b_dim[i]):] = 1.0  # dead bd cols
        # dead own cols occupy [s_dim, s_max); live bd shifts to s_max
        # => bd scalars of node i sit at s_max + (pos - s_dim[i])

        # ---- extend-add: children (at deeper levels) -> this level ----
        # child's U rows/cols = its bd blocks; they map into this front.
        # Flat src/dst index arrays are finalized after all levels exist
        # (the src flattening needs the SOURCE level's b_max).
        ea_by_src: Dict[int, list] = {}
        for k, i in enumerate(nl):
            for c in nodes[i].children:
                cb = nodes[c].bd
                if cb.shape[0] == 0:
                    continue
                # child bd scalar positions within its U (bd-local)
                cpos = []
                for blk in cb:
                    base = col_pos[c][blk] - int(s_dim[c])
                    cpos.extend(range(base, base + int(dims[blk])))
                cpos = np.array(cpos, dtype=np.int64)
                # positions in THIS front (own at pos, bd shifted to s_max)
                fpos = []
                for blk in cb:
                    p = col_pos[i][blk]
                    if p >= s_dim[i]:
                        p = p - int(s_dim[i]) + s_max
                    fpos.extend(range(p, p + int(dims[blk])))
                fpos = np.array(fpos, dtype=np.int64)
                ea_by_src.setdefault(nodes[c].depth, []).append(
                    (idx_in_level[c], cpos, fpos, k))
        ea = [dict(src_depth=cd, items=items)
              for cd, items in sorted(ea_by_src.items())]

        # ---- solve maps: global scalar ids of own and bd columns ----
        own_g = np.full((n_l, s_max), problem.dim_h, dtype=np.int64)
        bd_g = np.full((n_l, b_max), problem.dim_h, dtype=np.int64)
        for k, i in enumerate(nl):
            p = 0
            for blk in nodes[i].own:
                dmm = int(dims[blk])
                own_g[k, p:p + dmm] = np.arange(
                    full_off[blk], full_off[blk] + dmm)
                p += dmm
            p = 0
            for blk in nodes[i].bd:
                dmm = int(dims[blk])
                bd_g[k, p:p + dmm] = np.arange(
                    full_off[blk], full_off[blk] + dmm)
                p += dmm

        levels.append(dict(
            depth=d, node_ids=nl, n_l=n_l, s_max=s_max, b_max=b_max, W=W,
            asm=asm, eye=eye, ea=ea, own_g=own_g, bd_g=bd_g,
        ))

    # finalize extend-add source indices now that per-level b_max known
    lvl_of_depth = {lv["depth"]: lv for lv in levels}
    for lv in levels:
        for ea in lv["ea"]:
            src_lv = lvl_of_depth[ea["src_depth"]]
            bms = src_lv["b_max"]
            W = lv["W"]
            srcs, dsts = [], []
            for ci, cpos, fpos, k in ea["items"]:
                src = ((ci * bms + cpos[:, None]) * bms
                       + cpos[None, :]).reshape(-1)
                dst = ((k * W + fpos[:, None]) * W
                       + fpos[None, :]).reshape(-1)
                srcs.append(src)
                dsts.append(dst)
            ea["src"] = np.concatenate(srcs)
            ea["dst"] = np.concatenate(dsts)
            del ea["items"]

    return NDPlan(levels=levels, dim_h=problem.dim_h, n_nodes=len(nodes))




# ---------------------------------------------------------------------------
# Device: numeric factorization + solve
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SumSite:
    """Contributions with repeated destinations, summed by destination:
    ``values[pos]`` (listed in the plan's order) reduce by ``plan`` into
    the unique positions ``dst``."""

    pos: Optional[torch.Tensor]  # None: every value, in order
    dst: torch.Tensor
    plan: SegmentPlan


@dataclasses.dataclass
class LevelSites:
    """Device tensors of one level of an ``NDPlan``."""

    asm: list  # (group, g_idx, dst, o_sel or None, dst_t)
    eye: torch.Tensor  # (n_l, W)
    ea_src: list  # (source depth, flat positions in that level's U)
    ea: Optional[SumSite]  # into this level's flat F
    own: torch.Tensor  # (n_l * s_max,) rhs rows (padding: the trash row)
    own_pos: torch.Tensor  # positions of the real own rows ...
    own_dst: torch.Tensor  # ... and their rows of the solution
    bd: Optional[torch.Tensor]  # (n_l * b_max,) rows, as own
    rhs: Optional[SumSite]  # right-hand-side update of the forward solve


def _index(problem, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64),
                           device=problem.device)


def _sum_site(problem, dst: np.ndarray, pos: Optional[np.ndarray]) -> SumSite:
    uniq, inv = np.unique(dst, return_inverse=True)
    return SumSite(pos=None if pos is None else _index(problem, pos),
                   dst=_index(problem, uniq),
                   plan=plan_segments(inv, uniq.shape[0], problem.device,
                                      width=1))


def nd_sites(problem, plan: NDPlan) -> List[LevelSites]:
    """The device tensors and sum plans of ``plan`` (built once)."""
    if plan.sites is not None:
        return plan.sites
    dim = plan.dim_h

    def idx(a):
        return _index(problem, a)

    sites = []
    for lv in plan.levels:
        asm = [(a["group"], idx(a["g_idx"]), idx(a["dst"].reshape(-1)),
                idx(a["o_sel"]) if a["o_sel"].size else None,
                idx(a["dst_t"].reshape(-1))) for a in lv["asm"]]
        ea_src = [(ea["src_depth"], idx(ea["src"])) for ea in lv["ea"]]
        ea = None
        if lv["ea"]:
            ea = _sum_site(problem,
                           np.concatenate([e["dst"] for e in lv["ea"]]), None)
        own = lv["own_g"].reshape(-1)
        own_pos = np.nonzero(own < dim)[0]
        bd = rhs = None
        if lv["b_max"]:
            bd_g = lv["bd_g"].reshape(-1)
            bd_pos = np.nonzero(bd_g < dim)[0]
            bd = idx(bd_g)
            rhs = _sum_site(problem, bd_g[bd_pos], bd_pos)
        sites.append(LevelSites(
            asm=asm, eye=torch.as_tensor(lv["eye"], device=problem.device),
            ea_src=ea_src, ea=ea, own=idx(own), own_pos=idx(own_pos),
            own_dst=idx(own[own_pos]), bd=bd, rhs=rhs))
    plan.sites = sites
    return sites


def add_sums(target: torch.Tensor, values: torch.Tensor,
             site: SumSite) -> torch.Tensor:
    """``target`` (flat) with the values summed into their destinations:
    one ``reduce_rows`` per site, then an indexed copy at the unique
    positions."""
    if site.pos is not None:
        values = values.index_select(0, site.pos)
    sums = reduce_rows(values.reshape(-1, 1), site.plan).reshape(-1)
    return target.index_copy(0, site.dst,
                             target.index_select(0, site.dst) + sums)


def nd_factor(problem, plan: NDPlan, hvals: Dict,
              dtype=torch.float32) -> list:
    """Batched level-by-level numeric factorization. Per level: (L11,
    L21T, info) in float64, where ``info`` (n_l,) is ``cholesky_ex``'s:
    nonzero for a front that failed to factor.

    The fronts are assembled and their Schur updates summed in ``dtype``
    (the sums run through ``reduce_rows``, K1 on the card, which takes
    float32), and factored in float64: the card's and the CPU's float64
    factors of the same assembled front differ only by float64 rounding,
    so the rounded updates handed up the tree almost always agree bit for
    bit, where float32 factors would part the two devices' LM steps (see
    ``solvers.dense_cholesky.cholesky_solve``)."""
    factors = []
    U_of_depth: Dict[int, torch.Tensor] = {}
    for lv, st in zip(plan.levels, nd_sites(problem, plan)):
        n_l, W, s = lv["n_l"], lv["W"], lv["s_max"]
        F = torch.zeros(n_l * W * W, dtype=dtype, device=problem.device)
        for group, g_idx, dst, o_sel, dst_t in st.asm:
            vals = hvals[group].index_select(0, g_idx).to(dtype)
            F.index_copy_(0, dst, vals.reshape(-1))
            if o_sel is not None:
                F.index_copy_(0, dst_t, vals.index_select(0, o_sel).reshape(-1))
        if st.ea is not None:
            contrib = torch.cat([U_of_depth[d].reshape(-1).index_select(0, src)
                                 for d, src in st.ea_src])
            F = add_sums(F, contrib, st.ea)
        F = F.view(n_l, W, W)
        F.diagonal(dim1=1, dim2=2).add_(st.eye.to(dtype))
        F = F.to(torch.float64)

        L11, info = torch.linalg.cholesky_ex(F[:, :s, :s], check_errors=False)
        if W > s:
            # (n, s, b) = L11^{-1} A12
            L21T = torch.linalg.solve_triangular(L11, F[:, :s, s:],
                                                 upper=False)
            U = F[:, s:, s:] - torch.bmm(L21T.transpose(1, 2), L21T)
        else:
            L21T = F.new_zeros((n_l, s, 0))
            U = F.new_zeros((n_l, 0, 0))
        U_of_depth[lv["depth"]] = U.to(dtype)
        factors.append((L11, L21T, info))
    return factors


def nd_ok(factors) -> torch.Tensor:
    """True when every front of every level factored."""
    return torch.stack([(info == 0).all() for _, _, info in factors]).all()


def nd_solve(problem, plan: NDPlan, factors, b: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
    """Forward and backward triangular solves over the level schedule,
    in float64; the right-hand side's updates are summed in ``dtype``
    (as the factor's Schur updates are). Returns float64."""
    dim = plan.dim_h
    sites = nd_sites(problem, plan)
    # one trailing trash row: the padding of own / bd reads it as 0
    rhs = torch.cat([b.to(dtype), b.new_zeros(1, dtype=dtype)])
    ys = []
    for lv, st, (L11, L21T, _) in zip(plan.levels, sites, factors):
        b_own = rhs.index_select(0, st.own).view(lv["n_l"], lv["s_max"], 1)
        y = torch.linalg.solve_triangular(L11, b_own.to(torch.float64),
                                          upper=False)
        ys.append(y)
        if st.rhs is not None:
            upd = -torch.bmm(L21T.transpose(1, 2), y)
            rhs = add_sums(rhs, upd.reshape(-1).to(dtype), st.rhs)
    x = torch.zeros(dim + 1, dtype=torch.float64, device=b.device)
    for li in range(len(plan.levels) - 1, -1, -1):
        lv, st, (L11, L21T, _) = plan.levels[li], sites[li], factors[li]
        y = ys[li]
        if st.bd is not None:
            xb = x.index_select(0, st.bd).view(lv["n_l"], lv["b_max"], 1)
            y = y - torch.bmm(L21T, xb)
        xo = torch.linalg.solve_triangular(L11.transpose(1, 2), y,
                                           upper=True)
        x.index_copy_(0, st.own_dst,
                      xo.reshape(-1).index_select(0, st.own_pos))
    return x[:dim]
