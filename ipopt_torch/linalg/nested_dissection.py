"""Nested-dissection multifrontal LDL^T for general sparse KKT systems, over
a batch (port of ``ipopt_tpu/linalg/nested_dissection.py``).

Selected by ``linear_solver="multifrontal"`` for patterns whose RCM
bandwidth is too wide for the banded BCR backend, 3-D PDE grids above all.

1. Symbolic, once, on the host (numpy and scipy, a copy of the reference's):
   recursive BFS level-set bisection of the augmented-system graph builds a
   separator tree; every node owns a front, its separator (eliminated there)
   and its boundary (the ancestors' separator vertices its subtree touches).
   The fronts are grouped by tree depth and padded to one size per depth
   (``NDLevel``), deepest level first; the gather-form assembly indices and
   the child -> parent extend-add indices are precomputed.
2. Numeric, per factorization: one batched partial LDL^T per level.  The
   eliminated block ``F[:, :p, :p]`` of every front of a level is factored by
   ``block_tridiag.batched_block_ldlt``, that is K1 (``csrc/block_ldlt.cu``)
   on a CUDA tensor and its plain version on a CPU tensor, the reference's
   ``_vldlt`` (``nested_dissection.py:543, 616``).  The Schur complement
   ``F22 - Y D^-1 Y^T`` and ``L21`` are batched matmuls; the children's
   Schur complements are extend-added into the parent level's fronts.  The
   inertia is the pivot signs of every level less the padding pivots
   (exactly +1 each).

Triangular solves follow the reference's split by device
(``ipopt_tpu/linalg/ldlt.py:58-74``): the substitution loop on the CPU, the
library's triangular solve elsewhere (``torch.linalg.solve_triangular``,
cuBLAS, where the reference calls XLA's TriangularSolve).

The extend-add of a level adds the two children of a parent in two passes,
first children then second, so that no pass adds twice into one slot: the
result is the same on every device and equals the reference's in-order
scatter on the CPU, and each pass is a gather, an add and a put.  Indices
that the reference drops (``mode="drop"``) land in a dump slot that is cut
off.

Layout: batch-first, fronts (B, n_d, f, f); the reference solves one
problem, so B = 1 on every path (``stack_problems`` refuses these problems).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..profiling import span
from ..types import cached_tensor
from .block_tridiag import batched_block_ldlt, _block_inertia_counts
from .ldlt import tri_solve_blocks, _safe

_I32 = np.int32


# ---------------------------------------------------------------------------
# Symbolic phase (host numpy; ``nested_dissection.py:48-508``)
# ---------------------------------------------------------------------------

def _ragged_neighbors(indptr, indices, verts):
    """All CSR neighbors of ``verts`` (with repeats) — vectorized gather."""
    starts = indptr[verts]
    counts = indptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0,), _I32)
    offs = np.repeat(starts - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                     counts)
    return indices[np.arange(total, dtype=np.int64) + offs]


def _bfs_levels(indptr, indices, verts, start, member_stamp, stamp, lev_arr):
    """BFS levels within the vertex subset marked ``member_stamp == stamp``.
    Returns (order, levels) over reached vertices only.  ``lev_arr`` is a
    workspace of -1 over all vertices, left as it was found (the
    reference allocates it per call: the same levels, O(N) less work)."""
    frontier = np.array([start], _I32)
    lev_arr[start] = 0
    out = [frontier]
    d = 0
    while frontier.size:
        neigh = _ragged_neighbors(indptr, indices, frontier)
        neigh = neigh[(member_stamp[neigh] == stamp) & (lev_arr[neigh] < 0)]
        frontier = np.unique(neigh)
        lev_arr[frontier] = d + 1
        d += 1
        if frontier.size:
            out.append(frontier)
    reached = np.concatenate(out)
    lev = lev_arr[reached]
    lev_arr[reached] = -1
    return reached, lev


@dataclasses.dataclass
class _Node:
    elim: np.ndarray          # vertices eliminated at this node
    children: Tuple[int, ...]  # node ids
    depth: int
    bd: np.ndarray = None      # boundary (sorted), filled bottom-up
    sub: np.ndarray = None     # subtree vertices (sorted)


def _dissect(indptr, indices, verts, depth, leaf_max, nodes, member_stamp,
             stamp_ctr, lev_arr):
    """Recursive bisection; appends postorder to ``nodes``; returns node id."""
    if len(verts) <= leaf_max:
        nodes.append(_Node(elim=np.asarray(verts, _I32), children=(),
                           depth=depth))
        return len(nodes) - 1

    stamp = stamp_ctr[0] = stamp_ctr[0] + 1
    member_stamp[verts] = stamp
    reached, lev = _bfs_levels(indptr, indices, verts, int(verts[0]),
                               member_stamp, stamp, lev_arr)

    if len(reached) < len(verts):
        # disconnected: bin-pack whole components into two balanced halves
        # (splitting through a component would make every vertex boundary)
        comps = [reached]
        seen = np.zeros(len(member_stamp), bool)
        seen[reached] = True
        rest = verts[~seen[verts]]
        while rest.size:
            stamp = stamp_ctr[0] = stamp_ctr[0] + 1
            member_stamp[rest] = stamp
            c, _ = _bfs_levels(indptr, indices, rest, int(rest[0]),
                               member_stamp, stamp, lev_arr)
            comps.append(c)
            seen[c] = True
            rest = rest[~seen[rest]]
        comps.sort(key=len, reverse=True)
        binA, binB, szA, szB = [], [], 0, 0
        for c in comps:
            if szA <= szB:
                binA.append(c)
                szA += len(c)
            else:
                binB.append(c)
                szB += len(c)
        cl = _dissect(indptr, indices, np.concatenate(binA), depth + 1,
                      leaf_max, nodes, member_stamp, stamp_ctr, lev_arr)
        cr = _dissect(indptr, indices, np.concatenate(binB), depth + 1,
                      leaf_max, nodes, member_stamp, stamp_ctr, lev_arr)
        nodes.append(_Node(elim=np.zeros((0,), _I32), children=(cl, cr),
                           depth=depth))
        return len(nodes) - 1

    # pseudo-peripheral restart from a farthest vertex
    stamp = stamp_ctr[0] = stamp_ctr[0] + 1
    member_stamp[verts] = stamp
    start2 = int(reached[np.argmax(lev)])
    reached, lev = _bfs_levels(indptr, indices, verts, start2,
                               member_stamp, stamp, lev_arr)
    # cut at the level set containing the median vertex
    order = np.argsort(lev, kind="stable")
    cut_level = int(lev[order[len(order) // 2]])
    sep = reached[lev == cut_level]
    left = reached[lev < cut_level]
    right = reached[lev > cut_level]
    if len(left) == 0 or len(right) == 0 or len(sep) >= len(verts) // 2 + 1:
        # separator does not shrink the problem (clique-ish graph): leaf
        nodes.append(_Node(elim=np.asarray(verts, _I32), children=(),
                           depth=depth))
        return len(nodes) - 1
    cl = _dissect(indptr, indices, left, depth + 1, leaf_max, nodes,
                  member_stamp, stamp_ctr, lev_arr)
    cr = _dissect(indptr, indices, right, depth + 1, leaf_max, nodes,
                  member_stamp, stamp_ctr, lev_arr)
    nodes.append(_Node(elim=np.asarray(sep, _I32), children=(cl, cr),
                       depth=depth))
    return len(nodes) - 1


class NDLevel(NamedTuple):
    """Static per-depth batch descriptor."""
    n_nodes: int
    p: int      # padded eliminated-variable count per front
    u: int      # padded boundary count per front
    f: int      # p + u
    offset: int  # flat-slot offset of this level in the assembly buffer


@dataclasses.dataclass(frozen=True, eq=False)
class NDInfo:
    """The symbolic analysis, attached to ``CanonicalNLP.chain`` (numpy).
    Its Jacobian and Hessian fields are those of ``sparse.BandedInfo``, so
    the compressed-AD evaluators (``sparse.jacobian_values``,
    ``sparse_hessian_values``) serve both.  ``resto`` is the restoration
    NLP's analysis (None when there is none).  Compared by value, as the
    reference's (``nested_dissection.py:207-216``)."""

    n: int
    mi: int
    me: int
    N: int
    j_rows: np.ndarray
    j_cols: np.ndarray
    j_colors: np.ndarray
    n_colors_j: int
    h_rows: np.ndarray
    h_cols: np.ndarray
    h_colors: np.ndarray
    n_colors_h: int
    row_unknown: np.ndarray
    # tree levels, deepest first (the factorization's order)
    levels: Tuple[NDLevel, ...] = ()
    total_slots: int = 0          # sum of n_d * f_d^2
    n_pad_elim: int = 0           # padding pivots (each contributes +1)
    # gather-form assembly (as the banded backend's): the value indices of
    # each occupied slot, and the occupied slots in increasing order
    asm_src: np.ndarray = None    # (n_unique, kdup), padded with n_vals
    asm_slot: np.ndarray = None   # (n_unique,)
    n_vals: int = 0
    # per level:
    elim_gid: Tuple[np.ndarray, ...] = ()   # (n_d, p_d) unknown, pad -> N
    bd_gid: Tuple[np.ndarray, ...] = ()     # (n_d, u_d) unknown, pad -> N
    child_scatter: Tuple[np.ndarray, ...] = ()  # (n_d, u_d, u_d) flat index
    # into the parent level's (n_par, f_par, f_par) buffer; pad -> its size
    diag_kind: Tuple[np.ndarray, ...] = ()  # (n_d, p_d) 0 = x/s, 1 = y, 2 = pad
    resto: Any = None
    _cache: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)

    def _key(self):
        return (self.n, self.mi, self.me, self.N, self.levels,
                self.j_rows.tobytes(), self.j_cols.tobytes(),
                self.h_rows.tobytes(), self.h_cols.tobytes())

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, NDInfo) and self._key() == other._key()

    def tensor(self, name: str, device) -> torch.Tensor:
        """The field ``name`` (a Jacobian/Hessian array) on ``device``,
        uploaded once (cached)."""
        return cached_tensor(self, name, device)

    @property
    def asm_inv(self) -> np.ndarray:
        """The reference's (total_slots,) map from every slot to its
        occupied-slot index (n_unique where empty), made on demand: the
        port assembles from ``asm_slot`` and never holds this array."""
        n_unique = self.asm_src.shape[0]
        inv = np.full((self.total_slots,), n_unique, self.asm_src.dtype)
        inv[self.asm_slot] = np.arange(n_unique, dtype=self.asm_src.dtype)
        return inv


def nd_analyze(n: int, mi: int, me: int,
               j_rows, j_cols, eq_mask, h_rows, h_cols,
               leaf_max: int = 32,
               j_colors=None, h_colors=None) -> NDInfo:
    """Pattern -> separator tree -> level-batched front layout + index maps
    (``nested_dissection.py:219-508``)."""
    import scipy.sparse as sp
    from ..sparse import greedy_coloring

    m = len(eq_mask)
    N = n + mi + me + mi

    eq_mask = np.asarray(eq_mask, bool)
    eq_pos = np.cumsum(eq_mask, dtype=_I32) - 1
    ineq_pos = np.cumsum(~eq_mask, dtype=_I32) - 1
    row_unknown = np.where(eq_mask, n + mi + eq_pos,
                           n + mi + me + ineq_pos).astype(_I32)

    # ---- adjacency of the augmented system -------------------------------
    hr32 = np.asarray(h_rows, _I32)
    hc32 = np.asarray(h_cols, _I32)
    ea = [hr32]
    eb = [hc32]
    if len(j_rows):
        ju = row_unknown[np.asarray(j_rows, _I32)]
        jx = np.asarray(j_cols, _I32)
        ea += [ju, jx]
        eb += [jx, ju]
    if mi:
        sk = n + np.arange(mi, dtype=_I32)
        yk = n + mi + me + np.arange(mi, dtype=_I32)
        ea += [sk, yk]
        eb += [yk, sk]
    EA = np.concatenate(ea)
    EB = np.concatenate(eb)
    G = sp.coo_matrix((np.ones(len(EA), np.int8), (EA, EB)),
                      shape=(N, N)).tocsr()
    G = (G + G.T).tocsr()     # symmetric adjacency for the BFS
    indptr = G.indptr.astype(np.int64)
    indices = G.indices.astype(_I32)

    # ---- separator tree ---------------------------------------------------
    nodes: list = []
    member_stamp = np.zeros(N, np.int64)
    _dissect(indptr, indices, np.arange(N, dtype=_I32), 0, leaf_max, nodes,
             member_stamp, [0], np.full(N, -1, _I32))

    # ---- bottom-up: subtree + boundary (nodes list is postorder) ----------
    for t in nodes:
        subs = [np.sort(t.elim)]
        bds = []
        for c in t.children:
            subs.append(nodes[c].sub)
            bds.append(nodes[c].bd)
        t.sub = np.sort(np.concatenate(subs)) if subs else np.zeros((0,), _I32)
        adj_e = np.unique(_ragged_neighbors(indptr, indices, t.elim)) \
            if len(t.elim) else np.zeros((0,), _I32)
        cand = np.union1d(np.union1d(
            bds[0] if bds else np.zeros((0,), _I32),
            bds[1] if len(bds) > 1 else np.zeros((0,), _I32)), adj_e)
        t.bd = np.setdiff1d(cand, t.sub, assume_unique=False).astype(_I32)

    # ---- level batching (deepest depth first) -----------------------------
    max_depth = max(t.depth for t in nodes)
    by_depth = [[] for _ in range(max_depth + 1)]
    for tid, t in enumerate(nodes):
        by_depth[t.depth].append(tid)
    levels = []
    level_nodes = []        # per processing level: list of node ids
    offset = 0
    for d in range(max_depth, -1, -1):
        ids = by_depth[d]
        p = max(max((len(nodes[t].elim) for t in ids), default=0), 1)
        u = max((len(nodes[t].bd) for t in ids), default=0)
        f = p + u
        levels.append(NDLevel(n_nodes=len(ids), p=p, u=u, f=f, offset=offset))
        level_nodes.append(ids)
        offset += len(ids) * f * f
    total_slots = offset

    # ---- global elimination rank + per-vertex location --------------------
    rank = np.full(N, -1, np.int64)
    node_of = np.full(N, -1, _I32)          # node id where v is eliminated
    elim_slot = np.full(N, -1, _I32)        # slot within that node's front
    node_level = np.zeros(len(nodes), _I32)
    node_idx_in_level = np.zeros(len(nodes), _I32)
    r = 0
    for li, ids in enumerate(level_nodes):
        for k, tid in enumerate(ids):
            node_level[tid] = li
            node_idx_in_level[tid] = k
            e = nodes[tid].elim
            node_of[e] = tid
            elim_slot[e] = np.arange(len(e), dtype=_I32)
            rank[e] = r + np.arange(len(e))
            r += len(e)
    assert r == N and np.all(rank >= 0), "dissection lost vertices"

    # boundary lookup table: sorted (node_id * N + var) -> bd position
    bd_keys = []
    bd_vals = []
    for tid, t in enumerate(nodes):
        if len(t.bd):
            bd_keys.append(np.int64(tid) * N + t.bd.astype(np.int64))
            bd_vals.append(np.arange(len(t.bd), dtype=_I32))
    if bd_keys:
        bd_keys = np.concatenate(bd_keys)
        bd_vals = np.concatenate(bd_vals)
        o = np.argsort(bd_keys)
        bd_keys = bd_keys[o]
        bd_vals = bd_vals[o]
    else:
        bd_keys = np.zeros((0,), np.int64)
        bd_vals = np.zeros((0,), _I32)

    parent = np.full(len(nodes), -1, _I32)
    for pid, pt in enumerate(nodes):
        for c in pt.children:
            parent[c] = pid

    lvl_p = np.array([lv.p for lv in levels], _I32)
    lvl_f = np.array([lv.f for lv in levels], np.int64)
    lvl_off = np.array([lv.offset for lv in levels], np.int64)

    def _front_coords(ua, ub):
        """Owner node + (front position of ua, of ub) — vectorized."""
        ua = np.asarray(ua, _I32)
        ub = np.asarray(ub, _I32)
        first = np.where(rank[ua] <= rank[ub], ua, ub)
        towner = node_of[first]

        def pos_of(v):
            own = node_of[v] == towner
            key = towner.astype(np.int64) * N + v.astype(np.int64)
            j = np.searchsorted(bd_keys, key)
            j = np.minimum(j, max(len(bd_keys) - 1, 0))
            hit = len(bd_keys) > 0
            bdpos = bd_vals[j] if hit else np.zeros(len(v), _I32)
            ok = (bd_keys[j] == key) if hit else np.zeros(len(v), bool)
            # every non-owned endpoint must be in the owner's boundary
            if not np.all(own | ok):
                raise AssertionError("ND front structure violated")
            return np.where(own, elim_slot[v],
                            lvl_p[node_level[towner]] + bdpos).astype(_I32)

        return towner, pos_of(ua), pos_of(ub)

    def _slot(towner, i, j):
        li = node_level[towner]
        return (lvl_off[li]
                + node_idx_in_level[towner].astype(np.int64)
                * lvl_f[li] * lvl_f[li]
                + i.astype(np.int64) * lvl_f[li] + j.astype(np.int64))

    # ---- value-vector slot streams (order mirrors nd_assemble) -----------
    segs = []
    if len(h_rows):
        t_, pi, pj = _front_coords(np.asarray(h_rows, _I32),
                                   np.asarray(h_cols, _I32))
        segs.append(_slot(t_, pi, pj))       # oriented: full-symmetric COO
    if len(j_rows):
        ju = row_unknown[np.asarray(j_rows, _I32)]
        jx = np.asarray(j_cols, _I32)
        t_, pi, pj = _front_coords(ju, jx)
        segs.append(_slot(t_, pi, pj))
        segs.append(_slot(t_, pj, pi))       # mirror (ju != jx always)
    ux = np.arange(n, dtype=_I32)
    t_, pi, pj = _front_coords(ux, ux)
    segs.append(_slot(t_, pi, pj))           # sigma_x diagonal
    if mi:
        us = n + np.arange(mi, dtype=_I32)
        t_, pi, pj = _front_coords(us, us)
        segs.append(_slot(t_, pi, pj))       # sigma_s diagonal
        uy = n + mi + me + np.arange(mi, dtype=_I32)
        t_, pi, pj = _front_coords(us, uy)
        segs.append(_slot(t_, pi, pj))       # -1 coupling
        segs.append(_slot(t_, pj, pi))       # mirror
    uy = n + mi + np.arange(me + mi, dtype=_I32)
    t_, pi, pj = _front_coords(uy, uy)
    segs.append(_slot(t_, pi, pj))           # -delta_c diagonal

    # ---- per-level index arrays + padding-pivot slots ---------------------
    elim_gid = []
    bd_gid = []
    diag_kind = []
    child_scatter = []
    pad_slots = []
    n_pad_elim = 0
    kind_of = np.empty(N, np.int8)
    kind_of[: n + mi] = 0
    kind_of[n + mi:] = 1
    for li, (lv, ids) in enumerate(zip(levels, level_nodes)):
        eg = np.full((lv.n_nodes, lv.p), N, _I32)
        bg = np.full((lv.n_nodes, max(lv.u, 1)), N, _I32)
        dk = np.full((lv.n_nodes, lv.p), 2, np.int8)
        for k, tid in enumerate(ids):
            e = nodes[tid].elim
            eg[k, :len(e)] = e
            dk[k, :len(e)] = kind_of[e]
            b_ = nodes[tid].bd
            bg[k, :len(b_)] = b_
            # padding pivots: +1.0 on the elim diagonal
            for q in range(len(e), lv.p):
                pad_slots.append(lv.offset + k * lv.f * lv.f
                                 + q * lv.f + q)
                n_pad_elim += 1
        elim_gid.append(eg)
        bd_gid.append(bg[:, :lv.u] if lv.u else bg[:, :0])
        diag_kind.append(dk)
        # child -> parent extend-add scatter (children at level li, parents
        # at li + 1 in processing order)
        if li + 1 <= len(levels) - 1:
            plv = levels[li + 1]
            cs = np.full((lv.n_nodes, max(lv.u, 1), max(lv.u, 1)),
                         np.int64(plv.n_nodes) * plv.f * plv.f, np.int64)
            for k, tid in enumerate(ids):
                par = int(parent[tid])
                if par < 0:
                    continue
                b_ = nodes[tid].bd
                if not len(b_):
                    continue
                # position of each bd var in the parent's front
                pk = node_idx_in_level[par]
                pe = nodes[par].elim
                pos = np.empty(len(b_), np.int64)
                in_pe = np.isin(b_, pe)
                if in_pe.any():
                    pos[in_pe] = elim_slot[b_[in_pe]]
                if (~in_pe).any():
                    pos[~in_pe] = plv.p + np.searchsorted(
                        nodes[par].bd, b_[~in_pe])
                base = np.int64(pk) * plv.f * plv.f
                cs[k, :len(b_), :len(b_)] = (base
                                             + pos[:, None] * plv.f
                                             + pos[None, :])
            child_scatter.append(cs[:, :lv.u, :lv.u] if lv.u
                                 else cs[:, :0, :0])
        else:
            child_scatter.append(np.zeros((lv.n_nodes, 0, 0), np.int64))
    if pad_slots:
        segs.append(np.asarray(pad_slots, np.int64))

    # ---- gather-form assembly indices (as the banded backend's) -----------
    slot = np.concatenate(segs) if segs else np.zeros((0,), np.int64)
    n_vals = len(slot)
    order = np.argsort(slot)
    ss = slot[order]
    firstm = np.ones(n_vals, bool)
    firstm[1:] = ss[1:] != ss[:-1]
    group_id = np.cumsum(firstm, dtype=np.int64) - 1
    n_unique = int(group_id[-1]) + 1 if n_vals else 0
    starts = np.flatnonzero(firstm)
    kpos = np.arange(n_vals, dtype=np.int64) - starts[group_id]
    kdup = int(kpos.max()) + 1 if n_vals else 1
    # int32 when safe (always, unless fronts exceed 2^31 slots), built in
    # that type (the reference narrows int64 arrays: the same values)
    idt = _I32 if total_slots < 2**31 and n_vals < 2**31 else np.int64
    asm_src = np.full((n_unique, kdup), n_vals, idt)
    asm_src[group_id, kpos] = order

    # colourings
    if j_colors is None:
        j_colors = greedy_coloring(np.asarray(j_rows), np.asarray(j_cols),
                                   n, m)
    n_colors_j = int(j_colors.max()) + 1 if n and len(j_rows) else 0
    if h_colors is None:
        h_colors = greedy_coloring(np.asarray(h_rows), np.asarray(h_cols),
                                   n, n)
    n_colors_h = int(h_colors.max()) + 1 if n and len(h_rows) else 0

    return NDInfo(
        n=n, mi=mi, me=me, N=N,
        j_rows=np.asarray(j_rows, _I32), j_cols=np.asarray(j_cols, _I32),
        j_colors=j_colors, n_colors_j=max(n_colors_j, 1),
        h_rows=np.asarray(h_rows, _I32), h_cols=np.asarray(h_cols, _I32),
        h_colors=h_colors, n_colors_h=max(n_colors_h, 1),
        row_unknown=row_unknown,
        levels=tuple(levels), total_slots=total_slots,
        n_pad_elim=n_pad_elim,
        asm_src=asm_src, asm_slot=ss[firstm], n_vals=n_vals,
        elim_gid=tuple(elim_gid), bd_gid=tuple(bd_gid),
        child_scatter=tuple(child_scatter), diag_kind=tuple(diag_kind))


def _sibling_passes(info: NDInfo, li: int):
    """The nodes of level ``li`` split by their rank among the children of
    their parent (first children, then second): within one pass no two
    nodes extend-add into one parent slot."""
    plv = info.levels[li + 1]
    cs = info.child_scatter[li]
    lv = info.levels[li]
    if lv.u == 0:
        return []
    dump = plv.n_nodes * plv.f * plv.f
    par = np.where(cs[:, 0, 0] < dump, cs[:, 0, 0] // (plv.f * plv.f), -1)
    rank = np.zeros(lv.n_nodes, np.int64)
    seen: Dict[int, int] = {}
    for k, p in enumerate(par.tolist()):
        if p >= 0:
            rank[k] = seen.get(p, 0)
            seen[p] = rank[k] + 1
    return [np.flatnonzero((rank == r) & (par >= 0))
            for r in range(int(rank.max()) + 1 if lv.n_nodes else 0)]


def nd_aux(info: NDInfo, device) -> Dict[str, Any]:
    """The per-solve index data on ``device``, uploaded once per device
    (cached on the descriptor, so a warm solve uploads nothing): the
    occupied assembly slots, and per level the elimination and boundary
    unknowns, the diagonal kinds and the extend-add indices of each sibling
    pass, as int64 tensors."""
    key = ("aux", str(device))
    aux = info._cache.get(key)
    if aux is not None:
        return aux

    def up(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    aux = {"asm_src": up(info.asm_src), "asm_slot": up(info.asm_slot)}
    L = len(info.levels)
    for li, lv in enumerate(info.levels):
        aux[f"elim_gid{li}"] = up(info.elim_gid[li])
        aux[f"bd_gid{li}"] = up(info.bd_gid[li])
        aux[f"diag_kind{li}"] = up(info.diag_kind[li], torch.int8)
        if li + 1 < L:
            passes = []
            for nodes_ in _sibling_passes(info, li):
                passes.append((up(nodes_),
                               up(info.child_scatter[li][nodes_].reshape(-1))))
            aux[f"extend_add{li}"] = passes
    info._cache[key] = aux
    return aux


# ---------------------------------------------------------------------------
# Numeric phase (``nested_dissection.py:528-721``), every loop over levels
# ---------------------------------------------------------------------------

class NDFactor(NamedTuple):
    L11: Tuple[Any, ...]      # per level (B, n_d, p, p) unit lower
    d1: Tuple[Any, ...]       # per level (B, n_d, p)
    L21: Tuple[Any, ...]      # per level (B, n_d, u, p)
    num_pos: Any              # (B,)
    num_neg: Any
    num_zero: Any
    singular: Any


def nd_assemble(nlp, aux, info: NDInfo, it, j_vals, h_vals, delta_x, delta_c):
    """The value vector gathered into per-level fronts (B, n_d, f, f): the
    duplicates of a slot summed through ``asm_src``, then the occupied
    slots written into one zero buffer that the levels view.  ``delta_x``
    and ``delta_c`` are per-lane (B,) tensors."""
    from ..kkt import sigmas
    x = it.x
    Bt, dtype = x.shape[0], x.dtype
    sig = sigmas(nlp, it)
    vals = []
    if len(info.h_rows):
        vals.append(h_vals)
    if len(info.j_rows):
        vals.append(j_vals)
        vals.append(j_vals)
    vals.append(sig.sigma_x + delta_x[:, None])
    if info.mi:
        vals.append(sig.sigma_s + delta_x[:, None])
        mones = x.new_full((Bt, info.mi), -1.0)
        vals.append(mones)
        vals.append(mones)
    vals.append((-delta_c[:, None]).expand(Bt, info.me + info.mi))
    if info.n_pad_elim:
        vals.append(x.new_ones((Bt, info.n_pad_elim)))
    vals.append(x.new_zeros((Bt, 1)))
    v_ext = torch.cat([v.to(dtype) for v in vals], -1)
    slot_vals = v_ext[:, aux["asm_src"]].sum(-1)
    flat = x.new_zeros((Bt, info.total_slots))
    flat[:, aux["asm_slot"]] = slot_vals
    return tuple(flat[:, lv.offset:lv.offset + lv.n_nodes * lv.f * lv.f]
                 .view(Bt, lv.n_nodes, lv.f, lv.f) for lv in info.levels)


def nd_add_diag_deltas(info: NDInfo, aux, fronts, delta_x, delta_c):
    """(delta_x, -delta_c) added on the eliminated diagonal of every front
    (new tensors; the zero-delta assembly stays as it is)."""
    out = []
    for li, (lv, F) in enumerate(zip(info.levels, fronts)):
        kind = aux[f"diag_kind{li}"][None]                      # (1, n_d, p)
        zero = torch.zeros((), dtype=F.dtype, device=F.device)
        add = torch.where(kind == 0, delta_x[:, None, None],
                          torch.where(kind == 1, -delta_c[:, None, None], zero))
        F = F.clone()
        F.diagonal(dim1=-2, dim2=-1)[..., :lv.p] += add
        out.append(F)
    return tuple(out)


def _extend_add(F, U, passes):
    """F (B, n, f, f) plus the children's Schur complements U (B, n_c, u, u)
    at their parent slots, one sibling pass at a time; padding lands in a
    dump slot past the end.  Within a pass no live slot repeats, so each
    pass is a gather, an add and a put (no atomic adds; the dump slot's
    value is discarded)."""
    Bt = F.shape[0]
    buf = torch.cat([F.reshape(Bt, -1), F.new_zeros((Bt, 1))], -1)
    for nodes_, idx in passes:
        buf[:, idx] = buf[:, idx] + U[:, nodes_].reshape(Bt, -1)
    return buf[:, :-1].reshape(F.shape)


def nd_factorize(info: NDInfo, aux, fronts, pivot_tol: float = 0.0) -> NDFactor:
    """Level-batched partial LDL^T, deepest level first: K1 on every level's
    eliminated blocks.  ``nd_factorize.calls`` counts factorizations and
    ``nd_factorize.levels`` the levels they factored (one K1 launch each)."""
    nd_factorize.calls += 1
    nd_factorize.levels += len(info.levels)
    L11s, d1s, L21s = [], [], []
    Bt = fronts[0].shape[0]
    dev = fronts[0].device
    num_pos = torch.zeros((Bt,), dtype=torch.int64, device=dev)
    num_neg = torch.zeros_like(num_pos)
    num_zero = torch.zeros_like(num_pos)
    update = None
    for li, (lv, F) in enumerate(zip(info.levels, fronts)):
        if update is not None:
            with span("nd.extend_add"):
                F = _extend_add(F, update, aux[f"extend_add{li - 1}"])
        p, n_d = lv.p, lv.n_nodes
        L11, d1 = batched_block_ldlt(F[:, :, :p, :p].reshape(Bt * n_d, p, p))
        L11 = L11.view(Bt, n_d, p, p)
        d1 = d1.view(Bt, n_d, p)
        po, ne, ze = _block_inertia_counts(d1, pivot_tol)
        num_pos, num_neg, num_zero = num_pos + po, num_neg + ne, num_zero + ze
        if lv.u:
            Y = tri_solve_blocks(L11, F[:, :, :p, p:])               # (B, n, p, u)
            Yd = Y / _safe(d1)[..., None]
            L21 = Yd.transpose(-1, -2)
            update = F[:, :, p:, p:] - torch.matmul(Y.transpose(-1, -2), Yd)
        else:
            L21 = F.new_zeros((Bt, n_d, 0, p))
            update = None
        L11s.append(L11)
        d1s.append(d1)
        L21s.append(L21)
    num_pos = num_pos - info.n_pad_elim
    return NDFactor(L11=tuple(L11s), d1=tuple(d1s), L21=tuple(L21s),
                    num_pos=num_pos, num_neg=num_neg, num_zero=num_zero,
                    singular=num_zero > 0)


nd_factorize.calls = 0
nd_factorize.levels = 0


def nd_solve(info: NDInfo, aux, fac: NDFactor, rhs):
    """(B, N) solve: forward sweep bottom-up, the pivots, backward sweep
    top-down; the unknown N is a dump slot for the padding."""
    Bt = rhs.shape[0]
    rhs_e = torch.cat([rhs, rhs.new_zeros((Bt, 1))], -1)
    zs = []
    for li, lv in enumerate(info.levels):
        b1 = rhs_e[:, aux[f"elim_gid{li}"]]                   # (B, n_d, p)
        z1 = tri_solve_blocks(fac.L11[li], b1[..., None])[..., 0]
        zs.append(z1)
        if lv.u:
            upd = -torch.matmul(fac.L21[li], z1[..., None])[..., 0]
            rhs_e.index_add_(1, aux[f"bd_gid{li}"].reshape(-1),
                             upd.reshape(Bt, -1))
    sol_e = rhs.new_zeros((Bt, info.N + 1))
    for li in reversed(range(len(info.levels))):
        lv = info.levels[li]
        zhat = zs[li] / _safe(fac.d1[li])
        if lv.u:
            x_bd = sol_e[:, aux[f"bd_gid{li}"]]               # (B, n_d, u)
            zhat = zhat - torch.matmul(fac.L21[li].transpose(-1, -2),
                                       x_bd[..., None])[..., 0]
        x1 = tri_solve_blocks(fac.L11[li], zhat[..., None], transpose=True)[..., 0]
        sol_e[:, aux[f"elim_gid{li}"].reshape(-1)] = x1.reshape(Bt, -1)
    return sol_e[:, :info.N]


def nd_matvec(info: NDInfo, aux, fronts, x):
    """K x (B, N) from the assembled fronts: each entry of K lives in
    exactly one front; padding reads and writes the dump unknown N."""
    Bt = x.shape[0]
    x_e = torch.cat([x, x.new_zeros((Bt, 1))], -1)
    y_e = x.new_zeros((Bt, info.N + 1))
    for li, lv in enumerate(info.levels):
        gid = aux[f"elim_gid{li}"]
        if lv.u:
            gid = torch.cat([gid, aux[f"bd_gid{li}"]], 1)
        xf = x_e[:, gid]                                       # (B, n_d, f)
        yf = torch.matmul(fronts[li], xf[..., None])[..., 0]
        y_e.index_add_(1, gid.reshape(-1), yf.reshape(Bt, -1))
    return y_e[:, :info.N]


def nd_solve_refined(info: NDInfo, aux, fronts, fac: NDFactor, rhs, opts):
    """Solve + iterative refinement against the assembled fronts, the
    reference's loop (min/max refinement steps and ``residual_ratio_max``,
    no improvement test), against float64 fronts under
    ``refinement_precision="double"`` whatever the factor's dtype
    (``nested_dissection.py:683-721``); returns (sol, residual ratio) per
    lane."""
    from ..algorithm.step import refine, refine_dtypes
    dts = refine_dtypes(opts, fronts[0].dtype, fac.L11[0].dtype)
    fronts_a = tuple(F.to(dts[1]) for F in fronts)
    return refine(lambda s: nd_matvec(info, aux, fronts_a, s),
                  lambda r: nd_solve(info, aux, fac, r), rhs, opts,
                  improvement=False, dtypes=dts)
