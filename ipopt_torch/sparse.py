"""General-sparsity KKT backend: symbolic analysis -> RCM banding -> BCR
(port of the banded half of ``ipopt_tpu/sparse.py``).

Selected by ``linear_solver="banded-bcr"`` for a flat ``NLP``.  The user
declares the Jacobian and Lagrangian-Hessian patterns
(``NLP.jac_g_sparsity`` / ``lag_hess_sparsity``, COO (rows, cols), as TNLP's
structure callbacks do), or a small problem's patterns are detected by dense
AD probing at random points.

1. Once, on the host (numpy and scipy): the augmented-KKT pattern over the
   unknowns [x | s | y_c | y_d] is reordered by reverse Cuthill-McKee, the
   half bandwidth gives the block size b, and the permuted KKT is
   block-tridiagonal (nb blocks of b), which ``linalg/block_tridiag.py``
   factors by block cyclic reduction with K2 on every level.  Greedy
   distance-2 colourings of the Jacobian and Hessian columns give the seeds
   of the compressed derivatives, and the gather-form assembly indices
   (``asm_src``, ``asm_inv``) map the value vector into the (nb, b, b)
   diagonal and sub-diagonal block arrays.  The restoration NLP (x widened
   by per-row n/p slacks) is analyzed at the same time.
2. Per iteration: ``n_colors_j`` JVPs of g and ``n_colors_h``
   Hessian-vector products of the Lagrangian (``torch.func.jvp`` under
   ``vmap`` over the seeds) give the entry values; one gather-sum and one
   gather assemble the block arrays; the inertia-correction retry loop
   re-adds the deltas on the diagonal only.

The symbolic half is numpy and scipy only, a copy of the reference's (the
port imports nothing of it), so ``perm``, ``b``, ``nb``, the colourings and
the assembly indices equal the reference's.  The index arrays reach a device
once: ``BandedInfo.tensor(name, device)`` caches each per device on the
static descriptor, as ``ChainInfo.ineq_row`` does.  The descriptor is shared
by the problem, its restoration NLP keeps its own, and ``CanonicalNLP``
stays as it is (no ``aux_arrays`` field to move); a warm solve of the same
canonical problem uploads nothing.

Batching: the reference solves one banded problem at a time; here the lane
axis stays, at B = 1 (``stack_problems`` refuses banded problems).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from .options import Options
from .profiling import host_bool, span
from .problem import NLP, CanonicalNLP, canonicalize
from .scaling import grad_scale_factor
from .types import Iterate, cached_tensor, max_init, torch_dtype, tree_map


# ---------------------------------------------------------------------------
# Pattern detection (exact, dense-AD probing, for problems small enough;
# large problems declare their pattern, as TNLP does)
# ---------------------------------------------------------------------------

_AUTODETECT_MAX_DENSE = 8_000_000  # max n*m (or n*n) entries probed densely


def _probe_points(x0: np.ndarray, seed: int, n_probe: int):
    n = x0.shape[0]
    rng = np.random.RandomState(seed)
    for _ in range(n_probe):
        yield torch.as_tensor(x0 + 0.1 * rng.standard_normal(n)
                              + 0.01 * rng.uniform(0.5, 1.5, n), dtype=torch.float64)


def _nonzero(M: torch.Tensor) -> np.ndarray:
    return ~np.isclose(np.nan_to_num(M.detach().numpy(), nan=1.0), 0.0)


def detect_jacobian_sparsity(g_fn, x0: np.ndarray, n_probe: int = 2):
    """Exact Jacobian pattern by dense ``jacfwd`` at randomized points: an
    entry is structural if it is nonzero (or NaN) at any probe point."""
    pat = None
    for xp in _probe_points(x0, 0, n_probe):
        nz = _nonzero(jacfwd(g_fn)(xp))
        pat = nz if pat is None else (pat | nz)
    rows, cols = np.nonzero(pat)
    return rows.astype(np.int32), cols.astype(np.int32)


def detect_hessian_sparsity(lag_fn, x0: np.ndarray, n_probe: int = 2):
    """Exact Lagrangian-Hessian pattern (full symmetric) by dense
    ``hessian`` probing, random multipliers folded into ``lag_fn``."""
    pat = None
    for xp in _probe_points(x0, 1, n_probe):
        nz = _nonzero(hessian(lag_fn)(xp))
        pat = nz if pat is None else (pat | nz)
    pat = pat | pat.T
    rows, cols = np.nonzero(pat)
    return rows.astype(np.int32), cols.astype(np.int32)


def greedy_coloring(rows: np.ndarray, cols: np.ndarray, n_cols: int,
                    n_rows: int) -> np.ndarray:
    """Greedy distance-2 column colouring (columns sharing a row get
    distinct colours: Curtis-Powell-Reid).  Banded fast path: if every row's
    column span w is at most 64, ``col % w`` is a valid colouring."""
    import scipy.sparse as sp
    if len(rows) == 0 or n_cols == 0:
        return np.zeros((n_cols,), np.int32)
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    cmax = np.full(n_rows, -1, np.int32)
    cmin = np.full(n_rows, np.iinfo(np.int32).max, np.int32)
    np.maximum.at(cmax, rows, cols)
    np.minimum.at(cmin, rows, cols)
    nonempty = cmax >= 0
    w = int(np.max(np.where(nonempty, cmax - cmin + 1, 0), initial=1))
    if w <= 64:
        return (np.arange(n_cols, dtype=np.int64) % w).astype(np.int32)
    A = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(max(n_rows, 1), n_cols)).tocsc()
    B = (A.T @ A).tocsr()
    colors = np.full((n_cols,), -1, np.int32)
    for j in range(n_cols):
        nbr = B.indices[B.indptr[j]:B.indptr[j + 1]]
        used = set(int(c) for c in colors[nbr] if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[j] = c
    return colors


# ---------------------------------------------------------------------------
# The static descriptor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class BandedInfo:
    """The symbolic analysis, attached to ``CanonicalNLP.chain`` (numpy).

    Unknown u in [0, N): x (0..n-1), s (n..n+mi-1), y_c, y_d; ``pos[u]`` its
    position after the RCM permutation, ``perm[k]`` the unknown at position
    k.  The value vector the assembly gathers from is, in order:
    [h_vals | j_vals | j_vals mirrored | sig_x | sig_s | -1 couplings x2 |
    y diagonal (-delta_c) | pad (+1)].  ``asm_src`` (n_unique, Kdup) lists
    the value indices of each occupied slot (padded with n_vals, which reads
    an appended 0) and ``asm_inv`` (2 nb b b,) the occupied-slot index of
    every slot (padded with n_unique), slot = is_sub nb b b + blk b b +
    r b + c.  ``diag_kind`` (nb, b): 0 for x/s (+delta_x), 1 for y
    (-delta_c), 2 for padding.  ``h_keep``, ``j_mirror`` and ``s_mirror``
    mask the values whose slot is the other orientation's; ``resto`` is the
    restoration NLP's analysis (None when there is none)."""

    n: int
    mi: int
    me: int
    N: int
    b: int
    nb: int
    perm: np.ndarray
    pos: np.ndarray
    j_rows: np.ndarray
    j_cols: np.ndarray
    j_colors: np.ndarray
    n_colors_j: int
    h_rows: np.ndarray
    h_cols: np.ndarray
    h_colors: np.ndarray
    n_colors_h: int
    row_unknown: np.ndarray
    n_pad: int = 0
    asm_slot: Optional[np.ndarray] = None
    asm_src: Optional[np.ndarray] = None
    asm_inv: Optional[np.ndarray] = None
    n_vals: int = 0
    diag_kind: Optional[np.ndarray] = None
    h_keep: Optional[np.ndarray] = None
    j_mirror: Optional[np.ndarray] = None
    s_mirror: Optional[np.ndarray] = None
    resto: Optional["BandedInfo"] = None
    _cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def _key(self):
        return (self.n, self.mi, self.me, self.N, self.b, self.nb,
                self.perm.tobytes(), self.j_rows.tobytes(),
                self.j_cols.tobytes(), self.h_rows.tobytes(),
                self.h_cols.tobytes())

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, BandedInfo) and self._key() == other._key()

    def tensor(self, name: str, device) -> torch.Tensor:
        """The index array ``name`` on ``device``, uploaded once (cached)."""
        return cached_tensor(self, name, device)


def _targets_oriented(pos, b, ui, uj):
    """Slot of an entry K(ui, uj) of a full-symmetric COO list: same-block
    entries fill their own (r, c); the lower cross-block orientation fills
    sub; the upper one is dropped (keep=False), its mirror fills sub."""
    pi = pos[ui]
    pj = pos[uj]
    blki = pi // b
    blkj = pj // b
    same = blki == blkj
    cross_lower = blki == blkj + 1
    keep = same | cross_lower
    is_sub = cross_lower
    blk = np.where(same, blki, np.minimum(blki, blkj))
    return is_sub, blk, pi % b, pj % b, keep


def _targets_for_pairs(pos, b, ua, ub):
    """(is_sub, blk, r, c) of the K(hi, lo) orientation of symmetric entries
    between unknowns ua and ub."""
    pa = pos[ua]
    pb = pos[ub]
    hi = np.maximum(pa, pb)
    lo = np.minimum(pa, pb)
    blk_hi = hi // b
    blk_lo = lo // b
    if np.any(blk_hi - blk_lo > 1):
        raise AssertionError("bandwidth exceeded block size: RCM/b bug")
    is_sub = blk_hi != blk_lo
    blk = np.where(is_sub, blk_lo, blk_hi)
    return is_sub, blk, hi % b, lo % b


_I32 = np.int32


def analyze_sparsity(n: int, mi: int, me: int, j_rows, j_cols, eq_mask,
                     h_rows, h_cols, min_block: int = 8, block_align: int = 8,
                     j_colors=None, h_colors=None) -> BandedInfo:
    """The symbolic phase: pattern -> RCM -> block size -> gather indices
    (``ipopt_tpu/sparse.py:237-424``, int32 index arithmetic throughout)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = len(eq_mask)
    N = n + mi + me + mi

    eq_mask = np.asarray(eq_mask, bool)
    eq_pos = np.cumsum(eq_mask, dtype=_I32) - 1
    ineq_pos = np.cumsum(~eq_mask, dtype=_I32) - 1
    row_unknown = np.where(eq_mask, n + mi + eq_pos,
                           n + mi + me + ineq_pos).astype(_I32)

    # the augmented pattern's undirected edges: the Hessian COO (full
    # symmetric) once, Jacobian and s <-> y_d couplings in both orientations
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

    G = sp.coo_matrix((np.ones(len(EA), np.int8), (EA, EB)), shape=(N, N)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True), _I32)
    pos = np.empty(N, _I32)
    pos[perm] = np.arange(N, dtype=_I32)

    bw = int(np.max(np.abs(pos[EA] - pos[EB]))) if len(EA) else 1
    b = max(min_block, -(-max(bw, 1) // block_align) * block_align)
    nb = -(-N // b)
    n_pad = nb * b - N

    if j_colors is None:
        j_colors = greedy_coloring(np.asarray(j_rows), np.asarray(j_cols), n, m)
    n_colors_j = int(j_colors.max()) + 1 if n and len(j_rows) else 0
    if h_colors is None:
        h_colors = greedy_coloring(np.asarray(h_rows), np.asarray(h_cols), n, n)
    n_colors_h = int(h_colors.max()) + 1 if n and len(h_rows) else 0

    bb = b * b
    if 2 * nb * bb >= 2**31:
        raise ValueError(
            f"banded backend block storage too large: 2*nb*b^2 = {2 * nb * bb}"
            f" >= 2^31 (nb={nb}, b={b}); the RCM bandwidth is too wide for "
            f"this problem")
    sdt = _I32
    segs = []

    def _slot(is_sub, blk, r, c):
        return (np.asarray(is_sub, sdt) * sdt(nb * bb)
                + np.asarray(blk, sdt) * sdt(bb)
                + np.asarray(r, sdt) * sdt(b) + np.asarray(c, sdt))

    def emit(ua, ub, both: bool):
        """K(hi, lo); with ``both`` also K(lo, hi) for in-block off-diagonal
        entries (a zero-add on the entry's own slot for the others)."""
        is_sub, blk, r, c = _targets_for_pairs(pos, b, ua, ub)
        segs.append(_slot(is_sub, blk, r, c))
        if both:
            in_blk_off = (~is_sub) & (r != c)
            r2 = np.where(in_blk_off, c, r)
            c2 = np.where(in_blk_off, r, c)
            segs.append(_slot(is_sub, blk, r2, c2))
            return in_blk_off
        return None

    # 1. Hessian entries (both orientations already present)
    h_keep_mask = None
    if len(h_rows):
        is_sub, blk, r, c, h_keep_mask = _targets_oriented(
            pos, b, np.asarray(h_rows, _I32), np.asarray(h_cols, _I32))
        segs.append(_slot(is_sub, blk, r, c))
    # 2+3. Jacobian entries and their in-block mirrors
    j_mirror_mask = None
    if len(j_rows):
        j_mirror_mask = emit(row_unknown[np.asarray(j_rows, _I32)],
                             np.asarray(j_cols, _I32), both=True)
    # 4. sigma_x + delta_x on the x diagonal
    ux = np.arange(n, dtype=_I32)
    emit(ux, ux, both=False)
    # 5. sigma_s + delta_x on the s diagonal
    if mi:
        us = n + np.arange(mi, dtype=_I32)
        emit(us, us, both=False)
    # 6. the -1 couplings s <-> y_d
    s_mirror_mask = None
    if mi:
        s_mirror_mask = emit(n + np.arange(mi, dtype=_I32),
                             n + mi + me + np.arange(mi, dtype=_I32), both=True)
    # 7. -delta_c on the y diagonal
    uy = n + mi + np.arange(me + mi, dtype=_I32)
    emit(uy, uy, both=False)
    # 8. +1 on the padding diagonal
    if n_pad:
        pp = N + np.arange(n_pad, dtype=_I32)
        blk = pp // b
        segs.append(_slot(np.zeros(n_pad, bool), blk, pp % b, pp % b))

    # gather-form assembly indices; the order of duplicates within a slot
    # does not change their sum
    slot = np.concatenate(segs)
    n_vals = len(slot)
    order = np.argsort(slot)
    ss = slot[order]
    first = np.ones(n_vals, bool)
    first[1:] = ss[1:] != ss[:-1]
    group_id = np.cumsum(first, dtype=_I32) - 1
    n_unique = int(group_id[-1]) + 1 if n_vals else 0
    starts = np.flatnonzero(first).astype(_I32)
    kpos = np.arange(n_vals, dtype=_I32) - starts[group_id]
    kdup = int(kpos.max()) + 1 if n_vals else 1
    asm_src = np.full((n_unique, kdup), n_vals, np.int32)
    asm_src[group_id, kpos] = order
    asm_inv = np.full((2 * nb * bb,), n_unique, np.int32)
    asm_inv[ss[first]] = np.arange(n_unique, dtype=np.int32)

    kind_u = np.empty(nb * b, np.int8)
    kind_u[:] = 2
    kind_of = np.empty(N, np.int8)
    kind_of[: n + mi] = 0
    kind_of[n + mi:] = 1
    kind_u[:N] = kind_of[perm]
    diag_kind = kind_u.reshape(nb, b)

    return BandedInfo(
        n=n, mi=mi, me=me, N=N, b=b, nb=nb, perm=perm, pos=pos,
        j_rows=np.asarray(j_rows, np.int32), j_cols=np.asarray(j_cols, np.int32),
        j_colors=j_colors, n_colors_j=max(n_colors_j, 1),
        h_rows=np.asarray(h_rows, np.int32), h_cols=np.asarray(h_cols, np.int32),
        h_colors=h_colors, n_colors_h=max(n_colors_h, 1),
        row_unknown=row_unknown, n_pad=n_pad,
        asm_slot=np.asarray(slot, np.int32), asm_src=asm_src, asm_inv=asm_inv,
        n_vals=n_vals, diag_kind=diag_kind, h_keep=h_keep_mask,
        j_mirror=j_mirror_mask, s_mirror=s_mirror_mask)


# ---------------------------------------------------------------------------
# Canonicalization
# ---------------------------------------------------------------------------

def _declared_hessian(hess_pat, n):
    """A declared Hessian pattern deduplicated and, if it is one triangle,
    symmetrized to the full pattern."""
    hr = np.asarray(hess_pat[0], np.int64)
    hc = np.asarray(hess_pat[1], np.int64)
    keys = np.unique(hr * n + hc)
    keys_t = np.unique(hc * n + hr)
    if not (keys.size == keys_t.size and np.array_equal(keys, keys_t)):
        keys = np.unique(np.concatenate([keys, keys_t]))
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def canonicalize_sparse(nlp: NLP, options: Optional[Options] = None,
                        device=None) -> CanonicalNLP:
    """The canonical form (B = 1) of a flat NLP for the banded-BCR backend,
    or with ``linear_solver="multifrontal"`` for the nested-dissection one
    (``ipopt_tpu/sparse.py:461-600``), on ``device`` (default the CPU).
    Patterns from ``nlp.jac_g_sparsity`` / ``lag_hess_sparsity`` or, for a
    small problem, detected by dense AD probing."""
    opts = options or Options()
    base = canonicalize(nlp, opts.replace(nlp_scaling_method="none"), device=device)
    s = base.struct
    if s.n != s.n_full:
        raise ValueError(
            "the banded backend does not support eliminated fixed variables;"
            " use fixed_variable_treatment='relax_bounds' or 'make_constraint'")
    n, mi, me, m = s.n, s.mi, s.me, s.m

    jac_pat, hess_pat = nlp.jac_g_sparsity, nlp.lag_hess_sparsity
    if jac_pat is None or hess_pat is None:
        x0 = np.asarray(nlp.x0, np.float64).reshape(-1)
    # the probes run in float64 on the host, one instance's params
    params = None if nlp.params is None else tree_map(
        lambda v: v[0].detach().cpu().double(), base.params)

    def g_user(x):
        return nlp.g(x) if nlp.params is None else nlp.g(x, params)

    if jac_pat is None and m:
        if n * m > _AUTODETECT_MAX_DENSE:
            raise ValueError(
                f"problem too large for dense sparsity auto-detection "
                f"(n*m = {n * m}); declare NLP.jac_g_sparsity")
        j_rows, j_cols = detect_jacobian_sparsity(g_user, x0)
    elif jac_pat is not None:
        j_rows = np.asarray(jac_pat[0], np.int32)
        j_cols = np.asarray(jac_pat[1], np.int32)
    else:
        j_rows = np.zeros((0,), np.int32)
        j_cols = np.zeros((0,), np.int32)

    if hess_pat is None:
        if n * n > _AUTODETECT_MAX_DENSE:
            raise ValueError(
                f"problem too large for dense Hessian auto-detection "
                f"(n^2 = {n * n}); declare NLP.lag_hess_sparsity")
        y_rand = torch.as_tensor(np.random.RandomState(7).standard_normal(m))

        def lag(x):
            val = nlp.f(x) if nlp.params is None else nlp.f(x, params)
            if m:
                val = val + torch.dot(y_rand, g_user(x))
            return val

        h_rows, h_cols = detect_hessian_sparsity(lag, x0)
    else:
        h_rows, h_cols = _declared_hessian(hess_pat, n)

    eq_mask = np.zeros((m,), bool)
    eq_mask[s.eq_idx] = True
    if opts.linear_solver == "multifrontal":
        # nested dissection for patterns whose RCM bandwidth is too wide for
        # BCR (3-D grids; ``sparse.py:539-551``)
        from .linalg.nested_dissection import nd_analyze as analyze
    else:
        analyze = analyze_sparsity
    info = analyze(n, mi, me, j_rows, j_cols, eq_mask, h_rows, h_cols)

    if opts.resto_phase:
        # the restoration NLP: x widened by per-row n/p slacks (g - p + n),
        # so its pattern adds identity couplings into the slack columns and
        # the proximity term's full x diagonal
        import scipy.sparse as sp
        nr = n + 2 * m
        jr_rows, jr_cols = j_rows, j_cols
        if m:
            rr = np.arange(m, dtype=np.int32)
            jr_rows = np.concatenate([j_rows, rr, rr])
            jr_cols = np.concatenate([j_cols, (n + rr).astype(np.int32),
                                      (n + m + rr).astype(np.int32)])
        diag_x = np.arange(n, dtype=np.int32)
        Hd = sp.coo_matrix((np.ones(len(h_rows) + n, np.int8),
                            (np.concatenate([h_rows, diag_x]),
                             np.concatenate([h_cols, diag_x]))), shape=(nr, nr))
        Hd = (Hd != 0).tocoo()
        # each slack column appears in exactly one row: all n-columns share
        # one new colour and all p-columns another
        ncj = int(info.j_colors.max()) + 1 if len(j_rows) else 0
        jc_resto = (np.concatenate([info.j_colors, np.full(m, ncj, np.int32),
                                    np.full(m, ncj + 1, np.int32)])
                    if m else info.j_colors)
        resto = analyze(nr, mi, me, jr_rows, jr_cols, eq_mask,
                        Hd.row.astype(np.int32), Hd.col.astype(np.int32),
                        j_colors=jc_resto)
        info = dataclasses.replace(info, resto=resto, _cache={})

    base = base._replace(chain=info)
    if opts.nlp_scaling_method == "gradient-based":
        base = _sparse_gradient_scaling(base, opts)
    return base


def _sparse_gradient_scaling(nlp: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """GradientScaling from the compressed Jacobian at x0 (no dense J)."""
    s = nlp.struct
    dtype, dev = nlp.dtype, nlp.device
    x0 = nlp.x0
    df = grad_scale_factor(max_init(nlp.eval_grad_f(x0).abs(), 0.0), opts,
                           opts.nlp_scaling_obj_target_gradient)
    df = df * opts.obj_scaling_factor
    c_scale, d_scale = nlp.c_scale, nlp.d_scale
    if s.m:
        row_norm = max_init(compressed_jacobian_raw(nlp, x0).abs(), 0.0)
        dg = grad_scale_factor(row_norm, opts, opts.nlp_scaling_constr_target_gradient)
        if s.me:
            c_scale = dg[:, s.index("eq_idx", dev)]
        if s.mi:
            d_scale = dg[:, s.index("ineq_idx", dev)]
    return nlp._replace(
        obj_scale=df.to(dtype), c_scale=c_scale.to(dtype), d_scale=d_scale.to(dtype),
        d_L=nlp.d_L * d_scale, d_U=nlp.d_U * d_scale)


# ---------------------------------------------------------------------------
# Per-iteration values (compressed AD)
# ---------------------------------------------------------------------------

def _seeds(info: BandedInfo, which: str, like: torch.Tensor):
    """(n_colors, n) 0/1 seed matrix of the Jacobian ("j") or Hessian ("h")
    colouring."""
    colors = info.tensor(f"{which}_colors", like.device)
    nc = info.n_colors_j if which == "j" else info.n_colors_h
    return (colors[None, :] == torch.arange(nc, device=like.device)[:, None]).to(like.dtype)


def compressed_jacobian_raw(nlp: CanonicalNLP, x):
    """(B, m, n_colors_j) compressed Jacobian of the user's g (raw rows):
    column j's entries land in colour column j_colors[j]."""
    seeds = _seeds(nlp.chain, "j", x)

    def one(x1, params):
        def g(xx):
            return nlp.g(xx, params)
        return vmap(lambda sv: jvp(g, (x1,), (sv,))[1])(seeds).T

    return vmap(one)(x, nlp.params)


def _row_scale(nlp: CanonicalNLP):
    """(B, m) scale of each user row: c_scale on equality rows, d_scale on
    inequality rows."""
    s = nlp.struct
    if s.mi == 0 and s.me == s.m:
        return nlp.c_scale
    if s.me == 0 and s.mi == s.m:
        return nlp.d_scale
    rs = nlp.c_scale.new_ones((nlp.batch, s.m))
    if s.me:
        rs[:, s.index("eq_idx", rs.device)] = nlp.c_scale
    if s.mi:
        rs[:, s.index("ineq_idx", rs.device)] = nlp.d_scale
    return rs


def jacobian_values(nlp: CanonicalNLP, x):
    """(B, nnz) scaled Jacobian entries aligned with (j_rows, j_cols)."""
    info: BandedInfo = nlp.chain
    dev = x.device
    with span("eval.jacobian"):
        Jcomp = compressed_jacobian_raw(nlp, x)
        r = info.tensor("j_rows", dev)
        c = info.tensor("j_colors", dev)[info.tensor("j_cols", dev)]
        return Jcomp[:, r, c] * _row_scale(nlp)[:, r]


def sparse_hessian_values(nlp: CanonicalNLP, it: Iterate):
    """(B, nnz) scaled Lagrangian-Hessian entries aligned with (h_rows,
    h_cols): n_colors_h Hessian-vector products of the scaled Lagrangian,
    forward over reverse."""
    info: BandedInfo = nlp.chain
    dev = it.x.device
    seeds = _seeds(info, "h", it.x)

    def one(x1, yc, yd, lane):
        glag = grad(lambda xx: nlp.lag1(xx, yc, yd, lane))
        return vmap(lambda sv: jvp(glag, (x1,), (sv,))[1])(seeds).T

    Hcomp = vmap(one)(it.x, it.y_c, it.y_d, nlp.lane())
    r = info.tensor("h_rows", dev)
    c = info.tensor("h_colors", dev)[info.tensor("h_cols", dev)]
    return Hcomp[:, r, c]


# ---------------------------------------------------------------------------
# Assembly, factorization, solve (the backend contract of step.py)
# ---------------------------------------------------------------------------

def assemble_banded(nlp: CanonicalNLP, it: Iterate, j_vals, h_vals, delta_x, delta_c):
    """The value vector gathered into BTD block arrays (B, nb, b, b):
    duplicates summed through ``asm_src`` (Kdup columns, padding reads an
    appended 0), then one gather through ``asm_inv`` (empty slots read an
    appended 0).  ``delta_x`` and ``delta_c`` are per-lane (B,) tensors."""
    from .kkt import sigmas
    from .linalg.block_tridiag import BTDMatrix
    info: BandedInfo = nlp.chain
    x = it.x
    Bt, dtype, dev = x.shape[0], x.dtype, x.device
    sig = sigmas(nlp, it)
    zero = torch.zeros((), dtype=dtype, device=dev)
    dx, dc = delta_x[:, None], delta_c[:, None]

    vals = []
    if len(info.h_rows):
        vals.append(torch.where(info.tensor("h_keep", dev), h_vals, zero))
    if len(info.j_rows):
        vals.append(j_vals)
        vals.append(torch.where(info.tensor("j_mirror", dev), j_vals, zero))
    vals.append(sig.sigma_x + dx)
    if info.mi:
        vals.append(sig.sigma_s + dx)
        mones = x.new_full((Bt, info.mi), -1.0)
        vals.append(mones)
        vals.append(torch.where(info.tensor("s_mirror", dev), mones, zero))
    vals.append((-dc).expand(Bt, info.me + info.mi))
    if info.n_pad:
        vals.append(x.new_ones((Bt, info.n_pad)))
    vals.append(x.new_zeros((Bt, 1)))
    v_ext = torch.cat(vals, -1)
    slot_vals = v_ext[:, info.tensor("asm_src", dev)].sum(-1)
    slot_ext = torch.cat([slot_vals, x.new_zeros((Bt, 1))], -1)
    both = slot_ext[:, info.tensor("asm_inv", dev)].reshape(Bt, 2, info.nb, info.b, info.b)
    return BTDMatrix(diag=both[:, 0], sub=both[:, 1])


def add_diag_deltas(nlp: CanonicalNLP, Kb, delta_x, delta_c):
    """Re-add (delta_x, -delta_c) on the diagonal of a zero-delta assembly,
    so the retry loop re-regularizes without re-assembling."""
    from .linalg.block_tridiag import BTDMatrix
    info: BandedInfo = nlp.chain
    kind = info.tensor("diag_kind", Kb.diag.device)[None]          # (1, nb, b)
    zero = torch.zeros((), dtype=Kb.diag.dtype, device=Kb.diag.device)
    add = torch.where(kind == 0, delta_x[:, None, None],
                      torch.where(kind == 1, -delta_c[:, None, None], zero))
    eye_b = torch.eye(info.b, dtype=Kb.diag.dtype, device=Kb.diag.device)
    return BTDMatrix(diag=Kb.diag + add[..., None] * eye_b, sub=Kb.sub)


def expected_inertia_banded(nlp: CanonicalNLP):
    info: BandedInfo = nlp.chain
    return info.n + info.mi + info.n_pad, info.me + info.mi


class BandedFactorResult(NamedTuple):
    fac: Any
    K: Any
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any


def banded_factorize_kkt(nlp: CanonicalNLP, opts: Options, it: Iterate, h_vals, mu,
                         delta_w_last, delta_cd_override=None) -> BandedFactorResult:
    """Inertia-corrected banded factorization, the reference's schedule
    (``ipopt_tpu/sparse.py:800-876``): one zero-delta assembly, the deltas
    re-added per trial, and delta_c escalated on every failed round (x100,
    at most 1e-2): under an RCM ordering a y-row can be eliminated before
    its x partners, and a larger dual regularization restores quasi-definite
    conditioning where the elimination lost the -delta_c pivots.
    ``delta_cd_override`` (B,) replaces the mu-based regularization value
    (the cg-penalty method's); the floor stays."""
    from .linalg.block_tridiag import bcr_factorize, btd_cast
    exp_pos, exp_neg = expected_inertia_banded(nlp)
    j_vals = jacobian_values(nlp, it.x)
    zero = torch.zeros_like(mu)
    with span("kkt.assemble"):
        K_base = assemble_banded(nlp, it, j_vals, h_vals, zero, zero)

    def factor(dxv, dcv):
        Kb = add_diag_deltas(nlp, K_base, dxv, dcv)
        fac = bcr_factorize(btd_cast(Kb, opts.factorization_dtype),
                            pivot_tol=opts.ldlt_pivot_tol,
                            equilibrate=opts.linear_system_scaling == "mc19")
        ok = (fac.num_pos == exp_pos) & (fac.num_neg == exp_neg) & ~fac.singular
        return Kb, fac, ok

    return _retry_schedule(opts, factor, mu, delta_w_last, delta_cd_override)


def _retry_schedule(opts: Options, factor, mu, delta_w_last, delta_cd_override):
    """The inertia-correction retry loop of the banded and multifrontal
    backends (``sparse.py:800-876, 909-978``) around ``factor(delta_x,
    delta_c) -> (K, fac, ok)``.  Both backends carry one lane
    (``canonicalize_sparse`` builds one, ``batch.solve_batched`` refuses
    them), so a trial replaces the previous one: its K and factor are
    dropped before the next trial is factored, as the reference's loop
    carries only one."""
    from .algorithm.step import perturbation_start
    assert mu.numel() == 1, "the banded and multifrontal backends carry one lane"
    base_cd = (delta_cd_override if delta_cd_override is not None
               else opts.jacobian_regularization_value
               * mu ** opts.jacobian_regularization_exponent)
    delta_cd = torch.clamp(base_cd, min=opts.jacobian_regularization_value)
    dxv, dcv = torch.zeros_like(mu), delta_cd
    with span("kkt.factorize"):
        Kb, fac, ok = factor(dxv, dcv)
    trials = torch.ones(mu.shape, dtype=torch.int64, device=mu.device)
    gave_up = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    while host_bool((~(ok | gave_up) & (trials < opts.max_inertia_correction_rounds)).any()):
        only_dc = fac.singular & (dcv <= delta_cd)
        new_dc = torch.clamp(torch.maximum(dcv * 100.0, delta_cd), max=1e-2)
        start_val, inc_fact = perturbation_start(opts, delta_w_last)
        bumped = torch.where(dxv == 0, start_val, dxv * inc_fact)
        dxv = torch.where(only_dc, dxv, bumped)
        dcv = new_dc
        gave_up = dxv > opts.max_hessian_perturbation
        Kb = fac = None
        with span("kkt.factorize"):
            Kb, fac, ok = factor(dxv, dcv)
        trials = trials + 1

    new_last = torch.where(dxv > 0, dxv, delta_w_last)
    return BandedFactorResult(fac=fac, K=Kb, delta_x=dxv, delta_c=dcv,
                              delta_w_last=new_last, failed=~ok, num_trials=trials)


def pack_rhs_banded(nlp: CanonicalNLP, r_x, r_s, r_c, r_d):
    """[x | s | y_c | y_d] right-hand sides (B, .) -> the permuted, padded
    layout (B, nb b)."""
    info: BandedInfo = nlp.chain
    rhs = torch.cat([r_x, r_s, r_c, r_d], -1)[:, info.tensor("perm", r_x.device)]
    if info.n_pad:
        rhs = torch.cat([rhs, rhs.new_zeros((rhs.shape[0], info.n_pad))], -1)
    return rhs


def unpack_sol_banded(nlp: CanonicalNLP, sol):
    """Inverse of ``pack_rhs_banded``: -> (dx, ds, dy_c, dy_d)."""
    info: BandedInfo = nlp.chain
    n, mi, me = info.n, info.mi, info.me
    out = sol.new_empty((sol.shape[0], info.N))
    out[:, info.tensor("perm", sol.device)] = sol[:, :info.N]
    return (out[:, :n], out[:, n:n + mi], out[:, n + mi:n + mi + me],
            out[:, n + mi + me:])


# ---------------------------------------------------------------------------
# The nested-dissection multifrontal backend (``linear_solver=
# "multifrontal"``, ``sparse.py:909-991``): the banded backend's contract on
# the fronts of ``linalg/nested_dissection.py``
# ---------------------------------------------------------------------------

def nd_factorize_kkt(nlp: CanonicalNLP, opts: Options, it: Iterate, h_vals, mu,
                     delta_w_last, delta_cd_override=None) -> BandedFactorResult:
    """Inertia-corrected multifrontal factorization: one zero-delta assembly,
    the deltas re-added per trial, the banded backend's schedule."""
    from .linalg.nested_dissection import (nd_aux, nd_assemble,
                                           nd_add_diag_deltas, nd_factorize)
    info = nlp.chain
    aux = nd_aux(info, it.x.device)
    exp_pos, exp_neg = info.n + info.mi, info.me + info.mi
    j_vals = jacobian_values(nlp, it.x)
    zero = torch.zeros_like(mu)
    with span("kkt.assemble"):
        K_base = nd_assemble(nlp, aux, info, it, j_vals, h_vals, zero, zero)

    def factor(dxv, dcv):
        Kf = nd_add_diag_deltas(info, aux, K_base, dxv, dcv)
        fd = opts.factorization_dtype
        # the fronts factored in factorization_dtype (sparse.py:931-935)
        fac = nd_factorize(info, aux, tuple(F.to(torch_dtype(fd)) for F in Kf)
                           if fd else Kf, pivot_tol=opts.ldlt_pivot_tol)
        ok = (fac.num_pos == exp_pos) & (fac.num_neg == exp_neg) & ~fac.singular
        return Kf, fac, ok

    return _retry_schedule(opts, factor, mu, delta_w_last, delta_cd_override)


def nd_solve_parts(nlp: CanonicalNLP, opts: Options, fac, K, parts):
    """The four right-hand-side blocks [x | s | y_c | y_d] (the unknowns'
    own order: no permutation) solved and refined; split back."""
    from .linalg.nested_dissection import nd_aux, nd_solve_refined
    info = nlp.chain
    rhs = torch.cat(parts, -1)
    sol, rr = nd_solve_refined(info, nd_aux(info, rhs.device), K, fac, rhs, opts)
    n, mi, me = info.n, info.mi, info.me
    return (sol[:, :n], sol[:, n:n + mi], sol[:, n + mi:n + mi + me],
            sol[:, n + mi + me:]), rr
