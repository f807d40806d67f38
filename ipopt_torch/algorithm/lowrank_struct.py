"""Sherman-Morrison-Woodbury low-rank (L-BFGS) augmented systems over the
structured KKT backends, chained, arrow and banded, over a batch (port of
``ipopt_tpu/algorithm/lowrank_struct.py``).

``LowRankAugSystemSolver`` wraps whatever augmented-system solver the
builder picked (``IpAlgBuilder.cpp:568-628``); so does this module: the base
system K0 puts sigma I in place of W, which keeps every structure (diagonal
blocks only), the backend's own factorization takes K0, and K = K0 - Utilde
M^{-1} Utilde^T is solved by SMW with the Haynsworth inertia of
``lowrank_kkt.py``.  The 2k columns of Z = K0^{-1} Utilde are solved in
one base solve with a trailing column axis over each lane's one
factorization, as the reference vmaps the right-hand side over a shared
factor: nothing of the factorization is copied.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import Iterate
from ..problem import CanonicalNLP
from ..options import Options
from .quasi_newton import LowRankW
from .lowrank_kkt import (lowrank_correction, refine_parts, smw_apply,
                          smw_inertia)
from .step import regularized_retry


class StructLowRankKKT(NamedTuple):
    """The factorization of every lane; plays (fac) for ``solve_any``."""
    base_fac: Any
    base_K: Any
    U: Any       # (B, n, 2k)
    M: Any       # (B, 2k, 2k)
    Cw: Any      # eigenvalues of C = M - U^T Zx
    CV: Any
    smw_singular: Any
    Zx: Any      # (B, n, 2k) x-rows of K0^{-1} Utilde
    Zs: Any
    Zyc: Any
    Zyd: Any


class StructLowRankResult(NamedTuple):
    fac: StructLowRankKKT
    K: Any
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any


def _as_columns(t, k):
    """(B k, ...) with lane b's k right-hand sides in rows b k .. b k + k - 1
    -> (B, ..., k)."""
    return t.reshape(t.shape[0] // k, k, *t.shape[1:]).movedim(1, -1)


def _as_lanes(t):
    """Inverse of ``_as_columns``: (B, ..., k) -> (B k, ...)."""
    return t.movedim(-1, 1).reshape(t.shape[0] * t.shape[-1], *t.shape[1:-1])


def _base_solvers(nlp: CanonicalNLP):
    """(solve4(fac, parts), matvec4(K, parts), solve_many(fac, parts, k)) of
    the structured base system, from the static structure alone
    (``lowrank_struct.py:57-102``); ``solve_many`` takes k right-hand sides
    per lane as parts of B k rows (see ``_as_columns``)."""
    from .step import _backend
    be = _backend(nlp)
    if be == "arrow":
        from .arrow_kkt import arrow_solve, pack_rhs_arrow, unpack_sol_arrow

        def solve4(fac, parts):
            return unpack_sol_arrow(nlp, *arrow_solve(fac, *pack_rhs_arrow(nlp, *parts)))

        def matvec4(Ka, parts):
            return unpack_sol_arrow(nlp, *Ka.matvec(*pack_rhs_arrow(nlp, *parts)))

        def solve_many(fac, parts, k):
            r0, rs = pack_rhs_arrow(nlp, *parts)
            w0, ws = arrow_solve(fac, _as_columns(r0, k), _as_columns(rs, k))
            return unpack_sol_arrow(nlp, _as_lanes(w0), _as_lanes(ws))

        return solve4, matvec4, solve_many
    from ..linalg.block_tridiag import bcr_solve
    if be == "btd":
        from .chained_kkt import pack_rhs as pack, unpack_sol as unpack
    elif be == "banded":
        from ..sparse import pack_rhs_banded as pack, unpack_sol_banded as unpack
    else:
        raise ValueError(f"no structured base system for the {be} backend")

    def solve4(fac, parts):
        return unpack(nlp, bcr_solve(fac, pack(nlp, *parts)))

    def matvec4(Kb, parts):
        return unpack(nlp, Kb.matvec(pack(nlp, *parts)))

    def solve_many(fac, parts, k):
        return unpack(nlp, _as_lanes(bcr_solve(fac, _as_columns(pack(nlp, *parts), k))))

    return solve4, matvec4, solve_many


def _base_factor(nlp: CanonicalNLP, opts: Options, it: Iterate, sigma):
    """factor(delta_x, delta_c) -> (K, fac, ok) of the base system with
    W = sigma I (``lowrank_struct.py:105-183``); sigma is per lane (B,)."""
    from .step import _backend
    from ..linalg.block_tridiag import bcr_factorize
    be = _backend(nlp)
    x = it.x
    B, dtype, dev = x.shape[0], x.dtype, x.device
    mc19 = opts.linear_system_scaling == "mc19"
    sig = sigma[:, None, None, None]

    if be == "btd":
        from ..chained import stage_jacobians
        from .chained_kkt import assemble_btd, expected_inertia
        ch = nlp.chain
        AB = stage_jacobians(nlp, x)
        eye_v = torch.eye(ch.v, dtype=dtype, device=dev)
        W = (sig * eye_v).expand(B, ch.K + 1, ch.v, ch.v), x.new_zeros(
            (B, ch.K, ch.v, ch.v))
        exp_pos, exp_neg = expected_inertia(nlp)

        def assemble(dxv, dcv):
            return assemble_btd(nlp, it, AB, W, dxv, dcv)

        def factorize(K):
            return bcr_factorize(K, pivot_tol=opts.ldlt_pivot_tol, equilibrate=mc19)
    elif be == "arrow":
        from ..parallel.scenario import scenario_jacobians
        from .arrow_kkt import assemble_arrow, arrow_factorize, expected_inertia_arrow
        ar = nlp.chain
        Jb = scenario_jacobians(nlp, x)
        W = (sigma[:, None, None] * torch.eye(ar.n0, dtype=dtype, device=dev),
             x.new_zeros((B, ar.S, ar.ns, ar.n0)),
             (sig * torch.eye(ar.ns, dtype=dtype, device=dev)).expand(
                 B, ar.S, ar.ns, ar.ns))
        exp_pos, exp_neg = expected_inertia_arrow(nlp)

        def assemble(dxv, dcv):
            return assemble_arrow(nlp, it, Jb, W, dxv, dcv)

        def factorize(K):
            return arrow_factorize(K, pivot_tol=opts.ldlt_pivot_tol,
                                   devices=nlp.chain.devices)
    elif be == "banded":
        from ..sparse import assemble_banded, jacobian_values, expected_inertia_banded
        info = nlp.chain
        j_vals = jacobian_values(nlp, x)
        # sigma I on the x diagonal through the H pattern's diagonal entries
        h_diag = info.tensor("h_rows", dev) == info.tensor("h_cols", dev)
        h_vals = torch.where(h_diag[None, :], sigma[:, None],
                             torch.zeros((), dtype=dtype, device=dev))
        exp_pos, exp_neg = expected_inertia_banded(nlp)

        def assemble(dxv, dcv):
            return assemble_banded(nlp, it, j_vals, h_vals, dxv, dcv)

        def factorize(K):
            return bcr_factorize(K, pivot_tol=opts.ldlt_pivot_tol, equilibrate=mc19)
    else:
        raise ValueError(f"no structured base system for the {be} backend")

    def factor(dxv, dcv):
        K = assemble(dxv, dcv)
        fac = factorize(K)
        ok = (fac.num_pos == exp_pos) & (fac.num_neg == exp_neg) & ~fac.singular
        return K, fac, ok

    return factor


def _columns(fac, solve_many, U, mi, me):
    """Z = K0^{-1} [U; 0; 0; 0] (B, ., 2k): the 2k columns of every lane in
    one base solve over the lane's factorization."""
    B, n, twok = U.shape
    cols = _as_lanes(U)
    z_s = U.new_zeros((B * twok, mi))
    Z = solve_many(fac, (cols, z_s, U.new_zeros((B * twok, me)), z_s), twok)
    return tuple(_as_columns(z, twok) for z in Z)


def lowrank_struct_factorize(nlp: CanonicalNLP, opts: Options, it: Iterate,
                             lrw: LowRankW, mu, delta_w_last) -> StructLowRankResult:
    """Inertia-corrected SMW factorization on a structured backend
    (``lowrank_struct.py:186-278``), with the structured backends' schedule:
    delta_c floored at jacobian_regularization_value, escalating to at most
    1e-4 while either stage reports a singular matrix."""
    mi, me = nlp.mi, nlp.me
    factor = _base_factor(nlp, opts, it, lrw.sigma)
    _, _, solve_many = _base_solvers(nlp)
    delta_cd = torch.clamp(opts.jacobian_regularization_value
                           * mu ** opts.jacobian_regularization_exponent,
                           min=opts.jacobian_regularization_value)

    def full_factor(dxv, dcv):
        K, base_fac, base_ok = factor(dxv, dcv)
        Zx, Zs, Zyc, Zyd = _columns(base_fac, solve_many, lrw.U, mi, me)
        C = lrw.M - torch.matmul(lrw.U.transpose(-1, -2), Zx)
        Cw, CV, smw_singular, smw_ok = smw_inertia(C, lrw.M)
        fac = StructLowRankKKT(base_fac=base_fac, base_K=K, U=lrw.U, M=lrw.M,
                               Cw=Cw, CV=CV,
                               smw_singular=base_fac.singular | smw_singular,
                               Zx=Zx, Zs=Zs, Zyc=Zyc, Zyd=Zyd)
        return K, fac, base_ok & smw_ok

    K, fac, dxv, dcv, trials, ok, _ = regularized_retry(
        opts, full_factor, delta_cd, delta_w_last, singular=lambda f: f.smw_singular)
    new_last = torch.where(dxv > 0, dxv, delta_w_last)
    return StructLowRankResult(fac=fac, K=K, delta_x=dxv, delta_c=dcv,
                               delta_w_last=new_last, failed=~ok, num_trials=trials)


def lowrank_struct_solve_refined(nlp: CanonicalNLP, opts: Options,
                                 fac: StructLowRankKKT, parts):
    """SMW solve + iterative refinement on the exact corrected operator
    (``lowrank_struct.py:292-338``)."""
    solve4, matvec4, _ = _base_solvers(nlp)

    def matvec(sol):
        kx, ks, kc, kd = matvec4(fac.base_K, sol)
        return kx - lowrank_correction(fac.U, fac.M, sol[0]), ks, kc, kd

    return refine_parts(matvec, lambda p: smw_apply(fac, solve4(fac.base_fac, p)),
                        parts, opts)
