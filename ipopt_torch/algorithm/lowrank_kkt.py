"""Sherman-Morrison-Woodbury augmented-system solver for limited-memory
Hessians on the dense backend, over a batch (port of
``ipopt_tpu/algorithm/lowrank_kkt.py``; ``LowRankAugSystemSolver``,
``IpLowRankAugSystemSolver.cpp``).

With W = sigma I - U M^{-1} U^T the augmented matrix is

    K = K0 - Utilde M^{-1} Utilde^T,      Utilde = [U; 0; 0; 0],

and K0 (W replaced by sigma I) has a diagonal (x, x) block h and a diagonal
(s, s) block, so it condenses exactly onto the constraint rows: the
(me + mi) Schur complement S = J h^{-1} J^T + diag(delta_c, D_s^{-1} +
delta_d), factored by ``linalg/ldlt.ldlt`` (K1 on the card).  The inertia
is exact by Haynsworth, In(K) = In(K0) + In(C) - In(M) with C = M - Utilde^T
K0^{-1} Utilde: K has the wanted inertia iff S is positive definite and
In(C) = In(M).  C and M (2k x 2k) are counted by eigendecomposition, as in
the reference (robust where an unpivoted LDL^T of an indefinite matrix
breaks down).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import Iterate, max_init, tree_where
from ..problem import CanonicalNLP
from ..options import Options
from ..profiling import host_bool
from ..kkt import Evals, sigmas
from ..linalg.ldlt import ldlt, ldlt_solve, LDLTResult
from .quasi_newton import LowRankW
from .step import refine, perturbation_start


def _mm(A, B):
    return torch.matmul(A, B)


def _t(M):
    return M.transpose(-1, -2)


class LowRankKKT(NamedTuple):
    """The factorization of every lane; plays (fac, K) for ``solve_any``."""
    h: Any          # (B, n) diagonal of the base (x, x) block
    dsd: Any        # (B, mi) diagonal of the base (s, s) block
    J_c: Any        # (B, me, n)
    J_d: Any        # (B, mi, n)
    delta_c: Any    # (B,)
    delta_d: Any    # (B,)
    S_fac: LDLTResult  # LDL^T of the condensed Schur complement
    U: Any          # (B, n, 2k)
    M: Any          # (B, 2k, 2k)
    Cw: Any         # (B, 2k) eigenvalues of C = M - U^T Zx
    CV: Any         # (B, 2k, 2k) eigenvectors of C
    smw_singular: Any
    Zx: Any         # (B, n, 2k) x-rows of K0^{-1} Utilde
    Zs: Any
    Zyc: Any
    Zyd: Any


class LowRankFactorResult(NamedTuple):
    fac: LowRankKKT
    K: Any          # None: the matrix products live in the factorization
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any


def _base_solve(h, dsd, J_c, J_d, S_fac, r_x, r_s, r_c, r_d):
    """Solve K0 w = r by condensation onto the constraint rows
    (``lowrank_kkt.py:86-114``): dx = h^{-1} (r_x - J^T dy) and ds =
    dsd^{-1} (r_s + dy_d) leave S [dy_c; dy_d] = [J_c h^{-1} r_x - r_c;
    J_d h^{-1} r_x - dsd^{-1} r_s - r_d].  The right-hand sides are (B, .)
    or carry a trailing axis of k columns (B, ., k)."""
    vec = r_x.dim() == 2
    if vec:
        r_x, r_s, r_c, r_d = (r[..., None] for r in (r_x, r_s, r_c, r_d))
    hinv_rx = r_x / h[..., None]
    dsinv_rs = r_s / dsd[..., None]
    rhs_m = torch.cat([_mm(J_c, hinv_rx) - r_c,
                       _mm(J_d, hinv_rx) - dsinv_rs - r_d], 1)
    y = ldlt_solve(S_fac, rhs_m)
    me = J_c.shape[1]
    dy_c, dy_d = y[:, :me], y[:, me:]
    dx = hinv_rx - (_mm(_t(J_c), dy_c) + _mm(_t(J_d), dy_d)) / h[..., None]
    ds = dsinv_rs + dy_d / dsd[..., None]
    out = (dx, ds, dy_c, dy_d)
    return tuple(v[..., 0] for v in out) if vec else out


def _schur_matrix(h, dsd, J_c, J_d, delta_c, delta_d):
    """S = [[J_c h^-1 J_c^T + delta_c I, J_c h^-1 J_d^T],
            [.., J_d h^-1 J_d^T + diag(1/dsd) + delta_d I]] per lane."""
    me, mi = J_c.shape[1], J_d.shape[1]
    Jh_c = J_c / h[:, None, :]
    Jh_d = J_d / h[:, None, :]
    eye_c = torch.eye(me, dtype=h.dtype, device=h.device)
    eye_d = torch.eye(mi, dtype=h.dtype, device=h.device)
    S_cc = _mm(Jh_c, _t(J_c)) + delta_c[:, None, None] * eye_c
    S_cd = _mm(Jh_c, _t(J_d))
    S_dd = (_mm(Jh_d, _t(J_d)) + torch.diag_embed(1.0 / dsd)
            + delta_d[:, None, None] * eye_d)
    return torch.cat([torch.cat([S_cc, S_cd], -1),
                      torch.cat([_t(S_cd), S_dd], -1)], -2)


def smw_inertia(C, M):
    """(eigenvalues, eigenvectors of C, singular, ok) per lane: the
    Haynsworth test In(C) = In(M) with C nonsingular.  Both are symmetrized
    first (``jnp.linalg.eigh`` symmetrizes its input by default).  A lane
    whose C is not finite (a failed base factorization) gets NaN
    eigenpairs, which count as neither sign, so it is singular, as in the
    reference (LAPACK's eigh would refuse it)."""
    finite = torch.isfinite(C).all(-1).all(-1)[:, None]
    zero = torch.zeros((), dtype=C.dtype, device=C.device)
    nan = torch.full((), float("nan"), dtype=C.dtype, device=C.device)
    Cw, CV = torch.linalg.eigh(torch.where(finite[..., None], 0.5 * (C + _t(C)),
                                           zero))
    Cw = torch.where(finite, Cw, nan)
    CV = torch.where(finite[..., None], CV, nan)
    Mw = torch.linalg.eigvalsh(0.5 * (M + _t(M)))
    eps = torch.finfo(C.dtype).eps
    twok = C.shape[-1]

    def counts(w):
        tol = eps * torch.clamp(max_init(w.abs(), 0.0), min=1.0)[:, None]
        return (w > tol).sum(-1), (w < -tol).sum(-1)

    c_pos, c_neg = counts(Cw)
    m_pos, m_neg = counts(Mw)
    singular = c_pos + c_neg < twok
    ok = (c_pos == m_pos) & (c_neg == m_neg) & ~singular
    return Cw, CV, singular, ok


def lowrank_factorize_kkt(nlp: CanonicalNLP, opts: Options, it: Iterate,
                          ev: Evals, lrw: LowRankW, mu,
                          delta_w_last) -> LowRankFactorResult:
    """Factorize the low-rank augmented system of every lane with the dense
    path's inertia-correction retry loop (``lowrank_kkt.py:129-235``)."""
    mi, me = nlp.mi, nlp.me
    dtype = it.x.dtype
    sig = sigmas(nlp, it)
    m = me + mi
    B, n, twok = lrw.U.shape
    delta_cd = (opts.jacobian_regularization_value
                * mu ** opts.jacobian_regularization_exponent)

    def factor(delta_x, delta_c):
        h = lrw.sigma[:, None] + sig.sigma_x + delta_x[:, None]
        # delta_s = delta_x; the condensation needs dsd > 0
        dsd = torch.clamp(sig.sigma_s + delta_x[:, None],
                          min=torch.finfo(dtype).tiny ** 0.5)
        S_fac = ldlt(_schur_matrix(h, dsd, ev.J_c, ev.J_d, delta_c, delta_c),
                     pivot_tol=opts.ldlt_pivot_tol)
        base_ok = (S_fac.num_pos == m) & ~S_fac.singular
        zs = lrw.U.new_zeros((B, mi, twok))
        Zx, Zs, Zyc, Zyd = _base_solve(h, dsd, ev.J_c, ev.J_d, S_fac, lrw.U,
                                       zs, lrw.U.new_zeros((B, me, twok)), zs)
        C = lrw.M - _mm(_t(lrw.U), Zx)
        Cw, CV, smw_singular, smw_ok = smw_inertia(C, lrw.M)
        fac = LowRankKKT(h=h, dsd=dsd, J_c=ev.J_c, J_d=ev.J_d, delta_c=delta_c,
                         delta_d=delta_c, S_fac=S_fac, U=lrw.U, M=lrw.M, Cw=Cw,
                         CV=CV, smw_singular=smw_singular,
                         Zx=Zx, Zs=Zs, Zyc=Zyc, Zyd=Zyd)
        return fac, base_ok & smw_ok

    zero = torch.zeros_like(mu)
    delta_x = zero
    delta_c = delta_cd if opts.perturb_always_cd else zero
    fac, ok = factor(delta_x, delta_c)
    trials = torch.ones(mu.shape, dtype=torch.int64, device=mu.device)
    gave_up = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    while True:
        active = ~(ok | gave_up) & (trials < opts.max_inertia_correction_rounds)
        if not host_bool(active.any()):
            break
        was_singular = fac.S_fac.singular | fac.smw_singular
        only_dc = was_singular & (delta_c == 0)
        new_delta_c = torch.where(was_singular | (delta_c > 0),
                                  torch.maximum(delta_c, delta_cd), delta_c)
        start_val, inc_fact = perturbation_start(opts, delta_w_last)
        bumped = torch.where(delta_x == 0, start_val, delta_x * inc_fact)
        new_delta_x = torch.where(only_dc, delta_x, bumped)
        new_gave_up = new_delta_x > opts.max_hessian_perturbation
        fac2, ok2 = factor(new_delta_x, new_delta_c)
        trials, delta_x, delta_c, fac, ok, gave_up = tree_where(
            active, (trials + 1, new_delta_x, new_delta_c, fac2, ok2, new_gave_up),
            (trials, delta_x, delta_c, fac, ok, gave_up))

    new_delta_w_last = torch.where(delta_x > 0, delta_x, delta_w_last)
    return LowRankFactorResult(fac=fac, K=None, delta_x=delta_x, delta_c=delta_c,
                               delta_w_last=new_delta_w_last, failed=~ok,
                               num_trials=trials)


def lowrank_correction(U, M, dx):
    """U M^{-1} U^T dx per lane (pivoted LU: M is indefinite, and an
    unpivoted LDL^T can meet a zero pivot)."""
    t = torch.linalg.solve(M, _mm(_t(U), dx[..., None]))
    return _mm(U, t)[..., 0]


def lowrank_matvec(fac: LowRankKKT, dx, ds, dy_c, dy_d):
    """K v for the low-rank augmented system: only the x rows carry the
    correction (``lowrank_kkt.py:238-249``)."""
    r_x = (fac.h * dx + _mm(_t(fac.J_c), dy_c[..., None])[..., 0]
           + _mm(_t(fac.J_d), dy_d[..., None])[..., 0]
           - lowrank_correction(fac.U, fac.M, dx))
    r_s = fac.dsd * ds - dy_d
    r_c = _mm(fac.J_c, dx[..., None])[..., 0] - fac.delta_c[:, None] * dy_c
    r_d = _mm(fac.J_d, dx[..., None])[..., 0] - ds - fac.delta_d[:, None] * dy_d
    return r_x, r_s, r_c, r_d


def smw_apply(fac, base_sol):
    """w = K0^{-1} r + Z C^{-1} U^T (K0^{-1} r)_x, with C^{-1} from its
    eigendecomposition (pivots below tiny become +-tiny)."""
    dx0, ds0, dyc0, dyd0 = base_sol
    t = _mm(_t(fac.CV), _mm(_t(fac.U), dx0[..., None]))[..., 0]
    tiny = torch.finfo(dx0.dtype).tiny
    Cw = fac.Cw
    safe_w = torch.where(Cw.abs() > tiny, Cw,
                         torch.where(Cw >= 0, torch.full_like(Cw, tiny),
                                     torch.full_like(Cw, -tiny)))
    w = _mm(fac.CV, (t / safe_w)[..., None])
    return (dx0 + _mm(fac.Zx, w)[..., 0], ds0 + _mm(fac.Zs, w)[..., 0],
            dyc0 + _mm(fac.Zyc, w)[..., 0], dyd0 + _mm(fac.Zyd, w)[..., 0])


def lowrank_solve_once(fac: LowRankKKT, r_x, r_s, r_c, r_d):
    """One SMW solve (``lowrank_kkt.py:252-264``)."""
    return smw_apply(fac, _base_solve(fac.h, fac.dsd, fac.J_c, fac.J_d,
                                      fac.S_fac, r_x, r_s, r_c, r_d))


def refine_parts(matvec4, solve4, parts, opts: Options):
    """Iterative refinement over the four right-hand-side blocks, the
    residual ratio taken over all of them (``lowrank_kkt.py:267-295``)."""
    sizes = [p.shape[-1] for p in parts]

    def split(v):
        return tuple(torch.split(v, sizes, -1))

    sol, rr = refine(lambda v: torch.cat(matvec4(split(v)), -1),
                     lambda v: torch.cat(solve4(split(v)), -1),
                     torch.cat(parts, -1), opts, improvement=False)
    return split(sol), rr


def lowrank_solve_refined(fac: LowRankKKT, parts, opts: Options):
    """SMW solve + iterative refinement on the exact corrected operator."""
    return refine_parts(lambda p: lowrank_matvec(fac, *p),
                        lambda p: lowrank_solve_once(fac, *p), parts, opts)
