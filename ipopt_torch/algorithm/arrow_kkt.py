"""Block-arrow augmented-KKT backend for scenario problems, over a batch
(port of ``ipopt_tpu/algorithm/arrow_kkt.py``).

The factorization inverts every scenario block at once and reduces onto the
shared variables by the Schur complement

    S = K_0 - sum_s C_s^T K_s^{-1} C_s.

The scenario blocks of every lane go through ``batched_block_ldlt_inv`` in
one call (K1 on the card, the reference's own call site of its Pallas
kernel), the Schur root through ``linalg/ldlt.ldlt`` (K1 with one block per
lane).  Inertia (Sylvester) = the scenario blocks' pivot signs + the root's.

The S scenarios are cut into one contiguous group per device of
``ArrowInfo.devices`` (``canonicalize_scenario(..., devices=)``; by default
one group on the shared block's device): each group's blocks are factored
(K1) and back-solved on its device, the groups' Schur terms and
right-hand-side reductions are copied to the shared block's device and
summed there (the reference's ``psum``, ``arrow_kkt.py:113-115, 140``), and
the inertia is the sum of the groups' counts and the root's.

Scenario block unknowns, bs = ns + 2 ms wide: [x_s (ns) | s_s (ms) | y_s
(ms)].  Equality rows have no slack: their s slot is a dummy (+1 diagonal,
no -I coupling, zero rhs), so the expected inertia is pos = n + mi + me,
neg = me + mi.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..problem import CanonicalNLP
from ..types import Iterate, contiguous_ranges
from ..options import Options
from ..kkt import sigmas
from ..linalg.ldlt import ldlt, ldlt_solve, LDLTResult
from ..linalg.block_tridiag import batched_block_ldlt_inv
from ..parallel.scenario import ArrowInfo, scatter_rows
from .step import refine, regularized_retry


def _mv(M, x):
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


class ArrowMatrix(NamedTuple):
    Ks: Any   # (B, S, bs, bs) scenario blocks
    Cs: Any   # (B, S, bs, n0) coupling blocks
    K0: Any   # (B, n0, n0) shared block

    def matvec(self, r0, rs):
        """(r0 (B, n0), rs (B, S, bs)) -> the same shapes."""
        out_s = _mv(self.Ks, rs) + _mv(self.Cs, r0[:, None, :])
        out_0 = _mv(self.K0, r0) + torch.einsum("bsji,bsj->bi", self.Cs, rs)
        return out_0, out_s


class ArrowFactor(NamedTuple):
    """Ainv, ds and Yc hold one tensor per scenario group (``groups``:
    ((lo, hi, device), ...)), each (B, hi - lo, ...) on its device."""

    Ainv: Any        # (B, S_g, bs, bs) explicit scenario-block inverses
    ds: Any          # (B, S_g, bs) pivots (inertia)
    Yc: Any          # (B, S_g, bs, n0) = K_s^{-1} C_s
    root: LDLTResult  # LDL^T of the Schur complement (B, n0, n0)
    num_pos: Any
    num_neg: Any
    num_zero: Any
    singular: Any
    groups: tuple


def assemble_arrow(nlp: CanonicalNLP, it: Iterate, Jblocks, Wblocks,
                   delta_x, delta_c) -> ArrowMatrix:
    """The arrow augmented matrices of every lane (``arrow_kkt.py:56-97``);
    the deltas are per-lane (B,) tensors."""
    ar: ArrowInfo = nlp.chain
    S, n0, ns, ms, bs = ar.S, ar.n0, ar.ns, ar.ms, ar.bs
    J0, Js = Jblocks
    W00, W0s, Wss = Wblocks
    x = it.x
    B = x.shape[0]
    dx = delta_x.reshape(B, 1, 1)
    sig = sigmas(nlp, it)
    sig_x0 = sig.sigma_x[:, :n0]
    sig_xs = sig.sigma_x[:, n0:].reshape(B, S, ns)
    sig_s = scatter_rows(nlp, x.new_zeros((B, nlp.struct.me)), sig.sigma_s)
    ineq_row = ar.ineq_row(x.device)[None, :, :, None]      # (1, S, ms, 1)
    eye_ns = torch.eye(ns, dtype=x.dtype, device=x.device)
    eye_ms = torch.eye(ms, dtype=x.dtype, device=x.device)

    Ks = x.new_zeros((B, S, bs, bs))
    Ks[:, :, :ns, :ns] = Wss + (sig_xs + dx)[..., :, None] * eye_ns
    Ks[:, :, ns:ns + ms, ns:ns + ms] = torch.where(
        ineq_row, (sig_s + dx)[..., :, None] * eye_ms, eye_ms)
    Ks[:, :, ns + ms:, ns + ms:] = (-delta_c).reshape(B, 1, 1, 1) * eye_ms
    Ks[:, :, ns + ms:, :ns] = Js
    Ks[:, :, :ns, ns + ms:] = Js.transpose(-1, -2)
    ys = torch.where(ineq_row, -eye_ms, torch.zeros_like(eye_ms))
    Ks[:, :, ns + ms:, ns:ns + ms] = ys
    Ks[:, :, ns:ns + ms, ns + ms:] = ys.transpose(-1, -2)

    Cs = x.new_zeros((B, S, bs, n0))
    Cs[:, :, :ns] = W0s
    Cs[:, :, ns + ms:] = J0
    K0 = W00 + torch.diag_embed(sig_x0 + delta_x[:, None])
    return ArrowMatrix(Ks=Ks, Cs=Cs, K0=K0)


def _block_counts(ds, pivot_tol):
    """Per-lane inertia of the scenario blocks' pivots ds (B, S, bs), the
    zero threshold scaled by each block's largest pivot (NaN pivots count
    nowhere, as in the reference)."""
    scale = torch.clamp(ds.abs().amax(-1, keepdim=True), min=1.0)
    base = pivot_tol if pivot_tol > 0 else torch.finfo(ds.dtype).eps
    is_zero = ds.abs() <= base * scale
    return ((~is_zero & (ds > 0)).sum((-1, -2)), (~is_zero & (ds < 0)).sum((-1, -2)),
            is_zero.sum((-1, -2)))


def _scenario_blocks(Ks, Cs, pivot_tol):
    """(ds, Ainv, Yc, counts, C^T K^-1 C) of scenario blocks Ks (B, S, bs, bs)
    coupled by Cs (B, S, bs, n0): one ``batched_block_ldlt_inv`` call."""
    B, S, bs, _ = Ks.shape
    ds, Ainv = batched_block_ldlt_inv(Ks.reshape(B * S, bs, bs))
    ds, Ainv = ds.reshape(B, S, bs), Ainv.reshape(B, S, bs, bs)
    Yc = torch.matmul(Ainv, Cs)
    return ds, Ainv, Yc, _block_counts(ds, pivot_tol), torch.einsum(
        "bsji,bsjk->bik", Cs, Yc)


def scenario_groups(S: int, devices):
    """((lo, hi, device), ...): S scenarios cut into one contiguous group per
    device (empty groups dropped)."""
    return tuple((lo, hi, torch.device(d))
                 for (lo, hi), d in zip(contiguous_ranges(S, len(devices)), devices)
                 if hi > lo)


def arrow_factorize(K: ArrowMatrix, pivot_tol: float = 0.0,
                    devices=()) -> ArrowFactor:
    """Scenario-block inverses, the Schur complement and its LDL^T, with the
    inertia of the whole arrow matrix (``arrow_kkt.py:99-125``), the
    scenarios in one group per entry of ``devices`` (default: one group on
    K's device; module docstring)."""
    dev0 = K.K0.device
    groups = scenario_groups(K.Ks.shape[1], devices or (dev0,))
    out, counts, schur = [], [], []
    for lo, hi, d in groups:
        ds, Ainv, Yc, c, CYC = _scenario_blocks(K.Ks[:, lo:hi].to(d),
                                                K.Cs[:, lo:hi].to(d), pivot_tol)
        out.append((Ainv, ds, Yc))
        counts.append([v.to(dev0) for v in c])
        schur.append(CYC.to(dev0))
    # the gather and sum of the groups' Schur terms on the shared block's
    # device
    root = ldlt(K.K0 - sum(schur), pivot_tol)
    pos, neg, zer = (sum(c[i] for c in counts) for i in range(3))
    num_zero = zer + root.num_zero
    Ainv, ds, Yc = (tuple(o[i] for o in out) for i in range(3))
    return ArrowFactor(Ainv=Ainv, ds=ds, Yc=Yc, root=root,
                       num_pos=pos + root.num_pos, num_neg=neg + root.num_neg,
                       num_zero=num_zero, singular=num_zero > 0, groups=groups)


def arrow_solve(fac: ArrowFactor, r0, rs):
    """Solve the arrow system: condense onto the shared block with the
    stored Yc (C_s^T K_s^{-1} r_s = Yc^T r_s), solve the root, then
    back-substitute per scenario with the explicit inverses.  r0 (B, n0)
    and rs (B, S, bs), or (B, n0, k) and (B, S, bs, k) for k right-hand
    sides over the one factorization."""
    vec = rs.dim() == 3
    R0, Rs = (r0[..., None], rs[..., None]) if vec else (r0, rs)
    Rg = [Rs[:, lo:hi].to(d) for lo, hi, d in fac.groups]
    rhs0 = R0 - sum(torch.einsum("bsji,bsjk->bik", Yc, R).to(R0.device)
                    for Yc, R in zip(fac.Yc, Rg))
    w0 = ldlt_solve(fac.root, rhs0)
    ws = torch.cat([(Ainv @ R - Yc @ w0.to(R.device)[:, None]).to(R0.device)
                    for Ainv, Yc, R in zip(fac.Ainv, fac.Yc, Rg)], 1)
    return (w0[..., 0], ws[..., 0]) if vec else (w0, ws)


def expected_inertia_arrow(nlp: CanonicalNLP):
    """All primal variables, the inequality slacks and the equality rows'
    dummy slacks positive; every constraint row negative."""
    s = nlp.struct
    return s.n + s.mi + s.me, s.me + s.mi


def pack_rhs_arrow(nlp: CanonicalNLP, r_x, r_s, r_c, r_d):
    """(B, n), (B, mi), (B, me), (B, mi) -> (r0 (B, n0), rs (B, S, bs))."""
    ar: ArrowInfo = nlp.chain
    S, n0, ns, ms = ar.S, ar.n0, ar.ns, ar.ms
    B = r_x.shape[0]
    rs = r_x.new_zeros((B, S, ar.bs))
    rs[:, :, :ns] = r_x[:, n0:].reshape(B, S, ns)
    rs[:, :, ns:ns + ms] = scatter_rows(nlp, r_c.new_zeros(r_c.shape), r_s)
    rs[:, :, ns + ms:] = scatter_rows(nlp, r_c, r_d)
    return r_x[:, :n0], rs


def unpack_sol_arrow(nlp: CanonicalNLP, w0, ws):
    """Inverse of ``pack_rhs_arrow``: -> (dx, ds, dy_c, dy_d)."""
    ar: ArrowInfo = nlp.chain
    ns, ms = ar.ns, ar.ms
    s, B, dev = nlp.struct, w0.shape[0], w0.device
    dx = torch.cat([w0, ws[:, :, :ns].reshape(B, -1)], -1)
    s_flat = ws[:, :, ns:ns + ms].reshape(B, -1)
    y_flat = ws[:, :, ns + ms:].reshape(B, -1)
    ii, ei = s.index("ineq_idx", dev), s.index("eq_idx", dev)
    return dx, s_flat[:, ii], y_flat[:, ei], y_flat[:, ii]


class ArrowFactorResult(NamedTuple):
    fac: ArrowFactor
    K: ArrowMatrix
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any


def arrow_factorize_kkt(nlp: CanonicalNLP, opts: Options, it: Iterate,
                        Jblocks, Wblocks, mu, delta_w_last,
                        delta_cd_override=None) -> ArrowFactorResult:
    """Inertia-corrected arrow factorization with the reference's schedule
    (``arrow_kkt.py:204-267``): always dual-regularized (delta_c floored at
    jacobian_regularization_value, escalating to at most 1e-4 on repeated
    singularity), as the chained backend.  A lane that is done keeps its
    factorization, matrix and deltas."""
    exp_pos, exp_neg = expected_inertia_arrow(nlp)
    base_cd = (delta_cd_override if delta_cd_override is not None
               else opts.jacobian_regularization_value
               * mu ** opts.jacobian_regularization_exponent)
    delta_cd = torch.clamp(base_cd, min=opts.jacobian_regularization_value)

    def factor(delta_x, delta_c):
        Ka = assemble_arrow(nlp, it, Jblocks, Wblocks, delta_x, delta_c)
        fac = arrow_factorize(Ka, pivot_tol=opts.ldlt_pivot_tol,
                              devices=nlp.chain.devices)
        ok = (fac.num_pos == exp_pos) & (fac.num_neg == exp_neg) & ~fac.singular
        return Ka, fac, ok

    Ka, fac, dxv, dcv, trials, ok, _ = regularized_retry(opts, factor, delta_cd,
                                                         delta_w_last)
    new_last = torch.where(dxv > 0, dxv, delta_w_last)
    return ArrowFactorResult(fac=fac, K=Ka, delta_x=dxv, delta_c=dcv,
                             delta_w_last=new_last, failed=~ok,
                             num_trials=trials)


def arrow_solve_refined(K: ArrowMatrix, fac: ArrowFactor, r0, rs, opts: Options):
    """Arrow solve + iterative refinement against the assembled matrices
    (``arrow_kkt.py:270-298``); returns ((w0, ws), residual ratio)."""
    B, S, bs = rs.shape
    n0 = r0.shape[1]

    def split(v):
        return v[:, :n0], v[:, n0:].reshape(B, S, bs)

    def flat(w0, ws):
        return torch.cat([w0, ws.reshape(B, -1)], -1)

    sol, rr = refine(lambda v: flat(*K.matvec(*split(v))),
                     lambda v: flat(*arrow_solve(fac, *split(v))),
                     flat(r0, rs), opts, improvement=False)
    return split(sol), rr
