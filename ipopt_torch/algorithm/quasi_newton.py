"""Limited-memory quasi-Newton (L-BFGS / SR1) Hessian approximation, over a
batch (port of ``ipopt_tpu/algorithm/quasi_newton.py``;
``LimMemQuasiNewtonUpdater``, ``IpLimMemQuasiNewtonUpdater.hpp:81-310``):

- pairs s_k = x_{k+1} - x_k and y_k = grad_x L(x_{k+1}, lambda_{k+1}) -
  grad_x L(x_k, lambda_{k+1}) (the same multipliers on both gradients);
- the skipping rule (CheckSkippingBFGS) and the history reset;
- the initial diagonal sigma (``limited_memory_initialization``);
- the compact representation B = sigma I - U M^{-1} U^T.

Batch-first: every lane keeps its own history, a fixed-size ring buffer S, Y
(B, n, hist) with per-lane ``count``, ``head``, ``sigma`` and ``skips`` (B,);
every operation is masked per lane for a partly filled history.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..types import tree_where


class LBFGSState(NamedTuple):
    S: Any       # (B, n, hist) step history (ring buffer)
    Y: Any       # (B, n, hist) gradient-difference history
    count: Any   # (B,) number of valid pairs (<= hist)
    head: Any    # (B,) ring position of the next write
    sigma: Any   # (B,) current initial-diagonal scale
    skips: Any   # (B,) consecutive skipped updates


def lbfgs_init(batch: int, n: int, hist: int, dtype, device,
               init_val=1.0) -> LBFGSState:
    zi = torch.zeros((batch,), dtype=torch.int64, device=device)
    return LBFGSState(
        S=torch.zeros((batch, n, hist), dtype=dtype, device=device),
        Y=torch.zeros((batch, n, hist), dtype=dtype, device=device),
        count=zi, head=zi,
        sigma=torch.full((batch,), float(init_val), dtype=dtype, device=device),
        skips=zi)


def _dot(a, b):
    return (a * b).sum(-1)


def lbfgs_update(st: LBFGSState, s, y, opts) -> LBFGSState:
    """Insert the pair (s, y) (B, n) of every lane with Ipopt's skipping
    rule (``quasi_newton.py:52-134``).  BFGS skips when s^T y <= sqrt(eps)
    ||s|| ||y||; SR1 only when |s^T y| is that small.  The pair is stored
    normalized by 1/||s|| (B is invariant under it).  sigma follows
    ``limited_memory_initialization`` (scalar1 = s'y/s's, scalar2 =
    y'y/s'y, scalar3 their mean, scalar4 their geometric mean, constant),
    clipped to [limited_memory_init_val_min, limited_memory_init_val_max].
    ``limited_memory_max_skipping`` consecutive skips reset the history
    (sigma kept)."""
    B, n, hist = st.S.shape
    sty = _dot(s, y)
    s_norm = torch.sqrt(_dot(s, s))
    y_norm = torch.sqrt(_dot(y, y))
    eps = torch.finfo(s.dtype).eps
    sr1 = opts.limited_memory_update_type == "sr1"
    thresh = eps ** 0.5 * s_norm * y_norm
    skip = (sty.abs() <= thresh) if sr1 else (sty <= thresh)

    one = torch.ones_like(s_norm)
    inv_sn = torch.where(s_norm > 0, 1.0 / torch.clamp(s_norm, min=1e-300), one)
    slot = (torch.arange(hist, device=s.device) == st.head[:, None])[:, None, :]
    S_new = torch.where(slot, (s * inv_sn[:, None])[:, :, None], st.S)
    Y_new = torch.where(slot, (y * inv_sn[:, None])[:, :, None], st.Y)
    s1 = sty / torch.clamp(_dot(s, s), min=1e-300)
    s2 = _dot(y, y) / torch.where(sty.abs() > 0, sty, torch.full_like(sty, 1e-300))
    if sr1:
        # the SR1 B0 stays positive for negative-curvature pairs
        # (IpLimMemQuasiNewtonUpdater.cpp:544-546)
        s1, s2 = s1.abs(), s2.abs()
    strat = opts.limited_memory_initialization
    if strat == "constant":
        sigma_raw = torch.full_like(s1, opts.limited_memory_init_val)
    elif strat == "scalar2":
        sigma_raw = s2
    elif strat == "scalar3":
        sigma_raw = 0.5 * (s1 + s2)
    elif strat == "scalar4":
        sigma_raw = torch.sqrt(torch.clamp(s1 * s2, min=0.0))
    else:  # "scalar1" (default)
        sigma_raw = s1
    sigma_raw = torch.where(s_norm > 0, sigma_raw, st.sigma)
    sigma_new = torch.clamp(sigma_raw, opts.limited_memory_init_val_min,
                            opts.limited_memory_init_val_max)

    skips_new = torch.where(skip, st.skips + 1, torch.zeros_like(st.skips))
    reset = skips_new >= opts.limited_memory_max_skipping
    out = tree_where(skip,
                     LBFGSState(st.S, st.Y, st.count, st.head, st.sigma, skips_new),
                     LBFGSState(S_new, Y_new, torch.clamp(st.count + 1, max=hist),
                                (st.head + 1) % max(hist, 1), sigma_new, skips_new))
    # a full reset after too many skips (the updater resets B), sigma kept
    fresh = lbfgs_init(B, n, hist, st.S.dtype, st.S.device)._replace(sigma=out.sigma)
    return tree_where(reset, fresh, out)


class LowRankW(NamedTuple):
    """Compact (diagonal + low-rank) L-BFGS Hessian B = sigma I - U M^{-1}
    U^T of every lane (``LowRankUpdateSymMatrix``).  Invalid history slots
    are masked: their U columns are zero and M is the identity there, so the
    padding adds the same (+1, 0) inertia to M and to the SMW matrix
    C = M - U^T K0^{-1} U."""
    sigma: Any   # (B,)
    U: Any       # (B, n, 2k) masked low-rank factor (k columns for SR1)
    M: Any       # (B, 2k, 2k) masked middle matrix


def lbfgs_compact(st: LBFGSState, opts=None) -> LowRankW:
    """The compact form with ring-buffer masking (``quasi_newton.py:154-
    185``).  BFGS (Byrd-Nocedal-Schnabel): U = [sigma S, Y], M = [[sigma
    S'S, L], [L', -D]].  SR1: U = Y - sigma S, M = -(D + L + L' - sigma S'S)
    + sqrt(eps) I."""
    B, n, hist = st.S.shape
    dtype, dev = st.S.dtype, st.S.device
    sr1 = opts is not None and opts.limited_memory_update_type == "sr1"
    idx = torch.arange(hist, device=dev)
    # slot i is valid if written within the last `count` writes; offset
    # orders the slots chronologically
    offset = (idx[None, :] - (st.head - st.count)[:, None]) % max(hist, 1)
    valid = offset < st.count[:, None]                       # (B, hist)
    zero = torch.zeros((), dtype=dtype, device=dev)
    S = torch.where(valid[:, None, :], st.S, zero)
    Y = torch.where(valid[:, None, :], st.Y, zero)
    sig = st.sigma[:, None, None]
    StS = torch.matmul(S.transpose(-1, -2), S)
    StY = torch.matmul(S.transpose(-1, -2), Y)
    D = torch.diagonal(StY, dim1=-2, dim2=-1)
    older = offset[:, :, None] > offset[:, None, :]
    L = torch.where(older, StY, zero)

    if sr1:
        eye = torch.eye(hist, dtype=dtype, device=dev)
        Z = torch.diag_embed(D) + L + L.transpose(-1, -2) - sig * StS
        M = -Z + torch.finfo(dtype).eps ** 0.5 * eye
        M = torch.where(valid[:, :, None] & valid[:, None, :], M, eye)
        U = torch.where(valid[:, None, :], Y - sig * S, zero)
        return LowRankW(sigma=st.sigma, U=U, M=M)

    M = torch.cat([torch.cat([sig * StS, L], -1),
                   torch.cat([L.transpose(-1, -2), -torch.diag_embed(D)], -1)], -2)
    vmask = torch.cat([valid, valid], -1)
    eye2 = torch.eye(2 * hist, dtype=dtype, device=dev)
    M = torch.where(vmask[:, :, None] & vmask[:, None, :], M, eye2)
    U = torch.cat([sig * S, Y], -1)
    return LowRankW(sigma=st.sigma, U=U, M=M)


def lbfgs_dense_W(st: LBFGSState, opts=None, nl_mask=None):
    """The dense B = sigma I - U M^{-1} U^T (B, n, n) of every lane.  M is
    symmetric indefinite, and its leading block is singular for collinear
    pairs, so it is solved by pivoted LU (``torch.linalg.solve``), as the
    reference does.  ``nl_mask`` (n,) (num_linear_variables with
    hessian_approximation_space="nonlinear-variables") puts sigma on the
    nonlinear variables' diagonal only."""
    return dense_from_compact(lbfgs_compact(st, opts), nl_mask)


def dense_from_compact(lr: LowRankW, nl_mask=None):
    """sigma I (or sigma diag(nl_mask)) - U M^{-1} U^T per lane."""
    U = lr.U
    Minv_Ut = torch.linalg.solve(lr.M, U.transpose(-1, -2))
    diag = torch.ones((U.shape[1],), dtype=U.dtype, device=U.device)
    if nl_mask is not None:
        diag = nl_mask.to(U.dtype)
    return (lr.sigma[:, None, None] * torch.diag_embed(diag)
            - torch.matmul(U, Minv_Ut))
