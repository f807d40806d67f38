"""Block-tridiagonal augmented-KKT backend for chained problems, over a batch
(port of ``ipopt_tpu/algorithm/chained_kkt.py``).

The augmented system of every lane is assembled straight into a
``BTDMatrix`` and factorized by block cyclic reduction (K2 on every level).
Stage-block unknown ordering (block k of K+1 blocks, size bs = v + 2 mk):

    [ x_k (v) | s_k (mk) | y_k (mk) ]

    diag_k = [[W_kk + Sig_x + dx I,        0,         A_k^T ],
              [        0,          Sig_s + dx I_m,    -I_m  ],
              [       A_k,              -I_m,        -dc I  ]]
    sub_k (rows block k+1, cols block k)
           = [[W_{k+1,k}, 0, B_k^T], [0,0,0], [0,0,0]]

Equality rows have no slack: their s slot is a dummy (+1 diagonal, no -I
coupling, zero rhs).  The terminal block K has only x_K; its s/y slots are
dummies.  So the expected inertia is pos = n + mi + (me + 2 mk),
neg = me + mi.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..problem import CanonicalNLP
from ..types import Iterate
from ..options import Options
from ..kkt import sigmas
from ..linalg.block_tridiag import (BTDMatrix, BCRFactor, bcr_factorize, bcr_solve,
                                    btd_cast)
from ..chained import scatter_rows
from .step import refine, refine_dtypes, regularized_retry


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


def assemble_btd(nlp: CanonicalNLP, it: Iterate, AB, Wblocks,
                 delta_x, delta_c) -> BTDMatrix:
    """The BTD augmented matrices (B, K+1, bs, bs); the deltas are per-lane
    (B,) tensors."""
    ch = nlp.chain
    K, v, mk, bs = ch.K, ch.v, ch.mk, ch.bs
    A, Bm = AB
    Wd, Wo = Wblocks
    Bt = it.x.shape[0]
    x = it.x
    dx = delta_x.reshape(Bt, 1, 1)
    sig = sigmas(nlp, it)
    sigma_x = sig.sigma_x.reshape(Bt, K + 1, v)
    sigma_s = scatter_rows(nlp, x.new_zeros((Bt, nlp.struct.me)), sig.sigma_s)
    ineq_row = ch.ineq_row(x.device)[None, :, :, None]      # (1, K, mk, 1)
    eye_v, eye_m = _eye(v, x), _eye(mk, x)

    diag = x.new_zeros((Bt, K + 1, bs, bs))
    diag[:, :, :v, :v] = Wd + (sigma_x + dx)[..., :, None] * eye_v
    # s-s: Sig_s + delta_x on inequality rows, a +1 dummy on equality rows
    diag[:, :K, v:v + mk, v:v + mk] = torch.where(
        ineq_row, (sigma_s + dx)[..., :, None] * eye_m, eye_m)
    diag[:, :K, v + mk:, v + mk:] = (-delta_c).reshape(Bt, 1, 1, 1) * eye_m
    diag[:, :K, v + mk:, :v] = A
    diag[:, :K, :v, v + mk:] = A.transpose(-1, -2)
    ys = torch.where(ineq_row, -eye_m, torch.zeros_like(eye_m))
    diag[:, :K, v + mk:, v:v + mk] = ys
    diag[:, :K, v:v + mk, v + mk:] = ys.transpose(-1, -2)
    diag[:, K, v:, v:] = _eye(2 * mk, x)

    sub = x.new_zeros((Bt, K + 1, bs, bs))
    sub[:, :K, :v, :v] = Wo
    sub[:, :K, :v, v + mk:] = Bm.transpose(-1, -2)
    return BTDMatrix(diag=diag, sub=sub)


def pack_rhs(nlp: CanonicalNLP, r_x, r_s, r_c, r_d):
    """(B, n), (B, mi), (B, me), (B, mi) -> the stage layout (B, (K+1)*bs)."""
    ch = nlp.chain
    K, v, mk, bs = ch.K, ch.v, ch.mk, ch.bs
    Bt = r_x.shape[0]
    out = r_x.new_zeros((Bt, K + 1, bs))
    out[:, :, :v] = r_x.reshape(Bt, K + 1, v)
    out[:, :K, v:v + mk] = scatter_rows(nlp, r_c.new_zeros(r_c.shape), r_s)
    out[:, :K, v + mk:] = scatter_rows(nlp, r_c, r_d)
    return out.reshape(Bt, -1)


def unpack_sol(nlp: CanonicalNLP, sol):
    """Inverse of pack_rhs: -> (dx (B, n), ds (B, mi), dy_c (B, me),
    dy_d (B, mi))."""
    ch, s = nlp.chain, nlp.struct
    K, v, mk, bs = ch.K, ch.v, ch.mk, ch.bs
    Bt, dev = sol.shape[0], sol.device
    S = sol.reshape(Bt, K + 1, bs)
    dx = S[:, :, :v].reshape(Bt, -1)
    s_flat = S[:, :K, v:v + mk].reshape(Bt, -1)
    y_flat = S[:, :K, v + mk:].reshape(Bt, -1)
    ii, ei = s.index("ineq_idx", dev), s.index("eq_idx", dev)
    return dx, s_flat[:, ii], y_flat[:, ei], y_flat[:, ii]


def expected_inertia(nlp: CanonicalNLP):
    s = nlp.struct
    return s.n + s.mi + s.me + 2 * nlp.chain.mk, s.me + s.mi


def chain_diag_kind(nlp: CanonicalNLP) -> torch.Tensor:
    """(K+1, bs) int8 diagonal kinds, for re-adding the deltas without
    re-assembly (``chained_kkt.py:139-150``): 0 = x/s slot (+delta_x), 1 = y
    slot (-delta_c), 2 = dummy (+1, fixed)."""
    ch = nlp.chain
    K, v, mk = ch.K, ch.v, ch.mk
    kind = np.full((K + 1, ch.bs), 2, np.int8)
    kind[:, :v] = 0
    kind[:K, v:v + mk] = np.where(np.asarray(ch.eq_mask), 2, 0)
    kind[:K, v + mk:] = 1
    return torch.as_tensor(kind)


class ChainFactorResult(NamedTuple):
    fac: BCRFactor
    K: BTDMatrix             # the assembled matrices, for refinement
    delta_x: Any
    delta_c: Any
    delta_w_last: Any
    failed: Any
    num_trials: Any


def chained_factorize_kkt(nlp: CanonicalNLP, opts: Options, it: Iterate,
                          AB, Wblocks, mu, delta_w_last,
                          delta_cd_override=None) -> ChainFactorResult:
    """Inertia-corrected BTD factorization with the reference's own retry
    schedule (``chained_kkt.py:163-260``).  Unpivoted block elimination needs
    every diagonal block invertible, which a full-rank Jacobian does not
    imply, so delta_c is floored at jacobian_regularization_value, and on
    repeated singularity it escalates to at most 1e-4.  Each round factors
    every lane with one K2 launch per BCR level; a lane that is done keeps
    its factorization, matrix and deltas."""
    exp_pos, exp_neg = expected_inertia(nlp)
    base_cd = (delta_cd_override if delta_cd_override is not None
               else opts.jacobian_regularization_value
               * mu ** opts.jacobian_regularization_exponent)
    delta_cd = torch.clamp(base_cd, min=opts.jacobian_regularization_value)

    if opts.chain_shard:
        # the chain axis over the registered shards (parallel/chain_shard.py):
        # assemble once with zero deltas; the retry loop re-adds them on the
        # shards' diagonals
        from ..parallel.chain_shard import dist_factorize_retry, with_deltas
        zero = torch.zeros_like(mu)
        K0 = assemble_btd(nlp, it, AB, Wblocks, zero, zero)
        kind = chain_diag_kind(nlp).to(K0.diag.device)
        fac, dxv, dcv, trials, ok, _ = dist_factorize_retry(
            btd_cast(K0, opts.factorization_dtype), kind, opts, delta_cd,
            delta_w_last, exp_pos, exp_neg)
        dxv, dcv = dxv.to(mu.dtype), dcv.to(mu.dtype)
        # K with the final deltas, for the refinement's products
        Kb = with_deltas(K0, kind, dxv, dcv)
    else:
        def factor(delta_x, delta_c):
            Kbtd = assemble_btd(nlp, it, AB, Wblocks, delta_x, delta_c)
            fac = bcr_factorize(btd_cast(Kbtd, opts.factorization_dtype),
                                pivot_tol=opts.ldlt_pivot_tol,
                                equilibrate=opts.linear_system_scaling == "mc19")
            ok = (fac.num_pos == exp_pos) & (fac.num_neg == exp_neg) & ~fac.singular
            return Kbtd, fac, ok

        Kb, fac, dxv, dcv, trials, ok, _ = regularized_retry(opts, factor, delta_cd,
                                                             delta_w_last)
    return ChainFactorResult(fac=fac, K=Kb, delta_x=dxv, delta_c=dcv,
                             delta_w_last=torch.where(dxv > 0, dxv, delta_w_last),
                             failed=~ok, num_trials=trials)


def chained_solve_refined(Kbtd: BTDMatrix, fac, rhs, opts: Options):
    """BCR solve + iterative refinement against the assembled BTD matrices,
    in float64 under ``refinement_precision="double"`` whatever the factor's
    dtype (``chained_kkt.py:262-333``); returns (sol, residual ratio) per
    lane.  ``fac`` is a ``BCRFactor`` or, under ``chain_shard``, a
    ``ChainShardFactor`` (solved by ``dist_solve``)."""
    from ..parallel.chain_shard import ChainShardFactor, dist_solve
    if isinstance(fac, ChainShardFactor):
        solve_fn, fac_dt = dist_solve, fac.reduced.Ainv_root.dtype
    else:
        solve_fn, fac_dt = bcr_solve, fac.Ainv_root.dtype
    dts = refine_dtypes(opts, Kbtd.diag.dtype, fac_dt)
    K_a = BTDMatrix(diag=Kbtd.diag.to(dts[1]), sub=Kbtd.sub.to(dts[1]))
    return refine(K_a.matvec, lambda r: solve_fn(fac, r), rhs, opts, dtypes=dts)
