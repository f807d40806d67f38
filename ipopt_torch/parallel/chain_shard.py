"""The chain axis of a block-tridiagonal (BTD) KKT system sharded over
devices (port of ``ipopt_tpu/parallel/chain_shard.py``).

A Schur domain decomposition (the block-tridiagonal "SPIKE" scheme): the
chain of nb blocks is cut into P contiguous chunks of k = nb / P >= 3
blocks, one per shard, and

  1. each shard eliminates the interior of its chunk (blocks 1..k-2) with
     the batched BCR of ``linalg/block_tridiag.py`` (K2 on every level), and
     forms the spikes X1 = A_II^-1 C1, X2 = A_II^-1 C2 (one ``bcr_solve``
     with b right-hand sides each) and the 2x2-block Schur complement on its
     two boundary blocks;
  2. the boundary blocks of every shard are gathered (copied with ``.to``)
     to the first device, where the reduced (2P, b) BTD system is factored
     by the same BCR;
  3. the interior back-substitution is again local to each shard.

Inertia is exact by Haynsworth's additivity: inertia(K) = the sum of the
interior inertias + inertia(reduced).

The reference runs one program over a named mesh axis with ``shard_map``
and explicit collectives.  The port runs single-controller too: the shards
are given as a sequence of ``torch.device`` (``set_chain_mesh``), repeats
allowed.  Shards that share a device are stacked as lanes of one batched
``bcr_factorize``, so on one card P shards are P lanes and each BCR level is
one K2 launch for all of them.  The all-gather is a copy of each shard's
boundary blocks to the first device, the psum a sum of the shards' counts.

Layout: every tensor of the factorization keeps the batch axis first; a
device group's tensors are (B, n_g, ...) for its n_g shards, flattened to
(B * n_g, ...) lanes for the batched BCR.  So the per-lane tree helpers
(``tree_where``, ``tree_take``) select lanes of a ``ChainShardFactor`` as of
any other factorization.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..linalg.block_tridiag import (BTDMatrix, BCRFactor, bcr_factorize,
                                    bcr_solve, btd_apply_scale, btd_ruiz_scale)
from ..types import tree_map


class ShardGroup(NamedTuple):
    """The shards of one device; every tensor (B, n_g, ...)."""

    shards: Tuple[int, ...]    # shard indices p, in order
    device: Any
    interior: BCRFactor        # BCR of the (k-2)-block interiors
    X1: Any                    # ((k-2) b, b) interior^-1 C1 per shard
    X2: Any                    # ((k-2) b, b) interior^-1 C2 per shard
    sub0: Any                  # (b, b) coupling interior <-> first (scaled)
    subl: Any                  # (b, b) coupling last <-> interior (scaled)
    dscale: Any                # (k, b) Ruiz scale (ones if disabled)


class ChainShardFactor(NamedTuple):
    """The sharded factorization; counts per lane (B,) on the first device."""

    groups: Tuple[ShardGroup, ...]
    reduced: BCRFactor         # (B, 2P) boundary system on the first device
    num_pos: Any
    num_neg: Any
    num_zero: Any
    singular: Any


# The shards' devices that ``Options(chain_shard=True)`` uses (Options stays
# a hashable value, so the devices are registered out of band, as the
# reference registers its mesh).
_CHAIN_MESH = {"devices": None}


def set_chain_mesh(devices: Optional[Sequence]) -> None:
    """Register the shards' devices, one entry per shard (P = len(devices),
    repeats allowed: shards on one device run as lanes of one launch).
    ``None`` clears the registration."""
    _CHAIN_MESH["devices"] = (None if devices is None
                              else tuple(torch.device(d) for d in devices))


def chain_devices() -> Tuple[torch.device, ...]:
    devs = _CHAIN_MESH["devices"]
    if devs is None:
        raise ValueError("set_chain_mesh(devices) before chain_shard=True")
    return devs


def _check_shape(nb: int, P: int) -> int:
    """k = nb / P, under the reference's preconditions."""
    if nb % P != 0 or nb // P < 3:
        raise ValueError(f"chain sharding needs nb % P == 0 and nb / P >= 3 "
                         f"(nb = {nb}, P = {P})")
    return nb // P


def _groups(devices) -> Tuple[Tuple[torch.device, Tuple[int, ...]], ...]:
    """(device, shard indices) per distinct device, in first-seen order."""
    order = {}
    for p, d in enumerate(devices):
        order.setdefault(d, []).append(p)
    return tuple((d, tuple(ps)) for d, ps in order.items())


def _chunks(T, shards, k, device):
    """Rows ``shards`` of the (B, nb, ...) tensor T cut into k-block chunks,
    lane major: (B * len(shards), k, ...) on ``device``."""
    B = T.shape[0]
    C = T.reshape(B, -1, k, *T.shape[2:])[:, list(shards)]
    return C.reshape(B * len(shards), k, *T.shape[2:]).to(device)


def _per_shard(G, n_g):
    """(B * n_g, ...) -> (B, n_g, ...)."""
    return G.reshape(-1, n_g, *G.shape[1:])


def _lanes(group: ShardGroup) -> ShardGroup:
    """The group's tensors as (B * n_g, ...) lanes of the batched BCR."""
    return tree_map(lambda t: t.reshape(-1, *t.shape[2:]), group)


def _place(per_group, groups, P, dev0):
    """[(B, n_g, ...) per group] -> (B, P, ...) on ``dev0`` in shard order
    (the all-gather)."""
    slots = [None] * P
    for (_, shards), T in zip(groups, per_group):
        T = T.to(dev0)
        for j, p in enumerate(shards):
            slots[p] = T[:, j]
    return torch.stack(slots, 1)


def _factor_group(diag, sub, pivot_tol):
    """Step 1 for one group: diag, sub (L, k, b, b), scaled, the cross-chunk
    coupling taken out; returns (interior, X1, X2, S11, S22, S21)."""
    L, k, b = diag.shape[:3]
    # the interior chunk, blocks 1..k-2; its last coupling would reach the
    # boundary block k-1 and is masked out
    sub_i = sub[:, 1:k - 1].clone()
    sub_i[:, k - 3] = 0.0
    interior = bcr_factorize(BTDMatrix(diag=diag[:, 1:k - 1].contiguous(), sub=sub_i),
                             pivot_tol=pivot_tol)
    # spikes: A(block 1, block 0) = sub[0]; A(block k-2, block k-1) = sub[k-2]^T
    C1 = diag.new_zeros((L, (k - 2) * b, b))
    C1[:, :b] = sub[:, 0]
    C2 = diag.new_zeros((L, (k - 2) * b, b))
    C2[:, -b:] = sub[:, k - 2].transpose(-1, -2)
    X1 = bcr_solve(interior, C1)
    X2 = bcr_solve(interior, C2)
    # the 2x2-block Schur complement on (first, last): A_BB - C^T A_II^-1 C
    S11 = diag[:, 0] - sub[:, 0].transpose(-1, -2) @ X1[:, :b]
    S22 = diag[:, k - 1] - sub[:, k - 2] @ X2[:, -b:]
    S21 = -sub[:, k - 2] @ X1[:, -b:]
    return interior, X1, X2, S11, S22, S21


def dist_factorize(K: BTDMatrix, devices=None, equilibrate: bool = False,
                   pivot_tol: float = 0.0) -> ChainShardFactor:
    """Factorize every lane of K (B, nb, b, b) over the shards ``devices``
    (default: the registered ones); K's device is where the reduced system
    is factored and the counts live.  ``equilibrate`` applies a per-chunk
    symmetric Ruiz scale (the MC19 analogue, ``chain_shard.py:80-96``): the
    cross-chunk coupling E_p is scaled by the next chunk's first-block
    scale."""
    devices = chain_devices() if devices is None else tuple(
        torch.device(d) for d in devices)
    P = len(devices)
    B, nb, b = K.diag.shape[:3]
    k = _check_shape(nb, P)
    dev0 = K.diag.device
    groups = _groups(devices)
    # each chunk's last coupling reaches the next chunk (zero after the last)
    sub_all = K.sub.clone()
    sub_all[:, nb - 1] = 0.0
    parts = []
    for d, shards in groups:
        diag = _chunks(K.diag, shards, k, d)
        sub = _chunks(sub_all, shards, k, d)
        E = sub[:, k - 1].clone()
        sub[:, k - 1] = 0.0
        parts.append([diag, sub, E])
    if equilibrate:
        dscs = [btd_ruiz_scale(BTDMatrix(diag=diag, sub=sub)) for diag, sub, _ in parts]
        # every shard's first-block scale, gathered, for its left neighbour
        d_first = _place([_per_shard(s[:, 0], len(g[1])) for s, g in zip(dscs, groups)],
                         groups, P, dev0)                            # (B, P, b)
        d_next = torch.roll(d_first, -1, 1)
        for (d, shards), part, dsc in zip(groups, parts, dscs):
            Ks = btd_apply_scale(BTDMatrix(diag=part[0], sub=part[1]), dsc)
            dn = d_next[:, list(shards)].reshape(-1, b).to(d)
            part[0], part[1] = Ks.diag, Ks.sub
            part[2] = dn[:, :, None] * part[2] * dsc[:, k - 1][:, None, :]
    else:
        dscs = [part[0].new_ones(part[0].shape[:3]) for part in parts]

    out_groups, S = [], []
    for (d, shards), (diag, sub, E), dsc in zip(groups, parts, dscs):
        interior, X1, X2, S11, S22, S21 = _factor_group(diag, sub, pivot_tol)
        out_groups.append(tree_map(lambda t, n_g=len(shards): _per_shard(t, n_g),
                                   ShardGroup(shards=shards, device=d, interior=interior,
                                              X1=X1, X2=X2, sub0=sub[:, 0],
                                              subl=sub[:, k - 2], dscale=dsc)))
        S.append([_per_shard(T, len(shards)) for T in (S11, S22, S21, E)])
    # the one gather of the boundary data; the reduced (2P, b) system
    g11, g22, g21, gE = (_place([s[i] for s in S], groups, P, dev0) for i in range(4))
    red_diag = torch.stack([g11, g22], 2).reshape(B, 2 * P, b, b)
    # red_sub[i] couples reduced block i+1 to i: [S21_p, E_p] alternating
    red_sub = torch.stack([g21, gE], 2).reshape(B, 2 * P, b, b)
    reduced = bcr_factorize(BTDMatrix(diag=red_diag, sub=red_sub), pivot_tol=pivot_tol)

    def total(name):
        c = getattr(reduced, name)
        for g in out_groups:
            c = c + getattr(g.interior, name).sum(1).to(dev0)
        return c
    num_pos, num_neg, num_zero = total("num_pos"), total("num_neg"), total("num_zero")
    return ChainShardFactor(groups=tuple(out_groups), reduced=reduced,
                            num_pos=num_pos, num_neg=num_neg, num_zero=num_zero,
                            singular=num_zero > 0)


def dist_solve(fac: ChainShardFactor, rhs):
    """Solve K x = rhs per lane with a ``dist_factorize`` result; rhs is
    (B, nb*b) or (B, nb*b, r) on the first device."""
    vec = rhs.dim() == 2
    Rf = rhs[..., None] if vec else rhs
    B, N, r = Rf.shape
    b, k = fac.groups[0].dscale.shape[-1], fac.groups[0].dscale.shape[2]
    P = sum(len(g.shards) for g in fac.groups)
    dev0 = rhs.device
    groups = tuple((g.device, g.shards) for g in fac.groups)
    R_all = Rf.reshape(B, P * k, b, r)
    W, RF, RL = [], [], []
    lanes = [_lanes(g) for g in fac.groups]
    for g in lanes:
        # solve D K D y = D r, return x = D y
        R = _chunks(R_all, g.shards, k, g.device) * g.dscale[..., None]
        L = R.shape[0]
        w = bcr_solve(g.interior, R[:, 1:k - 1].reshape(L, -1, r)).reshape(L, k - 2, b, r)
        r_f = R[:, 0] - torch.matmul(g.sub0.transpose(-1, -2), w[:, 0])
        r_l = R[:, k - 1] - torch.matmul(g.subl, w[:, k - 3])
        W.append(w)
        RF.append(_per_shard(r_f, len(g.shards)))
        RL.append(_per_shard(r_l, len(g.shards)))
    # the one gather of the boundary right-hand sides; the reduced solve
    gf, gl = _place(RF, groups, P, dev0), _place(RL, groups, P, dev0)
    red_rhs = torch.stack([gf, gl], 2).reshape(B, 2 * P * b, r)
    xr = bcr_solve(fac.reduced, red_rhs).reshape(B, P, 2, b, r)
    Y = []
    for g, w in zip(lanes, W):
        sel = xr[:, list(g.shards)].to(g.device)
        x_f = sel[:, :, 0].reshape(-1, b, r)
        x_l = sel[:, :, 1].reshape(-1, b, r)
        L = w.shape[0]
        x_I = (w.reshape(L, -1, r) - torch.matmul(g.X1, x_f)
               - torch.matmul(g.X2, x_l)).reshape(L, k - 2, b, r)
        y = torch.cat([x_f[:, None], x_I, x_l[:, None]], 1) * g.dscale[..., None]
        Y.append(_per_shard(y, len(g.shards)))
    X = _place(Y, groups, P, dev0).reshape(B, N, r)
    return X[..., 0] if vec else X


def with_deltas(K0: BTDMatrix, kind, delta_x, delta_c) -> BTDMatrix:
    """K0 with +delta_x on the diagonal slots of kind 0 and -delta_c on those
    of kind 1 (``kind`` (nb, b); the deltas per lane (B,))."""
    dtype = K0.diag.dtype
    B = K0.diag.shape[0]
    add = torch.where(kind == 0, delta_x.to(dtype).reshape(B, 1, 1),
                      torch.where(kind == 1, -delta_c.to(dtype).reshape(B, 1, 1),
                                  torch.zeros((), dtype=dtype, device=kind.device)))
    return BTDMatrix(diag=K0.diag + torch.diag_embed(add), sub=K0.sub)


def dist_factorize_retry(K0: BTDMatrix, diag_kind, opts, delta_cd,
                         delta_w_last, exp_pos: int, exp_neg: int):
    """Assemble-once inertia-corrected sharded factorization
    (``chain_shard.py:228-340``): the reference's perturbation schedule
    (``algorithm/step.regularized_retry``), with the deltas re-added on the
    diagonal by ``diag_kind`` (K+1, bs) (0 = +delta_x, 1 = -delta_c, 2 =
    untouched) instead of re-assembling.  ``delta_cd`` and ``delta_w_last``
    are per lane (B,).  Equilibrates under mc19 and in float32.  Returns
    (fac, delta_x, delta_c, trials, ok, gave_up)."""
    from ..algorithm.step import regularized_retry
    dtype = K0.diag.dtype
    equil = opts.linear_system_scaling == "mc19" or dtype == torch.float32
    kind = torch.as_tensor(diag_kind, device=K0.diag.device)

    def factor(dxv, dcv):
        f = dist_factorize(with_deltas(K0, kind, dxv, dcv), equilibrate=equil,
                           pivot_tol=opts.ldlt_pivot_tol)
        return None, f, (f.num_pos == exp_pos) & (f.num_neg == exp_neg) & ~f.singular

    r = regularized_retry(opts, factor, delta_cd.to(dtype), delta_w_last.to(dtype))
    return r.fac, r.delta_x, r.delta_c, r.trials, r.ok, r.gave_up


def sharded_btd_factorize_solve(K: BTDMatrix, rhs, devices):
    """Factorize and solve K x = rhs over the shards ``devices``
    (``chain_shard.py:377-400``); returns (x, num_pos, num_neg, num_zero)
    per lane."""
    f = dist_factorize(K, devices)
    return dist_solve(f, rhs), f.num_pos, f.num_neg, f.num_zero
