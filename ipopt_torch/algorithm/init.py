"""Iterate initialization: ``DefaultIterateInitializer``
(``src/Algorithm/IpDefaultIterateInitializer.cpp:113-346,473-600``), per lane.

Port of ``ipopt_tpu/algorithm/init.py``: push x0 (or the least-squares x of
``least_square_init_primal``) and s0 = d(x0) inside their bounds; bound
multipliers at bound_mult_init_val or mu-based; least-squares equality
multipliers (zeroed above constr_mult_init_max; zero for a chained or
banded problem), or all duals from one augmented solve with
``least_square_init_duals``.  Also ``WarmStartIterateInitializer``.
"""
from __future__ import annotations

import torch

from ..types import Iterate, max_init
from ..problem import CanonicalNLP
from ..options import Options
from ..linalg.ldlt import dense_solve


def push_inside(v, lo, hi, has_lo, has_hi, push, frac):
    """The push_variables logic (IpDefaultIterateInitializer.cpp:473)."""
    zero = torch.zeros_like(v)
    two = has_lo & has_hi
    width = torch.where(two, hi - lo, torch.ones_like(v))
    p_lo = torch.where(has_lo, torch.where(
        two, torch.minimum(push * torch.clamp(lo.abs(), min=1.0), frac * width),
        push * torch.clamp(lo.abs(), min=1.0)), zero)
    p_hi = torch.where(has_hi, torch.where(
        two, torch.minimum(push * torch.clamp(hi.abs(), min=1.0), frac * width),
        push * torch.clamp(hi.abs(), min=1.0)), zero)
    out = torch.where(has_lo, torch.maximum(v, lo + p_lo), v)
    out = torch.where(has_hi, torch.minimum(out, hi - p_hi), out)
    # If bounds cross after pushing (tiny interval), fall back to midpoint.
    mid_ok = ~two | (lo + p_lo <= hi - p_hi)
    return torch.where(mid_ok, out, 0.5 * (lo + hi))


def _eye(B, k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device).expand(B, k, k)


def least_squares_y(nlp: CanonicalNLP, x, s, grad_f, J_c, J_d, z_L, z_U,
                    v_L, v_U, y_max):
    """Least-squares equality multipliers, zeroed per lane when
    ||y||_inf > y_max (IpLeastSquareMults.cpp; normal equations)."""
    n, mi, me = nlp.n, nlp.mi, nlp.me
    B = x.shape[0]
    if me + mi == 0:
        z = x.new_zeros((B, 0))
        return z, z
    A = x.new_zeros((B, n + mi, me + mi))
    A[:, :n, :me] = J_c.transpose(-1, -2)
    A[:, :n, me:] = J_d.transpose(-1, -2)
    A[:, n:, me:] = -_eye(B, mi, x)
    b = torch.cat([grad_f - z_L + z_U, -v_L + v_U], dim=-1)
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-12 * _eye(B, me + mi, x)
    y = dense_solve(AtA, -torch.matmul(At, b.unsqueeze(-1)).squeeze(-1))
    too_big = max_init(y.abs(), 0.0) > y_max
    y = torch.where(too_big[:, None], torch.zeros_like(y), y)
    return y[:, :me], y[:, me:]


def least_squares_primal_x(nlp: CanonicalNLP, x0):
    """least_square_init_primal (IpDefaultIterateInitializer.cpp:200-222,
    349-395): minus the min-norm (x, s) of the constraints linearized at x0,
    of which only x is used; x0 in a lane whose normal system gave a
    non-finite result."""
    n, mi = nlp.n, nlp.mi
    B = x0.shape[0]
    _, _, cv, dv, J_c, J_d = nlp.eval_all(x0)
    me = cv.shape[-1]
    m = me + mi
    A = x0.new_zeros((B, m, n + mi))
    A[:, :me, :n] = J_c
    A[:, me:, :n] = J_d
    A[:, me:, n:] = -_eye(B, mi, x0)
    b = torch.cat([cv, dv], dim=-1)
    AAt = A @ A.transpose(-1, -2) + 1e-12 * _eye(B, m, x0)
    sol = torch.matmul(A.transpose(-1, -2), dense_solve(AAt, b).unsqueeze(-1)
                       ).squeeze(-1)
    x_ls = -sol[:, :n]
    ok = torch.isfinite(x_ls).all(-1, keepdim=True)
    return torch.where(ok, x_ls, x0)


def least_squares_duals(nlp: CanonicalNLP, x, grad_f, J_c, J_d):
    """least_square_init_duals (IpDefaultIterateInitializer.cpp:299-345,
    397-474): the augmented system with W = 0, D_x = -(number of bounds of
    each variable) and rhs (grad_f, 0, 0, 0); z_L = -sol_x, z_U = sol_x,
    v_L = -sol_s, v_U = sol_s, y = -sol_y.  Returns (ok per lane, z_L, z_U,
    v_L, v_U, y_c, y_d)."""
    n, mi, me = nlp.n, nlp.mi, nlp.me
    B = x.shape[0]
    N = n + mi + me + mi
    kx = nlp.has_xL.to(x.dtype) + nlp.has_xU.to(x.dtype)
    ks = nlp.has_dL.to(x.dtype) + nlp.has_dU.to(x.dtype)
    K = x.new_zeros((B, N, N))
    K[:, :n, :n] = torch.diag_embed(-kx)
    K[:, n:n + mi, n:n + mi] = torch.diag_embed(-ks)
    r0 = n + mi
    K[:, r0:r0 + me, :n] = J_c
    K[:, :n, r0:r0 + me] = J_c.transpose(-1, -2)
    K[:, r0 + me:, :n] = J_d
    K[:, :n, r0 + me:] = J_d.transpose(-1, -2)
    K[:, r0 + me:, n:n + mi] = -_eye(B, mi, x)
    K[:, n:n + mi, r0 + me:] = -_eye(B, mi, x)
    rhs = torch.cat([grad_f, x.new_zeros((B, N - n))], dim=-1)
    sol = dense_solve(K + 1e-12 * _eye(B, N, x), rhs)
    sol_x, sol_s = sol[:, :n], sol[:, n:n + mi]
    ok = torch.isfinite(sol).all(-1)

    def w(has, v):
        return torch.where(has, v, torch.zeros_like(v))

    return (ok, w(nlp.has_xL, -sol_x), w(nlp.has_xU, sol_x),
            w(nlp.has_dL, -sol_s), w(nlp.has_dU, sol_s),
            -sol[:, r0:r0 + me], -sol[:, r0 + me:])


def default_initialize(nlp: CanonicalNLP, opts: Options) -> Iterate:
    x = nlp.x0
    if (opts.least_square_init_primal and nlp.chain is None
            and nlp.struct.me + nlp.struct.mi > 0):
        x = least_squares_primal_x(nlp, x)
    x = push_inside(x, nlp.x_L, nlp.x_U, nlp.has_xL, nlp.has_xU,
                    opts.bound_push, opts.bound_frac)
    d0 = nlp.eval_d(x)
    s = push_inside(d0, nlp.d_L, nlp.d_U, nlp.has_dL, nlp.has_dU,
                    opts.slack_bound_push, opts.slack_bound_frac)

    def fill(has, v):
        return torch.where(has, v, torch.zeros_like(v))

    if opts.bound_mult_init_method == "mu-based":
        one = torch.ones_like(x)
        z_L = fill(nlp.has_xL, opts.mu_init / torch.where(nlp.has_xL, x - nlp.x_L, one))
        z_U = fill(nlp.has_xU, opts.mu_init / torch.where(nlp.has_xU, nlp.x_U - x, one))
        one = torch.ones_like(s)
        v_L = fill(nlp.has_dL, opts.mu_init / torch.where(nlp.has_dL, s - nlp.d_L, one))
        v_U = fill(nlp.has_dU, opts.mu_init / torch.where(nlp.has_dU, nlp.d_U - s, one))
    else:
        val = opts.bound_mult_init_val
        z_L = fill(nlp.has_xL, torch.full_like(x, val))
        z_U = fill(nlp.has_xU, torch.full_like(x, val))
        v_L = fill(nlp.has_dL, torch.full_like(s, val))
        v_U = fill(nlp.has_dU, torch.full_like(s, val))
    if nlp.chain is not None:
        # chained and banded problems skip the dense least-squares estimate
        # (init.py:165-170); Ipopt's fallback above constr_mult_init_max is
        # y = 0 anyway
        y_c = x.new_zeros((x.shape[0], nlp.me))
        y_d = x.new_zeros((x.shape[0], nlp.mi))
    else:
        _, grad_f, _, _, J_c, J_d = nlp.eval_all(x)
        if opts.least_square_init_duals and nlp.struct.me + nlp.struct.mi > 0:
            # all duals from one augmented solve; bound multipliers floored
            # at their initial values (IpDefaultIterateInitializer.cpp:299-345)
            ok, zL2, zU2, vL2, vU2, y_c2, y_d2 = least_squares_duals(
                nlp, x, grad_f, J_c, J_d)
            okc = ok[:, None]
            z_L = torch.where(okc & nlp.has_xL, torch.maximum(zL2, z_L), z_L)
            z_U = torch.where(okc & nlp.has_xU, torch.maximum(zU2, z_U), z_U)
            v_L = torch.where(okc & nlp.has_dL, torch.maximum(vL2, v_L), v_L)
            v_U = torch.where(okc & nlp.has_dU, torch.maximum(vU2, v_U), v_U)
            y_c_ls, y_d_ls = least_squares_y(nlp, x, s, grad_f, J_c, J_d, z_L,
                                             z_U, v_L, v_U,
                                             opts.constr_mult_init_max)
            y_c = torch.where(okc, y_c2, y_c_ls)
            y_d = torch.where(okc, y_d2, y_d_ls)
        else:
            y_c, y_d = least_squares_y(nlp, x, s, grad_f, J_c, J_d, z_L, z_U,
                                       v_L, v_U, opts.constr_mult_init_max)
    return Iterate(x=x, s=s, y_c=y_c, y_d=y_d, z_L=z_L, z_U=z_U,
                   v_L=v_L, v_U=v_U)


def warm_start_initialize(nlp: CanonicalNLP, opts: Options, it0: Iterate) -> Iterate:
    """WarmStartIterateInitializer (IpWarmStartIterateInitializer.cpp:31-129):
    push the given point inside the bounds with the warm-start pushes, and
    clip the multipliers to [warm_start_mult_bound_push,
    warm_start_mult_init_max]."""
    x = push_inside(it0.x, nlp.x_L, nlp.x_U, nlp.has_xL, nlp.has_xU,
                    opts.warm_start_bound_push, opts.warm_start_bound_frac)
    s = it0.s if opts.warm_start_entire_iterate else nlp.eval_d(x)
    s = push_inside(s, nlp.d_L, nlp.d_U, nlp.has_dL, nlp.has_dU,
                    opts.warm_start_slack_bound_push,
                    opts.warm_start_slack_bound_frac)
    mp, mmax = opts.warm_start_mult_bound_push, opts.warm_start_mult_init_max

    def clip_mult(z, has):
        z = torch.clamp(z, mp, mmax)
        return torch.where(has, z, torch.zeros_like(z))

    return Iterate(
        x=x, s=s, y_c=torch.clamp(it0.y_c, -mmax, mmax),
        y_d=torch.clamp(it0.y_d, -mmax, mmax),
        z_L=clip_mult(it0.z_L, nlp.has_xL), z_U=clip_mult(it0.z_U, nlp.has_xU),
        v_L=clip_mult(it0.v_L, nlp.has_dL), v_U=clip_mult(it0.v_U, nlp.has_dU))
