"""Iterate initialization: ``DefaultIterateInitializer``
(``src/Algorithm/IpDefaultIterateInitializer.cpp:113-346,473-600``), per lane.

Port of the default path of ``ipopt_tpu/algorithm/init.py``: push x0 and
s0 = d(x0) inside their bounds, bound multipliers at bound_mult_init_val,
and least-squares equality multipliers (zeroed above constr_mult_init_max;
zero for a chained problem).
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


def default_initialize(nlp: CanonicalNLP, opts: Options) -> Iterate:
    x = push_inside(nlp.x0, nlp.x_L, nlp.x_U, nlp.has_xL, nlp.has_xU,
                    opts.bound_push, opts.bound_frac)
    d0 = nlp.eval_d(x)
    s = push_inside(d0, nlp.d_L, nlp.d_U, nlp.has_dL, nlp.has_dU,
                    opts.slack_bound_push, opts.slack_bound_frac)

    def fill(has, v):
        return torch.where(has, v, torch.zeros_like(v))

    val = opts.bound_mult_init_val
    z_L = fill(nlp.has_xL, torch.full_like(x, val))
    z_U = fill(nlp.has_xU, torch.full_like(x, val))
    v_L = fill(nlp.has_dL, torch.full_like(s, val))
    v_U = fill(nlp.has_dU, torch.full_like(s, val))
    if nlp.chain is not None:
        # chained problems skip the dense least-squares estimate
        # (init.py:165-170); Ipopt's fallback above constr_mult_init_max is
        # y = 0 anyway
        y_c = x.new_zeros((x.shape[0], nlp.me))
        y_d = x.new_zeros((x.shape[0], nlp.mi))
    else:
        _, grad_f, _, _, J_c, J_d = nlp.eval_all(x)
        y_c, y_d = least_squares_y(nlp, x, s, grad_f, J_c, J_d, z_L, z_U,
                                   v_L, v_U, opts.constr_mult_init_max)
    return Iterate(x=x, s=s, y_c=y_c, y_d=y_d, z_L=z_L, z_U=z_U,
                   v_L=v_L, v_U=v_U)
