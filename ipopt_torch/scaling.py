"""NLP scaling strategies (port of ``ipopt_tpu/scaling.py``).

``GradientScaling`` (``src/Algorithm/IpGradientScaling.cpp:19-63``): scale the
objective and each constraint so the max gradient component at x0 is at most
``nlp_scaling_max_gradient`` (the default); ``equilibration-based`` (the
MC19 analog: two Ruiz sweeps over the rows of [grad f; J] at x0);
``user-scaling`` (the objective by ``obj_scaling_factor``); or ``none``.
All lanes of a batch are scaled at once.
"""
from __future__ import annotations

import math

import torch
from torch.func import grad, jacfwd, vmap

from .options import Options
from .types import max_init


def grad_scale_factor(norm, opts: Options, target: float):
    """Gradient-based scale factor (IpGradientScaling.cpp:104-125)."""
    one = torch.ones_like(norm)
    cap = torch.where(norm > opts.nlp_scaling_max_gradient,
                      opts.nlp_scaling_max_gradient / norm, one)
    tgt = torch.where(norm > 0, target / torch.where(norm > 0, norm, one), one)
    d = tgt if target > 0 else cap
    return torch.clamp(d, min=opts.nlp_scaling_min_value)


def _raw_grads(cnlp):
    """Unscaled grad f (B, n) and Jacobian of g (B, m, n) at x0."""
    lane = cnlp.lane()

    def f_raw(x, ln):
        return cnlp.f(cnlp.x_full1(x, ln["x_fixed"]), ln["params"])

    def g_raw(x, ln):
        return cnlp.g(cnlp.x_full1(x, ln["x_fixed"]), ln["params"])

    gf = vmap(grad(f_raw))(cnlp.x0, lane)
    J = vmap(jacfwd(g_raw))(cnlp.x0, lane) if cnlp.struct.m else None
    return gf, J


def compute_scaling(cnlp, opts: Options):
    """Fill the obj_scale/c_scale/d_scale fields of a CanonicalNLP."""
    if opts.nlp_scaling_method == "none":
        return cnlp
    dtype = cnlp.x0.dtype
    if opts.nlp_scaling_method == "user-scaling":
        return cnlp._replace(obj_scale=torch.full_like(cnlp.obj_scale,
                                                       opts.obj_scaling_factor))
    gf, J = _raw_grads(cnlp)
    if opts.nlp_scaling_method == "equilibration-based":
        return _equilibration_scaling(cnlp, opts, gf, J)
    gnorm = max_init(gf.abs(), 0.0)
    df = grad_scale_factor(gnorm, opts, opts.nlp_scaling_obj_target_gradient)
    df = df * opts.obj_scaling_factor

    s = cnlp.struct
    c_scale = torch.ones_like(cnlp.c_scale)
    d_scale = torch.ones_like(cnlp.d_scale)
    if s.me + s.mi > 0:
        row_norm = max_init(J.abs(), 0.0)
        dg = grad_scale_factor(row_norm, opts,
                               opts.nlp_scaling_constr_target_gradient)
        if s.me:
            c_scale = dg[:, s.index("eq_idx", dg.device)]
        if s.mi:
            d_scale = dg[:, s.index("ineq_idx", dg.device)]

    # Scaling the inequality rows rescales their bounds too.
    return cnlp._replace(
        obj_scale=df.to(dtype), c_scale=c_scale.to(dtype),
        d_scale=d_scale.to(dtype),
        d_L=cnlp.d_L * d_scale, d_U=cnlp.d_U * d_scale)


def _equilibration_scaling(cnlp, opts: Options, gf, J):
    """EquilibrationScaling (src/Algorithm/IpEquilibrationScaling.cpp), as
    the reference does it (``ipopt_tpu/scaling.py:81-124``): two Ruiz sweeps
    of row equilibration over [grad f; J] at x0, the factors clipped to
    [nlp_scaling_min_value, 1/nlp_scaling_min_value]; the variables are not
    scaled."""
    M = gf[:, None, :] if J is None else torch.cat([gf[:, None, :], J], 1)
    r = torch.ones(M.shape[:2], dtype=M.dtype, device=M.device)
    for _ in range(2):
        rn = torch.sqrt(torch.clamp(max_init((M * r[:, :, None]).abs(), -math.inf),
                                    min=1e-30))
        r = r / rn
    r = torch.clamp(r, opts.nlp_scaling_min_value, 1.0 / opts.nlp_scaling_min_value)
    s = cnlp.struct
    c_scale, d_scale = cnlp.c_scale, cnlp.d_scale
    if s.m:
        dg = r[:, 1:]
        if s.me:
            c_scale = dg[:, s.index("eq_idx", dg.device)]
        if s.mi:
            d_scale = dg[:, s.index("ineq_idx", dg.device)]
    dtype = cnlp.x0.dtype
    return cnlp._replace(
        obj_scale=(r[:, 0] * opts.obj_scaling_factor).to(dtype),
        c_scale=c_scale.to(dtype), d_scale=d_scale.to(dtype),
        d_L=cnlp.d_L * d_scale, d_U=cnlp.d_U * d_scale)
