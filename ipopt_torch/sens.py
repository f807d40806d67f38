"""NLP sensitivity, the sIPOPT equivalent, over a batch (port of
``ipopt_tpu/sens.py``; ``contrib/sIPOPT``, ``SensApplication.hpp:26-183``).

Parameters are first-class (``CanonicalNLP.params``), so sensitivity is the
implicit derivative of the KKT conditions at a solution:

    F(w; p) = 0   =>   K dw = -dF/dp dp,

with K the augmented KKT matrix at the solution, factored once by the
backend's own ``step.factorize_any`` (K1 on the dense and multifrontal
backends, K2 on the chained and banded BCR levels), and dF/dp dp one
``torch.func.jvp`` through the parametric residual.  Every lane of a batch
is perturbed at once; the unit right-hand sides of ``reduced_hessian`` and
of the bound check are extra lanes of one ``solve_any`` call over each
lane's one factorization, not one solve each.

Every public function runs on the card unless ``device="cpu"`` is passed
(``solver.resolve_device``); ``it`` is a converged iterate, as
``SolveResult.iterate``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import jvp

from .types import Iterate, tree_map, tree_take
from .problem import CanonicalNLP
from .options import Options
from . import kkt
from .kkt import evaluate, condensed_rhs_parts
from .algorithm.solver import resolve_device
from .algorithm.step import factorize_any, solve_any, compute_hessian


class SensitivityResult(NamedTuple):
    dx: Any
    ds: Any
    dy_c: Any
    dy_d: Any
    dz_L: Any
    dz_U: Any
    dv_L: Any
    dv_U: Any


class BoundcheckResult(NamedTuple):
    """``sensitivity_step_boundcheck``'s corrected step and its active-set
    diagnostics per lane (sens_boundcheck, SensStdStepCalc.cpp:92-260)."""
    step: SensitivityResult
    n_fixed: Any          # (B,) bound activations corrected
    fixed_idx: Any        # (B, cap) x-indices pinned to their bound (-1 pad)
    max_violation: Any    # (B,) bound violation left after the correction


def _on_device(nlp: CanonicalNLP, it, mu, device):
    """(nlp, it, mu (B,)) on the device; an unbatched iterate (as
    ``solve`` returns it) gets a lane axis."""
    dev = resolve_device(device)
    nlp = nlp.to(dev)
    it = Iterate(*(torch.as_tensor(v).to(dev).reshape(nlp.batch, -1) for v in it))
    mu = torch.as_tensor(mu, dtype=it.x.dtype, device=dev)
    return nlp, it, mu.expand(it.x.shape[0]).clone()


def _like_input(it, out):
    """``out`` without its lane axis when the caller's iterate had none."""
    return tree_map(lambda t: t[0], out) if len(it[0].shape) == 1 else out


def _like(primal, v):
    """A tangent for ``primal`` (B, ...): one instance's value broadcasts over
    the lanes."""
    return torch.as_tensor(v, dtype=primal.dtype, device=primal.device).expand(
        primal.shape)


def _residual_parts(nlp: CanonicalNLP, opts: Options, it: Iterate, mu):
    """The four condensed KKT residual blocks (negated) at ``it``."""
    return condensed_rhs_parts(nlp, it, evaluate(nlp, it.x), mu, opts.kappa_d)


def _tangent_parts(nlp, opts, it, mu, field: str, tangent):
    """d(residual parts)/d(nlp.<field>) . tangent by one JVP."""
    def F(v):
        return _residual_parts(nlp._replace(**{field: v}), opts, it, mu)

    primal = getattr(nlp, field)
    return jvp(F, (primal,), (tree_map(_like, primal, tangent),))[1]


def _factorize_at(nlp: CanonicalNLP, opts: Options, it: Iterate, mu):
    ev = evaluate(nlp, it.x)
    return factorize_any(nlp, opts, it, ev, compute_hessian(nlp, it), mu,
                         torch.zeros_like(mu))


def _with_bound_steps(nlp: CanonicalNLP, it: Iterate, dx, ds, dy_c, dy_d):
    """Bound-multiplier sensitivities from the eliminated complementarity
    rows: (x - x_L) z = mu  =>  dz = -z / (x - x_L) dx, sign-flipped for
    upper bounds."""
    sl_xL, sl_xU, sl_sL, sl_sU = kkt.slacks(nlp, it)

    def w(has, v):
        return torch.where(has, v, torch.zeros_like(v))
    return SensitivityResult(
        dx=dx, ds=ds, dy_c=dy_c, dy_d=dy_d,
        dz_L=w(nlp.has_xL, -it.z_L / sl_xL * dx),
        dz_U=w(nlp.has_xU, it.z_U / sl_xU * dx),
        dv_L=w(nlp.has_dL, -it.v_L / sl_sL * ds),
        dv_U=w(nlp.has_dU, it.v_U / sl_sU * ds))


def _advance(it: Iterate, sr: SensitivityResult) -> Iterate:
    return Iterate(*(a + b for a, b in zip(it, sr)))


def _split(nlp, w):
    n, mi, me = nlp.n, nlp.mi, nlp.me
    return (w[..., :n], w[..., n:n + mi], w[..., n + mi:n + mi + me],
            w[..., n + mi + me:])


def _unit_solves(nlp: CanonicalNLP, opts: Options, fr, idx):
    """K^{-1} e_j for the x unit vectors j = idx[b, i] of every lane b:
    (B, k) -> (B, k, N), the k columns of a lane as extra lanes of one
    ``solve_any`` call over that lane's factorization."""
    B, k = idx.shape
    dev, dtype = nlp.x0.device, nlp.x0.dtype
    lanes = torch.arange(B, device=dev).repeat_interleave(k)
    sub = nlp.take(lanes)
    e_x = torch.zeros((B * k, nlp.n), dtype=dtype, device=dev)
    e_x[torch.arange(B * k, device=dev), idx.reshape(-1)] = 1.0
    zi = e_x.new_zeros((B * k, nlp.mi))
    parts = (e_x, zi, e_x.new_zeros((B * k, nlp.me)), zi)
    xsplit, _ = solve_any(sub, opts, tree_take(fr.fac, lanes),
                          tree_take(fr.K, lanes), parts)
    return torch.cat(xsplit, -1).reshape(B, k, -1)


def _sensitivity_step(nlp, opts, it, dparams, mu, device) -> SensitivityResult:
    nlp, it, mu = _on_device(nlp, it, mu, device)
    dparts = _tangent_parts(nlp, opts, it, mu, "params", dparams)
    fr = _factorize_at(nlp, opts, it, mu)
    xsplit, _ = solve_any(nlp, opts, fr.fac, fr.K, dparts)
    return _with_bound_steps(nlp, it, *xsplit)


def sensitivity_step(nlp: CanonicalNLP, opts: Options, it: Iterate, dparams,
                     mu=0.0, device=None) -> SensitivityResult:
    """dw for the parameter perturbation ``dparams`` (the tree of
    ``nlp.params``; one instance's values apply to every lane)."""
    return _like_input(it, _sensitivity_step(nlp, opts, it, dparams, mu, device))


def perturbed_solution(nlp: CanonicalNLP, opts: Options, it: Iterate,
                       new_params, mu=0.0, device=None) -> Iterate:
    """The first-order corrected primal-dual point for new parameter values
    (sIPOPT's fast update; a warm-started solve polishes it)."""
    dev = resolve_device(device)
    dparams = tree_map(lambda a, b: _like(a.to(dev), b) - a.to(dev),
                       nlp.params, new_params)
    sr = _sensitivity_step(nlp, opts, it, dparams, mu, dev)
    it_b = Iterate(*(torch.as_tensor(v).to(dev).reshape(sr.dx.shape[0], -1)
                     for v in it))
    return _like_input(it, _advance(it_b, sr))


def _boundcheck(nlp, opts, it, fr, dw, bound_eps, cap, rounds):
    """The bordered-KKT correction of ``sensitivity_step_boundcheck`` on the
    saved factorization; returns (dw, n_fixed, fixed_idx)."""
    n = nlp.n
    B, dev = dw.shape[0], dw.device
    ar = torch.arange(cap, device=dev)
    fixed_idx = torch.full((B, cap), -1, dtype=torch.int64, device=dev)
    n_fixed = torch.zeros((B,), dtype=torch.int64, device=dev)
    neg_inf = torch.full_like(it.x, float("-inf"))
    eye = torch.eye(cap, dtype=dw.dtype, device=dev)
    for _ in range(rounds):
        x_pred = it.x + dw[:, :n]
        viol_L = torch.where(nlp.has_xL, nlp.x_L - x_pred, neg_inf)
        viol_U = torch.where(nlp.has_xU, x_pred - nlp.x_U, neg_inf)
        viol = torch.maximum(viol_L, viol_U)
        target = torch.where(viol_L >= viol_U, nlp.x_L, nlp.x_U)
        vals, idx = torch.topk(viol, cap, dim=-1)
        active = vals > bound_eps
        Bc = _unit_solves(nlp, opts, fr, idx)                     # (B, cap, N)
        S = torch.gather(Bc[:, :, :n], 2, idx[:, None, :].expand(B, cap, cap))
        S = S.transpose(1, 2) * 0.5 + S * 0.5
        S = torch.where(active[:, :, None] & active[:, None, :], S, eye)
        du = torch.where(active, target.gather(1, idx) - x_pred.gather(1, idx),
                         torch.zeros_like(vals))
        dl = torch.linalg.solve_ex(S, -du)[0]
        dl = torch.where(active, dl, torch.zeros_like(dl))
        dw = dw - torch.einsum("bkn,bk->bn", Bc, dl)
        n_act = active.sum(-1)
        fixed_idx = torch.where(ar[None] < n_act[:, None], idx, fixed_idx)
        n_fixed = torch.maximum(n_fixed, n_act)
    return dw, n_fixed, fixed_idx


def sensitivity_step_boundcheck(nlp: CanonicalNLP, opts: Options, it: Iterate,
                                dparams, mu=0.0, bound_eps: float = 1e-3,
                                cap: int = 16, rounds: int = 2,
                                device=None) -> BoundcheckResult:
    """The sensitivity step with bound-activity detection
    (``sens_boundcheck``/``sens_bound_eps``, SensStdStepCalc.cpp:42,92-260):
    where x + dx passes a variable bound by more than ``bound_eps``, up to
    ``cap`` violated coordinates per lane are pinned to their bounds by the
    bordered-KKT correction

        [K  E'][dw]   [rhs]          S = E K^-1 E',
        [E  0 ][dl] = [du ]   via    dl = S^-1 (E dw0 - du),  dw = dw0 - B dl,

    on the same saved factorization, with ``rounds`` re-detections."""
    it0 = it
    nlp, it, mu = _on_device(nlp, it, mu, device)
    dparts = _tangent_parts(nlp, opts, it, mu, "params", dparams)
    fr = _factorize_at(nlp, opts, it, mu)
    xsplit, _ = solve_any(nlp, opts, fr.fac, fr.K, dparts)
    dw, n_fixed, fixed_idx = _boundcheck(nlp, opts, it, fr, torch.cat(xsplit, -1),
                                         bound_eps, min(cap, nlp.n), rounds)
    step = _with_bound_steps(nlp, it, *_split(nlp, dw))
    x_pred = it.x + step.dx
    neg_inf = torch.full_like(x_pred, float("-inf"))
    resid = torch.maximum(
        torch.where(nlp.has_xL, nlp.x_L - x_pred, neg_inf).amax(-1),
        torch.where(nlp.has_xU, x_pred - nlp.x_U, neg_inf).amax(-1))
    return _like_input(it0, BoundcheckResult(
        step=step, n_fixed=n_fixed, fixed_idx=fixed_idx, max_violation=resid))


def sensitivity_step_rhs(nlp: CanonicalNLP, opts: Options, it: Iterate, d_crhs,
                         mu=0.0, device=None) -> SensitivityResult:
    """Sensitivity to the equality right-hand side (the AMPL sIPOPT
    protocol, SensAmplTNLP / SensBuilder.cpp:88-140): ``d_crhs`` (me,) or
    (B, me) in equality-row order, user units."""
    it0 = it
    nlp, it, mu = _on_device(nlp, it, mu, device)
    dparts = _tangent_parts(nlp, opts, it, mu, "c_rhs", d_crhs)
    fr = _factorize_at(nlp, opts, it, mu)
    xsplit, _ = solve_any(nlp, opts, fr.fac, fr.K, dparts)
    return _like_input(it0, _with_bound_steps(nlp, it, *xsplit))


def _rhs_boundcheck(nlp: CanonicalNLP, opts: Options, it: Iterate, d_crhs, mu,
                    bound_eps, device=None) -> SensitivityResult:
    """``sensitivity_step_boundcheck`` with the right-hand-side tangent."""
    nlp, it, mu = _on_device(nlp, it, mu, device)
    dparts = _tangent_parts(nlp, opts, it, mu, "c_rhs", d_crhs)
    fr = _factorize_at(nlp, opts, it, mu)
    xsplit, _ = solve_any(nlp, opts, fr.fac, fr.K, dparts)
    dw, _, _ = _boundcheck(nlp, opts, it, fr, torch.cat(xsplit, -1), bound_eps,
                           min(16, nlp.n), 2)
    return _with_bound_steps(nlp, it, *_split(nlp, dw))


def perturbed_solution_rhs(nlp: CanonicalNLP, opts: Options, it: Iterate,
                           new_crhs, mu=0.0, n_steps: int = 1,
                           boundcheck: bool = False, bound_eps: float = 1e-3,
                           device=None) -> Iterate:
    """The first-order corrected point for a new equality right-hand side
    (sens_sol_state_1): ``n_steps`` > 1 follows a linear schedule with one
    backsolve per step (n_sens_steps, SensAlgorithm.cpp:173); ``boundcheck``
    pins bound-violating coordinates (sens_boundcheck)."""
    dev = resolve_device(device)
    nlp = nlp.to(dev)
    cur = Iterate(*(torch.as_tensor(v).to(dev).reshape(nlp.batch, -1) for v in it))
    new_crhs = _like(nlp.c_rhs, new_crhs)
    cur_nlp = nlp
    steps = max(n_steps, 1)
    for k in range(steps):
        target = nlp.c_rhs + (k + 1) / steps * (new_crhs - nlp.c_rhs)
        d = target - cur_nlp.c_rhs
        if boundcheck:
            sr = _rhs_boundcheck(cur_nlp, opts, cur, d, mu, bound_eps, device=dev)
        else:
            sr = sensitivity_step_rhs(cur_nlp, opts, cur, d, mu, device=dev)
        cur = _advance(cur, sr)
        cur_nlp = cur_nlp._replace(c_rhs=target)
    return _like_input(it, cur)


def sensitivity_path(nlp: CanonicalNLP, opts: Options, it: Iterate,
                     param_schedule, mu=0.0, device=None) -> Iterate:
    """Multi-step sensitivity (``n_sens_steps``, SensAlgorithm.cpp:173): a
    sequence of parameter values followed with one backsolve per step on
    the one factorization at ``it``, the parametric residual re-evaluated
    at each predicted point."""
    it0 = it
    nlp, it, mu = _on_device(nlp, it, mu, device)
    fr = _factorize_at(nlp, opts, it, mu)
    cur_it, cur_params = it, nlp.params
    for new_params in param_schedule:
        new_params = tree_map(_like, cur_params, new_params)
        dparams = tree_map(lambda a, b: b - a, cur_params, new_params)
        dparts = _tangent_parts(nlp._replace(params=cur_params), opts, cur_it, mu,
                                "params", dparams)
        xsplit, _ = solve_any(nlp, opts, fr.fac, fr.K, dparts)
        cur_it = _advance(cur_it, _with_bound_steps(nlp, cur_it, *xsplit))
        cur_params = new_params
    return _like_input(it0, cur_it)


def reduced_hessian(nlp: CanonicalNLP, opts: Options, it: Iterate, var_indices,
                    mu=0.0, device=None):
    """The reduced Hessian on the selected variables (sIPOPT
    ``compute_red_hessian``, SensApplication.cpp): the inverse of the
    (var, var) block of K^{-1}, per lane: (B, k, k).  The k unit columns
    are extra lanes of one solve."""
    it0 = it
    nlp, it, mu = _on_device(nlp, it, mu, device)
    idx = torch.as_tensor(var_indices, dtype=torch.int64, device=it.x.device)
    B, k = it.x.shape[0], idx.shape[0]
    fr = _factorize_at(nlp, opts, it, mu)
    cols = _unit_solves(nlp, opts, fr, idx.expand(B, k))
    S = cols[:, :, :nlp.n][:, :, idx]                           # (B, k, k)
    eye = torch.eye(k, dtype=S.dtype, device=S.device).expand(B, k, k)
    return _like_input(it0, torch.linalg.solve_ex(0.5 * (S + S.transpose(1, 2)), eye)[0])
