"""Barrier parameter strategies over a batch (port of
``ipopt_tpu/algorithm/mu.py``).

- ``MonotoneMuUpdate`` (``src/Algorithm/IpMonotoneMuUpdate.cpp``), the
  Fiacco-McCormick rule

      mu+ = max( min(kappa_mu * mu, mu^theta_mu), mu_min_bound ),
      tau = max(tau_min, 1 - mu),

  repeated while the barrier problem is already solved to
  ``barrier_tol_factor * mu``;
- ``AdaptiveMuUpdate`` with its oracles (``IpLoqoMuOracle``,
  ``IpProbingMuOracle``, ``IpQualityFunctionMuOracle``) and its three
  globalizations.  Every field of ``AdaptiveMuState`` has a leading batch
  axis; each lane keeps its own mode, filter and references.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

import math

from ..options import Options
from ..profiling import host_bool
from ..types import Iterate, col, max_init, min_init
from ..kkt import _msum, slacks, fraction_to_boundary


class MuState(NamedTuple):
    mu: Any   # (B,)
    tau: Any  # (B,)


def mu_init_state(opts: Options, batch: int, dtype, device) -> MuState:
    mu = torch.full((batch,), opts.mu_init, dtype=dtype, device=device)
    tau = torch.clamp(1.0 - mu, min=opts.tau_min)
    return MuState(mu=mu, tau=tau)


def _new_mu_tau(mu, opts: Options):
    mu_min_bound = max(opts.mu_target,
                       min(opts.tol, opts.compl_inf_tol) / (opts.barrier_tol_factor + 1.0))
    new_mu = torch.clamp(
        torch.minimum(opts.mu_linear_decrease_factor * mu,
                      mu ** opts.mu_superlinear_decrease_power),
        min=mu_min_bound)
    new_tau = torch.clamp(1.0 - new_mu, min=opts.tau_min)
    return new_mu, new_tau


def monotone_mu_update_components(opts: Options, ms: MuState, dual_s, primal,
                                  compl_terms_max_fn, max_rounds: int = 30) -> MuState:
    """dual_s: dual_inf/s_d; primal: primal_inf; compl_terms_max_fn(mu) ->
    max_i |slack_i * mult_i - mu| / s_c, all per lane.  The decrease repeats
    per lane while the barrier problem is solved, at most ``max_rounds``
    times (the reference's bound with mu_allow_fast_monotone_decrease)."""
    mu, tau = ms.mu, ms.tau
    rounds = torch.zeros(mu.shape, dtype=torch.int64, device=mu.device)
    while True:
        err = torch.maximum(torch.maximum(dual_s, primal), compl_terms_max_fn(mu))
        converged = err <= opts.barrier_tol_factor * mu
        new_mu, new_tau = _new_mu_tau(mu, opts)
        active = converged & (new_mu < mu) & (rounds < max_rounds)
        if not host_bool(active.any()):
            break
        mu = torch.where(active, new_mu, mu)
        tau = torch.where(active, new_tau, tau)
        rounds = rounds + active.long()
    return MuState(mu=mu, tau=tau)


# ---------------------------------------------------------------------------
# Adaptive mu: the oracles and the free/monotone globalization
# (ipopt_tpu/algorithm/mu.py:104-459).
# ---------------------------------------------------------------------------

def _products(nlp, it: Iterate):
    """The four masked slack-multiplier product blocks."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    return ((nlp.has_xL, sl_xL * it.z_L), (nlp.has_xU, sl_xU * it.z_U),
            (nlp.has_dL, sl_sL * it.v_L), (nlp.has_dU, sl_sU * it.v_U))


def _n_compl(nlp):
    """Number of finite bounds per lane."""
    return (nlp.has_xL.sum(-1) + nlp.has_xU.sum(-1)
            + nlp.has_dL.sum(-1) + nlp.has_dU.sum(-1))


def _mmin(has, v):
    return min_init(torch.where(has, v, torch.full_like(v, math.inf)), math.inf)


def avg_complementarity(nlp, it: Iterate):
    """Average slack*multiplier product over the finite bounds, per lane
    (curr_avrg_compl, IpIpoptCalculatedQuantities.cpp:3611-3660); returns
    (avg, number of bounds)."""
    total = sum(_msum(has, p) for has, p in _products(nlp, it))
    ncomps = _n_compl(nlp)
    avg = total / torch.clamp(ncomps, min=1).to(total.dtype)
    return torch.where(ncomps > 0, avg, torch.zeros_like(avg)), ncomps


def min_complementarity(nlp, it: Iterate):
    blocks = [_mmin(has, p) for has, p in _products(nlp, it)]
    return torch.minimum(torch.minimum(blocks[0], blocks[1]),
                         torch.minimum(blocks[2], blocks[3]))


def loqo_mu(nlp, it: Iterate, opts: Options):
    """LOQO centrality rule (IpLoqoMuOracle.cpp): sigma = 0.1 min(0.05
    (1 - xi)/xi, 2)^3 with xi = min(compl)/avg(compl); mu = sigma * avg."""
    avg, ncomps = avg_complementarity(nlp, it)
    mn = min_complementarity(nlp, it)
    xi = torch.where(avg > 0, mn / torch.clamp(avg, min=1e-300),
                     torch.ones_like(avg))
    xi = torch.clamp(xi, 1e-12, 1.0)
    sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi) / xi, max=2.0) ** 3
    return torch.where(ncomps > 0, sigma * avg, torch.zeros_like(avg))


def _predicted_products(nlp, it: Iterate, step: Iterate, a_pr, a_du):
    """The products slack*multiplier after the step (a_pr, a_du), masked."""
    sl_xL, sl_xU, sl_sL, sl_sU = slacks(nlp, it)
    p, d = col(a_pr), col(a_du)

    def m(has, v):
        return torch.where(has, v, torch.zeros_like(v))

    return (m(nlp.has_xL, (sl_xL + p * step.x) * (it.z_L + d * step.z_L)),
            m(nlp.has_xU, (sl_xU - p * step.x) * (it.z_U + d * step.z_U)),
            m(nlp.has_dL, (sl_sL + p * step.s) * (it.v_L + d * step.v_L)),
            m(nlp.has_dU, (sl_sU - p * step.s) * (it.v_U + d * step.v_U)))


def probing_mu(nlp, it: Iterate, opts: Options, step_aff: Iterate):
    """Mehrotra probing (IpProbingMuOracle.cpp): the affine step to the
    boundary (tau = 1) predicts mu_aff; sigma = (mu_aff / mu_avg)^3."""
    avg, ncomps = avg_complementarity(nlp, it)
    a_pr, a_du = fraction_to_boundary(nlp, it, step_aff, 1.0)
    nxL, nxU, nsL, nsU = _predicted_products(nlp, it, step_aff, a_pr, a_du)
    mu_aff = ((nxL.sum(-1) + nxU.sum(-1) + nsL.sum(-1) + nsU.sum(-1))
              / torch.clamp(ncomps, min=1).to(avg.dtype))
    sigma = torch.clamp((mu_aff / torch.clamp(avg, min=1e-300)) ** 3,
                        opts.sigma_min, opts.sigma_max)
    return torch.where(ncomps > 0, sigma * avg, torch.zeros_like(avg))


def quality_function_mu(nlp, it: Iterate, opts: Options, step_aff: Iterate,
                        step_cent: Iterate, dual_inf, primal_inf, tau):
    """Quality-function oracle (IpQualityFunctionMuOracle.cpp): golden-section
    search over log(sigma) for the sigma minimizing the linear model of the
    KKT error after the step d_aff + sigma*mu_avg*d_cent.

    The reference's ``lax.while_loop`` is vmapped over a batch, so every lane
    steps until none is live and a finished lane's carry is frozen.  Here
    the loop runs its bound, ``quality_function_max_section_steps``, with the
    same freezing: no lane's result depends on when the others stop, and no
    step reads a value back to the host."""
    avg, ncomps = avg_complementarity(nlp, it)
    dtype, dev = avg.dtype, avg.device
    nsafe = torch.clamp(ncomps, min=1).to(dtype)
    has = (nlp.has_xL, nlp.has_xU, nlp.has_dL, nlp.has_dU)
    norm = opts.quality_function_norm_type
    cen = opts.quality_function_centrality
    bal = opts.quality_function_balancing_term

    def qf(sigma):
        mu_c = col(sigma * avg)
        step = Iterate(*(a + mu_c * c for a, c in zip(step_aff, step_cent)))
        a_pr, a_du = fraction_to_boundary(nlp, it, step, tau)
        prods = _predicted_products(nlp, it, step, a_pr, a_du)
        du = (1.0 - a_du) * dual_inf
        pr = (1.0 - a_pr) * primal_inf
        if norm == "1-norm":
            compl_v = sum(p.abs().sum(-1) for p in prods) / nsafe
            quality = du + pr + compl_v
        elif norm == "max-norm":
            mx = [max_init(p.abs(), 0.0) for p in prods]
            compl_v = torch.maximum(torch.maximum(mx[0], mx[1]),
                                    torch.maximum(mx[2], mx[3]))
            quality = torch.maximum(torch.maximum(du, pr), compl_v)
        else:  # "2-norm-squared" (default) and "2-norm" (same argmin)
            compl_v = torch.sqrt(sum((p ** 2).sum(-1) for p in prods) / nsafe)
            quality = du * du + pr * pr + compl_v * compl_v
            if norm == "2-norm":
                quality = torch.sqrt(quality)
        if cen != "none" or bal != "none":
            compl_avg = sum(p.sum(-1) for p in prods) / nsafe
            mins = [_mmin(h, p) for h, p in zip(has, prods)]
            compl_min = torch.minimum(torch.minimum(mins[0], mins[1]),
                                      torch.minimum(mins[2], mins[3]))
            xi = torch.clamp(torch.where(
                compl_avg > 0, compl_min / torch.clamp(compl_avg, min=1e-300),
                torch.ones_like(compl_avg)), 1e-12, 1.0)
            if cen == "log":
                quality = quality - compl_v * torch.log(xi)
            elif cen == "reciprocal":
                quality = quality + compl_v / xi
            elif cen == "cubed-reciprocal":
                quality = quality + compl_v / xi ** 3
            if bal == "cubic":
                quality = quality + torch.clamp(
                    torch.maximum(du, pr) - compl_v, min=0.0) ** 3
        return quality

    # Golden section on log(sigma) with the reference's two stopping
    # tolerances (PerformGoldenSection, IpQualityFunctionMuOracle.cpp:698-790)
    B = avg.shape[0]
    lo = torch.full((B,), math.log(opts.sigma_min), dtype=dtype, device=dev)
    hi = torch.full((B,), math.log(opts.sigma_max), dtype=dtype, device=dev)
    gr = 0.5 * (math.sqrt(5.0) - 1.0)
    tiny = torch.finfo(dtype).tiny
    m1, m2 = hi - gr * (hi - lo), lo + gr * (hi - lo)
    f1, f2 = qf(torch.exp(m1)), qf(torch.exp(m2))
    for _ in range(opts.quality_function_max_section_steps):
        width_live = (hi - lo) >= (opts.quality_function_section_sigma_tol
                                   * torch.clamp(hi.abs(), min=1.0))
        fmax = torch.clamp(torch.maximum(f1, f2), min=tiny)
        qf_live = (1.0 - torch.minimum(f1, f2) / fmax
                   ) >= opts.quality_function_section_qf_tol
        live = width_live & qf_live
        shrink_hi = f1 < f2
        new_lo = torch.where(shrink_hi, lo, m1)
        new_hi = torch.where(shrink_hi, m2, hi)
        n1, n2 = new_hi - gr * (new_hi - new_lo), new_lo + gr * (new_hi - new_lo)
        # one fresh evaluation per section: the kept midpoint's value moves
        f_new = qf(torch.exp(torch.where(shrink_hi, n1, n2)))
        nf1 = torch.where(shrink_hi, f_new, f2)
        nf2 = torch.where(shrink_hi, f1, f_new)
        lo, hi, m1, m2, f1, f2 = (torch.where(live, a, b) for a, b in zip(
            (new_lo, new_hi, n1, n2, nf1, nf2), (lo, hi, m1, m2, f1, f2)))
    sigma = torch.exp(torch.where(f1 < f2, m1, m2))
    return torch.where(ncomps > 0, sigma * avg, torch.zeros_like(avg))


_OBJ_FILTER_CAP = 32


class AdaptiveMuState(NamedTuple):
    """Per-lane carry of AdaptiveMuUpdate (IpAdaptiveMuUpdate.cpp:78-139):
    the mode, the kkt-error reference, the obj-constr filter (capacity
    ``_OBJ_FILTER_CAP``), the dynamic mu_max, the safeguard's initial
    infeasibilities (negative = not set yet) and whether this update fell
    back to monotone mode."""

    free_mode: Any          # (B,) bool
    ref_kkt_error: Any      # (B,)
    no_progress_count: Any  # (B,)
    filt_theta: Any         # (B, cap)
    filt_f: Any             # (B, cap)
    filt_size: Any          # (B,)
    mu_max_dyn: Any
    init_dual_inf: Any
    init_primal_inf: Any
    just_switched: Any      # (B,) bool


def adaptive_mu_init(batch: int, dtype, device) -> AdaptiveMuState:
    inf = torch.full((batch, _OBJ_FILTER_CAP), math.inf, dtype=dtype,
                     device=device)
    neg = torch.full((batch,), -1.0, dtype=dtype, device=device)
    false = torch.zeros((batch,), dtype=torch.bool, device=device)
    zi = torch.zeros((batch,), dtype=torch.int64, device=device)
    return AdaptiveMuState(
        free_mode=~false, ref_kkt_error=torch.full_like(neg, math.inf),
        no_progress_count=zi, filt_theta=inf, filt_f=inf.clone(),
        filt_size=zi, mu_max_dyn=neg, init_dual_inf=neg.clone(),
        init_primal_inf=neg.clone(), just_switched=false)


def adaptive_mu_update(opts: Options, ams: AdaptiveMuState, ms: MuState,
                       oracle_mu, dual_s, primal, compl_fn, theta_curr, f_curr,
                       avg_compl_val, dual1_avg, primal1_avg, fix_mu_val=None):
    """One adaptive update of every lane (IpAdaptiveMuUpdate.cpp:78-139,
    ``ipopt_tpu/algorithm/mu.py:319-459``); returns (AdaptiveMuState,
    MuState).

    Free mode takes mu from the oracle, floored by the lower-mu safeguard
    and mu_min and capped at mu_max (while mu_max is at its registered
    default, at mu_max_fact * the first average complementarity).  The
    globalization (kkt-error, obj-constr-filter or never-monotone-mode)
    decides the fall-back to monotone mode, whose entry level is
    ``fix_mu_val`` (the fixed_mu_oracle value; None = the average
    complementarity rule); a lane returns to free mode once its barrier
    problem is solved."""
    compl0 = compl_fn(0.0)
    knorm = opts.adaptive_mu_kkt_norm_type
    if knorm == "1-norm":
        kkt_error = dual_s + primal + compl0
    elif knorm == "2-norm-squared":
        kkt_error = dual_s ** 2 + primal ** 2 + compl0 ** 2
    elif knorm == "2-norm":
        kkt_error = torch.sqrt(dual_s ** 2 + primal ** 2 + compl0 ** 2)
    else:  # "max-norm"
        kkt_error = torch.maximum(torch.maximum(dual_s, primal), compl0)

    # the effective mu_max (mu_max_fact, IpAdaptiveMuUpdate.cpp:269-275)
    mu_max_dyn = ams.mu_max_dyn
    if opts.mu_max == Options.__dataclass_fields__["mu_max"].default:
        mu_max_dyn = torch.where(ams.mu_max_dyn < 0,
                                 opts.mu_max_fact * avg_compl_val, ams.mu_max_dyn)
        mu_max_eff = torch.where(mu_max_dyn > 0, mu_max_dyn,
                                 torch.full_like(mu_max_dyn, opts.mu_max))
    else:
        mu_max_eff = torch.full_like(oracle_mu, opts.mu_max)

    # the lower-mu safeguard (adaptive_mu_safeguard_factor, :748-787)
    init_d, init_p = ams.init_dual_inf, ams.init_primal_inf
    fac = opts.adaptive_mu_safeguard_factor
    if fac != 0.0:
        init_d = torch.where(init_d < 0, torch.clamp(dual1_avg, min=1.0), init_d)
        init_p = torch.where(init_p < 0, torch.clamp(primal1_avg, min=1.0), init_p)
        mu_guard = torch.maximum(fac * dual1_avg / init_d,
                                 fac * primal1_avg / init_p)
        if opts.adaptive_mu_globalization == "kkt-error":
            mu_guard = torch.minimum(mu_guard, ams.ref_kkt_error)
    else:
        mu_guard = torch.zeros_like(oracle_mu)

    mu_free = torch.minimum(
        torch.maximum(torch.clamp(oracle_mu, min=opts.mu_min), mu_guard),
        mu_max_eff)
    tau_free = torch.clamp(1.0 - mu_free, min=opts.tau_min)

    filt_theta, filt_f, filt_size = ams.filt_theta, ams.filt_f, ams.filt_size
    glob = opts.adaptive_mu_globalization
    if glob == "obj-constr-filter":
        # CheckSufficientProgress: the (theta, f) pair must not be dominated
        blocked = ((theta_curr[:, None] >= ams.filt_theta)
                   & (f_curr[:, None] >= ams.filt_f)).any(-1)
        progress = ~blocked
        count = torch.where(progress, torch.zeros_like(ams.no_progress_count),
                            ams.no_progress_count + 1)
        new_ref = ams.ref_kkt_error
        switch_to_monotone = ams.free_mode & blocked
        # RememberCurrentPoint: augment with a margin (filter_margin_fact)
        margin = torch.clamp(opts.filter_margin_fact
                             * torch.clamp(theta_curr, min=1.0),
                             max=opts.filter_max_margin)
        i = torch.clamp(filt_size, max=_OBJ_FILTER_CAP - 1).unsqueeze(-1)
        aug = (ams.free_mode & progress)[:, None]
        filt_theta = torch.where(aug, filt_theta.scatter(
            -1, i, (theta_curr - margin).unsqueeze(-1)), filt_theta)
        filt_f = torch.where(aug, filt_f.scatter(
            -1, i, (f_curr - margin).unsqueeze(-1)), filt_f)
        filt_size = torch.where(aug[:, 0],
                                torch.clamp(filt_size + 1, max=_OBJ_FILTER_CAP),
                                filt_size)
    elif glob == "never-monotone-mode":
        count = torch.zeros_like(ams.no_progress_count)
        new_ref = ams.ref_kkt_error
        switch_to_monotone = torch.zeros_like(ams.free_mode)
    else:  # "kkt-error"
        progress = kkt_error <= opts.adaptive_mu_kkterror_red_fact * ams.ref_kkt_error
        count = torch.where(progress, torch.zeros_like(ams.no_progress_count),
                            ams.no_progress_count + 1)
        new_ref = torch.minimum(kkt_error, ams.ref_kkt_error)
        switch_to_monotone = ams.free_mode & (
            count >= opts.adaptive_mu_kkterror_red_iters)

    # monotone mode (NewFixedMu, IpAdaptiveMuUpdate.cpp:583-623): enter at the
    # fixed_mu_oracle value, else adaptive_mu_monotone_init_factor * the
    # average complementarity, floored by the safeguard and mu_min
    if fix_mu_val is not None:
        mono_entry_mu = fix_mu_val
    else:
        mono_entry_mu = opts.adaptive_mu_monotone_init_factor * avg_compl_val
    mono_entry_mu = torch.clamp(torch.maximum(mono_entry_mu, mu_guard),
                                min=opts.mu_min)
    ms_for_mono = MuState(mu=torch.where(switch_to_monotone, mono_entry_mu, ms.mu),
                          tau=ms.tau)
    ms_mono = monotone_mu_update_components(opts, ms_for_mono, dual_s, primal,
                                            compl_fn)
    err_at_mu = torch.maximum(torch.maximum(dual_s, primal), compl_fn(ms.mu))
    back_to_free = ~ams.free_mode & (err_at_mu <= opts.barrier_tol_factor * ms.mu)
    free_now = torch.where(switch_to_monotone, torch.zeros_like(back_to_free),
                           back_to_free | ams.free_mode)

    mu = torch.where(free_now, mu_free, ms_mono.mu)
    tau = torch.where(free_now, tau_free, ms_mono.tau)
    new_ams = AdaptiveMuState(
        free_mode=free_now,
        ref_kkt_error=torch.where(switch_to_monotone,
                                  torch.full_like(new_ref, math.inf), new_ref),
        no_progress_count=torch.where(switch_to_monotone,
                                      torch.zeros_like(count), count),
        filt_theta=filt_theta, filt_f=filt_f, filt_size=filt_size,
        mu_max_dyn=mu_max_dyn, init_dual_inf=init_d, init_primal_inf=init_p,
        just_switched=switch_to_monotone)
    return new_ams, MuState(mu=mu, tau=tau)
