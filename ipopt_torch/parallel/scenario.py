"""Scenario-decomposed (two-stage stochastic) NLPs, whose augmented KKT
systems are block-arrow (port of ``ipopt_tpu/parallel/scenario.py``).

    min  f0(x0) + sum_s f_s(x0, x_s, theta_s)
    s.t. gs_L <= g_s(x0, x_s, theta_s) <= gs_U        s = 1..S
         bounds on x0 and x_s

The scenario callables are torch functions of one scenario, evaluated over
the scenarios (and the lanes of a batch) with ``torch.func.vmap``; theta_s
carries the scenario data (a tensor or a dict of tensors with leading axis
S).  The augmented KKT is block-arrow,

    [ K_1          C_1 ]
    [      ...     ... ]
    [          K_S C_S ]
    [ C_1^T ... C_S^T  K_0 ]

with K_s the scenario block over w_s = [x_s | s_s | y_s] and K_0 the shared
block over x0 (``algorithm/arrow_kkt.py``).  ``canonicalize_scenario`` gives
a regular ``CanonicalNLP`` whose flat closures sum/stack the scenarios, plus
the static ``ArrowInfo`` in its ``chain`` field, on which evaluation and the
KKT backend dispatch.  The arrow backend solves one problem (B = 1).

The scenario axis over devices (the reference shards the scenario leaves
over a mesh with ``device_put`` and GSPMD turns the Schur reduction into a
``psum``): ``canonicalize_scenario(..., devices=[...])`` records one device
per group of scenarios in ``ArrowInfo.devices``; the arrow factorization
then cuts the S scenarios into that many contiguous groups, factors and
back-solves each group on its device, and sums the groups' Schur and
right-hand-side reductions on the first device
(``algorithm/arrow_kkt.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import hessian, jacfwd, vmap

from ..options import Options
from ..problem import NLP, CanonicalNLP, canonicalize
from ..scaling import grad_scale_factor
from ..types import max_init, tree_map


@dataclasses.dataclass
class ScenarioNLP:
    """User spec.  f_scen(x0, xs, theta_s) -> scalar; g_scen(x0, xs,
    theta_s) -> (ms,) (build it with ``torch.stack``).  x0_init (n0,),
    xs_init (S, ns); g_L/g_U broadcastable to (S, ms); x0_L/x0_U to (n0,),
    xs_L/xs_U to (S, ns); theta with leading axis S (optional); f0(x0) ->
    scalar (optional)."""

    f_scen: Callable
    g_scen: Callable
    x0_init: Any
    xs_init: Any
    g_L: Any = None
    g_U: Any = None
    x0_L: Any = None
    x0_U: Any = None
    xs_L: Any = None
    xs_U: Any = None
    theta: Any = None
    f0: Optional[Callable] = None
    name: str = "scenario"


@dataclasses.dataclass(frozen=True, eq=False)
class ArrowInfo:
    """Static scenario structure attached to ``CanonicalNLP.chain``."""

    S: int
    n0: int
    ns: int
    ms: int
    f_scen: Callable
    g_scen: Callable
    f0: Optional[Callable]
    eq_mask: np.ndarray  # (S, ms) bool
    # one device per contiguous group of scenarios (empty: no groups)
    devices: Tuple[torch.device, ...] = ()
    _cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def bs(self):
        """Scenario block size [x_s | s_s | y_s]."""
        return self.ns + 2 * self.ms

    def _key(self):
        return (self.S, self.n0, self.ns, self.ms, self.f_scen, self.g_scen,
                self.f0, self.eq_mask.tobytes())

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, ArrowInfo) and self._key() == other._key()

    def ineq_row(self, device) -> torch.Tensor:
        """``~eq_mask`` as an (S, ms) bool tensor on ``device`` (cached)."""
        key = ("ineq_row", str(device))
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(~self.eq_mask, device=device)
            self._cache[key] = t
        return t


def flat_callables(S: int, n0: int, ns: int, f_scen, g_scen, f0=None):
    """The flat ``f(x_full, params)`` and ``g(x_full, params)`` of a
    scenario problem, x = [x0 (n0) | X_s (S ns)], theta in
    ``params["theta"]``."""

    def f_flat(xfull, params):
        x0 = xfull[:n0]
        Xs = xfull[n0:].reshape(S, ns)
        total = vmap(f_scen, in_dims=(None, 0, 0))(x0, Xs, params["theta"]).sum()
        if f0 is not None:
            total = total + f0(x0)
        return total

    def g_flat(xfull, params):
        x0 = xfull[:n0]
        Xs = xfull[n0:].reshape(S, ns)
        return vmap(g_scen, in_dims=(None, 0, 0))(x0, Xs,
                                                   params["theta"]).reshape(-1)

    return f_flat, g_flat


def _tensor_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tensor_tree(t, dtype) for k, t in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device="cpu", dtype=dtype)
    return torch.as_tensor(np.asarray(tree, dtype=np.float64), dtype=dtype)


def canonicalize_scenario(sn: ScenarioNLP, options: Optional[Options] = None,
                          device=None, devices: Optional[Sequence] = None
                          ) -> CanonicalNLP:
    """The canonical form (B = 1) of a scenario problem
    (``ipopt_tpu/parallel/scenario.py:99-166``), on ``device`` (default the
    CPU): flat layout, the equality mask, canonicalization without scaling,
    then the gradient scaling from the scenario Jacobians.  ``devices`` (one
    entry per group of scenarios, repeats allowed) splits the scenario
    blocks of the arrow factorization into that many contiguous groups, each
    factored on its device."""
    opts = options or Options()
    dtype = torch.float64 if opts.dtype == "float64" else torch.float32
    x0i = np.asarray(sn.x0_init, np.float64)
    xsi = np.asarray(sn.xs_init, np.float64)
    n0 = x0i.shape[0]
    S, ns = xsi.shape
    theta = _tensor_tree(np.zeros((S, 0)) if sn.theta is None else sn.theta,
                         dtype)
    th0 = tree_map(lambda t: t[0], theta)
    with torch.no_grad():
        ms = int(sn.g_scen(torch.as_tensor(x0i, dtype=dtype),
                           torch.as_tensor(xsi[0], dtype=dtype), th0).shape[0])
    f_flat, g_flat = flat_callables(S, n0, ns, sn.f_scen, sn.g_scen, sn.f0)

    def bc(b, default, shape):
        return np.broadcast_to(np.asarray(default if b is None else b,
                                          np.float64), shape)

    g_L = bc(sn.g_L, -np.inf, (S, ms)).reshape(-1)
    g_U = bc(sn.g_U, np.inf, (S, ms)).reshape(-1)
    x_L = np.concatenate([bc(sn.x0_L, -np.inf, (n0,)),
                          bc(sn.xs_L, -np.inf, (S, ns)).reshape(-1)])
    x_U = np.concatenate([bc(sn.x0_U, np.inf, (n0,)),
                          bc(sn.xs_U, np.inf, (S, ns)).reshape(-1)])
    flat = NLP(f=f_flat, g=g_flat, x0=np.concatenate([x0i, xsi.reshape(-1)]),
               x_L=x_L, x_U=x_U, g_L=g_L, g_U=g_U, params={"theta": theta},
               name=sn.name)

    gl_eff = np.where(g_L <= opts.nlp_lower_bound_inf, -np.inf, g_L)
    gu_eff = np.where(g_U >= opts.nlp_upper_bound_inf, np.inf, g_U)
    eq_mask = (gl_eff == gu_eff).reshape(S, ms)
    info = ArrowInfo(S=S, n0=n0, ns=ns, ms=ms, f_scen=sn.f_scen,
                     g_scen=sn.g_scen, f0=sn.f0, eq_mask=eq_mask,
                     devices=tuple(torch.device(d) for d in devices or ()))
    base = canonicalize(flat, opts.replace(nlp_scaling_method="none"),
                        dtype=dtype, device=device)
    if base.struct.n != n0 + S * ns:
        raise ValueError("fixed variables are not supported in scenario "
                         "problems")
    base = base._replace(chain=info)
    if opts.nlp_scaling_method == "gradient-based":
        base = _scenario_gradient_scaling(base, opts)
    return base


def _scenario_gradient_scaling(nlp: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """GradientScaling from the scenario Jacobians at x0 (no dense J,
    ``scenario.py:169-195``)."""
    s = nlp.struct
    dtype, dev = nlp.dtype, nlp.device
    gf = nlp.eval_grad_f(nlp.x0)
    df = grad_scale_factor(max_init(gf.abs(), 0.0), opts,
                           opts.nlp_scaling_obj_target_gradient)
    df = df * opts.obj_scaling_factor
    J0, Js = scenario_jacobians(nlp, nlp.x0)  # the row scale is all ones here
    row_norm = torch.maximum(max_init(J0.abs(), 0.0),
                             max_init(Js.abs(), 0.0)).reshape(nlp.batch, -1)
    dg = grad_scale_factor(row_norm, opts, opts.nlp_scaling_constr_target_gradient)
    c_scale = dg[:, s.index("eq_idx", dev)] if s.me else nlp.c_scale
    d_scale = dg[:, s.index("ineq_idx", dev)] if s.mi else nlp.d_scale
    return nlp._replace(
        obj_scale=df.to(dtype), c_scale=c_scale.to(dtype),
        d_scale=d_scale.to(dtype), d_L=nlp.d_L * d_scale, d_U=nlp.d_U * d_scale)


# ---------------------------------------------------------------------------
# Structured evaluations (scenario blocks of every lane)
# ---------------------------------------------------------------------------

def _split_x(ar: ArrowInfo, x):
    """x (B, n) -> (x0 (B, n0), X_s (B, S, ns))."""
    return x[:, :ar.n0], x[:, ar.n0:].reshape(x.shape[0], ar.S, ar.ns)


def scatter_rows(nlp: CanonicalNLP, eq_vals, ineq_vals, fill=0.0):
    """(B, S, ms) scenario-row array with ``eq_vals`` (B, me) at the equality
    rows and ``ineq_vals`` (B, mi) at the inequality rows."""
    ar, s = nlp.chain, nlp.struct
    ref = eq_vals if s.me else ineq_vals
    flat = torch.full((ref.shape[0], ar.S * ar.ms), fill, dtype=ref.dtype,
                      device=ref.device)
    if s.me:
        flat[:, s.index("eq_idx", ref.device)] = eq_vals
    if s.mi:
        flat[:, s.index("ineq_idx", ref.device)] = ineq_vals
    return flat.reshape(-1, ar.S, ar.ms)


def _row_scale(nlp: CanonicalNLP):
    """(B, S, ms): c_scale on equality rows, d_scale on inequality rows."""
    return scatter_rows(nlp, nlp.c_scale, nlp.d_scale, fill=1.0)


def scenario_jacobians(nlp: CanonicalNLP, x):
    """J0 (B, S, ms, n0) = dg_s/dx0 and Js (B, S, ms, ns) = dg_s/dx_s, row
    scaling included (``scenario.py:212-226``)."""
    ar: ArrowInfo = nlp.chain
    x0, Xs = _split_x(ar, x)

    def jac_one(a0, xs, th):
        JA = jacfwd(lambda a: ar.g_scen(a, xs, th))(a0)
        JB = jacfwd(lambda b: ar.g_scen(a0, b, th))(xs)
        return JA, JB

    J0, Js = vmap(vmap(jac_one, in_dims=(None, 0, 0)))(x0, Xs,
                                                        nlp.params["theta"])
    rs = _row_scale(nlp)[..., None]
    return J0 * rs, Js * rs


def scenario_hessians(nlp: CanonicalNLP, x, y_c, y_d):
    """Lagrangian Hessian blocks: W00 (B, n0, n0), W0s (B, S, ns, n0) (rows
    x_s, columns x0) and Wss (B, S, ns, ns) (``scenario.py:228-259``)."""
    ar: ArrowInfo = nlp.chain
    n0 = ar.n0
    x0, Xs = _split_x(ar, x)
    Y = scatter_rows(nlp, y_c, y_d) * _row_scale(nlp)

    def hess_one(a0, xs, th, yk, osc):
        def lag(z):
            a, b = z[:n0], z[n0:]
            return osc * ar.f_scen(a, b, th) + torch.dot(yk, ar.g_scen(a, b, th))
        return hessian(lag)(torch.cat([a0, xs]))

    H = vmap(vmap(hess_one, in_dims=(None, 0, 0, 0, None)))(
        x0, Xs, nlp.params["theta"], Y, nlp.obj_scale)
    W00 = H[:, :, :n0, :n0].sum(1)
    if ar.f0 is not None:
        W00 = W00 + nlp.obj_scale[:, None, None] * vmap(hessian(ar.f0))(x0)
    return W00, H[:, :, n0:, :n0], H[:, :, n0:, n0:]
