"""Stage-chained NLPs, whose augmented KKT systems are block-tridiagonal
(port of ``ipopt_tpu/chained.py``).

    min   sum_k f_k(x_k, x_{k+1}, theta_k)  [+ f_last(x_K)]
    s.t.  g_L_k <= g_k(x_k, x_{k+1}, theta_k) <= g_U_k     k = 0..K-1
          x_L <= x <= x_U

with x split into K+1 groups of ``v`` variables.  The stage callables are
torch functions of one stage, evaluated over the stages (and the lanes of a
batch) with ``torch.func.vmap``; constraint Jacobians and Lagrangian
Hessians come as stage blocks, and the KKT matrix is assembled straight into
block-tridiagonal form (``algorithm/chained_kkt.py``): no dense n x n object
is ever built.

``canonicalize_chained`` gives a regular ``CanonicalNLP`` whose flat
closures sum/stack the stages, plus the static ``ChainInfo`` in its
``chain`` field, on which evaluation and the KKT backend dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import hessian, jacfwd, vmap

from .options import Options
from .problem import NLP, CanonicalNLP, canonicalize
from .scaling import grad_scale_factor
from .types import max_init


@dataclasses.dataclass
class ChainedNLP:
    """User spec for a chained problem.

    f_stage(xk, xk1, theta_k) -> scalar, summed over stages.
    g_stage(xk, xk1, theta_k) -> (mk,);  g_L/g_U broadcastable to (K, mk).
    x0: (K+1, v);  x_L/x_U broadcastable to (K+1, v).
    theta: per-stage parameters with leading axis K (an array or a dict of
    arrays; optional).  f_last(xK) -> scalar: optional terminal term.
    """

    f_stage: Callable
    g_stage: Callable
    x0: Any
    g_L: Any = None
    g_U: Any = None
    x_L: Any = None
    x_U: Any = None
    theta: Any = None
    f_last: Optional[Callable] = None
    name: str = "chained"


@dataclasses.dataclass(frozen=True, eq=False)
class ChainInfo:
    """Static stage structure attached to ``CanonicalNLP.chain``.  Two are
    equal when their sizes, row classes and stage callables are (the
    callables compare with ``==``), so lanes canonicalized separately from
    one model stack into one batch."""

    K: int
    v: int
    mk: int
    f_stage: Callable
    g_stage: Callable
    f_last: Optional[Callable]
    eq_mask: np.ndarray     # (K, mk) bool
    _cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def bs(self):
        """Stage block size of the augmented KKT: [x | s | y]."""
        return self.v + 2 * self.mk

    def _key(self):
        return (self.K, self.v, self.mk, self.f_stage, self.g_stage,
                self.f_last, self.eq_mask.tobytes())

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, ChainInfo) and self._key() == other._key()

    def ineq_row(self, device) -> torch.Tensor:
        """``~eq_mask`` as a (K, mk) bool tensor on ``device`` (cached)."""
        key = ("ineq_row", str(device))
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(~self.eq_mask, device=device)
            self._cache[key] = t
        return t


def flat_callables(K: int, v: int, f_stage, g_stage, f_last=None):
    """The flat ``f(x_full, params)`` and ``g(x_full, params)`` of a chain:
    the stage functions over the K stages, theta in ``params["theta"]``."""

    def f_flat(xfull, params):
        X = xfull.reshape(K + 1, v)
        total = vmap(f_stage)(X[:-1], X[1:], params["theta"]).sum()
        if f_last is not None:
            total = total + f_last(X[-1])
        return total

    def g_flat(xfull, params):
        X = xfull.reshape(K + 1, v)
        return vmap(g_stage)(X[:-1], X[1:], params["theta"]).reshape(-1)

    return f_flat, g_flat


def _tensor_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tensor_tree(t, dtype) for k, t in tree.items()}
    return torch.as_tensor(np.asarray(tree, dtype=np.float64), dtype=dtype)


def canonicalize_chained(cnlp: ChainedNLP, options: Optional[Options] = None,
                         device=None) -> CanonicalNLP:
    """The canonical form (B = 1) of a chained problem
    (``ipopt_tpu/chained.py:95-159``), on ``device`` (default the CPU)."""
    opts = options or Options()
    dtype = torch.float64 if opts.dtype == "float64" else torch.float32
    x0 = np.asarray(cnlp.x0, np.float64)
    Kp1, v = x0.shape
    K = Kp1 - 1
    theta = _tensor_tree(np.zeros((K, 0)) if cnlp.theta is None else cnlp.theta,
                         dtype)
    th0 = {k: t[0] for k, t in theta.items()} if isinstance(theta, dict) else theta[0]
    x0t = torch.as_tensor(x0, dtype=dtype)
    with torch.no_grad():
        mk = int(cnlp.g_stage(x0t[0], x0t[1], th0).shape[0])
    f_flat, g_flat = flat_callables(K, v, cnlp.f_stage, cnlp.g_stage, cnlp.f_last)

    def bcast(val, default, shape):
        return np.broadcast_to(np.asarray(default if val is None else val,
                                          np.float64), shape).reshape(-1)

    g_L = bcast(cnlp.g_L, -np.inf, (K, mk))
    g_U = bcast(cnlp.g_U, np.inf, (K, mk))
    x_L = None if cnlp.x_L is None else bcast(cnlp.x_L, None, (Kp1, v))
    x_U = None if cnlp.x_U is None else bcast(cnlp.x_U, None, (Kp1, v))
    flat = NLP(f=f_flat, g=g_flat, x0=x0.reshape(-1), x_L=x_L, x_U=x_U,
               g_L=g_L, g_U=g_U, params={"theta": theta}, name=cnlp.name)

    gl_eff = np.where(g_L <= opts.nlp_lower_bound_inf, -np.inf, g_L)
    gu_eff = np.where(g_U >= opts.nlp_upper_bound_inf, np.inf, g_U)
    eq_mask = (gl_eff == gu_eff).reshape(K, mk)
    info = ChainInfo(K=K, v=v, mk=mk, f_stage=cnlp.f_stage,
                     g_stage=cnlp.g_stage, f_last=cnlp.f_last, eq_mask=eq_mask)

    # the generic gradient scaling would build the dense Jacobian: scale
    # from the stage Jacobians instead
    base = canonicalize(flat, opts.replace(nlp_scaling_method="none"),
                        dtype=dtype, device=device)
    if base.struct.n != Kp1 * v:
        raise ValueError("fixed-variable elimination is not supported for "
                         "chained problems; use fixed_variable_treatment="
                         "'relax_bounds'")
    base = base._replace(chain=info)
    if opts.nlp_scaling_method == "gradient-based":
        base = _chained_gradient_scaling(base, opts)
    return base


def _chained_gradient_scaling(nlp: CanonicalNLP, opts: Options) -> CanonicalNLP:
    """GradientScaling from the stage Jacobians at x0 (no dense J)."""
    s = nlp.struct
    dtype, dev = nlp.dtype, nlp.device
    gf = nlp.eval_grad_f(nlp.x0)
    df = grad_scale_factor(max_init(gf.abs(), 0.0), opts,
                           opts.nlp_scaling_obj_target_gradient)
    df = df * opts.obj_scaling_factor
    A, Bm = stage_jacobians(nlp, nlp.x0)  # row_scale is all ones here
    row_norm = torch.maximum(max_init(A.abs(), 0.0),
                             max_init(Bm.abs(), 0.0)).reshape(nlp.batch, -1)
    dg = grad_scale_factor(row_norm, opts, opts.nlp_scaling_constr_target_gradient)
    c_scale = dg[:, s.index("eq_idx", dev)] if s.me else nlp.c_scale
    d_scale = dg[:, s.index("ineq_idx", dev)] if s.mi else nlp.d_scale
    return nlp._replace(
        obj_scale=df.to(dtype), c_scale=c_scale.to(dtype),
        d_scale=d_scale.to(dtype), d_L=nlp.d_L * d_scale, d_U=nlp.d_U * d_scale)


# ---------------------------------------------------------------------------
# Structured evaluations (stage blocks of every lane)
# ---------------------------------------------------------------------------

def scatter_rows(nlp: CanonicalNLP, eq_vals, ineq_vals, fill=0.0):
    """(B, K, mk) stage-row array with ``eq_vals`` (B, me) at the equality
    rows and ``ineq_vals`` (B, mi) at the inequality rows."""
    ch, s = nlp.chain, nlp.struct
    ref = eq_vals if s.me else ineq_vals
    flat = torch.full((ref.shape[0], ch.K * ch.mk), fill, dtype=ref.dtype,
                      device=ref.device)
    if s.me:
        flat[:, s.index("eq_idx", ref.device)] = eq_vals
    if s.mi:
        flat[:, s.index("ineq_idx", ref.device)] = ineq_vals
    return flat.reshape(-1, ch.K, ch.mk)


def row_scale(nlp: CanonicalNLP):
    """(B, K, mk) per-row scale: c_scale on equality rows, d_scale on
    inequality rows."""
    return scatter_rows(nlp, nlp.c_scale, nlp.d_scale, fill=1.0)


def stage_jacobians(nlp: CanonicalNLP, x):
    """Scaled stage Jacobians A = d g_k / d x_k and B = d g_k / d x_{k+1},
    each (B, K, mk, v), constraint-row scaling included."""
    ch = nlp.chain
    X = x.reshape(x.shape[0], ch.K + 1, ch.v)

    def jac_one(xk, xk1, th):
        JA = jacfwd(lambda a: ch.g_stage(a, xk1, th))(xk)
        JB = jacfwd(lambda b: ch.g_stage(xk, b, th))(xk1)
        return JA, JB

    A, Bm = vmap(vmap(jac_one))(X[:, :-1], X[:, 1:], nlp.params["theta"])
    rs = row_scale(nlp)[..., None]
    return A * rs, Bm * rs


def stage_hessians(nlp: CanonicalNLP, x, y_c, y_d):
    """Scaled Lagrangian Hessian stage blocks: Wd (B, K+1, v, v) and
    Wo (B, K, v, v) with Wo[:, k] = W[x_{k+1}, x_k]."""
    ch = nlp.chain
    v = ch.v
    X = x.reshape(x.shape[0], ch.K + 1, v)
    Y = scatter_rows(nlp, y_c, y_d) * row_scale(nlp)

    def hess_one(xk, xk1, th, yk, osc):
        def lag(z):
            a, b = z[:v], z[v:]
            return osc * ch.f_stage(a, b, th) + torch.dot(yk, ch.g_stage(a, b, th))
        return hessian(lag)(torch.cat([xk, xk1]))

    H = vmap(vmap(hess_one, in_dims=(0, 0, 0, 0, None)))(
        X[:, :-1], X[:, 1:], nlp.params["theta"], Y, nlp.obj_scale)
    Wd = X.new_zeros(X.shape + (v,))
    Wd[:, :-1] += H[..., :v, :v]
    Wd[:, 1:] += H[..., v:, v:]
    if ch.f_last is not None:
        Wd[:, -1] += nlp.obj_scale[:, None, None] * vmap(hessian(ch.f_last))(X[:, -1])
    return Wd, H[..., v:, :v]
