"""Problem definition and canonicalization — the TNLP / TNLPAdapter equivalent.

Port of ``ipopt_tpu/problem.py``.  The user gives two **torch** functions
``f(x)`` and ``g(x)`` of one instance (``x`` of shape (n_full,)) plus bound
arrays; gradients, Jacobians and the Lagrangian Hessian come from
``torch.func`` (``grad`` / ``jacfwd`` / ``hessian``) in place of the
reference's ``jax.grad`` / ``jax.jacfwd`` / ``jax.hessian``
(``ipopt_tpu/problem.py:191,232,239,254``).

Batch-first: every array field of a ``CanonicalNLP`` carries a leading batch
axis B.  The callables are shared by all instances (per-instance data travels
in the arrays and in ``params``, as in ``ipopt_tpu/batch.py:98-100``) and are
evaluated over the batch with ``torch.func.vmap``.  ``canonicalize`` builds the
case B = 1; ``ipopt_torch.batch.stack_problems`` concatenates instances.

The static analysis (eq/ineq split, fixed variables, bound relaxation) is done
once in numpy, exactly as in the reference (``IpTNLPAdapter.cpp:313``,
``IpOrigIpoptNLP.cpp:54``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, hessian, jacfwd, vjp, vmap

from .options import Options
from .types import DeviceConstant, tree_map, tree_take


@dataclasses.dataclass
class NLP:
    """User problem spec:  min f(x)  s.t.  g_L <= g(x) <= g_U,  x_L <= x <= x_U.

    ``f`` and ``g`` take one instance's x (a 1-D tensor); ``g`` returns a 1-D
    tensor (build it with ``torch.stack``).  With ``params`` set, they take
    ``(x, params)`` and ``params`` may differ per instance of a batch.
    ``jac_g_sparsity`` and ``lag_hess_sparsity`` optionally declare the
    (rows, cols) COO patterns of dg/dx and of the Lagrangian Hessian (either
    triangle or full) for ``linear_solver="banded-bcr"``
    (``ipopt_torch.sparse``); without them that backend detects the patterns
    of a small problem.  ``canonicalize`` ignores them.  ``y0``, ``z_L0``
    and ``z_U0`` are starting multipliers, read only with
    ``warm_start_init_point=True``.
    """

    f: Callable[..., Any]
    x0: Any
    g: Optional[Callable[..., Any]] = None
    x_L: Optional[Any] = None
    x_U: Optional[Any] = None
    g_L: Optional[Any] = None
    g_U: Optional[Any] = None
    params: Optional[Any] = None
    jac_g_sparsity: Optional[Any] = None
    lag_hess_sparsity: Optional[Any] = None
    name: str = "nlp"
    # starting multipliers for a warm start (warm_start_init_point): y0 (m,)
    # in user constraint order, z_L0 / z_U0 (n_full,)
    y0: Optional[Any] = None
    z_L0: Optional[Any] = None
    z_U0: Optional[Any] = None


@dataclasses.dataclass(frozen=True, eq=False)
class CanonicalStructure:
    """Static (numpy) structure computed once at setup; identical for every
    instance of a batch."""

    n_full: int
    n: int
    m: int
    me: int
    mi: int
    eq_idx: np.ndarray
    ineq_idx: np.ndarray
    free_idx: np.ndarray
    fixed_idx: np.ndarray
    fixed_treatment: str
    # gradient_approximation / jacobian_approximation =
    # "finite-difference-values": forward differences with this perturbation
    # (0 = exact AD; ``problem.py:86-99``)
    fd_grad_eps: float = 0.0
    fd_jac_eps: float = 0.0
    _index_cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def _key(self):
        return (self.n_full, self.n, self.m, self.me, self.mi,
                self.eq_idx.tobytes(), self.ineq_idx.tobytes(),
                self.free_idx.tobytes(), self.fixed_idx.tobytes(),
                self.fixed_treatment, self.fd_grad_eps, self.fd_jac_eps)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return (isinstance(other, CanonicalStructure)
                and self._key() == other._key())

    def index(self, name: str, device) -> torch.Tensor:
        """The index array ``name`` as a tensor on ``device`` (cached).
        ``"perm"`` maps user-space positions into ``cat([x, x_fixed])``."""
        key = (name, str(device))
        t = self._index_cache.get(key)
        if t is None:
            if name == "perm":
                perm = self.n + np.arange(self.n_full)
                perm[self.free_idx] = np.arange(self.n)
                arr = perm
            else:
                arr = getattr(self, name)
            t = torch.as_tensor(np.asarray(arr, dtype=np.int64), device=device)
            self._index_cache[key] = t
        return t


ARRAY_FIELDS = ("params", "x_L", "x_U", "d_L", "d_U", "has_xL", "has_xU",
                "has_dL", "has_dU", "c_rhs", "x_fixed", "x0", "x_L_orig",
                "x_U_orig", "obj_scale", "c_scale", "d_scale")


class CanonicalNLP(NamedTuple):
    """The internal problem form (NLP layer, IpNLP.hpp:41):

        min f(x)   s.t.  c(x) = 0,   d_L <= d(x) <= d_U,   x_L <= x <= x_U

    with relaxed bounds, masks for infinite bounds and scaling applied inside
    the evaluations.  ``f`` and ``g`` have the internal per-instance
    signature ``(x_full, params)``.  Array shapes: x_L/x_U/x0 (B, n),
    d_L/d_U (B, mi), c_rhs (B, me), x_fixed (B, n_full), obj_scale (B,),
    c_scale (B, me), d_scale (B, mi); ``params`` is a tree of (B, ...)
    tensors or ``()``.  ``chain`` is the static stage structure of a chained
    problem (``ipopt_torch.chained.ChainInfo``), shared by every lane, or
    None; the KKT backend and the structured evaluations dispatch on it.
    """

    struct: CanonicalStructure
    f: Callable
    g: Optional[Callable]
    params: Any
    x_L: Any
    x_U: Any
    d_L: Any
    d_U: Any
    has_xL: Any
    has_xU: Any
    has_dL: Any
    has_dU: Any
    c_rhs: Any
    x_fixed: Any
    x0: Any
    x_L_orig: Any
    x_U_orig: Any
    obj_scale: Any
    c_scale: Any
    d_scale: Any
    chain: Any = None

    # -- convenience -------------------------------------------------------
    @property
    def n(self):
        return self.struct.n

    @property
    def me(self):
        return self.struct.me

    @property
    def mi(self):
        return self.struct.mi

    @property
    def batch(self) -> int:
        return self.x0.shape[0]

    @property
    def device(self):
        return self.x0.device

    @property
    def dtype(self):
        return self.x0.dtype

    def arrays(self) -> dict:
        return {k: getattr(self, k) for k in ARRAY_FIELDS}

    def take(self, idx: torch.Tensor) -> "CanonicalNLP":
        """The sub-batch of lanes ``idx``."""
        return self._replace(**tree_take(self.arrays(), idx))

    def to(self, device) -> "CanonicalNLP":
        """Move every array to ``device``."""
        return self._replace(**tree_map(lambda t: t.to(device), self.arrays()))

    def lane(self) -> dict:
        """The per-instance data the evaluations read, batched."""
        return {"params": self.params, "obj_scale": self.obj_scale,
                "c_scale": self.c_scale, "d_scale": self.d_scale,
                "c_rhs": self.c_rhs, "x_fixed": self.x_fixed}

    # -- one-instance evaluations (vmapped below) --------------------------
    def x_full1(self, x, x_fixed):
        """Scatter free variables back into user space (TNLPAdapter::ResortX,
        IpTNLPAdapter.cpp:2400), as a gather so that it batches under vmap."""
        s = self.struct
        if s.n == s.n_full:
            return x
        return torch.cat([x, x_fixed])[s.index("perm", x.device)]

    def f1(self, x, lane):
        return lane["obj_scale"] * self.f(self.x_full1(x, lane["x_fixed"]),
                                          lane["params"])

    def cd1(self, x, lane):
        """(c(x), d(x)) of one instance, scaled (``CanonicalNLP._g_split``)."""
        s = self.struct
        if self.g is None:
            z = x.new_zeros((0,))
            return z, z
        gv = self.g(self.x_full1(x, lane["x_fixed"]), lane["params"])
        if s.mi == 0 and s.me == s.m:
            return lane["c_scale"] * (gv - lane["c_rhs"]), x.new_zeros((0,))
        if s.me == 0 and s.mi == s.m:
            return x.new_zeros((0,)), lane["d_scale"] * gv
        c = (gv[s.index("eq_idx", x.device)] - lane["c_rhs"]
             if s.me else x.new_zeros((0,)))
        d = gv[s.index("ineq_idx", x.device)] if s.mi else x.new_zeros((0,))
        return lane["c_scale"] * c, lane["d_scale"] * d

    def lag1(self, x, y_c, y_d, lane, obj_factor=1.0):
        val = obj_factor * self.f1(x, lane)
        c, d = self.cd1(x, lane)
        if self.struct.me:
            val = val + torch.dot(y_c, c)
        if self.struct.mi:
            val = val + torch.dot(y_d, d)
        return val

    # -- batched evaluations (all scaled) ----------------------------------
    def eval_f(self, x):
        return vmap(self.f1)(x, self.lane())

    def eval_grad_f(self, x):
        eps = self.struct.fd_grad_eps
        if eps:
            # forward differences (B, n) (IpTNLPAdapter.cpp:1355-1385)
            return self._fd_columns(lambda z, ln: self.f1(z, ln)[None], x, eps)[:, 0]
        return vmap(grad(self.f1))(x, self.lane())

    def _fd_columns(self, fn, x, eps):
        """(fn(x + eps e_j) - fn(x)) / eps for every j, per lane: fn maps one
        instance's x to a 1-D tensor; returns (B, len, n) (the reference's
        vmapped seeds, ``problem.py:182-190, 217-238``)."""
        lane = self.lane()
        X = x[:, None, :] + eps * torch.eye(x.shape[1], dtype=x.dtype,
                                            device=x.device)
        F0 = vmap(fn)(x, lane)                                   # (B, m)
        F = vmap(vmap(fn, in_dims=(0, None)))(X, lane)           # (B, n, m)
        return ((F - F0[:, None, :]) / eps).transpose(1, 2)

    def eval_cd(self, x):
        return vmap(self.cd1)(x, self.lane())

    def eval_c(self, x):
        if self.struct.me == 0:
            return x.new_zeros((x.shape[0], 0))
        return self.eval_cd(x)[0]

    def eval_d(self, x):
        if self.struct.mi == 0:
            return x.new_zeros((x.shape[0], 0))
        return self.eval_cd(x)[1]

    def eval_jac_cd(self, x):
        """(J_c (B, me, n), J_d (B, mi, n)) by forward-mode AD."""
        B, n = x.shape
        if self.struct.m == 0:
            z = x.new_zeros((B, 0, n))
            return z, z
        if self.struct.fd_jac_eps:
            J = self._fd_columns(lambda z, ln: torch.cat(self.cd1(z, ln)), x,
                                 self.struct.fd_jac_eps)
            return J[:, :self.struct.me], J[:, self.struct.me:]
        J_c, J_d = vmap(jacfwd(self.cd1))(x, self.lane())
        return J_c.reshape(B, self.struct.me, n), J_d.reshape(B, self.struct.mi, n)

    def eval_jac_t(self, x, y_c, y_d):
        """J_c^T y_c + J_d^T y_d per lane (B, n), by one vector-Jacobian
        product of (c, d) without forming the Jacobians."""
        def one(xx, ln, yc, yd):
            _, pull = vjp(lambda z: self.cd1(z, ln), xx)
            return pull((yc, yd))[0]
        return vmap(one)(x, self.lane(), y_c, y_d)

    def eval_lag_hess(self, x, y_c, y_d, obj_factor=1.0):
        """W = obj_factor ∇²f + Σ y_c_i ∇²c_i + Σ y_d_j ∇²d_j (TNLP::eval_h,
        IpTNLP.hpp:460): one ``torch.func.hessian`` of the Lagrangian."""
        return vmap(hessian(lambda xx, yc, yd, ln: self.lag1(
            xx, yc, yd, ln, obj_factor)))(x, y_c, y_d, self.lane())

    def eval_all(self, x):
        """f, grad_f, c, d, J_c, J_d at x."""
        if self.struct.fd_grad_eps:
            f, gf = self.eval_f(x), self.eval_grad_f(x)
        else:
            gf, f = vmap(grad_and_value(self.f1))(x, self.lane())
        c, d = self.eval_cd(x)
        J_c, J_d = self.eval_jac_cd(x)
        return f, gf, c, d, J_c, J_d


def _as_np(v, size=None, default=None):
    if v is None:
        return np.full((size,), default, dtype=np.float64)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    a = np.array(v, dtype=np.float64)
    if size is not None:
        a = np.broadcast_to(a, (size,)).copy()
    return a


def _tensor_leaves(tree):
    """A parameter tree with every leaf (tensor, numpy array or number) as a
    tensor, as the reference's ``jnp.asarray`` over its leaves."""
    if isinstance(tree, dict):
        return {k: _tensor_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tensor_leaves(v) for v in tree)
    return torch.as_tensor(tree)


def _constant_surrogates(f2, g2, x0, eq_mask, opts: Options, dtype):
    """The constant-derivative flags (grad_f_constant / jac_c_constant /
    jac_d_constant / hessian_constant, ``ipopt_tpu/problem.py:373-420``):
    the user promises (partial) linearity, so the exact Taylor surrogate at
    x0 replaces the function; its derivatives are then constants."""
    xc = torch.as_tensor(x0, dtype=dtype)
    X0 = DeviceConstant(xc)
    if opts.grad_f_constant or opts.hessian_constant:
        f_user = f2
        with torch.no_grad():
            F0 = DeviceConstant(f_user(xc, ()))
        GF0 = DeviceConstant(grad(lambda x: f_user(x, ()))(xc))
        if opts.hessian_constant:
            H0 = DeviceConstant(hessian(lambda x: f_user(x, ()))(xc))

            def f2(x, p):
                dx = x - X0.like(x)
                return (F0.like(x) + GF0.like(x) @ dx
                        + 0.5 * dx @ (H0.like(x) @ dx))
        else:
            def f2(x, p):
                return F0.like(x) + GF0.like(x) @ (x - X0.like(x))
    if g2 is not None and (opts.hessian_constant or opts.jac_c_constant
                           or opts.jac_d_constant):
        g_user = g2
        with torch.no_grad():
            G0 = DeviceConstant(g_user(xc, ()))
        J0 = DeviceConstant(jacfwd(lambda x: g_user(x, ()))(xc))

        def lin(x):
            return G0.like(x) + J0.like(x) @ (x - X0.like(x))
        if opts.hessian_constant or (opts.jac_c_constant and opts.jac_d_constant):
            def g2(x, p):
                return lin(x)
        else:
            cmask = DeviceConstant(eq_mask if opts.jac_c_constant else ~eq_mask)

            def g2(x, p):
                return torch.where(cmask.like(x), lin(x), g_user(x, p))
    return f2, g2


def canonicalize(nlp: NLP, options: Optional[Options] = None, dtype=None,
                 device=None) -> CanonicalNLP:
    """Build the canonical internal form of one problem (B = 1).

    Mirrors ``ipopt_tpu.problem.canonicalize``: split the constraints into
    equalities/inequalities, apply the fixed-variable treatment, relax the
    bounds by ``bound_relax_factor * max(1, |bound|)`` and compute the NLP
    scaling.  ``device`` defaults to the CPU: setup belongs on the host, the
    solver entry points move the result to the card.
    """
    opts = options or Options()
    if dtype is None:
        dtype = torch.float64 if opts.dtype == "float64" else torch.float32
    device = torch.device("cpu") if device is None else torch.device(device)

    x0 = _as_np(nlp.x0)
    n_full = x0.shape[0]

    def _apply_inf(lo, hi):
        # nlp_lower/upper_bound_inf: hs071 uses 2e19 for "no upper bound"
        lo = np.where(lo <= opts.nlp_lower_bound_inf, -np.inf, lo)
        hi = np.where(hi >= opts.nlp_upper_bound_inf, np.inf, hi)
        return lo, hi

    x_L = _as_np(nlp.x_L, n_full, -np.inf)
    x_U = _as_np(nlp.x_U, n_full, np.inf)
    x_L, x_U = _apply_inf(x_L, x_U)

    # Internal callables take (x_full, params).
    if nlp.params is None:
        user_f, user_g = nlp.f, nlp.g
        f2 = lambda x, params: user_f(x)
        g2 = (lambda x, params: user_g(x)) if user_g is not None else None
        params = ()
    else:
        f2, g2 = nlp.f, nlp.g
        params = tree_map(lambda v: v.to(device=device, dtype=dtype)[None],
                          _tensor_leaves(nlp.params))
    g_L_user, g_U_user = nlp.g_L, nlp.g_U

    def _num_g(gfun):
        xs = torch.as_tensor(x0, dtype=dtype, device=device)
        p = () if nlp.params is None else tree_map(lambda v: v[0], params)
        with torch.no_grad():
            return int(gfun(xs, p).shape[0])

    # fixed_variable_treatment = "make_constraint" (IpTNLPAdapter.cpp:463-631):
    # keep x_i as a variable, drop its bounds, add the row x_i = val to g.
    fixed_mask_mc = (x_L == x_U)
    if opts.fixed_variable_treatment == "make_constraint" and fixed_mask_mc.any():
        mc_idx = np.nonzero(fixed_mask_mc)[0]
        mc_vals = x_L[mc_idx].copy()
        base_g = g2
        m_base = _num_g(base_g) if base_g is not None else 0
        mc_t = torch.as_tensor(mc_idx, dtype=torch.int64, device=device)
        if base_g is None:
            g2 = lambda x, p: x[mc_t]
        else:
            g2 = lambda x, p: torch.cat([base_g(x, p), x[mc_t]])
        g_L_user = np.concatenate([_as_np(nlp.g_L, m_base, -np.inf), mc_vals])
        g_U_user = np.concatenate([_as_np(nlp.g_U, m_base, np.inf), mc_vals])
        x_L = np.where(fixed_mask_mc, -np.inf, x_L)
        x_U = np.where(fixed_mask_mc, np.inf, x_U)

    if g2 is not None:
        m = _num_g(g2)
        g_L, g_U = _apply_inf(_as_np(g_L_user, m, -np.inf),
                              _as_np(g_U_user, m, np.inf))
    else:
        m = 0
        g_L = np.zeros((0,))
        g_U = np.zeros((0,))

    eq_mask = (g_L == g_U)
    eq_idx = np.nonzero(eq_mask)[0].astype(np.int32)
    ineq_idx = np.nonzero(~eq_mask)[0].astype(np.int32)
    me, mi = len(eq_idx), len(ineq_idx)
    if (opts.grad_f_constant or opts.hessian_constant or opts.jac_c_constant
            or opts.jac_d_constant):
        if nlp.params is not None:
            raise ValueError(
                "grad_f_constant / jac_*_constant / hessian_constant require a "
                "parameter-free NLP (the surrogate is built at x0 once)")
        f2, g2 = _constant_surrogates(f2, g2, x0, eq_mask, opts, dtype)

    # Fixed variable treatment (IpTNLPAdapter.cpp:463-631).
    fixed_mask = (x_L == x_U)
    treatment = opts.fixed_variable_treatment
    if treatment in ("make_parameter", "make_parameter_nodual") and fixed_mask.any():
        free_idx = np.nonzero(~fixed_mask)[0].astype(np.int32)
        fixed_idx = np.nonzero(fixed_mask)[0].astype(np.int32)
    else:
        free_idx = np.arange(n_full, dtype=np.int32)
        fixed_idx = np.zeros((0,), dtype=np.int32)
        if treatment == "relax_bounds" and fixed_mask.any():
            rf = max(opts.bound_relax_factor, 1e-10)
            adj = rf * np.maximum(1.0, np.abs(x_L))
            x_L = np.where(fixed_mask, x_L - adj, x_L)
            x_U = np.where(fixed_mask, x_U + adj, x_U)
    n = len(free_idx)

    struct = CanonicalStructure(
        n_full=n_full, n=n, m=m, me=me, mi=mi, eq_idx=eq_idx,
        ineq_idx=ineq_idx, free_idx=free_idx, fixed_idx=fixed_idx,
        fixed_treatment=treatment,
        fd_grad_eps=(opts.findiff_perturbation if opts.gradient_approximation
                     == "finite-difference-values" else 0.0),
        fd_jac_eps=(opts.findiff_perturbation if opts.jacobian_approximation
                    == "finite-difference-values" else 0.0))

    x_fixed = np.where(fixed_mask, x_L, 0.0) if len(fixed_idx) else np.zeros(n_full)

    x_L_f = x_L[free_idx]
    x_U_f = x_U[free_idx]
    d_L = g_L[ineq_idx] if mi else np.zeros((0,))
    d_U = g_U[ineq_idx] if mi else np.zeros((0,))
    c_rhs = g_U[eq_idx] if me else np.zeros((0,))

    # Bound relaxation (IpOrigIpoptNLP.cpp:54-357).
    rf = opts.bound_relax_factor
    x_L_orig, x_U_orig = x_L_f.copy(), x_U_f.copy()
    if rf > 0:
        x_L_r = np.where(np.isfinite(x_L_f), x_L_f - rf * np.maximum(1, np.abs(x_L_f)), x_L_f)
        x_U_r = np.where(np.isfinite(x_U_f), x_U_f + rf * np.maximum(1, np.abs(x_U_f)), x_U_f)
        d_L_r = np.where(np.isfinite(d_L), d_L - rf * np.maximum(1, np.abs(d_L)), d_L)
        d_U_r = np.where(np.isfinite(d_U), d_U + rf * np.maximum(1, np.abs(d_U)), d_U)
    else:
        x_L_r, x_U_r, d_L_r, d_U_r = x_L_f, x_U_f, d_L, d_U

    has_xL = np.isfinite(x_L_r)
    has_xU = np.isfinite(x_U_r)
    has_dL = np.isfinite(d_L_r)
    has_dU = np.isfinite(d_U_r)

    def arr(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=device)[None]

    def mask(v):
        return torch.as_tensor(v, dtype=torch.bool, device=device)[None]

    cnlp = CanonicalNLP(
        struct=struct, f=f2, g=g2, params=params,
        x_L=arr(np.where(has_xL, x_L_r, 0.0)),
        x_U=arr(np.where(has_xU, x_U_r, 0.0)),
        d_L=arr(np.where(has_dL, d_L_r, 0.0)),
        d_U=arr(np.where(has_dU, d_U_r, 0.0)),
        has_xL=mask(has_xL), has_xU=mask(has_xU),
        has_dL=mask(has_dL), has_dU=mask(has_dU),
        c_rhs=arr(c_rhs), x_fixed=arr(x_fixed), x0=arr(x0[free_idx]),
        x_L_orig=arr(np.where(np.isfinite(x_L_orig), x_L_orig, 0.0)),
        x_U_orig=arr(np.where(np.isfinite(x_U_orig), x_U_orig, 0.0)),
        obj_scale=arr(1.0), c_scale=arr(np.ones(me)), d_scale=arr(np.ones(mi)),
    )
    from .scaling import compute_scaling
    return compute_scaling(cnlp, opts)
