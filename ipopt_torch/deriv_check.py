"""Derivative checker: forward differences against the derivatives the solver
uses (port of ``ipopt_tpu/deriv_check.py``; ``TNLPAdapter::CheckDerivatives``,
``IpTNLPAdapter.cpp:2983``, options ``derivative_test``,
``derivative_test_perturbation``, ``derivative_test_tol``,
``derivative_test_first_index``, ``derivative_test_print_all``,
``point_perturbation_radius``).

``torch.func`` makes the derivatives exact by construction, so the checker
catches what automatic differentiation and differences legitimately
disagree on: non-smooth or branching user functions.  The relative error of
an entry is |ad - fd| / max(1, |fd|).  Every lane of the problem is checked
at once; a failure line names its lane when there is more than one.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .options import Options
from .problem import CanonicalNLP


class DerivCheckResult(NamedTuple):
    ok: bool
    max_rel_err_grad: float
    max_rel_err_jac: float
    max_rel_err_hess: float
    failures: List[str]


def _fd(fn, x, h):
    """Forward differences of fn (B, n) -> (B, m): (B, m, n)."""
    f0 = fn(x)
    cols = [(fn(x + h * e) - f0) / h
            for e in torch.eye(x.shape[1], dtype=x.dtype, device=x.device)]
    return torch.stack(cols, -1) if cols else f0[..., None][..., :0]


def _rel(ad, fd):
    return np.abs(ad - fd) / np.maximum(1.0, np.abs(fd))


def check_derivatives(nlp: CanonicalNLP, opts: Options, x=None,
                      device=None) -> DerivCheckResult:
    """Check the gradient and constraint Jacobian (``derivative_test=
    "first-order"``), the Lagrangian Hessian (``"only-second-order"``) or
    both (``"second-order"``) at x (default x0, moved randomly within
    ``point_perturbation_radius`` inside the bounds, as the reference)."""
    from .algorithm.solver import resolve_device
    dev = resolve_device(device)
    nlp = nlp.to(dev)
    dtype = nlp.dtype
    x = nlp.x0 if x is None else torch.as_tensor(x, dtype=dtype, device=dev).reshape(
        nlp.x0.shape)
    n, me, mi = nlp.n, nlp.me, nlp.mi
    if opts.point_perturbation_radius > 0:
        # IpTNLPAdapter.cpp:3030-3037: uniform in [max(x_l, x0 - r),
        # min(x_u, x0 + r)], one draw shared by the lanes
        u = np.random.RandomState(42).uniform(0.0, 1.0, n)
        xr = x.detach().cpu().numpy()
        r = opts.point_perturbation_radius
        lo = np.where(nlp.has_xL.cpu().numpy(),
                      np.maximum(nlp.x_L.cpu().numpy(), xr - r), xr - r)
        hi = np.where(nlp.has_xU.cpu().numpy(),
                      np.minimum(nlp.x_U.cpu().numpy(), xr + r), xr + r)
        x = torch.as_tensor(lo + u * (hi - lo), dtype=dtype, device=dev)
    h = opts.derivative_test_perturbation
    tol = opts.derivative_test_tol
    first_idx = max(opts.derivative_test_first_index, 0)
    lanes = x.shape[0]
    failures: List[str] = []

    def where(b, name):
        return f"{name}" if lanes == 1 else f"lane {b} {name}"

    def np_(t):
        return t.detach().cpu().double().numpy()

    max_g = max_j = max_h = 0.0
    if opts.derivative_test in ("first-order", "second-order"):
        g_ad = np_(nlp.eval_grad_f(x))
        g_fd = np_(_fd(lambda z: nlp.eval_f(z)[:, None], x, h)[:, 0])
        rel = _rel(g_ad, g_fd)
        rel[:, :first_idx] = 0.0
        max_g = float(rel.max()) if rel.size else 0.0
        for b, i in zip(*np.nonzero(rel > tol)):
            failures.append(f"{where(b, f'grad_f[{i}]')}: ad={g_ad[b, i]:.8e} "
                            f"fd={g_fd[b, i]:.8e} rel={rel[b, i]:.2e}")
        if me + mi > 0:
            def gall(z):
                return torch.cat(nlp.eval_cd(z), -1)
            J_ad = np_(vmap(jacfwd(lambda z, ln: torch.cat(nlp.cd1(z, ln))))(
                x, nlp.lane()))
            J_fd = np_(_fd(gall, x, h))
            relJ = _rel(J_ad, J_fd)
            relJ[:, :, :first_idx] = 0.0
            max_j = float(relJ.max()) if relJ.size else 0.0
            thresh = -1.0 if opts.derivative_test_print_all else tol
            for b, r, c in zip(*np.nonzero(relJ > thresh)):
                failures.append(f"{where(b, f'jac_g[{r},{c}]')}: "
                                f"ad={J_ad[b, r, c]:.8e} fd={J_fd[b, r, c]:.8e} "
                                f"rel={relJ[b, r, c]:.2e}")
    if opts.derivative_test in ("second-order", "only-second-order"):
        y_c = x.new_ones((lanes, me))
        y_d = x.new_ones((lanes, mi))

        def grad_lag(z):
            J_c, J_d = nlp.eval_jac_cd(z)
            gl = nlp.eval_grad_f(z)
            if me:
                gl = gl + torch.matmul(y_c[:, None, :], J_c)[:, 0]
            if mi:
                gl = gl + torch.matmul(y_d[:, None, :], J_d)[:, 0]
            return gl

        H_ad = np_(nlp.eval_lag_hess(x, y_c, y_d))
        H_fd = np_(_fd(grad_lag, x, h))
        relH = _rel(H_ad, H_fd)
        relH[:, :first_idx, :] = 0.0
        relH[:, :, :first_idx] = 0.0
        max_h = float(relH.max()) if relH.size else 0.0
        for b, r, c in zip(*np.nonzero(relH > tol)):
            failures.append(f"{where(b, f'hess_lag[{r},{c}]')}: "
                            f"ad={H_ad[b, r, c]:.8e} fd={H_fd[b, r, c]:.8e} "
                            f"rel={relH[b, r, c]:.2e}")
    ok = max(max_g, max_j, max_h) <= tol
    return DerivCheckResult(ok=ok, max_rel_err_grad=max_g, max_rel_err_jac=max_j,
                            max_rel_err_hess=max_h, failures=failures)


def report(result: DerivCheckResult) -> List[str]:
    """The lines ``solve`` prints for ``derivative_test`` (``solver.py:
    1621-1633``): the verdict and the first 20 failures."""
    state = "passed" if result.ok else "FAILED"
    return ([f"Derivative checker {state} (grad {result.max_rel_err_grad:.2e}, "
             f"jac {result.max_rel_err_jac:.2e}, "
             f"hess {result.max_rel_err_hess:.2e})\n"]
            + ["  " + line + "\n" for line in result.failures[:20]])
