"""The comparison that decides ``correct``: the plain reference of a
configuration (``reference/<problem>.py``, NumPy only) judges what the timed
path produced.  Nothing here imports the program.

Two layers are judged:

- the solution each sampled solve of the window returned (status, x, the
  multipliers y, z_L, z_U and the objective), by the first-order optimality
  conditions the reference works out again at that point;
- the step layer: one linear solve of the interior-point step captured in
  the window (the iterate it was formed at, its barrier parameter and
  regularizations, and the program's solution), against the KKT matrix and
  right-hand side the reference assembles itself at that iterate, as a
  normwise backward error.

Ipopt's documented defaults, which no configuration here changes, fix the
quantities the step's system is formed from.
"""
from __future__ import annotations

import numpy as np

BOUND_RELAX_FACTOR = 1e-8      # bound_relax_factor
CONSTR_VIOL_TOL = 1e-4         # constr_viol_tol, the cap on the relaxation
KAPPA_D = 1e-5                 # kappa_d, the damping of one-sided bounds
SCALING_MAX_GRADIENT = 100.0   # nlp_scaling_max_gradient
SCALING_MIN_VALUE = 1e-8       # nlp_scaling_min_value


def _inf_norm(v):
    return float(np.max(np.abs(v))) if v.size else 0.0


def solution_readings(ref, sol):
    """Readings of one returned solution (NumPy float64 arrays and floats):
    ``primal_inf`` max |c(x)|, ``dual_inf`` max |grad f + J^T y - z_L + z_U|,
    ``compl`` the largest |slack * bound multiplier| over the finite bounds,
    ``bound_viol`` the largest step of x outside its bounds, ``obj_gap`` the
    returned objective's relative gap to f(x)."""
    x, y, zl, zu = sol["x"], sol["y"], sol["z_L"], sol["z_U"]
    fin_l, fin_u = np.isfinite(ref.x_L), np.isfinite(ref.x_U)
    f = ref.f(x)
    compl = 0.0
    if fin_l.any():
        compl = max(compl, _inf_norm((x - ref.x_L)[fin_l] * zl[fin_l]))
    if fin_u.any():
        compl = max(compl, _inf_norm((ref.x_U - x)[fin_u] * zu[fin_u]))
    viol = max(0.0, float(np.max(np.where(fin_l, ref.x_L - x, 0.0))),
               float(np.max(np.where(fin_u, x - ref.x_U, 0.0))))
    return {
        "primal_inf": _inf_norm(ref.c(x)),
        "dual_inf": _inf_norm(ref.grad_f(x) + ref.jac_t_v(x, y) - zl + zu),
        "compl": compl,
        "bound_viol": viol,
        "obj_gap": abs(f - float(sol["obj"])) / max(1.0, abs(f)),
    }


def _relaxed(bound, sign):
    fin = np.isfinite(bound)
    adj = np.minimum(BOUND_RELAX_FACTOR * np.maximum(1.0, np.abs(bound)), CONSTR_VIOL_TOL)
    return np.where(fin, bound + sign * np.where(fin, adj, 0.0), bound), fin


def scaling(ref, x0):
    """Gradient-based scaling at the starting point: the objective's factor
    and each constraint row's, min(1, 100 / the largest |derivative|), at
    least 1e-8."""
    def factor(norm):
        return np.maximum(np.where(norm > SCALING_MAX_GRADIENT,
                                   SCALING_MAX_GRADIENT / np.where(norm > 0, norm, 1.0), 1.0),
                          SCALING_MIN_VALUE)
    return float(factor(np.asarray(_inf_norm(ref.grad_f(x0))))), factor(ref.jac_row_absmax(x0))


def step_backward_error(ref, x0, cap):
    """Normwise backward error ||K d - r||_inf / (||K||_inf ||d||_inf +
    ||r||_inf) of the captured step d = (dx, dy) against the reference's

        K = [[W + Sigma + delta_x I, J_s^T], [J_s, -delta_c I]],
        r = -[sf grad f - mu / (x - x_L) + mu / (x_U - x) + damping + J_s^T y,
              s_c * c(x)]

    at the captured iterate (x, y, z_L, z_U, mu, delta_x, delta_c: the
    program's state there), with W = sf Hess f + sum_j s_c,j y_j Hess c_j,
    Sigma = z_L / (x - x_L) + z_U / (x_U - x) over the relaxed bounds, J_s
    the Jacobian with row j scaled by s_c,j, and (sf, s_c) the scaling the
    reference works out from x0.  The configurations here have equality
    constraints only, so the system has no slack rows."""
    x, y, zl, zu = (np.asarray(cap[k], np.float64) for k in ("x", "y_c", "z_L", "z_U"))
    dx, dy = np.asarray(cap["dx"], np.float64), np.asarray(cap["dy_c"], np.float64)
    mu, dlx, dlc = float(cap["mu"]), float(cap["delta_x"]), float(cap["delta_c"])
    sf, sc = scaling(ref, x0)
    xl, has_l = _relaxed(ref.x_L, -1.0)
    xu, has_u = _relaxed(ref.x_U, 1.0)
    sl = np.where(has_l, x - np.where(has_l, xl, 0.0), 1.0)
    su = np.where(has_u, np.where(has_u, xu, 0.0) - x, 1.0)
    sigma = np.where(has_l, zl / sl, 0.0) + np.where(has_u, zu / su, 0.0)
    lam = sc * y
    r_x = (sf * ref.grad_f(x) - np.where(has_l, mu / sl, 0.0) + np.where(has_u, mu / su, 0.0)
           - np.where(has_l & ~has_u, KAPPA_D * mu, 0.0)
           + np.where(has_u & ~has_l, KAPPA_D * mu, 0.0)
           + ref.jac_t_v(x, sc * y))
    r_c = sc * ref.c(x)
    res_x = (ref.hess_v(x, sf, lam, dx) + (sigma + dlx) * dx + ref.jac_t_v(x, sc * dy)) + r_x
    res_c = sc * ref.jac_v(x, dx) - dlc * dy + r_c
    # ||K||_inf, the largest absolute row sum: the x rows hold W + Sigma +
    # delta_x and the columns of J_s, the constraint rows J_s and -delta_c
    diag = ref.hess_diag(x, sf, lam) + sigma + dlx
    rows_x = np.abs(diag) + ref.hess_offdiag_abs_rowsum(x, sf, lam) + ref.jac_t_v_abs(x, sc)
    rows_c = sc * ref.jac_abs_rowsum(x) + abs(dlc)
    k_norm = max(_inf_norm(rows_x), _inf_norm(rows_c))
    d_norm = max(_inf_norm(dx), _inf_norm(dy))
    r_norm = max(_inf_norm(r_x), _inf_norm(r_c))
    return max(_inf_norm(res_x), _inf_norm(res_c)) / (k_norm * d_norm + r_norm)
