"""Plain NumPy reference of LuksanVlcek1 (Luksan and Vlcek 1999; Ipopt's
examples/ScalableProblems/LuksanVlcek1.cpp), written from the problem's
statement (see ``problems/lv1.py`` for it) and sharing no code with the
program or with the benchmark's builder: the functions, their first
derivatives as products with vectors, the banded Lagrangian Hessian, and the
absolute row sums that norms of the KKT matrix need.  Float64 throughout.

With (a, b, c) = (x_j, x_{j+1}, x_{j+2}) and E = exp(a - b), and
sin(b - c) sin(b + c) = (cos 2c - cos 2b) / 2, constraint j has

    dg/da = -(1 + a) E,   dg/db = 9 b^2 + 4 + sin 2b + a E,   dg/dc = 2 - sin 2c
    d2g/da2 = -(2 + a) E, d2g/dadb = (1 + a) E, d2g/db2 = 18 b + 2 cos 2b - a E,
    d2g/dc2 = -2 cos 2c,  and no (a, c) or (b, c) term.
"""
from __future__ import annotations

import numpy as np


class Problem:
    def __init__(self, cfg):
        self.n = int(cfg["n"])
        self.m = self.n - 2
        self.x_L = np.full(self.n, -np.inf)
        self.x_U = np.full(self.n, np.inf)

    def f(self, x):
        return float(np.sum(100.0 * (x[:-1] ** 2 - x[1:]) ** 2 + (x[:-1] - 1.0) ** 2))

    def grad_f(self, x):
        p, q = x[:-1], x[1:]
        r = p ** 2 - q
        g = np.zeros_like(x)
        g[:-1] += 400.0 * p * r + 2.0 * (p - 1.0)
        g[1:] += -200.0 * r
        return g

    def c(self, x):
        a, b, c = x[:-2], x[1:-1], x[2:]
        return (3.0 * b ** 3 + 2.0 * c - 5.0 + 0.5 * (np.cos(2.0 * c) - np.cos(2.0 * b))
                + 4.0 * b - a * np.exp(a - b) - 3.0)

    def _jac(self, x):
        """The three entries of each row: (dg/da, dg/db, dg/dc)."""
        a, b, c = x[:-2], x[1:-1], x[2:]
        E = np.exp(a - b)
        return -(1.0 + a) * E, 9.0 * b ** 2 + 4.0 + np.sin(2.0 * b) + a * E, 2.0 - np.sin(2.0 * c)

    def jac_v(self, x, v):
        ja, jb, jc = self._jac(x)
        return ja * v[:-2] + jb * v[1:-1] + jc * v[2:]

    def jac_t_v(self, x, w):
        ja, jb, jc = self._jac(x)
        out = np.zeros(self.n)
        out[:-2] += ja * w
        out[1:-1] += jb * w
        out[2:] += jc * w
        return out

    def jac_abs_rowsum(self, x):
        ja, jb, jc = self._jac(x)
        return np.abs(ja) + np.abs(jb) + np.abs(jc)

    def jac_t_v_abs(self, x, w):
        """|J|^T w."""
        ja, jb, jc = self._jac(x)
        out = np.zeros(self.n)
        out[:-2] += np.abs(ja) * w
        out[1:-1] += np.abs(jb) * w
        out[2:] += np.abs(jc) * w
        return out

    def jac_row_absmax(self, x):
        ja, jb, jc = self._jac(x)
        return np.maximum(np.maximum(np.abs(ja), np.abs(jb)), np.abs(jc))

    def _hess_bands(self, x, sf, lam):
        """(main diagonal, first off-diagonal) of sf Hess f + sum lam_j Hess g_j;
        the second off-diagonal is zero."""
        n = self.n
        d0 = np.zeros(n)
        d1 = np.zeros(n - 1)
        p, q = x[:-1], x[1:]
        d0[:-1] += sf * (1200.0 * p ** 2 - 400.0 * q + 2.0)
        d0[1:] += sf * 200.0
        d1 += sf * (-400.0 * p)
        a, b, c = x[:-2], x[1:-1], x[2:]
        E = np.exp(a - b)
        d0[:-2] += lam * (-(2.0 + a) * E)
        d0[1:-1] += lam * (18.0 * b + 2.0 * np.cos(2.0 * b) - a * E)
        d0[2:] += lam * (-2.0 * np.cos(2.0 * c))
        d1[:-1] += lam * ((1.0 + a) * E)
        return d0, d1

    def hess_diag(self, x, sf, lam):
        return self._hess_bands(x, sf, lam)[0]

    def hess_offdiag_abs_rowsum(self, x, sf, lam):
        _, d1 = self._hess_bands(x, sf, lam)
        out = np.zeros(self.n)
        out[:-1] += np.abs(d1)
        out[1:] += np.abs(d1)
        return out

    def hess_v(self, x, sf, lam, v):
        d0, d1 = self._hess_bands(x, sf, lam)
        out = d0 * v
        out[:-1] += d1 * v[1:]
        out[1:] += d1 * v[:-1]
        return out
