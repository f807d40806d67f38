"""LuksanVlcek1 as one flat ``NLP`` of the port, with its declared banded
patterns: the benchmark's own frozen copy.

    min  sum_{i < n-1} 100 (x_i^2 - x_{i+1})^2 + (x_i - 1)^2
    s.t. 3 b^3 + 2 c - 5 + sin(b - c) sin(b + c) + 4 b - a exp(a - b) - 3 = 0
         for (a, b, c) = (x_j, x_{j+1}, x_{j+2}), j = 0 .. n-3

with no bounds on x.  The Jacobian's row j covers x_j .. x_{j+2}; the
Lagrangian Hessian has bandwidth 2.
"""
from __future__ import annotations

import numpy as np
import torch

from ipopt_torch import NLP


def start(cfg):
    """(x0, x_L, x_U) of the published starting point -1.2, 1, -1.2, 1, ...
    (LuksanVlcek1.cpp's ``get_starting_point``) and no bounds."""
    n = int(cfg["n"])
    x0 = np.full(n, -1.2)
    x0[1::2] = 1.0
    return x0, np.full(n, -np.inf), np.full(n, np.inf)


def _band(m, n, lo, hi):
    rows, cols = [], []
    for off in range(lo, hi + 1):
        i = np.arange(max(0, -off), min(m, n - off), dtype=np.int32)
        rows.append(i)
        cols.append(i + np.int32(off))
    return np.concatenate(rows), np.concatenate(cols)


def _f(x):
    return (100.0 * (x[:-1] ** 2 - x[1:]) ** 2 + (x[:-1] - 1.0) ** 2).sum()


def _g(x):
    a, b, c = x[:-2], x[1:-1], x[2:]
    return (3.0 * b ** 3 + 2.0 * c - 5.0 + torch.sin(b - c) * torch.sin(b + c)
            + 4.0 * b - a * torch.exp(a - b) - 3.0)


def build(cfg, x0):
    """The ``NLP`` of the configuration ``cfg`` from the starting point x0."""
    n = int(cfg["n"])
    m = n - 2
    return NLP(f=_f, g=_g, x0=x0, g_L=np.zeros(m), g_U=np.zeros(m),
               jac_g_sparsity=_band(m, n, 0, 2),
               lag_hess_sparsity=_band(n, n, -2, 2), name=f"lv1_n{n}")
