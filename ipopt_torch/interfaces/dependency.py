"""Linearly dependent equality constraints (port of
``ipopt_tpu/interfaces/dependency.py``): ``TDependencyDetector`` as
``TNLPAdapter`` uses it (``src/Interfaces/IpTNLPAdapter.cpp:628-700``).  At
the starting point, the equality rows whose gradients depend linearly on
earlier rows are found by a modified Gram-Schmidt rank filter, once, on the
host; ``dependency_detection_with_rhs`` appends the residual, so that an
inconsistent duplicate is kept and shows as infeasibility.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.func import jacfwd

from .transforms import _as_tensors


def detect_dependent_constraints(nlp, opts) -> List[int]:
    """Indices (user constraint numbering) of dependent equality rows at x0."""
    if nlp.g is None:
        return []
    x0 = torch.as_tensor(np.asarray(nlp.x0, dtype=np.float64))
    if nlp.params is not None:
        params = _as_tensors(nlp.params)

        def g_fn(x):
            return nlp.g(x, params)
    else:
        g_fn = nlp.g
    with torch.no_grad():
        g0 = g_fn(x0).double().numpy()
    m = g0.shape[0]
    g_L = np.broadcast_to(np.asarray(
        nlp.g_L if nlp.g_L is not None else -np.inf, np.float64), (m,))
    g_U = np.broadcast_to(np.asarray(
        nlp.g_U if nlp.g_U is not None else np.inf, np.float64), (m,))
    eq = np.nonzero(g_L == g_U)[0]
    if eq.size <= 1:
        return []
    rows = jacfwd(g_fn)(x0).double().numpy()[eq, :]
    if opts.dependency_detection_with_rhs:
        rows = np.concatenate([rows, (g0[eq] - g_L[eq])[:, None]], axis=1)
    tol = 1e4 * np.finfo(np.float64).eps
    basis: List[np.ndarray] = []
    deps: List[int] = []
    for i in range(rows.shape[0]):
        v = rows[i].copy()
        nrm0 = np.linalg.norm(v)
        if nrm0 == 0.0:
            deps.append(int(eq[i]))  # a zero gradient row is dependent
            continue
        for b in basis:
            v -= np.dot(b, v) * b
        nrm = np.linalg.norm(v)
        if nrm <= tol * nrm0:
            deps.append(int(eq[i]))
        else:
            basis.append(v / nrm)
    return deps
