"""Problem-level transforms: NLPBoundsRemover and TNLPReducer (port of
``ipopt_tpu/interfaces/transforms.py``).

- ``remove_bounds``: variable bounds become inequality rows (reference
  ``NLPBoundsRemover``, src/Interfaces/IpNLPBoundsRemover.hpp:23), selected
  by ``replace_bounds``;
- ``reduce_constraints``: drop a set of constraint rows (reference
  ``TNLPReducer``, src/Interfaces/IpTNLPReducer.hpp:23), used after
  ``dependency_detector`` found dependent equalities.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..problem import NLP
from ..types import DeviceConstant


def _rows(idx: np.ndarray):
    """x[idx] on the device of x."""
    index = DeviceConstant(np.asarray(idx, np.int64))
    return lambda x: x.index_select(0, index.like(x))


def _num_rows(nlp: NLP) -> int:
    x0 = torch.as_tensor(np.asarray(nlp.x0, dtype=np.float64))
    with torch.no_grad():
        gv = nlp.g(x0) if nlp.params is None else nlp.g(
            x0, _as_tensors(nlp.params))
    return int(gv.shape[0])


def _as_tensors(params):
    if isinstance(params, dict):
        return {k: _as_tensors(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_as_tensors(v) for v in params)
    return torch.as_tensor(params)


def remove_bounds(nlp: NLP) -> NLP:
    """An equivalent NLP whose variable bounds are the inequality rows
    x_i >= L / x_i <= U, with the variables themselves free."""
    n = np.asarray(nlp.x0, float).shape[0]

    def fill(v, default):
        if v is None:
            return np.full((n,), default)
        return np.broadcast_to(np.asarray(v, float), (n,)).astype(float)

    x_L = fill(nlp.x_L, -np.inf)
    x_U = fill(nlp.x_U, np.inf)
    x_L = np.where(x_L <= -1e19, -np.inf, x_L)
    x_U = np.where(x_U >= 1e19, np.inf, x_U)
    idx = np.nonzero(np.isfinite(x_L) | np.isfinite(x_U))[0]
    if idx.size == 0:
        return nlp
    base_g = nlp.g
    take = _rows(idx)
    m_base = 0 if base_g is None else _num_rows(nlp)
    if nlp.params is not None:
        def g_new(x, p):
            return take(x) if base_g is None else torch.cat([base_g(x, p), take(x)])
    else:
        def g_new(x):
            return take(x) if base_g is None else torch.cat([base_g(x), take(x)])

    def fillg(v, default):
        if v is None:
            return np.full((m_base,), default)
        return np.broadcast_to(np.asarray(v, float), (m_base,)).astype(float)

    g_L = np.concatenate([fillg(nlp.g_L, -np.inf), x_L[idx]])
    g_U = np.concatenate([fillg(nlp.g_U, np.inf), x_U[idx]])
    return dataclasses.replace(nlp, g=g_new, g_L=g_L, g_U=g_U, x_L=None,
                               x_U=None, name=nlp.name + "_boundsremoved")


def reduce_constraints(nlp: NLP, drop: Sequence[int]) -> NLP:
    """The NLP with the constraint rows ``drop`` removed."""
    if nlp.g is None:
        return nlp
    m = _num_rows(nlp)
    dropped = set(drop)
    keep = np.array([i for i in range(m) if i not in dropped], np.int64)
    base_g = nlp.g
    take = _rows(keep)
    if nlp.params is not None:
        def g_new(x, p):
            return take(base_g(x, p))
    else:
        def g_new(x):
            return take(base_g(x))

    def pick(v):
        if v is None:
            return None
        return np.broadcast_to(np.asarray(v, float), (m,))[keep]

    return dataclasses.replace(nlp, g=g_new, g_L=pick(nlp.g_L),
                               g_U=pick(nlp.g_U), name=nlp.name + "_reduced")
