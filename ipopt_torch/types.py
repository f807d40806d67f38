"""Core types of the PyTorch port: status codes and the primal-dual iterate.

Port of ``ipopt_tpu/types.py``.  The status enums are the reference's own
(Ipopt's ``SolverReturn`` and ``ApplicationReturnStatus``).  Every block of an
``Iterate`` is a tensor with a leading batch axis ``B``: the port writes the
batch out instead of getting it from ``vmap``, so one call advances every
instance of a batch (``solve`` is the case ``B = 1``).
"""
from __future__ import annotations

import enum
from typing import Any, NamedTuple

import numpy as np
import torch


class SolverReturn(enum.IntEnum):
    """Mirrors Ipopt's SolverReturn enum (IpAlgTypes.hpp)."""

    CONTINUE = -1  # internal: not yet terminated
    SUCCESS = 0
    MAXITER_EXCEEDED = 1
    CPUTIME_EXCEEDED = 2
    WALLTIME_EXCEEDED = 3
    STOP_AT_TINY_STEP = 4
    STOP_AT_ACCEPTABLE_POINT = 5
    LOCAL_INFEASIBILITY = 6
    USER_REQUESTED_STOP = 7
    FEASIBLE_POINT_FOUND = 8
    DIVERGING_ITERATES = 9
    RESTORATION_FAILURE = 10
    ERROR_IN_STEP_COMPUTATION = 11
    INVALID_NUMBER_DETECTED = 12
    TOO_FEW_DEGREES_OF_FREEDOM = 13
    INVALID_OPTION = 14
    OUT_OF_MEMORY = 15
    INTERNAL_ERROR = 16
    UNASSIGNED = 17


class ApplicationReturnStatus(enum.IntEnum):
    """Mirrors Ipopt's ApplicationReturnStatus (IpReturnCodes_inc.h)."""

    SOLVE_SUCCEEDED = 0
    SOLVED_TO_ACCEPTABLE_LEVEL = 1
    INFEASIBLE_PROBLEM_DETECTED = 2
    SEARCH_DIRECTION_BECOMES_TOO_SMALL = 3
    DIVERGING_ITERATES = 4
    USER_REQUESTED_STOP = 5
    FEASIBLE_POINT_FOUND = 6
    MAXITER_EXCEEDED = -1
    RESTORATION_FAILED = -2
    ERROR_IN_STEP_COMPUTATION = -3
    MAXCPUTIME_EXCEEDED = -4
    MAXWALLTIME_EXCEEDED = -5
    NOT_ENOUGH_DEGREES_OF_FREEDOM = -10
    INVALID_PROBLEM_DEFINITION = -11
    INVALID_OPTION = -12
    INVALID_NUMBER_DETECTED = -13
    UNRECOVERABLE_EXCEPTION = -100
    NONIPOPT_EXCEPTION_THROWN = -101
    INSUFFICIENT_MEMORY = -102
    INTERNAL_ERROR = -199


SOLVER_TO_APP_STATUS = {
    SolverReturn.SUCCESS: ApplicationReturnStatus.SOLVE_SUCCEEDED,
    SolverReturn.MAXITER_EXCEEDED: ApplicationReturnStatus.MAXITER_EXCEEDED,
    SolverReturn.CPUTIME_EXCEEDED: ApplicationReturnStatus.MAXCPUTIME_EXCEEDED,
    SolverReturn.WALLTIME_EXCEEDED: ApplicationReturnStatus.MAXWALLTIME_EXCEEDED,
    SolverReturn.STOP_AT_TINY_STEP: ApplicationReturnStatus.SEARCH_DIRECTION_BECOMES_TOO_SMALL,
    SolverReturn.STOP_AT_ACCEPTABLE_POINT: ApplicationReturnStatus.SOLVED_TO_ACCEPTABLE_LEVEL,
    SolverReturn.LOCAL_INFEASIBILITY: ApplicationReturnStatus.INFEASIBLE_PROBLEM_DETECTED,
    SolverReturn.USER_REQUESTED_STOP: ApplicationReturnStatus.USER_REQUESTED_STOP,
    SolverReturn.FEASIBLE_POINT_FOUND: ApplicationReturnStatus.FEASIBLE_POINT_FOUND,
    SolverReturn.DIVERGING_ITERATES: ApplicationReturnStatus.DIVERGING_ITERATES,
    SolverReturn.RESTORATION_FAILURE: ApplicationReturnStatus.RESTORATION_FAILED,
    SolverReturn.ERROR_IN_STEP_COMPUTATION: ApplicationReturnStatus.ERROR_IN_STEP_COMPUTATION,
    SolverReturn.INVALID_NUMBER_DETECTED: ApplicationReturnStatus.INVALID_NUMBER_DETECTED,
    SolverReturn.TOO_FEW_DEGREES_OF_FREEDOM: ApplicationReturnStatus.NOT_ENOUGH_DEGREES_OF_FREEDOM,
    SolverReturn.INVALID_OPTION: ApplicationReturnStatus.INVALID_OPTION,
    SolverReturn.OUT_OF_MEMORY: ApplicationReturnStatus.INSUFFICIENT_MEMORY,
    SolverReturn.INTERNAL_ERROR: ApplicationReturnStatus.INTERNAL_ERROR,
}


class Iterate(NamedTuple):
    """Primal-dual iterate: the 8-block layout of IpIteratesVector.hpp:25.

    Shapes: x (B, n), s (B, mi), y_c (B, me), y_d (B, mi), z_L/z_U (B, n),
    v_L/v_U (B, mi).  Bound multipliers are dense, zero where the bound is
    infinite.
    """

    x: Any
    s: Any
    y_c: Any
    y_d: Any
    z_L: Any
    z_U: Any
    v_L: Any
    v_U: Any


class KKTResiduals(NamedTuple):
    """Raw KKT residuals of the barrier problem, each with a leading batch
    axis (see ``ipopt_tpu/types.py`` for the block definitions)."""

    grad_lag_x: Any
    grad_lag_s: Any
    c: Any
    d_minus_s: Any
    compl_x_L: Any
    compl_x_U: Any
    compl_s_L: Any
    compl_s_U: Any


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of ``tree`` (and to the matching
    leaves of ``rest``); ``None`` and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *leaves) for leaves in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return tree


def tree_where(mask: torch.Tensor, new, old):
    """Per-lane select over a tree of batched tensors: lane b takes ``new``
    where ``mask[b]`` and keeps ``old`` otherwise (``jnp.where(running, new,
    old)`` of ``ipopt_tpu/batch.py:35``, written out over the batch axis).
    Each leaf takes the mask on its own device."""
    return tree_map(lambda n, o: torch.where(_expand(mask.to(n.device), n), n, o),
                    new, old)


def tree_take(tree, idx: torch.Tensor):
    """The lanes ``idx`` of every batched tensor in ``tree``."""
    return tree_map(lambda t: t.index_select(0, idx), tree)


def tree_put(tree, idx: torch.Tensor, sub):
    """``tree`` with its lanes ``idx`` replaced by the lanes of ``sub``."""
    return tree_map(lambda t, s: t.index_copy(0, idx, s.to(t.dtype)), tree, sub)


def contiguous_ranges(n: int, parts: int):
    """``parts`` contiguous (lo, hi) ranges covering 0..n-1, their sizes
    differing by one at most (empty ones at the end when parts > n)."""
    sizes = [n // parts + (i < n % parts) for i in range(parts)]
    starts = [sum(sizes[:i]) for i in range(parts)]
    return [(lo, lo + z) for lo, z in zip(starts, sizes)]


def max_init(v: torch.Tensor, init: float) -> torch.Tensor:
    """``jnp.max(v, axis=-1, initial=init)``: NaN propagates, an empty last
    axis gives ``init``."""
    if v.shape[-1] == 0:
        return torch.full(v.shape[:-1], init, dtype=v.dtype, device=v.device)
    return torch.clamp(v.amax(-1), min=init)


def min_init(v: torch.Tensor, init: float) -> torch.Tensor:
    """``jnp.min(v, axis=-1, initial=init)``."""
    if v.shape[-1] == 0:
        return torch.full(v.shape[:-1], init, dtype=v.dtype, device=v.device)
    return torch.clamp(v.amin(-1), max=init)


def col(v):
    """A per-lane scalar (B,) as a column (B, 1); Python numbers pass."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.unsqueeze(-1)
    return v


class DeviceConstant:
    """A constant array made once on the host and handed out on the device of
    each call's argument: floating values in its dtype, integer and boolean
    values (indices, masks) in their own (one copy per device and dtype)."""

    def __init__(self, value):
        self.value = torch.as_tensor(value).detach()
        self._copies = {}

    def like(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype if self.value.is_floating_point() else self.value.dtype
        key = (x.device, dtype)
        t = self._copies.get(key)
        if t is None:
            t = self._copies[key] = self.value.to(device=x.device, dtype=dtype)
        return t


def cached_tensor(info, name: str, device) -> torch.Tensor:
    """The numpy field ``name`` of a static descriptor (``sparse.BandedInfo``,
    ``linalg.nested_dissection.NDInfo``) on ``device``, uploaded once and
    kept in its ``_cache``; 32-bit indices stay 32-bit, masks become bool."""
    key = (name, str(device))
    t = info._cache.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(getattr(info, name)), device=device)
        info._cache[key] = t
    return t


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an option value ("float32" or "float64")."""
    return {"float32": torch.float32, "float64": torch.float64}[name]
