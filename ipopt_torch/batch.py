"""Batched solves: many independent NLPs of one structure in lockstep.

Port of ``ipopt_tpu/batch.py``.  The reference vmaps the per-instance step;
the port's algorithm is written over an explicit leading batch axis, so one
call factorizes the KKT matrix of every instance (one K1 launch per
inertia-correction round).  A finished lane is frozen: it is not stepped
again, so the batch result equals solving each instance alone
(``tests/test_batch.py``'s contract).  Every per-lane carry moves in
lockstep, the adaptive barrier strategy's (``AdaptiveMuState``) included;
the quality-function oracle's golden-section search runs its bound of
steps with each lane's finished carry frozen, as the reference's vmapped
loop does.
"""
from __future__ import annotations

from typing import Optional

import torch

from .problem import CanonicalNLP, ARRAY_FIELDS, canonicalize
from .chained import ChainedNLP, canonicalize_chained
from .options import Options
from .sparse import BandedInfo
from .linalg.nested_dissection import NDInfo
from .algorithm.solver import (SolveResult, guarded_step, prepare_options,
                               resolve_device, solve_canonical)

__all__ = ["stack_problems", "solve_batched", "guarded_step"]


def stack_problems(problems, options: Optional[Options] = None,
                   device=None) -> CanonicalNLP:
    """Stack structurally identical problems into one batched CanonicalNLP.

    Each problem (an ``NLP``, a ``ChainedNLP`` or a canonical problem) is
    canonicalized on the host (CPU), then the batch is moved to ``device`` in
    one transfer per array.  The callables must be the same computation for
    every instance (per-instance data travels in the bounds, ``c_rhs``,
    ``x0`` and ``params``); the first instance's are kept.  Chained problems
    must share one ``ChainInfo`` (the MPC-fleet pattern).  Banded problems
    (``linear_solver="banded-bcr"``) are refused: that backend solves one
    problem at a time, as the reference's does."""
    opts = options or Options()
    banded = ("the banded and multifrontal backends (linear_solver='banded-bcr', "
              "'multifrontal') solve one problem at a time: use solve()")

    def canon(p):
        if isinstance(p, CanonicalNLP):  # a NamedTuple: test it first
            if isinstance(p.chain, (BandedInfo, NDInfo)):
                raise ValueError(banded)
            return p
        if isinstance(p, ChainedNLP):
            return canonicalize_chained(p, opts)
        if opts.linear_solver in ("banded-bcr", "multifrontal"):
            raise ValueError(banded)
        return canonicalize(p, opts)

    cs = [canon(p) for p in problems]
    s0, ch0 = cs[0].struct, cs[0].chain
    for c in cs[1:]:
        if c.struct != s0:
            raise ValueError("batched problems must share structure "
                             "(same n/me/mi and index sets)")
        if c.chain != ch0:
            raise ValueError("batched chained problems must share one "
                             "ChainInfo (sizes, row classes, stage callables)")
    first = cs[0]

    def cat(name):
        vals = [getattr(c, name) for c in cs]
        if name == "params":
            if first.params == ():
                return ()
            return _cat_trees(vals)
        return torch.cat([v.cpu() for v in vals], 0)

    stacked = first._replace(**{name: cat(name) for name in ARRAY_FIELDS})
    return stacked if device is None else stacked.to(device)


def _cat_trees(trees):
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.cat([t.cpu() for t in trees], 0)
    if isinstance(t0, dict):
        return {k: _cat_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_cat_trees(list(vs)) for vs in zip(*trees))
    raise TypeError(f"cannot stack params leaf {type(t0)!r}")


def solve_batched(problem_batch, options: Optional[Options] = None,
                  device=None, **option_kwargs) -> SolveResult:
    """Solve a batch of structurally identical NLPs in lockstep.

    ``problem_batch`` is a list of ``NLP``/canonical instances or a batched
    ``CanonicalNLP``.  The solve runs on ``device``, by default the CUDA
    device; ``device="cpu"`` selects the CPU.  Every field of the result has
    a leading batch axis."""
    opts = prepare_options(options, option_kwargs)
    opts = opts.replace(print_level=0)  # no per-lane logging in batch mode
    dev = resolve_device(device)
    if isinstance(problem_batch, CanonicalNLP):  # a NamedTuple: test it first
        nlp_b = problem_batch.to(dev)
    else:
        nlp_b = stack_problems(problem_batch, opts, device=dev)
    # the reference's batched driver runs no convergence check before the
    # first step (ipopt_tpu/batch.py:38-52)
    return solve_canonical(nlp_b, opts, initial_convergence_check=False)
