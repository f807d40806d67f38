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

Over devices (``solve_batched(..., devices=[...])``, the counterpart of the
reference's ``mesh=``): the lanes are cut into one contiguous chunk per
device, each chunk is solved on its device, and the results are
concatenated in lane order.  Each device owns whole instances, so no
collective runs inside the solve.  The chunks are solved one after another
from the one host thread: N cards hold one chunk each (placement, device
memory), but the wall is the sum of the chunks' walls, since a solve's host
loop waits on its device every iteration and host threads cannot overlap
them (``torch.func``'s forward-mode levels are global to the process).  Across processes
(``solve_batched_distributed``, the counterpart of the reference's
``jax.distributed`` batch): each rank of an initialized ``torch.distributed``
process group solves its chunk on its own device and the result fields are
all-gathered.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from .problem import CanonicalNLP, ARRAY_FIELDS, canonicalize
from .types import contiguous_ranges, tree_map
from .chained import ChainedNLP, canonicalize_chained
from .options import Options
from .sparse import BandedInfo
from .linalg.nested_dissection import NDInfo
from .algorithm.solver import (SolveResult, guarded_step, prepare_options,
                               resolve_device, solve_canonical)

__all__ = ["stack_problems", "solve_batched", "solve_batched_distributed",
           "guarded_step"]


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
                  device=None, devices: Optional[Sequence] = None,
                  **option_kwargs) -> SolveResult:
    """Solve a batch of structurally identical NLPs in lockstep.

    ``problem_batch`` is a list of ``NLP``/canonical instances or a batched
    ``CanonicalNLP``.  The solve runs on ``device``, by default the CUDA
    device; ``device="cpu"`` selects the CPU.  With ``devices`` (a sequence
    of devices, repeats allowed) the lanes are cut into one contiguous chunk
    per entry, each chunk solved on its device one after another (module
    docstring: placement, not speed; ``solve_batched_distributed`` runs
    the chunks at the same time, one process per device), and the results
    concatenated in lane order on the first device; every lane equals its
    one-device solve.  Every field of the result has a leading batch
    axis."""
    opts = prepare_options(options, option_kwargs)
    opts = opts.replace(print_level=0)  # no per-lane logging in batch mode
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        nlp_b = _host_batch(problem_batch, opts)
        chunks = [(lo, hi, d) for (lo, hi), d in
                  zip(contiguous_ranges(nlp_b.batch, len(devs)), devs) if hi > lo]
        return _concat(_solve_chunks(nlp_b, chunks, opts), devs[0])
    dev = resolve_device(device)
    if isinstance(problem_batch, CanonicalNLP):  # a NamedTuple: test it first
        nlp_b = problem_batch.to(dev)
    else:
        nlp_b = stack_problems(problem_batch, opts, device=dev)
    return _solve_lanes(nlp_b, opts)


def _solve_lanes(nlp_b: CanonicalNLP, opts: Options) -> SolveResult:
    # the reference's batched driver runs no convergence check before the
    # first step (ipopt_tpu/batch.py:38-52)
    return solve_canonical(nlp_b, opts, initial_convergence_check=False)


def _solve_chunks(nlp_b: CanonicalNLP, chunks, opts: Options):
    """The results of the lane chunks ((lo, hi, device), ...), in turn, each
    solved with its device current."""
    out = []
    for lo, hi, d in chunks:
        with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
            out.append(_solve_lanes(nlp_b.take(torch.arange(lo, hi)).to(d), opts))
    return out


def _host_batch(problem_batch, opts: Options) -> CanonicalNLP:
    if isinstance(problem_batch, CanonicalNLP):
        return problem_batch.to("cpu")
    return stack_problems(problem_batch, opts)


def _concat(parts, device) -> SolveResult:
    """The results of consecutive lane chunks as one result on ``device``."""
    out = tree_map(lambda *ts: torch.cat([t.to(device) for t in ts], 0),
                   *(p[:-1] for p in parts))
    return SolveResult(*out, sum(p.batched_factorizations for p in parts))


def solve_batched_distributed(problem_batch, options: Optional[Options] = None,
                              device=None, group=None,
                              **option_kwargs) -> SolveResult:
    """Solve a batch over the ranks of an initialized ``torch.distributed``
    process group (``group``, default the world): every rank passes the same
    batch, solves its contiguous chunk of lanes on ``device`` (by default
    ``cuda:<rank % device_count>``; ``device="cpu"`` for the CPU), and gets
    the whole result, its fields all-gathered in lane order (on the CPU
    under gloo, on the rank's device under NCCL)."""
    import torch.distributed as dist
    opts = prepare_options(options, option_kwargs).replace(print_level=0)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        device = (f"cuda:{rank % torch.cuda.device_count()}"
                  if torch.cuda.is_available() else None)
    dev = resolve_device(device)
    batched = isinstance(problem_batch, CanonicalNLP)
    ranges = contiguous_ranges(problem_batch.batch if batched else len(problem_batch),
                               world)
    lo, hi = ranges[rank]
    # each rank canonicalizes only its own chunk of a list of problems
    part = _host_batch(problem_batch if batched else problem_batch[lo:hi], opts)
    off = lo if batched else 0
    res = _solve_chunks(part, [(off, off + hi - lo, dev)], opts)[0]
    width = max(b - a for a, b in ranges)
    comm_dev = dev if dist.get_backend(group) == "nccl" else torch.device("cpu")

    def gather(t):
        # chunks differ by one lane at most: pad to the widest, gather, trim
        kind = t.dtype
        t = t.to(comm_dev, torch.uint8 if kind == torch.bool else kind)
        pad = t.new_zeros((width,) + t.shape[1:])
        pad[:t.shape[0]] = t
        bufs = [torch.empty_like(pad) for _ in range(world)]
        dist.all_gather(bufs, pad, group=group)
        return torch.cat([buf[:b - a] for buf, (a, b) in zip(bufs, ranges)], 0).to(kind)

    total = torch.tensor([res.batched_factorizations], device=comm_dev)
    dist.all_reduce(total, group=group)
    return SolveResult(*tree_map(gather, res[:-1]), int(total))
