"""The multifrontal dense elimination's share of its roofline over the
traced solve: the summed least time of every call of the program's
``nested_dissection.eliminate_fronts`` (one level of one factorization: K1
on F11, the triangular solve for Y = L11^-1 F12, the Schur product
F22 - Y^T D^-1 Y) over the summed device time of the kernels launched inside
those calls, in percent.

The least time of a call counts the fronts' own sizes, not the padded ones
the level runs at: for a front with p eliminated and u boundary unknowns,
K1's work on F11 as ``roofline.k1_work`` counts it (the count
``k1_roofline`` uses), then the unit triangular solve's p (p - 1) / 2
multiply-adds per column of F12, D^-1 Y's p u quotients and the symmetric
Schur product's u (u + 1) / 2 entries of p multiply-adds, two operations to
a multiply-add; bytes beyond K1's: F12 and F22's lower triangle read, L21
and the update's lower triangle written.  A call's least time is
``roofline._least_s`` of its bytes and operations.  The own sizes of a
call's fronts come from the analysis: the level of its (n_d, p, f), taken
in order where two levels share one shape; a call of no level of the
problem (a restoration phase's) counts its device time and no work.

A program without ``eliminate_fronts`` (before the function existed) has no
such call; there the calls timed are K1's at the level loop
(``nested_dissection.batched_block_ldlt``) and the share counts K1's own
work alone.  That reading is another quantity (K1 alone, as ``k1_roofline``
but at the fronts' own sizes) and is not to be compared with the whole
elimination's."""
from ipopt_torch.linalg import nested_dissection as _nd
from portbench.roofline import _esize, _least_s, k1_work

_WHOLE = hasattr(_nd, "eliminate_fronts")

CALL_SITES = (("ipopt_torch.linalg.nested_dissection.eliminate_fronts",) if _WHOLE else
              ("ipopt_torch.linalg.nested_dissection.batched_block_ldlt",))


def front_work(p, u, dtype="torch.float64", whole=True):
    """(bytes, operations) of one front's elimination (K1's part alone with
    ``whole`` False); p, u ints or integer arrays."""
    nbytes, ops = k1_work(1, p, dtype)
    if not whole:
        return nbytes, ops
    elems = 2 * p * u + u * (u + 1)
    return nbytes + _esize(dtype) * elems, ops + u * p * (p - 1) + p * u + p * u * (u + 1)


def _levels(info):
    """The call's shape key -> [(own p, own u) arrays of each level of that
    shape], in the levels' order: (n_d, p, f) of ``eliminate_fronts``'s
    (B, n_d, p, f), or (n_d, p) of K1's (B n_d, p, p) with B = 1."""
    out = {}
    for lv, eg, bg in zip(info.levels, info.elim_gid, info.bd_gid):
        key = (lv.n_nodes, lv.p, lv.f) if _WHOLE else (lv.n_nodes, lv.p)
        out.setdefault(key, []).append(((eg < info.N).sum(1).astype("int64"),
                                        (bg < info.N).sum(1).astype("int64")))
    return out


def read(run):
    calls = run.trace.calls.get("front_dense_roofline") if run.trace else None
    if not calls or run.info is None:
        return None
    levels = _levels(run.info)
    seen, least, device = {}, 0.0, 0.0
    for shape, dtype, dev_s in calls:
        key = tuple(shape[-3:]) if _WHOLE else tuple(shape[:2])
        device += dev_s
        owns = levels.get(key)
        if owns:
            k = seen.get(key, 0)
            seen[key] = k + 1
            nbytes, ops = front_work(*owns[k % len(owns)], dtype, _WHOLE)
            least += _least_s(float(nbytes.sum()), float(ops.sum()), dtype)
    return 100.0 * least / device if device > 0 else None
