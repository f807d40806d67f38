"""KKT factorizations per iteration (``counters.n_factorizations`` over
``iter_count``, summed over the window's solves): the inertia-correction
retries' work beyond one factorization per step."""


def read(run):
    iters = sum(s["iter_count"] for s in run.solves)
    if not iters:
        return None
    return sum(s["n_factorizations"] for s in run.solves) / iters
