"""Back-solves with the factorization, refinement included, per
interior-point iteration (ms): the self time of the program's
``kkt.backsolve`` spans in the traced solve, over its ``iteration`` spans
(host clock)."""
from portbench.spans import self_ms_per_iteration


def read(run):
    return self_ms_per_iteration(run, ("kkt.backsolve",))
