"""KKT assembly and factorization per interior-point iteration (ms): the
self time of the program's ``kkt.assemble`` and ``kkt.factorize`` spans (one
per trial of the inertia-correction retry) in the traced solve, over its
``iteration`` spans (host clock)."""
from portbench.spans import self_ms_per_iteration


def read(run):
    return self_ms_per_iteration(run, ("kkt.assemble", "kkt.factorize"))
