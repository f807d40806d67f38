"""The multifrontal factorization's extend-adds per interior-point
iteration (ms): the self time of the program's ``nd.extend_add`` spans in
the traced solve, over its ``iteration`` spans (host clock).  Nothing to
read on a backend without fronts."""
from portbench.spans import self_ms_per_iteration


def read(run):
    return self_ms_per_iteration(run, ("nd.extend_add",))
