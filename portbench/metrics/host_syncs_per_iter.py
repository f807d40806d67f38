"""Blocking reads of device values per interior-point iteration: the
program's ``host_wait`` spans in the traced solve over its ``iteration``
spans (a count)."""
from portbench.spans import per_iteration


def read(run):
    return per_iteration(run, lambda spans: sum(1 for s in spans if s.name == "host_wait"))
