"""Seconds in which the device ran a kernel, a copy or a memset during the
traced solve: the union of the device intervals of a CUDA-only trace.  It
repeats to a few digits where ``solve_s`` spreads with the host, so a
change to the device's work shows here when the wall cannot resolve it."""


def read(run):
    return run.trace.busy_s if run.trace is not None and run.trace.busy_s > 0 else None
