"""Share of the traced solve's wall in which no kernel, copy or memset ran
on the device: 1 - (union of the device intervals) / wall, in percent, from
a trace of CUDA activity only.  The tracer's own cost on the host makes it
read high."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
