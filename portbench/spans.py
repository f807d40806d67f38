"""The program's spans of the traced solve, for the per-layer metrics that
read them (``metrics/<name>.py``).  The program records a solve's spans
while a profiler session is active (``ipopt_torch.profiling.last_spans``:
name, start and end ns, parent index, iteration); a program without the
recorder gives none, and these metrics then find nothing to read.  Self
times are worked out here, from the spans alone."""


def traced_spans(run):
    """The spans of the run's traced solve, or None: no traced solve, or a
    program that records none."""
    if run.trace is None:
        return None
    try:
        from ipopt_torch import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_spans", None)
    return (last() or None) if last is not None else None


def self_ns(spans, names) -> int:
    """Summed self time (ns) of the spans named ``names``: each span's
    duration less the part its child spans cover."""
    child = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    return sum(s.end_ns - s.start_ns - c for s, c in zip(spans, child) if s.name in names)


def per_iteration(run, value):
    """``value(spans)`` over the number of ``iteration`` spans of the traced
    solve; None where there is nothing to read."""
    spans = traced_spans(run)
    iters = sum(1 for s in spans if s.name == "iteration") if spans else 0
    return value(spans) / iters if iters else None


def self_ms_per_iteration(run, names):
    """Self time (ms) of the spans named ``names`` per iteration; None
    where the traced solve has no such span."""
    spans = traced_spans(run)
    if not spans or not any(s.name in names for s in spans):
        return None
    return per_iteration(run, lambda spans: self_ns(spans, names) / 1e6)
