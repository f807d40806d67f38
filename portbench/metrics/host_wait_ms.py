"""The host blocked on the device, per interior-point iteration (ms): the
summed time of the program's ``host_wait`` spans in the traced solve over
its ``iteration`` spans (host clock)."""
from portbench.spans import per_iteration


def read(run):
    return per_iteration(run, lambda spans: sum(
        s.end_ns - s.start_ns for s in spans if s.name == "host_wait") / 1e6)
