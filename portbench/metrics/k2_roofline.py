"""K2's share of its roofline over the traced solve: the summed least time
of every K2 call (``roofline.k2_least_s`` of its (nb, b) and type) over the
summed device time of the kernels launched inside those calls, in percent.
The calls are those of K2's wrapper at its call site in the block cyclic
reduction."""
from portbench.roofline import k2_least_s

CALL_SITES = ("ipopt_torch.linalg.block_tridiag.block_ldlt_inv",)


def read(run):
    calls = run.trace.calls.get("k2_roofline") if run.trace else None
    if not calls:
        return None
    return 100.0 * sum(k2_least_s(s, d) for s, d, _ in calls) / sum(t for _, _, t in calls)
