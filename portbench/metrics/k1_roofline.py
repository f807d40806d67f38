"""K1's share of its roofline over the traced solve: the summed least time
of every K1 call (``roofline.k1_least_s`` of its (nb, b) and type) over the
summed device time of the kernels launched inside those calls, in percent.
The calls are those of K1's wrapper at its call sites."""
from portbench.roofline import k1_least_s

CALL_SITES = ("ipopt_torch.linalg.block_tridiag.block_ldlt",
              "ipopt_torch.linalg.ldlt.block_ldlt")


def read(run):
    calls = run.trace.calls.get("k1_roofline") if run.trace else None
    if not calls:
        return None
    return 100.0 * sum(k1_least_s(s, d) for s, d, _ in calls) / sum(t for _, _, t in calls)
