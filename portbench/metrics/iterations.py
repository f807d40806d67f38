"""Interior-point iterations per solve (``SolveResult.iter_count``), the
mean over the window's solves."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iter_count"] for s in run.solves) / len(run.solves)
