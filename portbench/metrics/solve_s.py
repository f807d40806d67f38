"""Time to solution: the summed wall of the window's whole solves, each
ended by a synchronize, over their count (host clock)."""


def read(run):
    return sum(run.solve_walls) / len(run.solve_walls) if run.solve_walls else None
