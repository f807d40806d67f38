"""Evaluations per interior-point iteration (ms): the self time of the
program's ``eval`` (f, grad f, c, d), ``eval.jacobian``, ``eval.jac_t``
(J^T y) and ``eval.hessian`` spans in the traced solve, over its
``iteration`` spans (host clock)."""
from portbench.spans import self_ms_per_iteration


def read(run):
    return self_ms_per_iteration(run, ("eval", "eval.jacobian", "eval.jac_t",
                                       "eval.hessian"))
