"""ipopt_torch — the PyTorch/CUDA port of ipopt_tpu.

The same primal-dual interior point method with filter line search, the same
``Options`` names and defaults and the same status codes, written over an
explicit batch axis in PyTorch; the batched unpivoted LDL^T of the KKT
matrices is a hand-written CUDA kernel (``csrc/block_ldlt.cu``, K1).  Chained
problems (``ChainedNLP``) run on a block-tridiagonal KKT backend, factored by
block cyclic reduction whose block inverses are the hand-written kernel
``csrc/block_ldlt_inv.cu`` (K2).  A flat ``NLP`` solved with
``linear_solver="banded-bcr"`` runs on the general-sparsity backend
(``ipopt_torch.sparse``): its declared or detected sparsity pattern is
reordered by reverse Cuthill-McKee into the same block-tridiagonal form.
Scenario problems (``ScenarioNLP``, two-stage stochastic programs) run on a
block-arrow backend: K1 factors the scenario blocks, a Schur complement
couples them.  ``hessian_approximation="limited-memory"`` (BFGS or SR1)
works on every backend, by Sherman-Morrison-Woodbury around the backend's
own factorization.  ``factorization_dtype="float32"`` factors every
backend's KKT in float32 (K1 and K2 in float32) and refines against the
float64 matrix; ``ipopt_torch.sens`` computes parametric sensitivities on
the solution's factorization, ``ipopt_torch.deriv_check`` checks
derivatives and ``ipopt_torch.profiling`` times and traces a solve.
The entry points run on the CUDA device unless the caller passes
``device="cpu"``.

Quick start::

    from ipopt_torch import solve, solve_batched, modellib
    res = solve(modellib.hs071())                       # on the card
    res = solve(modellib.hs071(), device="cpu")         # on the CPU
    rb = solve_batched([modellib.hs071_family(0.005 * i) for i in range(512)])
    rc = solve(modellib.luksan_vlcek1(4096, 32))        # chained, on the card
    rs = solve(modellib.luksan_vlcek1_flat(100_000),    # banded, on the card
               linear_solver="banded-bcr")
    ra = solve(modellib.hs071(), mu_strategy="adaptive")  # adaptive mu
    rl = solve(modellib.hs071(), hessian_approximation="limited-memory")
    rz = solve(ScenarioNLP(...))                          # block-arrow
    rw = solve(modellib.hs071(), it0=res.iterate,         # a warm start
               warm_start_init_point=True, mu_init=1e-6)
"""

from .types import Iterate, SolverReturn, ApplicationReturnStatus
from .problem import NLP, CanonicalNLP, canonicalize
from .chained import ChainedNLP, canonicalize_chained
from .parallel.scenario import ScenarioNLP, canonicalize_scenario
from .options import Options, print_options_documentation, parse_options_file
from .algorithm.solver import SolveResult, UnsupportedOptionError, solve
from .batch import solve_batched, stack_problems
from . import modellib

__version__ = "0.1.0"

__all__ = [
    "NLP", "CanonicalNLP", "canonicalize", "Options", "solve", "SolveResult",
    "Iterate", "SolverReturn", "ApplicationReturnStatus",
    "UnsupportedOptionError", "print_options_documentation",
    "parse_options_file", "solve_batched", "stack_problems", "modellib",
    "ChainedNLP", "canonicalize_chained", "ScenarioNLP", "canonicalize_scenario",
]
