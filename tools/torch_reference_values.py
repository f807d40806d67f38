"""Solve the cases of tests/torch_cases.py with the JAX reference (float64,
CPU) and write their results to tests/torch_reference_values.json, which
the port's parity tests read.

    python3 tools/torch_reference_values.py [--out PATH] [case ...]

With case names, only those are solved, and the file keeps its other
entries; ``--out`` writes another file (to run subsets in parallel).  Each case records status, iterations, objective, the counters,
the restoration count and the per-iteration mu and line-search trials (and
the final iterate, for the cases marked ``record_iterate``; the
per-iteration (iteration, objective, inf_pr, inf_du, mu, alpha_pr,
alpha_du) and the
final x, for those marked ``record_trace``).
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(os.path.dirname(HERE), "tests")
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import ipopt_tpu  # noqa: E402
import torch_cases  # noqa: E402

OUT = os.path.join(TESTS, "torch_reference_values.json")


def solve_case(name, done):
    case = torch_cases.CASES[name]
    it0 = None
    if case["warm"] is not None:
        it0 = done[case["warm"]]
    mus, trials, trace = [], [], []

    def cb(**k):
        mus.append(float(k["mu"]))
        trials.append(int(k["ls_trials"]))
        trace.append([int(k["iter_count"])] + [float(k[f]) for f in (
            "obj_value", "inf_pr", "inf_du", "mu", "alpha_pr", "alpha_du")])
        return True

    custom = torch_cases.eigh_kkt("ref") if case.get("custom") else None
    res = ipopt_tpu.solve(torch_cases.build(case["problem"], "ref"), print_level=0,
                          it0=it0, intermediate_callback=cb,
                          custom_kkt_solver=custom, **case["opts"])
    c = res.counters
    extra = {}
    if case.get("record_iterate"):
        extra["iterate"] = [np.asarray(v).tolist() for v in res.iterate]
    if case.get("record_trace"):
        extra["trace"] = trace
        extra["x"] = np.asarray(res.x).tolist()
    return res, dict(**extra,
        status=int(res.status), iter_count=int(res.iter_count), obj=float(res.obj),
        n_obj_evals=int(c.n_obj_evals), n_grad_evals=int(c.n_grad_evals),
        n_hess_evals=int(c.n_hess_evals), n_factorizations=int(c.n_factorizations),
        n_kkt_solves=int(c.n_kkt_solves), restoration_count=int(res.restoration_count),
        mu=mus, ls_trials=trials)


def canonical(problem, opts):
    """The reference's canonical form of a case's problem."""
    from ipopt_tpu.chained import ChainedNLP, canonicalize_chained
    if isinstance(problem, ChainedNLP):
        return canonicalize_chained(problem, opts)
    return ipopt_tpu.canonicalize(problem, opts)


def sens_record(name, table):
    """The reference's sens.py computation ``torch_cases.SENS[name]`` at its
    case's recorded final iterate: the result's leaves, in order, as lists."""
    import ipopt_tpu.sens as sens
    case_name, fn, arg, kw = torch_cases.SENS[name]
    case = torch_cases.CASES[case_name]
    opts = ipopt_tpu.Options(**case["opts"])
    nlp = canonical(torch_cases.build(case["problem"], "ref"), opts)
    it = ipopt_tpu.Iterate(*(jax.numpy.asarray(v) for v in table[case_name]["iterate"]))
    out = getattr(sens, fn)(nlp, opts, it, arg, **kw)
    return [np.asarray(v).tolist() for v in jax.tree.leaves(out)]


def main(names):
    names = names or sorted(torch_cases.CASES)
    table = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            table = json.load(fh)
    done = {}
    order = ([n for n in names if torch_cases.CASES[n]["warm"] is None]
             + [n for n in names if torch_cases.CASES[n]["warm"] is not None])
    for name in order:
        warm = torch_cases.CASES[name]["warm"]
        if warm is not None and warm not in done:
            done[warm] = solve_case(warm, done)[0].iterate
        t0 = time.perf_counter()
        res, rec = solve_case(name, done)
        done[name] = res.iterate
        table[name] = rec
        print(f"{name}: status {rec['status']} iterations {rec['iter_count']} "
              f"obj {rec['obj']!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in sorted(torch_cases.SENS):
        if torch_cases.SENS[name][0] in names:
            table[f"sens:{name}"] = sens_record(name, table)
            print(f"sens:{name} recorded", flush=True)
    with open(OUT, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--out"]:
        OUT, args = args[1], args[2:]
    main(args)
