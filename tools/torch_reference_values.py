"""Solve the cases of tests/torch_cases.py with the JAX reference (float64,
CPU) and write their results to tests/torch_reference_values.json, which
the port's parity tests read.

    python3 tools/torch_reference_values.py [--out PATH] [case ...]

With case names, only those are solved, and the file keeps its other
entries (``capi`` alone records the ``solve_from_c`` entries); ``--out``
writes another file (to run subsets in parallel).  Each case records
status, iterations, objective, the counters,
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

# eight virtual CPU devices, as tests/conftest.py sets them: the chain_shard
# cases shard the chain axis over them
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

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
    if case["opts"].get("chain_shard"):
        from jax.sharding import Mesh
        from ipopt_tpu.parallel.chain_shard import set_chain_mesh
        set_chain_mesh(Mesh(np.array(jax.devices()[:torch_cases.CHAIN_SHARDS]),
                            ("chain",)), "chain")
    # the sharded solve cannot run a host callback inside its loop (XLA's
    # partitioner refuses a replicated side-effecting op): no per-iteration
    # record there
    sharded = bool(case["opts"].get("chain_shard"))
    res = ipopt_tpu.solve(torch_cases.build(case["problem"], "ref"), print_level=0,
                          it0=it0, intermediate_callback=None if sharded else cb,
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


def shard_retry_record(name):
    """The reference's dist_factorize_retry on torch_cases.shard_retry_problem()
    over CHAIN_SHARDS virtual devices: (delta_x, delta_c, trials, ok,
    gave_up, num_pos, num_neg, num_zero)."""
    from jax.sharding import Mesh
    from ipopt_tpu.linalg.block_tridiag import BTDMatrix
    from ipopt_tpu.parallel import chain_shard as cs
    dtype, scaling = torch_cases.SHARD_RETRY[name]
    diag, sub, kind, exp_pos, exp_neg = torch_cases.shard_retry_problem()
    cs.set_chain_mesh(Mesh(np.array(jax.devices()[:torch_cases.CHAIN_SHARDS]),
                           ("chain",)), "chain")
    jdt = getattr(jax.numpy, dtype)
    K = BTDMatrix(diag=jax.numpy.asarray(diag, jdt), sub=jax.numpy.asarray(sub, jdt))
    fac, dx, dc, tr, ok, gu = cs.dist_factorize_retry(
        K, jax.numpy.asarray(kind), ipopt_tpu.Options(linear_system_scaling=scaling),
        jax.numpy.asarray(1e-8), jax.numpy.asarray(0.0), exp_pos, exp_neg)
    return [float(dx), float(dc), int(tr), bool(ok), bool(gu), int(fac.num_pos),
            int(fac.num_neg), int(fac.num_zero)]


def batch_record():
    """The reference's solve_batched of the HS071 batch BATCH_DELTAS, its
    lanes sharded over an 8-device mesh (tests/test_batch.py:48-61)."""
    from jax.sharding import Mesh
    from ipopt_tpu.batch import solve_batched
    batch = [ipopt_tpu.NLP(**torch_cases._hs071_spec(jax.numpy, jax.numpy.array, d))
             for d in torch_cases.BATCH_DELTAS]
    res = solve_batched(batch, mesh=Mesh(np.array(jax.devices()[:8]), ("batch",)))
    return dict(status=np.asarray(res.status).tolist(),
                iter_count=np.asarray(res.iter_count).tolist(),
                obj=np.asarray(res.obj).tolist(), x=np.asarray(res.x).tolist())


def capi_record(name):
    """The reference's solve_from_c on torch_cases.capi_solve's HS071:
    (status, x, obj)."""
    from ipopt_tpu.interfaces import capi
    status, x, obj = torch_cases.capi_solve(capi, name)[:3]
    return dict(status=int(status), x=[float(v) for v in x], obj=float(obj))


def main(names):
    # "capi" records the solve_from_c entries alone
    capi_only = names == ["capi"]
    names = [] if capi_only else (names or sorted(torch_cases.CASES))
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
    if any(torch_cases.CASES[n]["suite"] == "distributed" for n in names):
        table["batch:hs071_shifted"] = batch_record()
        print("batch:hs071_shifted recorded", flush=True)
    if any(torch_cases.CASES[n]["suite"] == "chain_shard" for n in names):
        for name in sorted(torch_cases.SHARD_RETRY):
            table[f"shard_retry:{name}"] = shard_retry_record(name)
            print(f"shard_retry:{name} recorded", flush=True)
    if capi_only or len(names) == len(torch_cases.CASES):
        for name in torch_cases.CAPI:
            table[f"capi:{name}"] = capi_record(name)
            print(f"capi:{name} recorded", flush=True)
    with open(OUT, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--out"]:
        OUT, args = args[1], args[2:]
    main(args)
