"""The port's multi-device paths on every card of one host, each against its
one-card solve:

1. ``solve_batched(devices=[cuda:0, ..., cuda:N-1])`` on the HS071 family
   (B = 512 and 2048): every lane equal to the one-card solve, warm walls
   (the chunks run one after another: placement, not speed);
2. ``chain_shard=True`` on ``luksan_vlcek1(4096, 32)`` over 8 shards spread
   over the N cards, beside the 8 shards on one card and the unsharded
   solve: status, iterations, objective, ms per iteration;
3. ``stochastic_qp(8192, 30)`` with its scenarios in N groups, one per
   card, beside the one-group solve;
4. ``solve_batched_distributed`` in N processes over NCCL, one card each,
   on the same families: every lane equal to the one-card solve, the
   slowest rank's warm wall beside the one-card solve's.

    python3 tools/multi_card.py           # needs two cards or more
    python3 tools/multi_card.py --cpu 4   # the same logic on the CPU at small
                                          # sizes, 4 "devices", gloo

Prints one line per measurement and, as its last line, a JSON object with
the numbers; exits non-zero if any check fails.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ipopt_torch  # noqa: E402
from ipopt_torch import modellib  # noqa: E402
from ipopt_torch.parallel.chain_shard import set_chain_mesh  # noqa: E402

OPTS = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, print_level=0)
FULL = dict(batches=(512, 2048), chain=(4096, 32), shards=8, scen=(8192, 30))
SMALL = dict(batches=(16,), chain=(256, 4), shards=8, scen=(64, 5))


def log(msg):
    print(msg, flush=True)


def sync():
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def timed(fn):
    """(result of the warm call, its wall in s); a cold call first."""
    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return "; ".join(out.stdout.strip().splitlines())


def batch_phase(devs, B):
    family = [modellib.hs071_family(0.005 * i) for i in range(B)]
    nlp_b = ipopt_torch.stack_problems(family, ipopt_torch.Options(**OPTS))
    one, t1 = timed(lambda: ipopt_torch.solve_batched(nlp_b, device=devs[0], **OPTS))
    many, tn = timed(lambda: ipopt_torch.solve_batched(nlp_b, devices=devs, **OPTS))
    same = all(torch.equal(getattr(many, f).cpu(), getattr(one, f).cpu())
               for f in ("status", "iter_count"))
    dx = float((many.x.cpu() - one.x.cpu()).abs().max())
    log(f"batch B = {B}: {len(devs)} devices {tn:.3f} s against one {t1:.3f} s "
        f"({t1 / tn:.2f}x); status and iterations equal {same}, max |dx| {dx:.3e}")
    return dict(B=B, one_s=t1, many_s=tn, speedup=t1 / tn, equal=same and dx <= 1e-12,
                max_dx=dx), one, t1


def chain_phase(devs, n, v, P):
    cnlp = ipopt_torch.canonicalize_chained(modellib.luksan_vlcek1(n, v),
                                            ipopt_torch.Options(**OPTS), device=devs[0])
    rows = {}
    for tag, mesh in (("unsharded", None), ("one_device", [devs[0]] * P),
                      ("spread", [devs[p * len(devs) // P] for p in range(P)])):
        set_chain_mesh(mesh)
        kw = dict(OPTS, chain_shard=mesh is not None)
        try:
            res, wall = timed(lambda: ipopt_torch.solve(cnlp, device=devs[0], **kw))
        finally:
            set_chain_mesh(None)
        it = int(res.iter_count)
        rows[tag] = dict(status=int(res.status), iterations=it, obj=float(res.obj),
                         wall_s=wall, ms_per_iteration=wall / max(it, 1) * 1e3)
        log(f"chain luksan_vlcek1({n}, {v}) {tag} ({P} shards): {rows[tag]}")
    base = rows["unsharded"]
    ok = all((r["status"], r["iterations"]) == (base["status"], base["iterations"])
             and abs(r["obj"] - base["obj"]) <= 1e-9 * abs(base["obj"])
             for r in rows.values())
    return dict(rows, equal=ok)


def scenario_phase(devs, S, ns):
    rows = {}
    for tag, groups in (("one_group", None), ("groups", devs)):
        cnlp = ipopt_torch.canonicalize_scenario(modellib.stochastic_qp(S, ns),
                                                 ipopt_torch.Options(**OPTS),
                                                 device=devs[0], devices=groups)
        res, wall = timed(lambda: ipopt_torch.solve(cnlp, device=devs[0], **OPTS))
        it = int(res.iter_count)
        rows[tag] = dict(status=int(res.status), iterations=it, obj=float(res.obj),
                         wall_s=wall, ms_per_iteration=wall / max(it, 1) * 1e3)
        log(f"scenario stochastic_qp({S}, {ns}) {tag} ({len(devs)} devices): {rows[tag]}")
    a, b = rows["one_group"], rows["groups"]
    ok = ((a["status"], a["iterations"]) == (b["status"], b["iterations"])
          and abs(a["obj"] - b["obj"]) <= 1e-9 * abs(a["obj"]))
    return dict(rows, equal=ok)


_WORKER = textwrap.dedent("""
    import sys, time
    import torch
    import torch.distributed as dist
    rank, world, port, backend, B, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                          sys.argv[3], sys.argv[4], int(sys.argv[5]),
                                          sys.argv[6])
    sys.path.insert(0, sys.argv[7])
    dev = f"cuda:{rank}" if backend == "nccl" else "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.batch import solve_batched_distributed
    OPTS = dict(tol=1e-8, acceptable_tol=1e-6, acceptable_iter=10, print_level=0)
    # stacked on the host before the clock starts, as the one-card solve is
    family = ipopt_torch.stack_problems([modellib.hs071_family(0.005 * i)
                                         for i in range(B)], ipopt_torch.Options(**OPTS))
    solve_batched_distributed(family, device=dev, **OPTS)
    dist.barrier()
    t0 = time.perf_counter()
    res = solve_batched_distributed(family, device=dev, **OPTS)
    dist.barrier()
    wall = time.perf_counter() - t0
    one = torch.load(ref)
    same = (torch.equal(res.status.cpu(), one["status"])
            and torch.equal(res.iter_count.cpu(), one["iter_count"]))
    dx = float((res.x.cpu() - one["x"]).abs().max())
    dist.destroy_process_group()
    print(f"DISTRIBUTED rank {rank} equal {same} max_dx {dx!r} wall {wall!r}", flush=True)
""")


def distributed_phase(world, backend, one, B, one_s):
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "one.pt")
        torch.save({k: getattr(one, k).cpu() for k in ("status", "iter_count", "x")}, ref)
        worker = os.path.join(tmp, "worker.py")
        with open(worker, "w") as fh:
            fh.write(_WORKER)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        # one host: NCCL's bootstrap over the loopback interface
        env = dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
        procs = [subprocess.Popen([sys.executable, worker, str(r), str(world), str(port),
                                   backend, str(B), ref, ROOT], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    rows = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = [x for x in out.splitlines() if x.startswith("DISTRIBUTED")]
        if p.returncode != 0 or not line:
            log(f"rank {r} failed (rc {p.returncode}):\n{out[-3000:]}")
            rows.append(dict(rank=r, equal=False))
            continue
        f = line[-1].split()
        rows.append(dict(rank=r, equal=f[4] == "True", max_dx=float(f[6]),
                         wall_s=float(f[8])))
        log(line[-1])
    ok = all(r["equal"] and r["max_dx"] <= 1e-12 for r in rows)
    wall = max(r["wall_s"] for r in rows) if ok else None
    log(f"distributed B = {B}: {world} processes ({backend}) {wall} s against one "
        f"device {one_s:.3f} s; every lane equal {ok}")
    return dict(backend=backend, world=world, B=B, ranks=rows, wall_s=wall,
                one_s=one_s, speedup=one_s / wall if ok else None, equal=ok)


def main(argv):
    if argv[:1] == ["--cpu"]:
        n = int(argv[1])
        devs, sizes, backend = [torch.device("cpu")] * n, SMALL, "gloo"
        torch.set_num_threads(1)
        card = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            raise SystemExit("multi_card: needs two CUDA cards or more (or --cpu N)")
        n = torch.cuda.device_count()
        devs, sizes, backend = [torch.device(f"cuda:{i}") for i in range(n)], FULL, "nccl"
        card = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        from ipopt_torch.linalg import cuda_lib
        t0 = time.perf_counter()
        cuda_lib.build()
        log(f"build {time.perf_counter() - t0:.1f} s")
    log(f"devices: {n}; card(s): {card}")
    out = dict(devices=n, card=card)
    out["batch"], out["distributed"] = [], []
    for B in sizes["batches"]:
        row, one, one_s = batch_phase(devs, B)
        out["batch"].append(row)
        out["distributed"].append(distributed_phase(n, backend, one, B, one_s))
    out["chain"] = chain_phase(devs, *sizes["chain"], sizes["shards"])
    out["scenario"] = scenario_phase(devs, *sizes["scen"])
    ok = (all(r["equal"] for r in out["batch"] + out["distributed"])
          and out["chain"]["equal"] and out["scenario"]["equal"])
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
