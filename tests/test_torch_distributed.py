"""Batches and scenarios over devices in the PyTorch port, on the CPU:
``solve_batched(devices=...)`` (the reference's ``mesh=``,
``tests/test_batch.py:48-61``), the scenario groups of
``canonicalize_scenario(devices=...)`` (``tests/test_scenario.py:70-97``)
and two gloo processes solving halves of a batch with
``solve_batched_distributed`` (``tests/test_distributed.py``'s problem).
The reference's results are recorded by ``tools/torch_reference_values.py``
(its sharded solves take tens of seconds to compile here).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ipopt_torch
from ipopt_torch import Options, modellib
from ipopt_torch.parallel.scenario import canonicalize_scenario
import torch_cases
from test_torch_adaptive import assert_matches_recorded

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch():
    return [modellib.hs071_family(d) for d in torch_cases.BATCH_DELTAS]


@pytest.mark.parametrize("devices", [["cpu"] * 8, ["cpu"] * 3])
def test_solve_batched_over_devices(devices):
    """One chunk of lanes per device: every lane equals the one-device
    solve exactly and the reference's mesh-sharded solve (status,
    iterations, objective and x)."""
    one = ipopt_torch.solve_batched(_batch(), device="cpu")
    res = ipopt_torch.solve_batched(_batch(), devices=devices)
    for f in ("status", "iter_count", "obj", "x", "y", "z_L", "z_U"):
        assert torch.equal(getattr(res, f), getattr(one, f)), f
    assert res.batched_factorizations >= one.batched_factorizations
    want = torch_cases.recorded()["batch:hs071_shifted"]
    assert res.status.tolist() == want["status"]
    assert res.iter_count.tolist() == want["iter_count"]
    np.testing.assert_allclose(res.obj.numpy(), want["obj"], rtol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), want["x"], atol=1e-8)


def test_scenario_groups_over_devices():
    """stochastic_qp(16, 4, seed 3) with its scenarios in 8 groups: the
    reference's recorded solve and the port's one-group solve."""
    name = "scen_qp_16"
    _, rec = torch_cases.solve_port(name, {})
    assert_matches_recorded(name, rec)
    sn = torch_cases.build(torch_cases.CASES[name]["problem"], "port")
    opts = Options(print_level=0)
    cnlp = canonicalize_scenario(sn, opts, device="cpu", devices=["cpu"] * 8)
    assert len(cnlp.chain.devices) == 8
    res = ipopt_torch.solve(cnlp, opts, device="cpu")
    assert (int(res.status), int(res.iter_count)) == (rec["status"], rec["iter_count"])
    np.testing.assert_allclose(float(res.obj), rec["obj"], rtol=1e-9)
    one = ipopt_torch.solve(sn, opts, device="cpu")
    assert float((res.x - one.x).abs().max()) < 1e-10


def test_scenario_groups_factor_and_solve():
    """The grouped arrow factorization against the one-group one on one
    assembled matrix: the same inertia, solutions to 1e-12, also with
    more groups than a device count divides evenly."""
    from ipopt_torch.algorithm.arrow_kkt import ArrowMatrix, arrow_factorize, arrow_solve
    rng = np.random.default_rng(0)
    B, S, bs, n0 = 1, 10, 5, 3
    A = rng.standard_normal((B, S, bs, bs))
    Ks = A + A.transpose(0, 1, 3, 2) + np.diag([4.0, 4.0, 4.0, -4.0, -4.0])
    K0 = np.eye(n0)[None] * 20.0
    K = ArrowMatrix(Ks=torch.tensor(Ks), Cs=torch.tensor(rng.standard_normal((B, S, bs, n0))),
                    K0=torch.tensor(K0))
    r0 = torch.tensor(rng.standard_normal((B, n0)))
    rs = torch.tensor(rng.standard_normal((B, S, bs)))
    f1 = arrow_factorize(K)
    w0, ws = arrow_solve(f1, r0, rs)
    for G in (2, 3, 10):
        fg = arrow_factorize(K, devices=["cpu"] * G)
        assert len(fg.groups) == G
        assert [int(getattr(fg, c)) for c in ("num_pos", "num_neg", "num_zero")] == [
            int(getattr(f1, c)) for c in ("num_pos", "num_neg", "num_zero")]
        g0, gs = arrow_solve(fg, r0, rs)
        assert float((g0 - w0).abs().max()) < 1e-12
        assert float((gs - ws).abs().max()) < 1e-12


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    import ipopt_torch
    from ipopt_torch import modellib
    from ipopt_torch.batch import solve_batched_distributed
    B = 8
    batch = [modellib.hs071_family(0.01 * i) for i in range(B)]
    res = solve_batched_distributed(batch, device="cpu", tol=1e-8)
    assert res.status.shape == (B,), res.status.shape
    assert (res.status == 0).all(), res.status
    assert abs(float(res.obj[0]) - 17.0140171451792) < 1e-6, float(res.obj[0])
    one = ipopt_torch.solve_batched(batch[rank * 4:rank * 4 + 4], device="cpu",
                                    tol=1e-8)
    assert torch.equal(res.x[rank * 4:rank * 4 + 4], one.x)
    dist.destroy_process_group()
    print(f"rank {rank}: DISTRIBUTED_OK {res.iter_count.tolist()}")
""")


def test_two_process_gloo_batch(tmp_path):
    """Two gloo processes, each solving its half of an 8-lane HS071 family;
    both see all 8 lanes at status 0, lane 0 at f* to 1e-6, and their own
    half equal to a one-process solve of it."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), "2", str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert "DISTRIBUTED_OK" in out, out[-2000:]
