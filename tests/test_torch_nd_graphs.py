"""The multifrontal step's CUDA graphs (``nested_dissection.NDGraphs``):
when they engage, what they count, and that a replayed solve is the eager
solve bit for bit.

On the CPU the graphs never engage: a CPU solve and a recorded solve run
the eager loops and the replay counters stay 0.  The graphs' own logic (the
static input the assembly writes, the generation each factor carries, the
counts) is checked on the CPU through a stand-in for the capture that
reruns the captured function into its first outputs at every replay, which
is what a CUDA graph does with its static buffers.  Tests marked ``gpu``
capture real graphs on the card and hold the replayed solves to the eager
ones bit for bit.  This file imports no JAX, so the ``gpu`` tests run on a
machine without it: ``python3 -m pytest -q --noconftest -m gpu
tests/test_torch_nd_graphs.py``.
"""
import pytest
import torch

import ipopt_torch
from ipopt_torch import modellib
from ipopt_torch.algorithm.init import default_initialize
from ipopt_torch.linalg import nested_dissection as nd
from ipopt_torch.sparse import (canonicalize_sparse, jacobian_values,
                                sparse_hessian_values)

torch.set_num_threads(1)

MF = dict(linear_solver="multifrontal", print_level=0)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for leaf in tree for t in _tensors(leaf)]
    return []


def _same_bits(a, b):
    """Equal bit for bit (NaN where the other has the same NaN)."""
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return torch.equal(a, b)


def _replaying_capture(fn):
    """The CPU's stand-in for ``nd._capture``: the first run's outputs are
    the static outputs, and a replay writes a new run's into them."""
    out = fn()

    class Graph:
        def replay(self):
            for static, new in zip(_tensors(out), _tensors(fn())):
                static.copy_(new)

    return Graph(), out


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graphs engage on the CPU, through the stand-in capture."""
    monkeypatch.setattr(nd, "_card_room", lambda info, like: True)
    monkeypatch.setattr(nd, "_capture", _replaying_capture)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    return dict(nd.graph_counts, calls=nd.nd_factorize.calls, levels=nd.nd_factorize.levels)


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _solve(cnlp, dev, **kw):
    before = _counts()
    res = ipopt_torch.solve(cnlp, device=dev, **dict(MF, **kw))
    return res, _delta(before)


def _canonical(problem, dev, **kw):
    return canonicalize_sparse(problem, ipopt_torch.Options(**dict(MF, **kw)), device=dev)


def _assert_same_solve(a, b):
    for k in ("status", "iter_count", "restoration_count", "batched_factorizations"):
        assert int(getattr(a, k)) == int(getattr(b, k)), k
    assert int(a.counters.n_factorizations) == int(b.counters.n_factorizations)
    for k in ("x", "y", "z_L", "z_U", "obj"):
        assert _same_bits(getattr(a, k), getattr(b, k)), k


def _assert_replayed_everything(n, n_eager, res):
    """Every trial and every sweep of a solve's first run was a replay, of
    the problem's three graphs and, where the solve entered the restoration
    phase, of the restoration problem's own three; the counts a solve
    reports read as in the eager solve."""
    assert n["trial"] == n["calls"] == int(res.batched_factorizations)
    assert (n["calls"], n["levels"]) == (n_eager["calls"], n_eager["levels"])
    assert n["solve"] > 0 and n["matvec"] > 0
    assert n["eager"] == 0
    assert n["captures"] == 3 * (1 + (int(res.restoration_count) > 0))


def test_cpu_solve_runs_eager_and_counts_as_before():
    """The CPU takes the eager loops: no capture, no replay, no graph in
    the descriptor's cache; nd_factorize counts one call per trial and one
    level per K1 input, as before the graphs."""
    cnlp = _canonical(modellib.mittelmann_dist_control_3d(6), "cpu")
    res, n = _solve(cnlp, "cpu")
    assert (int(res.status), int(res.iter_count), int(res.counters.n_factorizations)) \
        == (0, 12, 24)
    assert all(n[k] == 0 for k in nd.graph_counts), n
    assert n["calls"] == int(res.batched_factorizations) == 24
    assert n["levels"] == 24 * len(cnlp.chain.levels)
    assert all(v is None for k, v in cnlp.chain._cache.items() if k[0] == "graphs")


@pytest.mark.parametrize("recorded", ("timing_statistics", "profiler"))
def test_recorded_solve_runs_eager(cpu_graphs, recorded):
    """Where the graphs could engage, a recorded solve (its spans read one
    by one) still runs the eager loops: no capture and no replay."""
    cnlp = _canonical(modellib.mittelmann_dist_control(8), "cpu")
    if recorded == "timing_statistics":
        res, n = _solve(cnlp, "cpu", timing_statistics=True)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            res, n = _solve(cnlp, "cpu")
    assert int(res.status) == 0
    assert all(n[k] == 0 for k in nd.graph_counts), n
    assert n["calls"] == int(res.batched_factorizations) > 0
    assert not any(k[0] == "graphs" for k in cnlp.chain._cache)


@pytest.mark.parametrize("case", ("retries", "float32_fronts", "2d", "float32_iterate"))
def test_replayed_solve_equals_eager(cpu_graphs, case):
    """With the graphs engaged (the CPU stand-in), the solve equals the
    recorded, eager one bit for bit: the same iterates, iterations and
    factorizations; every trial (two per iteration in the 3-D control,
    the inertia correction's retries) and every sweep was a replay; one
    capture of the trial and one of each sweep, and as many again for the
    restoration problem, which the float32 solves enter; a second solve
    captures nothing.  A float32 iterate refined in float64 takes the
    product's graph on float64 copies of its fronts."""
    if case == "2d":
        problem, kw = modellib.mittelmann_dist_control(8), {}
    elif case == "float32_iterate":
        problem = modellib.mittelmann_dist_control(8)
        kw = dict(dtype="float32", refinement_precision="double", tol=1e-6)
    else:
        problem = modellib.mittelmann_dist_control_3d(6)
        kw = dict(factorization_dtype="float32", tol=1e-7) if case == "float32_fronts" else {}
    cnlp = _canonical(problem, "cpu", **kw)
    eager, n_eager = _solve(cnlp, "cpu", timing_statistics=True, **kw)
    graphed, n = _solve(cnlp, "cpu", **kw)
    _assert_same_solve(graphed, eager)
    _assert_replayed_everything(n, n_eager, graphed)
    if case == "retries":
        assert int(graphed.counters.n_factorizations) > int(graphed.iter_count)
    again, n2 = _solve(cnlp, "cpu", **kw)
    _assert_same_solve(again, eager)
    assert n2["captures"] == 0 and n2["trial"] == n["trial"]


def test_declined_graphs_run_eager_and_the_decision_is_kept(monkeypatch):
    """Where the step's graphs would not fit the card (``_card_room``
    false), the solve runs the eager loops: no capture, no replay, the
    recorded solve bit for bit.  The decision is taken once per problem
    and kept, so a second solve asks nothing and no solve changes paths
    part-way."""
    asked = []
    monkeypatch.setattr(nd, "_card_room", lambda info, like: asked.append(info) or False)
    monkeypatch.setattr(nd, "_capture", _replaying_capture)
    cnlp = _canonical(modellib.mittelmann_dist_control(8), "cpu")
    eager, n_eager = _solve(cnlp, "cpu", timing_statistics=True)
    assert asked == []
    res, n = _solve(cnlp, "cpu")
    _assert_same_solve(res, eager)
    assert all(n[k] == 0 for k in nd.graph_counts), n
    assert (n["calls"], n["levels"]) == (n_eager["calls"], n_eager["levels"])
    assert len(asked) == len({id(info) for info in asked}) >= 1
    first = len(asked)
    again, _ = _solve(cnlp, "cpu")
    _assert_same_solve(again, eager)
    assert len(asked) == first


@pytest.mark.parametrize("k", (1, 3))
def test_sensitivity_lanes_of_a_graphed_factor_solve_eagerly(cpu_graphs, k):
    """``sens.reduced_hessian`` solves its k unit columns as k lanes taken
    of the factor (``types.tree_take``): copies of the graph's factor,
    which the eager loops solve whatever k is, while the factorization
    itself is a replay.  The result equals the recorded, eager call bit
    for bit."""
    from ipopt_torch.profiling import solve_span
    from ipopt_torch.sens import reduced_hessian
    cnlp = _canonical(modellib.mittelmann_dist_control(8), "cpu")
    opts = ipopt_torch.Options(**MF)
    it = ipopt_torch.solve(cnlp, device="cpu", **MF).iterate
    idx = list(range(0, 3 * k, 3))
    with solve_span(timing=True):
        want = reduced_hessian(cnlp, opts, it, idx, device="cpu")
    before = _counts()
    got = reduced_hessian(cnlp, opts, it, idx, device="cpu")
    n = _delta(before)
    assert got.shape == (k, k)
    assert _same_bits(got, want)
    assert n["trial"] >= 1 and n["solve"] == n["matvec"] == 0


def _step_inputs(dev, **kw):
    cnlp = _canonical(modellib.mittelmann_dist_control(8), dev, resto_phase=False)
    info = cnlp.chain
    opts = ipopt_torch.Options(**dict(MF, resto_phase=False, **kw))
    it = default_initialize(cnlp, opts)
    aux = nd.nd_aux(info, dev)
    jv = jacobian_values(cnlp, it.x)
    hv = sparse_hessian_values(cnlp, it)
    zero = torch.zeros((1,), dtype=torch.float64, device=dev)
    rhs = torch.randn((1, info.N), generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64).to(dev)
    return cnlp, info, opts, it, aux, jv, hv, zero, rhs


def _check_trials_and_staleness(dev, fac_dtype=None):
    cnlp, info, opts, it, aux, jv, hv, zero, rhs = _step_inputs(dev)
    base = nd.nd_assemble(cnlp, aux, info, it, jv, hv, zero, zero)
    g = nd.NDGraphs(info, aux, it.x, fac_dtype, 0.0)
    nd.nd_assemble(cnlp, aux, info, it, jv, hv, zero, zero, out=g.flat)
    facs = []
    for dx, dc in ((0.0, 1e-8), (1e-4, 1e-6)):
        dxv, dcv = zero + dx, zero + dc
        K_e, fac_e = nd.nd_trial(info, aux, base, dxv, dcv, fac_dtype)
        K_g, fac_g = g.trial(dxv, dcv)
        for a, b in zip(_tensors((K_e, fac_e)), _tensors((K_g, fac_g))):
            assert _same_bits(a, b)
        sol_e = nd.nd_solve_refined(info, aux, K_e, fac_e, rhs, opts)
        sol_g = nd.nd_solve_refined(info, aux, K_g, fac_g, rhs, opts)
        for a, b in zip(sol_e, sol_g):
            assert _same_bits(a, b)
        facs.append((K_g, fac_g))
    assert (facs[0][1].generation, facs[1][1].generation) == (1, 2)
    with pytest.raises(RuntimeError, match="overwrote it"):
        nd.nd_solve_refined(info, aux, *facs[0], rhs, opts)
    return g


@pytest.mark.parametrize("fac_dtype", (None, torch.float32))
def test_trial_replays_equal_eager_and_stale_factors_are_refused(cpu_graphs, fac_dtype):
    """Two trials of one NDGraphs (CPU stand-in): each equals the eager
    trial bit for bit, fronts and factor, and so do its refined solves; a
    factor whose trial the next replay overwrote is refused."""
    _check_trials_and_staleness("cpu", fac_dtype)


# ---------------------------------------------------------------------------
# On the card: real CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ("2d_30", "3d_10_retries", "3d_10_float32_fronts"))
def test_card_replayed_solve_is_the_eager_solve(cuda, case):
    """On the card, a solve that replays the step's graphs equals the
    recorded solve, which runs the eager loops, bit for bit: iterates,
    iterations, factorizations; every trial and sweep of the graphed solve
    was a replay, and the eager one counts its trials and sweeps as
    eager."""
    kw = dict(factorization_dtype="float32", tol=1e-7) if "float32" in case else {}
    problem = (modellib.mittelmann_dist_control(30) if case == "2d_30"
               else modellib.mittelmann_dist_control_3d(10))
    cnlp = _canonical(problem, cuda, **kw)
    graphed, n = _solve(cnlp, cuda, **kw)
    eager, n_eager = _solve(cnlp, cuda, timing_statistics=True, **kw)
    _assert_same_solve(graphed, eager)
    _assert_replayed_everything(n, n_eager, graphed)
    assert n_eager["trial"] == n_eager["solve"] == n_eager["matvec"] == 0
    assert n_eager["eager"] == n["trial"] + n["solve"] + n["matvec"]
    if case == "3d_10_retries":
        assert int(graphed.counters.n_factorizations) > int(graphed.iter_count)


@pytest.mark.gpu
def test_card_declined_graphs_count_eager(cuda, monkeypatch):
    """On the card, where the graphs would not fit, every trial and sweep
    runs eagerly and is counted so; the solve equals the recorded one bit
    for bit."""
    monkeypatch.setattr(nd, "_card_room", lambda info, like: False)
    cnlp = _canonical(modellib.mittelmann_dist_control(30), cuda)
    res, n = _solve(cnlp, cuda)
    eager, n_eager = _solve(cnlp, cuda, timing_statistics=True)
    _assert_same_solve(res, eager)
    assert n["captures"] == n["trial"] == n["solve"] == n["matvec"] == 0
    assert n["eager"] == n_eager["eager"] > int(res.batched_factorizations) > 0


@pytest.mark.gpu
def test_card_sensitivity_lanes_of_a_graphed_factor(cuda):
    """``test_sensitivity_lanes_of_a_graphed_factor_solve_eagerly`` with
    real graphs: three unit columns of the reduced Hessian as lanes of a
    replayed factor, equal to the recorded call bit for bit."""
    from ipopt_torch.profiling import solve_span
    from ipopt_torch.sens import reduced_hessian
    cnlp = _canonical(modellib.mittelmann_dist_control(30), cuda)
    opts = ipopt_torch.Options(**MF)
    it = ipopt_torch.solve(cnlp, device=cuda, **MF).iterate
    with solve_span(timing=True):
        want = reduced_hessian(cnlp, opts, it, [0, 3, 6], device=cuda)
    before = _counts()
    got = reduced_hessian(cnlp, opts, it, [0, 3, 6], device=cuda)
    n = _delta(before)
    assert _same_bits(got, want)
    assert n["trial"] >= 1 and n["solve"] == n["matvec"] == 0 and n["eager"] >= 2


@pytest.mark.gpu
def test_card_graphed_levels_meet_the_k1_rule(cuda):
    """K1's outputs in a replayed trial equal the eager trial's bit for
    bit, and meet K1's rule (``block_ldlt.k1_rule``) against the plain
    version on the eager trial's level inputs."""
    from ipopt_torch.linalg.block_ldlt import block_ldlt_plain, k1_rule
    from ipopt_torch.profile_main import capture_k1_inputs
    cnlp, info, opts, it, aux, jv, hv, zero, rhs = _step_inputs(cuda)
    base = nd.nd_assemble(cnlp, aux, info, it, jv, hv, zero, zero)
    dxv, dcv = zero + 1e-4, zero + 1e-6
    eager = []
    seen = capture_k1_inputs(lambda: eager.append(nd.nd_trial(info, aux, base, dxv, dcv)))
    g = nd.NDGraphs(info, aux, it.x, None, 0.0)
    nd.nd_assemble(cnlp, aux, info, it, jv, hv, zero, zero, out=g.flat)
    graphed = g.trial(dxv, dcv)
    for a, b in zip(_tensors(eager[0]), _tensors(graphed)):
        assert _same_bits(a, b)
    fac = graphed[1]
    assert len(seen) == len(info.levels)
    for li, A in enumerate(seen):
        L = fac.L11[li].reshape(A.shape)
        d = fac.d1[li].reshape(A.shape[:2])
        Lp, dp = block_ldlt_plain(A)
        ok, why, _ = k1_rule(A, L, d, Lp, dp)
        assert ok, f"level {li} {tuple(A.shape)}: {why}"


@pytest.mark.gpu
def test_card_trials_equal_eager_and_stale_factors_are_refused(cuda):
    """``test_trial_replays_equal_eager_and_stale_factors_are_refused`` with
    real graphs."""
    _check_trials_and_staleness(cuda)


# ---------------------------------------------------------------------------
# The sweeps' scatter passes: the in-order sum, with no slot hit twice
# ---------------------------------------------------------------------------

def _in_order_solve(info, aux, fac, rhs):
    """``nd.nd_solve`` with one ``index_add_`` of a level's boundary
    updates, which the CPU sums in index order."""
    Bt = rhs.shape[0]
    rhs_e = torch.cat([rhs, rhs.new_zeros((Bt, 1))], -1)
    zs = []
    for li, lv in enumerate(info.levels):
        b1 = rhs_e[:, aux[f"elim_gid{li}"]]
        z1 = nd.tri_solve_blocks(fac.L11[li], b1[..., None])[..., 0]
        zs.append(z1)
        if lv.u:
            upd = -torch.matmul(fac.L21[li], z1[..., None])[..., 0]
            rhs_e.index_add_(1, aux[f"bd_gid{li}"].reshape(-1), upd.reshape(Bt, -1))
    sol_e = rhs.new_zeros((Bt, info.N + 1))
    for li in reversed(range(len(info.levels))):
        lv = info.levels[li]
        zhat = zs[li] / nd._safe(fac.d1[li])
        if lv.u:
            x_bd = sol_e[:, aux[f"bd_gid{li}"]]
            zhat = zhat - torch.matmul(fac.L21[li].transpose(-1, -2), x_bd[..., None])[..., 0]
        x1 = nd.tri_solve_blocks(fac.L11[li], zhat[..., None], transpose=True)[..., 0]
        sol_e[:, aux[f"elim_gid{li}"].reshape(-1)] = x1.reshape(Bt, -1)
    return sol_e[:, :info.N]


def _in_order_matvec(info, aux, fronts, x):
    Bt = x.shape[0]
    x_e = torch.cat([x, x.new_zeros((Bt, 1))], -1)
    y_e = x.new_zeros((Bt, info.N + 1))
    for li, lv in enumerate(info.levels):
        gid = aux[f"elim_gid{li}"]
        if lv.u:
            gid = torch.cat([gid, aux[f"bd_gid{li}"]], 1)
        yf = torch.matmul(fronts[li], x_e[:, gid][..., None])[..., 0]
        y_e.index_add_(1, gid.reshape(-1), yf.reshape(Bt, -1))
    return y_e[:, :info.N]


@pytest.mark.parametrize("case", ("2d_8", "3d_6"))
def test_sweeps_sum_in_index_order(case):
    """On the CPU the scatter passes of ``nd_solve`` and ``nd_matvec`` give
    bit for bit what one in-order ``index_add_`` per level gives; within a
    pass no slot repeats, and every live entry is in exactly one pass."""
    problem = (modellib.mittelmann_dist_control(8) if case == "2d_8"
               else modellib.mittelmann_dist_control_3d(6))
    cnlp = _canonical(problem, "cpu", resto_phase=False)
    info = cnlp.chain
    opts = ipopt_torch.Options(**dict(MF, resto_phase=False))
    it = default_initialize(cnlp, opts)
    aux = nd.nd_aux(info, "cpu")
    zero = torch.zeros((1,), dtype=torch.float64)
    base = nd.nd_assemble(cnlp, aux, info, it, jacobian_values(cnlp, it.x),
                          sparse_hessian_values(cnlp, it), zero, zero)
    K, fac = nd.nd_trial(info, aux, base, zero + 1e-4, zero + 1e-6)
    v = torch.randn((1, info.N), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    assert _same_bits(nd.nd_solve(info, aux, fac, v), _in_order_solve(info, aux, fac, v))
    assert _same_bits(nd.nd_matvec(info, aux, K, v), _in_order_matvec(info, aux, K, v))
    for li, lv in enumerate(info.levels):
        gid = info.elim_gid[li]
        passes = {"row_add": gid if not lv.u else torch.cat(
            [torch.as_tensor(gid), torch.as_tensor(info.bd_gid[li])], 1).numpy()}
        if lv.u:
            passes["bd_add"] = info.bd_gid[li]
        for name, idx in passes.items():
            flat = torch.as_tensor(idx).reshape(-1)
            order, cuts = aux[f"{name}{li}"]
            for a, b, tgt in cuts:
                assert tgt.unique().numel() == tgt.numel()
                assert torch.equal(flat[order[a:b]], tgt)
            live = torch.nonzero(flat < info.N)[:, 0]
            assert torch.equal(order.sort().values, live)
            assert sum(b - a for a, b, _ in cuts) == order.numel()
