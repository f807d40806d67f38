"""The harness is driven by data: a configuration, a traffic mix, a cell and
a metric added as new files (and entries of BENCHMARK.json) are found by
name, with no edit to any file the benchmark has."""
import hashlib
import json
import os

import pytest

from portbench import harness


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_config_traffic_cell_and_metric_are_found_by_name(small_root):
    before = _digests(small_root)
    pb = os.path.join(small_root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", "lv1-1m.json")))
    cfg.update(name="lv1-small", n=600)
    json.dump(cfg, open(os.path.join(pb, "configs", "lv1-small.json"), "w"))
    json.dump({"loop": "closed", "clients": 1, "why": "a test mix",
               "options": {"linear_solver": "banded-bcr", "mu_init": 0.05}},
              open(os.path.join(pb, "workloads", "solves.banded-mu05.json"), "w"))
    with open(os.path.join(pb, "metrics", "solves_done.py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.solves)\n")
    spec = json.load(open(os.path.join(small_root, "BENCHMARK.json")))
    spec["configs"].append({"name": "lv1-small", "source": "a test", "reduced": ["n"],
                            "file": "portbench/configs/lv1-small.json", "why": "a test"})
    spec["workloads"].append({"name": "lv1-small.mu05", "config": "lv1-small",
                              "traffic": "solves.banded-mu05", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "solves_done", "unit": "count", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["lv1-small.mu05"]})
    json.dump(spec, open(os.path.join(small_root, "BENCHMARK.json"), "w"))

    result, checks = harness.run_cell(small_root, "lv1-small.mu05", 7, 0.5, False,
                                      device="cpu")
    assert result["correct"], checks
    assert result["metrics"]["solves_done"]["value"] == result["attempted"] >= 1
    after = _digests(small_root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_metrics_apply_to_the_cells_they_list(small_root):
    spec = harness.load_spec(small_root)
    mf = harness.find_cell(small_root, spec, "neuma1-128.mf")
    bd = harness.find_cell(small_root, spec, "lv1-1m.banded")
    assert {m["name"] for m in mf.per_layer} == {
        "canon_s", "iterations", "factorizations_per_iter", "fronts_gib", "k1_roofline",
        "idle_share", "device_busy_s"}
    assert {m["name"] for m in bd.per_layer} == {
        "canon_s", "iterations", "factorizations_per_iter", "k2_roofline", "idle_share",
        "device_busy_s"}
    assert [m["name"] for m in mf.end_to_end] == ["setup_s", "solve_s"]
    assert mf.traffic["options"] == {"linear_solver": "multifrontal"}


@pytest.mark.parametrize("config, problem", [("lv1-1m", "lv1"), ("neuma1-128", "neuma1")])
def test_seed_gives_the_same_start_inside_the_bounds(small_root, config, problem):
    builder = harness.load_module(small_root, "problems", problem)
    cfg = json.load(open(os.path.join(small_root, "portbench", "configs", f"{config}.json")))
    a = harness.start_point(builder, cfg, 2**31 + 11)
    b = harness.start_point(builder, cfg, 2**31 + 11)
    c = harness.start_point(builder, cfg, 12)
    x0, x_L, x_U = builder.start(cfg)
    assert (a == b).all() and (a >= x_L).all() and (a <= x_U).all()
    assert abs(a - x0).max() <= cfg["perturbation"]
    # a perturbation of 0 gives every seed the published start
    assert (a == c).all() == (cfg["perturbation"] == 0)
