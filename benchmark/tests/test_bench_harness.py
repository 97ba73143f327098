"""The benchmark's yardstick and harness on the CPU: the counts, pieces
found by name, the form of the result line, the imports it allows, and a
run without a card."""

from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest

from bench_small import ROOT, run_small

from benchmark import counts, harness

BENCH = ROOT / "benchmark"


def test_counts_match_the_ports_bench_arithmetic():
    conf = harness.load_json(BENCH / "configs" / "tanabata.json")["config"]
    assert counts.mlp_flops_per_point() == 1_186_816
    assert counts.rays_per_step(conf) == 3055
    assert counts.train_points(conf) == (195_520, 391_040)
    assert counts.train_flops_per_step(conf) == 2_088_416_378_880
    assert counts.frame_flops(conf, 400, 600) == 400 * 600 * 192 * 1_186_816


def test_least_time_names_its_bound():
    t, bound = counts.least_seconds(495e12, 1.0, "float32")
    assert (t, bound) == (1.0, "compute")
    t, bound = counts.least_seconds(1.0, 3.35e12, "bfloat16")
    assert (t, bound) == (1.0, "memory")


def test_every_cell_finds_its_pieces():
    bench = harness.spec()
    for wl in bench["workloads"]:
        assert harness.config_file(bench, wl["config"]).is_file()
        kind = harness.traffic(wl["traffic"])["kind"]
        assert hasattr(harness.cell_module(kind), "run")
        assert harness.limits(wl["name"])
        for m in harness.metric_names(bench, wl["name"], "per_layer"):
            assert callable(harness.reader(m))


def test_pieces_dropped_into_their_folders_are_found(tmp_path, monkeypatch):
    tree = tmp_path / "benchmark"
    shutil.copytree(BENCH, tree, ignore=shutil.ignore_patterns("tests"))
    conf = tree / "configs" / "new_cfg.json"
    conf.write_text(json.dumps({"precision": "float32", "config": {}}))
    (tree / "traffic" / "new_mix.json").write_text(json.dumps({"kind": "train"}))
    (tree / "limits" / "new_cfg.new_mix.json").write_text('{"loss_gap": 1}')
    (tree / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    monkeypatch.setattr(harness, "HERE", tree)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    bench = {"configs": [{"name": "new_cfg",
                          "file": "benchmark/configs/new_cfg.json"}],
             "per_layer": [{"name": "new_metric.x",
                            "workloads": ["new_cfg.new_mix"]}]}
    assert harness.config_file(bench, "new_cfg") == conf
    assert harness.traffic("new_mix") == {"kind": "train"}
    assert harness.limits("new_cfg.new_mix") == {"loss_gap": 1}
    assert harness.metric_names(bench, "new_cfg.new_mix", "per_layer") == [
        "new_metric.x"]
    assert harness.reader("new_metric.x")(None) == 42.0


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace, capsys):
    result, checks = run_small("tanabata.train", trace=trace)
    assert harness.finish(result, checks) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "iter_ms"}
    for name in checks:
        assert f"check {name}:" in out.err


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported(path) & {"jax", "jaxlib", "flax", "benerf_tpu"}, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "benerf_tpu_torch" not in _imported(path), path


def test_a_run_refuses_a_loaded_jax_package(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "benerf_tpu", object())
    assert harness.finish({"correct": True}, {}) != 0
    assert capsys.readouterr().out == ""


def test_no_card_no_result(capsys):
    from benchmark import run

    if run.torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the run without one")
    rc = run.main(["--workload", "tanabata.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
