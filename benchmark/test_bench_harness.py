"""The harness: files found by name, BENCHMARK.json's rules, the result
line's schema, the isolation check, a new cell and metric added from
files alone."""

from __future__ import annotations

import json
import re
import sys

import pytest

from benchmark import harness, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_entry_finds_its_files():
    cat = harness.Catalog()
    for wl in cat.spec["workloads"]:
        spec = cat.workload(wl["name"])
        assert spec["config"] == wl["config"]
        assert spec["traffic"] == wl["traffic"]
        assert spec["chips"] == wl["chips"] == 1
        cat.config(wl["config"])
        assert hasattr(cat.driver(cat.traffic(wl["traffic"])["loop"]),
                       "check")
        assert set(spec["limits"]) in ({"grad1_gap", "delta_gap"},
                                       {"grad1_gap", "z_delta1_gap"},
                                       {"image_gap"})
    for kind in ("end_to_end", "per_layer"):
        for m in cat.spec[kind]:
            assert callable(cat.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    cat = harness.Catalog()
    spec = cat.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in spec["configs"]] + list(cells) + [
        m["name"] for k in ("end_to_end", "per_layer") for m in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in {"lower",
                                                             "higher"}
            assert m["source"] in SOURCES
            assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        # every cell that reports the metric reports what it moves
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved, m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert len(cat.metrics_of(cell, "end_to_end")) >= 2
        assert cat.metrics_of(cell, "per_layer")
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("name,bad", [
    ("sln_tpu_torch.render", False), ("sln_tpu", True),
    ("sln_tpu.render.scene", True), ("jax", True), ("jaxlib.xla", True),
    ("flax.linen", True), ("jax_like", False), ("flaxen", False)])
def test_isolation_compares_whole_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    assert (name.split(".")[0] in found) == bad


def test_no_forbidden_module_after_a_run(small_catalog):
    run.run_cell(small_catalog, "train_small", 7, 0.2, False, "cpu")
    assert harness.forbidden_modules() == []


def test_result_line_schema(small_catalog):
    out = run.run_cell(small_catalog, "train_small", 2**31 + 11, 0.3, True,
                       "cpu")
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(out)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s",
                                  "window_s"}
    for name, m in out["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert isinstance(m["value"], float)
    for key in ("device_ops", "idle_gaps"):
        assert len(out["breakdown"][key]) <= 10
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out, allow_nan=False))


def test_a_new_cell_and_metric_from_files_alone(small_catalog):
    """A cell, its configuration, its traffic and a per-layer metric added
    as new files and entries, and nothing edited, are found and run."""
    root = small_catalog.root
    cfg = json.loads((root / "configs" / "train_small.json").read_text())
    cfg["model"]["embedding_dim"] = 8
    (root / "configs" / "train_tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "train_small.json").read_text())
    tr["batch_size"] = 4
    (root / "traffic" / "train_b4.json").write_text(json.dumps(tr))
    wl = json.loads((root / "workloads" / "train_small.json").read_text())
    (root / "workloads" / "train_tiny_b4.json").write_text(json.dumps(
        dict(wl, config="train_tiny", traffic="train_b4")))
    (root / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return rec.get('examples', 0) / 4.0\n")
    small_catalog.spec["workloads"].append(
        {"name": "train_tiny_b4", "config": "train_tiny",
         "traffic": "train_b4", "chips": 1, "why": "added"})
    small_catalog.spec["end_to_end"][3]["workloads"].append("train_tiny_b4")
    small_catalog.spec["per_layer"].append(
        {"name": "steps_seen", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "refine loop",
         "moves": "train_examples_per_s", "workloads": ["train_tiny_b4"]})
    out = run.run_cell(small_catalog, "train_tiny_b4", 3, 0.2, False, "cpu")
    assert "train_examples_per_s" in out["metrics"]
    out = run.run_cell(small_catalog, "train_tiny_b4", 3, 0.2, True, "cpu")
    assert out["metrics"]["steps_seen"]["value"] > 0
