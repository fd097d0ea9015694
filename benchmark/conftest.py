"""Fixtures of the benchmark's own tests: a catalog of small cells in a
temporary folder, found from its files alone, that runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import harness

SRC = harness.HERE
# each small cell: (real cell it stands for, config, its changes, traffic
# changes)
SMALL = {
    "refine_small": ("refine_256px_b1", {}, {
        "batch_pool": 2, "render_px": 32,
        "iterations": 4, "trace_steps": 2}),
    "shade_small_fp32": ("gan_shade_fp32", {
        "ngf": 8, "nz": 16, "crop_size": 64}, {
        "num_z": 3, "z_chunk": 2, "room_pool": 4, "trace_rooms": 1,
        "check_share": 1.0}),
    "shade_small_bf16": ("gan_shade_bf16", {
        "ngf": 8, "nz": 16, "crop_size": 64}, {
        "num_z": 3, "z_chunk": 2, "room_pool": 4, "trace_rooms": 1,
        "check_share": 1.0}),
    "train_small": ("train_graph_b256", {
        "weights": "seeded",
        "model": {"embedding_dim": 16, "gconv_num_layers": 2}}, {
        "rooms": 32, "batch_size": 8, "trace_steps": 2}),
}


def _merge(base: dict, change: dict) -> dict:
    out = dict(base)
    for k, v in change.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def make_small_catalog(root: Path) -> harness.Catalog:
    """The real drivers and metric readers, and small configurations,
    traffic and cells standing for the real ones (with their limits)."""
    for d in ("drivers", "metrics"):
        shutil.copytree(SRC / d, root / d)
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir()
    real = harness.Catalog()
    spec = json.loads(json.dumps(real.spec))
    spec["workloads"] = []
    for name, (cell, cfg_change, traffic_change) in SMALL.items():
        wl = real.workload(cell)
        cfg = _merge(real.config(wl["config"]), cfg_change)
        traffic = _merge(real.traffic(wl["traffic"]), traffic_change)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(wl, config=name, traffic=name)))
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": name, "chips": 1,
                                  "why": f"small {cell}"})
        for kind in ("end_to_end", "per_layer"):
            for m in spec[kind]:
                if cell in m.get("workloads", ()):
                    m["workloads"].append(name)
    return harness.Catalog(root, spec)


@pytest.fixture
def small_catalog(tmp_path):
    torch.set_num_threads(2)
    return make_small_catalog(tmp_path / "bench")
