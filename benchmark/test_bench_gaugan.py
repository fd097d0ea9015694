"""The cells gaugan_ade20k_b8 and refine_96px_b8 at small sizes on the CPU:
a whole run of each, traced and untraced, through `run.run_cell`, and
GauGAN's controls computed on its own inputs."""

from __future__ import annotations

import json
import math

import pytest
import torch

from benchmark import control, harness, run
from benchmark.conftest import _merge

# each small cell: (real cell it stands for, config changes, traffic
# changes)
SMALL = {
    "gaugan_small": ("gaugan_ade20k_b8", {
        "label_nc": 6, "semantic_nc": 7, "crop_size": 64, "ngf": 8,
        "ndf": 8}, {"batch_size": 2, "pool": 6, "trace_steps": 1}),
    "refine96_small": ("refine_96px_b8", {}, {
        "batch_pool": 2, "rooms_per_batch": 2, "render_px": 32,
        "iterations": 4, "trace_steps": 2}),
}


@pytest.fixture
def catalog(tmp_path):
    """The real drivers and readers, the small cells' files, and
    BENCHMARK.json's entries with the small cells beside the real ones."""
    import shutil
    torch.set_num_threads(2)
    root = tmp_path / "bench"
    for d in ("drivers", "metrics"):
        shutil.copytree(harness.HERE / d, root / d)
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir()
    real = harness.Catalog()
    spec = json.loads(json.dumps(real.spec))
    for name, (cell, cfg_change, traffic_change) in SMALL.items():
        wl = real.workload(cell)
        (root / "configs" / f"{name}.json").write_text(json.dumps(
            _merge(real.config(wl["config"]), cfg_change)))
        (root / "traffic" / f"{name}.json").write_text(json.dumps(
            _merge(real.traffic(wl["traffic"]), traffic_change)))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(wl, config=name, traffic=name)))
        for kind in ("end_to_end", "per_layer"):
            for m in spec[kind]:
                if cell in m.get("workloads", ()):
                    m["workloads"].append(name)
    return harness.Catalog(root, spec)


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_agrees_with_the_reference(catalog, cell, trace):
    out = run.run_cell(catalog, cell, 3_000_000_017, 0.5, trace, "cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in catalog.metrics_of(cell, kind)}
    if trace:
        # readings of the card's clock, kernels or graphs need a card
        want -= {"gaugan_g_update_ms", "gaugan_d_update_ms",
                 "raster_fwd_roofline", "raster_bwd_roofline",
                 "refine_graphed_steps_pct"}
    assert want <= set(out["metrics"]), want - set(out["metrics"])
    for v in out["metrics"].values():
        assert math.isfinite(v["value"])


@pytest.mark.parametrize("kind", ["no_vgg", "g_spectral_frozen",
                                  "bn_running", "d_half_batch",
                                  "d_no_real", "d_flipped"])
def test_gaugan_faults_are_not_correct(catalog, kind):
    """Each planted fault reads above a limit of the real cell."""
    ctx = harness.Context(catalog, "gaugan_small", 7, 0.0, False, "cpu",
                          0.0)
    numbers, _ = control.control_numbers(ctx, kind)
    limits = harness.Catalog().workload("gaugan_ade20k_b8")["limits"]
    assert set(numbers) == set(limits)
    assert not harness.judge(numbers, limits), numbers
