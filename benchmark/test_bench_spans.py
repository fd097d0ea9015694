"""The metrics that read the program's spans: a traced run reads the
host time its spans count, where the cells list them; the program's span
in the rasterizer's backward is recorded on the card, where autograd runs
the backward on a thread of its own."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import run
from sln_tpu_torch import trace

# each small cell: the metrics that read its spans, and the span counted
# once per traced unit
SPAN_METRICS = {
    "refine_small": (("refine_step_host_ms", "refine_render_host_ms",
                      "refine_backward_host_ms"), "sln.refine.step",
                     "trace_steps"),
    "shade_small_fp32": (("shade_decode_host_ms",), "sln.shade.colorize",
                         "trace_rooms"),
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_reads_the_program_spans(small_catalog, cell):
    names, unit, units = SPAN_METRICS[cell]
    trace.reset()
    out = run.run_cell(small_catalog, cell, 2**31 + 5, 0.3, True, "cpu")
    counts = trace.counters()
    assert counts[f"{unit}.calls"] == small_catalog.traffic(cell)[units]
    for name in names:
        entry = next(m for m in small_catalog.spec["per_layer"]
                     if m["name"] == name)
        assert cell in entry["workloads"]
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name
    if cell == "refine_small":
        m = out["metrics"]
        assert m["refine_render_host_ms"]["value"] < \
            m["refine_step_host_ms"]["value"]
        assert m["refine_backward_host_ms"]["value"] < \
            m["refine_step_host_ms"]["value"]


def test_untraced_run_reads_no_span():
    """With no traced part the counters hold no span, and the readers
    leave their metrics out."""
    from benchmark.program_spans import host_ms_per

    trace.reset()
    assert host_ms_per("sln.refine.step", "sln.refine.step") is None


@pytest.mark.cuda
def test_rasterizer_backward_span_is_recorded_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    from sln_tpu_torch.render import rasterizer_cuda as rc
    from sln_tpu_torch.render.rasterizer import face_geometry

    gen = torch.Generator().manual_seed(0)
    v2d = (torch.rand(1, 64, 3, 2, generator=gen) * 32.0).cuda()
    v2d.requires_grad_(True)
    z = (1.0 + torch.rand(1, 64, 3, generator=gen)).cuda()
    geom = face_geometry(v2d, z, torch.ones(1, 64, dtype=torch.bool,
                                            device="cuda"),
                         torch.zeros(1, 64, dtype=torch.long, device="cuda"))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        depth, classes = rc.soft_rasterize_cuda(geom, 4, 32)
        (depth.sum() + classes.sum()).backward()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert {"sln.render.prepare", "sln.render.raster",
            "sln.raster.bwd"} <= names
    assert trace.counters()["sln.raster.bwd.calls"] == 1
    assert v2d.grad is not None and torch.isfinite(v2d.grad).all()
