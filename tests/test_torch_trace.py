"""The port's spans and counters (sln_tpu_torch/trace.py): nothing is kept
without a profiler; under one, the refine step's, the render's and the
shading's spans nest as the layers do; the dispatched-pairs counter against
a count by hand; the rasterizer's launch counters under their old names;
each span's calls and host time counted while a profiler records; a graph
capture's counts put aside and counted again by each replay."""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sln_tpu_torch import trace
from sln_tpu_torch.config import DataConfig, default_config
from sln_tpu_torch.models.vae import Sg2ScVAE
from sln_tpu_torch.render import assets, rasterizer_cuda as rc
from sln_tpu_torch.render import scene as scene_lib
from sln_tpu_torch.render.rasterizer import face_geometry
from sln_tpu_torch.spade.generator import SPADEGenerator4
from sln_tpu_torch.tools.eval_refinement_quality import val_batch
from sln_tpu_torch.workloads import gan_shade, refine

torch.set_num_threads(2)


def sln_events(fn):
    """fn() under a CPU profiler: its sln.* ranges, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = [e for e in prof.events() if e.name.startswith("sln.")]
    return sorted(evs, key=lambda e: e.time_range.start)


def inside(child, parent) -> bool:
    return (child.thread == parent.thread
            and parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def children(evs, parent, name):
    return [e for e in evs if e.name == name and e is not parent
            and inside(e, parent)]


@pytest.fixture(scope="module")
def refiner():
    """A small refiner on the CPU: one synthetic room, a random 16-wide
    VAE, a 32 px render."""
    torch.manual_seed(0)
    cfg = default_config()
    cfg = cfg.replace(
        data=DataConfig(max_objects=16, max_triples=48, max_on_rels=16),
        model=dataclasses.replace(cfg.model, embedding_dim=16,
                                  gconv_num_layers=2),
        refine=dataclasses.replace(cfg.refine, render_size=32))
    batch = val_batch(cfg, 1, "cpu")
    model = Sg2ScVAE(cfg.model).eval()
    rcfg = refine.refine_render_config(cfg)
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device="cpu")
    with torch.no_grad():
        z0, _ = model.encode(batch)
    midx, target, size_t, room_row = refine.prepare_refine_inputs(
        batch, bank_host, bank, rcfg)
    return refine.make_refine_step(model, batch, midx, bank, target,
                                   size_t, room_row, cfg, z0)


def test_nothing_is_kept_without_a_profiler(refiner):
    trace.reset()
    assert trace.span("sln.anything") is trace.span("sln.other")
    refiner.step()
    assert not trace._held
    counts = trace.counters()
    assert "raster.dispatched_pairs" not in counts
    assert not [k for k in counts if k.startswith("sln.")]


def test_refine_step_spans_nest_as_the_layers(refiner):
    trace.reset()
    evs = sln_events(refiner.step)
    (step,) = [e for e in evs if e.name == "sln.refine.step"]
    for name in ("sln.refine.decode", "sln.render.layout",
                 "sln.refine.losses", "sln.refine.backward",
                 "sln.refine.update"):
        assert len(children(evs, step, name)) == 1, name
    (layout,) = children(evs, step, "sln.render.layout")
    for name in ("sln.render.assemble", "sln.render.geometry",
                 "sln.render.prepare", "sln.render.raster",
                 "sln.render.channels"):
        assert len(children(evs, layout, name)) == 1, name
    (backward,) = children(evs, step, "sln.refine.backward")
    # the CPU's backward runs on the calling thread
    assert len(children(evs, backward, "sln.raster.bwd")) == 1
    phases = [e.name for e in evs if e.name.startswith("sln.refine.")
              and e is not step]
    assert phases == ["sln.refine.decode", "sln.refine.losses",
                      "sln.refine.backward", "sln.refine.update"]
    # one render's dispatched pairs, held and summed on reading
    counts = trace.counters()
    assert counts["raster.dispatched_pairs"] > 0
    assert not trace._held
    # each span's calls and host time, the phases inside the step's
    assert counts["sln.refine.step.calls"] == 1
    assert counts["sln.render.layout.calls"] == 1
    phases = [counts[f"sln.refine.{p}.host_ns"] for p in
              ("decode", "losses", "backward", "update")]
    assert min(phases) > 0
    assert (sum(phases) + counts["sln.render.layout.host_ns"]
            <= counts["sln.refine.step.host_ns"])


def _big_face_scene(valid_faces: int, faces: int):
    """One scene of `faces` faces, the first `valid_faces` of them each
    covering the whole image at depth 2, the rest invalid."""
    v2d = torch.tensor([[-100.0, -100.0], [300.0, -100.0], [-100.0, 300.0]])
    v2d = v2d.expand(1, faces, 3, 2).clone()
    z = torch.full((1, faces, 3), 2.0)
    valid = torch.arange(faces)[None] < valid_faces
    face_class = torch.zeros(1, faces, dtype=torch.long)
    return face_geometry(v2d, z, valid, face_class)


@pytest.mark.parametrize("valid_faces,faces,tiles,chunks", [
    (1, 1, 8, 1),       # one chunk, active on all 8 tiles of 32 x 32 px
    (130, 200, 8, 2),   # two chunks holding valid faces, on every tile
    (0, 5, 8, 0),       # no valid face: no chunk is active anywhere
])
def test_dispatched_pairs_by_hand(valid_faces, faces, tiles, chunks):
    geom = _big_face_scene(valid_faces, faces)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, counts, _ = rc.prepare_faces(geom, 4, 32)
    want = tiles * chunks * rc.FC * rc.PT
    assert counts.shape == (1, tiles, 1)
    assert int(counts.sum()) * rc.FC * rc.PT == want
    assert trace.counters().get("raster.dispatched_pairs", 0) == want
    trace.reset("raster.dispatched_pairs")
    assert "raster.dispatched_pairs" not in trace.counters()


def test_launch_counters_keep_their_names():
    rc.reset_launch_counts()
    assert (rc.FWD_LAUNCHES, rc.BWD_LAUNCHES) == (0, 0)
    trace.count("raster.fwd_launches", 2)
    trace.count("raster.bwd_launches", 3)
    from sln_tpu_torch.render.rasterizer_cuda import FWD_LAUNCHES
    assert (FWD_LAUNCHES, rc.BWD_LAUNCHES) == (2, 3)
    # the plain versions launch nothing
    geom = _big_face_scene(1, 1)
    depth, _ = rc.soft_rasterize_cuda(geom, 4, 32)
    assert depth.shape == (1, 32, 32)
    assert (rc.FWD_LAUNCHES, rc.BWD_LAUNCHES) == (2, 3)
    rc.reset_launch_counts()
    assert (rc.FWD_LAUNCHES, rc.BWD_LAUNCHES) == (0, 0)
    with pytest.raises(AttributeError):
        rc.NO_SUCH_COUNTER


def test_tally_counts_a_capture_once_per_replay():
    """Inside trace.tally() counts (from any thread) and held tensors go to
    the tally, profiler or not, and nothing to the registry; each
    Tally.replay counts them again, the tensors only while a profiler
    records and as they read when the replay is counted."""
    trace.reset()
    static = torch.tensor([3, 4], dtype=torch.int32)
    with trace.tally() as tally:
        trace.count("raster.fwd_launches", 2)
        worker = threading.Thread(target=trace.count,
                                  args=("raster.bwd_launches", 3))
        worker.start()
        worker.join()
        trace.count_tensor("raster.dispatched_pairs", static, 10)
    assert tally.counts == {"raster.fwd_launches": 2,
                            "raster.bwd_launches": 3}
    assert [(n, s) for n, _, s in tally.tensors] == [
        ("raster.dispatched_pairs", 10)]
    assert trace.counters() == {}
    tally.replay()
    assert trace.counters() == {"raster.fwd_launches": 2,
                                "raster.bwd_launches": 3}
    with profile(activities=[ProfilerActivity.CPU]):
        tally.replay()
        static.fill_(0)           # the next replay overwrites it
        tally.replay()
    counts = trace.counters()
    assert (counts["raster.fwd_launches"], counts["raster.bwd_launches"]) \
        == (6, 9)
    assert counts["raster.dispatched_pairs"] == 70
    trace.count("raster.fwd_launches")
    assert trace.counters()["raster.fwd_launches"] == 7


@pytest.mark.parametrize("num_z,z_chunk", [(5, 2), (4, 4)])
def test_colorize_one_decode_span_per_chunk(num_z, z_chunk):
    torch.manual_seed(0)
    model = SPADEGenerator4(41, 3, 8, 4, 64).eval()
    seg = torch.rand(41, 64, 64)
    zs = torch.randn(-(-num_z // z_chunk), z_chunk, 8)
    evs = sln_events(lambda: gan_shade.colorize(model, seg, zs, num_z,
                                                out_dtype="uint8"))
    (col,) = [e for e in evs if e.name == "sln.shade.colorize"]
    assert len(children(evs, col, "sln.shade.decode")) == len(zs)
    for name in ("sln.shade.seg_mods", "sln.shade.to_host"):
        assert len(children(evs, col, name)) == 1
