"""Multi-rank dry run of the port: the train step and the serving paths
over a dp x tp mesh of ranks (counterpart of the JAX package's
__graft_entry__.dryrun_multichip and _dryrun_serving), on tiny shapes.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m sln_tpu_torch.dryrun [--device cpu]

Variants, each printing one line on rank 0 and raising on a failure:
  - the (data, model) mesh, num_model 2 when N >= 4 and N is even: one
    train step of the default-width model from its seeded init, sharded
    over the model axis (parallel.sharding), on this rank's rows of the
    host-sharded epoch stream (the ranks' rows assembled over the data
    group give the global stream's batch); a finite loss;
  - staged: the dataset staged on the device once and the rows gathered
    there, from a fresh init: the loss within 1e-3 relative;
  - microbatched: the next step in 2 chunks, a finite loss;
  - multi-slice, when N >= 8 and N % 4 == 0: the hybrid mesh 2 x N/4 x 2
    (one node: simulated by contiguous ranks) from the same init, its loss
    within 1e-3 relative of the first;
  - serving over the data group: the sampler, one sharded refine of N/2
    rooms at 32 px for 2 steps (both rasterizer kernels on the card) and
    SPADE colorize of a small generator.
Rank 0 then prints one JSON line {"dryrun": {...}} (the rasterizer launches
summed over the ranks included).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from sln_tpu_torch.config import Config, DataConfig, default_config
from sln_tpu_torch.data import synthetic, tensorize
from sln_tpu_torch.data.augment import SizeInfo, build_graphs
from sln_tpu_torch.models.vae import Sg2ScVAE
from sln_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                         global_from_host_shards,
                                         make_mesh, make_multislice_mesh)
from sln_tpu_torch.render import assets, rasterizer_cuda as rc
from sln_tpu_torch.render import scene as scene_lib
from sln_tpu_torch.spade.generator import SPADEGenerator4
from sln_tpu_torch.train import loop
from sln_tpu_torch.workloads import gan_shade, heatmap, refine

REL_TOL = 1e-3      # __graft_entry__.py:133-136


def example_setup(device, max_objects: int = 16, num_rooms: int = 8):
    """(cfg, arrays, size_info): the default config at max_objects object
    slots, num_rooms synthetic rooms (seed 0) and the size table (128
    rooms, seed 1), as the JAX dry run's _example_setup."""
    cfg = default_config().replace(data=DataConfig(
        max_objects=max_objects, max_triples=max_objects * 3,
        max_on_rels=max_objects))
    arrays = tensorize.tensorize_rooms(synthetic.generate_rooms(num_rooms,
                                                                seed=0),
                                       max_objects)
    size_info = SizeInfo(*(torch.as_tensor(x, device=device) for x in
                           synthetic.default_size_table(128, seed=1)))
    return cfg, arrays, size_info


def sharded_state(cfg: Config, device, mesh: Mesh) -> loop.TrainState:
    """The seeded init (every rank the same bits) with fresh Adam, this
    rank's shards of it kept."""
    return loop.shard_state(loop.create_state(cfg, device), mesh)


def on_device(raw: loop.RawBatch, device) -> loop.RawBatch:
    return loop.RawBatch(*(torch.as_tensor(np.asarray(a), device=device)
                           for a in raw))


def close(a: float, b: float) -> bool:
    return abs(a - b) < REL_TOL * max(1.0, abs(b))


def say(mesh: Mesh, *args) -> None:
    if mesh.rank == 0:
        print(*args, flush=True)


def train_variants(device, init_method: Optional[str]) -> tuple:
    """The train-step variants; returns (their results, the dp x tp mesh)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    num_model = 2 if world >= 4 and world % 2 == 0 else 1
    num_data = world // num_model
    mesh = make_mesh(num_data, num_model, device, init_method)
    device = mesh.device
    say(mesh, f"mesh: data={num_data} model={num_model}")
    B = max(num_data * 2, 8)
    cfg, arrays, size_info = example_setup(device)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))
    n_rooms = arrays["objs"].shape[0]

    # the host-sharded input stream: this rank's rows of the global batch
    state = sharded_state(cfg, device, mesh)
    step = loop.make_train_step(state, cfg, size_info, mesh=mesh)
    raw_local = on_device(next(loop.host_sharded_batches(
        arrays, B, np.random.default_rng(0), mesh.data_index,
        mesh.data_size)), device)
    whole = next(loop.batches_from_arrays(arrays, B,
                                          np.random.default_rng(0)))
    for got, want in zip(global_from_host_shards(raw_local, mesh), whole):
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError("the host shards do not assemble into the "
                                 "global batch")
    losses = {k: float(v) for k, v in step(raw_local).items()}
    if not np.isfinite(losses["total_loss"]):
        raise AssertionError(f"dp x tp step: {losses}")
    say(mesh, "dryrun_multichip ok:", losses)
    out = {"mesh": {"data": num_data, "model": num_model}, "batch": B,
           "total_loss": losses["total_loss"]}

    # staged: the dataset on the device once, this rank's rows gathered
    fresh = sharded_state(cfg, device, mesh)
    staged_step = loop.make_train_step(fresh, cfg, size_info, mesh=mesh)
    idx = next(loop.batch_indices(n_rooms, B, np.random.default_rng(0)))
    rows = loop.shard_rows(B, 0, mesh.data_index, mesh.data_size)
    staged = loop.stage_arrays(arrays, device)
    total = float(staged_step(loop.gather_batch(staged, idx[rows]))
                  ["total_loss"])
    if not close(total, losses["total_loss"]):
        raise AssertionError(f"staged {total} vs {losses['total_loss']}")
    say(mesh, "dryrun_staged ok:", {"total_loss": total})
    out["staged_total_loss"] = total

    # microbatched: the next step of the first state, in 2 chunks
    cfg_mb = cfg.replace(train=dataclasses.replace(cfg.train,
                                                   microbatch=B // 2))
    step_mb = loop.make_train_step(state, cfg_mb, size_info, mesh=mesh)
    raw_mb = on_device(next(loop.host_sharded_batches(
        arrays, B, np.random.default_rng(0), mesh.data_index,
        mesh.data_size, microbatch=B // 2)), device)
    total = float(step_mb(raw_mb)["total_loss"])
    if not np.isfinite(total):
        raise AssertionError(f"microbatched step: {total}")
    say(mesh, "dryrun_microbatch ok:", {"total_loss": total, "chunks": 2})
    out["microbatch_total_loss"] = total

    # multi-slice: 2 x N/4 x 2 from the same init and rows
    if world >= 8 and world % 4 == 0 and B % (world // 2) == 0:
        ms_mesh = make_multislice_mesh(2, world // 4, 2, device,
                                       init_method)
        ms_state = sharded_state(cfg, device, ms_mesh)
        ms_step = loop.make_train_step(ms_state, cfg, size_info,
                                       mesh=ms_mesh)
        ms_raw = on_device(next(loop.host_sharded_batches(
            arrays, B, np.random.default_rng(0), ms_mesh.data_index,
            ms_mesh.data_size)), device)
        total = float(ms_step(ms_raw)["total_loss"])
        if not close(total, losses["total_loss"]):
            raise AssertionError(f"multi-slice {total} vs "
                                 f"{losses['total_loss']}")
        say(mesh, "dryrun_multislice ok:",
            {"mesh": dict(zip(("slice", "data", "model"), ms_mesh.shape)),
             "total_loss": total})
        out["multislice"] = {"shape": list(ms_mesh.shape),
                             "total_loss": total}
    return out, mesh


def seeded(module_fn, seed: int = 0):
    """A module built under torch.manual_seed(seed): every rank's init the
    same bits."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return module_fn()


def refine_setup(device, n_rooms: int) -> tuple:
    """(cfg, batch, device bank, prepare_refine_inputs' inputs) of the
    serving refine: n_rooms of example_setup's rooms at 8 object slots,
    rendered at 32 px with the JAX dry run's bank."""
    cfg = default_config().replace(data=DataConfig(
        max_objects=8, max_triples=24, max_on_rels=8))
    cfg = cfg.replace(refine=dataclasses.replace(
        cfg.refine, render_size=32, pyramid_sizes=(16, 32)))
    _, arrays, size_info = example_setup(device, max_objects=8)
    idx = np.arange(n_rooms) % arrays["objs"].shape[0]

    def t(k):
        return torch.as_tensor(arrays[k][idx], device=device)

    batch = build_graphs(t("objs"), t("boxes"), t("angles"), t("obj_mask"),
                         t("room_ids"), size_info, max_on_rels=8,
                         generator=torch.Generator(device).manual_seed(0))
    # the JAX dry run's bank: faceless meshes (subdiv 0), so only the room
    # shell (subdiv 1) has faces
    bank_host = assets.build_procedural_bank(0)
    bank = scene_lib.device_bank(bank_host, 1, device=device)
    inputs = refine.prepare_refine_inputs(
        batch, bank_host, bank, refine.refine_render_config(cfg))
    return cfg, batch, bank, inputs


def serving(mesh: Mesh) -> dict:
    """The sampler, the sharded refine and colorize over the data group
    (the JAX dry run's _dryrun_serving), at its shapes."""
    device, nd = mesh.device, mesh.data_size
    cfg = default_config().replace(data=DataConfig(
        max_objects=8, max_triples=24, max_on_rels=8))
    latent = cfg.model.latent_dim

    sb = heatmap.heatmap_scene_batch(nd * 2, 8, 24, device=device)
    smodel = seeded(lambda: Sg2ScVAE(cfg.model)).to(device)
    sample = heatmap.make_sampler(smodel, sb, np.zeros(latent, np.float32),
                                  np.eye(latent, dtype=np.float32),
                                  mesh=mesh)
    eps = torch.randn((nd * 2, 8, latent), device=device,
                      generator=torch.Generator(device).manual_seed(1))
    boxes, _ = sample(eps)
    if boxes.shape[0] != nd * 2 or not bool(torch.isfinite(boxes).all()):
        raise AssertionError("the sharded sampler")

    # the refine: nd rooms at 32 px, 2 steps
    cfg, batch, bank, inputs = refine_setup(device, nd)
    rmodel = seeded(lambda: Sg2ScVAE(cfg.model)).to(device)
    z0 = torch.zeros((nd, 8, latent), device=device)
    b, midx, target, size_t, room_row, z0_s, rmodel = \
        refine.shard_refine_inputs(mesh, batch, *inputs, z0, rmodel)
    rc.reset_launch_counts()
    refiner = refine.make_refine_step(rmodel, b, midx, bank, target, size_t,
                                      room_row, cfg, z0_s, mesh=mesh)
    hist = refiner.run(2)
    launches = [rc.FWD_LAUNCHES, rc.BWD_LAUNCHES]
    if not bool(torch.isfinite(refiner.z).all()):
        raise AssertionError("the sharded refine's z is not finite")

    # colorize: a small seeded generator, nd * 2 z
    gmodel = seeded(lambda: SPADEGenerator4(nz=16, ngf=4, crop_size=32),
                    3).to(device).eval()
    seg = torch.zeros((41, 32, 32), device=device)
    seg[1] = 1.0
    zs = gan_shade.draw_zs(nd * 2, 16, z_chunk=nd * 2, device=device)
    rgb = gan_shade.colorize(gmodel, seg, zs, nd * 2, mesh=mesh)
    if rgb.shape[0] != nd * 2 or not np.isfinite(rgb).all():
        raise AssertionError("sharded colorize")
    out = {"refine_total": float(hist["total"][-1]),
           "spade_rgb_mean": float(rgb.mean())}
    say(mesh, "dryrun_serving ok: sampler + sharded refinement + SPADE "
        "shade", out)
    total = all_reduce_sum(torch.tensor(launches, device=device), mesh,
                           axis=None)
    out["rasterizer_launches"] = [int(x) for x in total.cpu()]
    return out


def dryrun(device: str = "cuda", init_method: Optional[str] = None) -> dict:
    """Every variant on this rank; returns the results (the same numbers
    on every rank) after rank 0 prints them as one JSON line."""
    out, mesh = train_variants(device, init_method)
    try:
        out["serving"] = serving(mesh)
        say(mesh, json.dumps({"dryrun": out}))
    finally:
        mesh.close()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card per rank, or ranks sharing the "
                         "cards over gloo) or cpu")
    dryrun(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
