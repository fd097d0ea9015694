"""Refine loop as `--fine_tune` runs it (`workloads/refine.py`
`finetune_rooms`): rooms back to back, each set up with a fresh copy of
the decoder's weights, its target render, z0 from the posterior and its
retrieval, refined through the program's `Refiner.step` for the traffic's
iterations, its losses then read to the host; closed loop. A traffic mix
may put several rooms in one batch (`rooms_per_batch`), as the
refinement-quality tool does.

Set-up loads the committed checkpoint, sets up the first room and takes
its first steps: the reference follows those after the window.
"""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness
from benchmark.counts import flops as F
from benchmark.counts import raster as RC
from benchmark.reference import compare, render as R
from benchmark.reference.checkpoint import load_vae_state_dict
from benchmark.reference.refine import RefineReference
from benchmark.reference.vae import Sg2ScVAE as RefVAE
from benchmark.traffic import scenes as S

CHECKED_STEPS = 3
# the worst leaf's first gradient, and z's change over the first step
# (the refine loop's own variable, one leaf among the decoder's 96); the
# losses and the changes over three steps swing with float32's rounding
# alone and are logged (PERF.md)
ALONE = ("z",)
COMPARED = ("grad1_gap", "z_delta1_gap")


def _program_config(ctx):
    from sln_tpu_torch.config import (CameraConfig, Config, ModelConfig,
                                      RefineConfig, RenderConfig,
                                      TrainConfig)
    m, r, t = ctx.config["model"], ctx.config["render"], ctx.traffic
    cam = CameraConfig(**{**r["camera"], "image_size": t["render_px"]})
    return Config(
        model=ModelConfig(**m),
        render=RenderConfig(camera=cam, sigma_px=r["sigma_px"],
                            gamma=r["gamma"], z_far=r["z_far"],
                            mesh_subdiv=r["mesh_subdiv"],
                            shell_subdiv=r["shell_subdiv"]),
        refine=RefineConfig(
            num_iters=t["iterations"], lr_z=t["lr_z"],
            lr_model_scale=t["lr_model_scale"], momentum=t["momentum"],
            nesterov=True, softargmax_beta=t["softargmax_beta"],
            angle_noise_scale=t["angle_noise_scale"],
            pyramid_sizes=tuple(t["pyramid_sizes"]),
            depth_loss_weight=t["depth_loss_weight"],
            semantic_loss_weight=t["semantic_loss_weight"],
            size_loss_weight=t["size_loss_weight"],
            render_size=t["render_px"]),
        train=TrainConfig(learning_rate=t["learning_rate"]))


def reference_camera(ctx) -> R.Camera:
    r = ctx.config["render"]
    return R.Camera(image_size=ctx.traffic["render_px"],
                    sigma=r["sigma_px"], gamma=r["gamma"], z_far=r["z_far"],
                    **r["camera"])


class Batch:
    """One batch of rooms: its scenes, z0 noise and per-step angle noise,
    made from the run's seed."""

    def __init__(self, ctx, j: int, size_info):
        t, dev = ctx.traffic, ctx.device
        B, O = t["rooms_per_batch"], ctx.config["data"]["max_objects"]
        rooms = S.generate_rooms(B, S.host_seed(ctx.seed, 1, j),
                                 t["rooms"])
        self.scenes = S.scene_batch(rooms, O, size_info,
                                    S.device_generator(dev, ctx.seed, 2, j),
                                    dev)
        latent = ctx.config["model"]["embedding_dim"]
        self.eps = torch.randn((B, O, latent), device=dev,
                               generator=S.device_generator(dev, ctx.seed,
                                                            3, j))
        self.noise = torch.randn(
            (t["iterations"], B, O), device=dev,
            generator=S.device_generator(dev, ctx.seed, 4, j)
        ) * t["angle_noise_scale"]


class State:
    pass


def _start(st, j: int):
    """The program's refiner for pool batch j, set up as --fine_tune
    does."""
    from sln_tpu_torch.data.batch import SceneBatch
    from sln_tpu_torch.models.vae import reparameterize
    from sln_tpu_torch.render import assets, scene as scene_lib
    from sln_tpu_torch.workloads import refine

    bt = st.pool[j % len(st.pool)]
    b = SceneBatch(*bt.scenes)
    model = copy.deepcopy(st.model).eval()
    with torch.no_grad():
        mu, logvar = model.encode(b)
        z0 = reparameterize(mu, logvar, eps=bt.eps)
        room_row = (b.boxes * b.room_mask[..., None]).sum(1, keepdim=True)
        dims = room_row[:, 0, 3:]
        scale6 = torch.cat([dims, dims], -1)[:, None, :]
        objs = b.objs.cpu().numpy()
        midx_gt = torch.as_tensor(assets.retrieve_models(
            objs, (b.boxes * scale6).cpu().numpy(), st.bank_host),
            device=b.objs.device)
        target = scene_lib.render_layout(b.objs, b.boxes, b.angles.float(),
                                         b.obj_mask, midx_gt, st.bank,
                                         st.rcfg)
        boxes0, _ = model.decode(z0, b)
        boxes0 = torch.where(b.room_mask[..., None], room_row, boxes0)
        abs0 = boxes0 * scale6
        midx = torch.as_tensor(assets.retrieve_models(
            objs, abs0.cpu().numpy(), st.bank_host), device=b.objs.device)
        size_t = abs0[..., 3:] - abs0[..., :3]
    refiner = refine.make_refine_step(model, b, midx, st.bank, target,
                                      size_t, room_row, st.cfg, z0)
    return refiner, bt.noise


def _leaves(refiner):
    out = {"z": refiner.z}
    out.update(dict(refiner.model.named_parameters()))
    return out


def make_inputs(ctx) -> State:
    """What the benchmark hands both sides: the checkpoint's weights, the
    mesh bank and shell, and the pool of batches."""
    st = State()
    st.sd = load_vae_state_dict(str(ctx.repo / ctx.config["weights"]))
    ctx.mark("weights")
    r = ctx.config["render"]
    st.bank_host = R.mesh_bank(r["mesh_subdiv"])
    st.shells = R.room_shells(r["shell_subdiv"])
    st.size_info = S.size_table(ctx.device)
    st.pool = [Batch(ctx, j, st.size_info)
               for j in range(ctx.traffic["batch_pool"])]
    return st


def setup(ctx):
    from sln_tpu_torch.models.vae import Sg2ScVAE
    from sln_tpu_torch.render import scene as scene_lib
    from sln_tpu_torch.workloads import refine

    ctx.mark("imports")
    st = make_inputs(ctx)
    ctx.mark("inputs")
    dev = ctx.device
    st.cfg = _program_config(ctx)
    st.rcfg = refine.refine_render_config(st.cfg)
    with torch.device("meta"):
        model = Sg2ScVAE(st.cfg.model)
    model = model.to_empty(device=dev)
    model.load_state_dict(st.sd)
    st.model = model.eval()
    ctx.mark("model")
    st.bank = scene_lib.device_bank(st.bank_host, shells=st.shells,
                                    device=dev)
    ctx.mark("program")
    # the first batch's first steps, through the window's own call
    st.j = 0
    st.refiner, st.noise = _start(st, 0)
    ctx.mark("first batch")
    st.before = {k: v.detach().clone() for k, v in
                 _leaves(st.refiner).items()}
    st.first_losses = []
    for k in range(CHECKED_STEPS):
        aux = st.refiner.step(st.noise[k])
        st.first_losses.append(aux["total"])
        if k == 0:
            opt = st.refiner.opt
            st.grad1 = {name: (opt.state[p]["momentum_buffer"].clone()
                               if "momentum_buffer" in opt.state[p]
                               else None)
                        for name, p in _leaves(st.refiner).items()}
            st.after1 = {name: v.detach().clone() for name, v in
                         _leaves(st.refiner).items()}
    st.after = {k: v.detach().clone() for k, v in
                _leaves(st.refiner).items()}
    ctx.sync()
    st.setup_s = ctx.since_start()
    return st


def window(ctx, st, seconds):
    """Closed loop for `seconds`: steps of the current batch; a finished
    batch's losses are read to the host and the next batch of the pool
    set up."""
    iters, B = ctx.traffic["iterations"], ctx.traffic["rooms_per_batch"]
    totals, batches, stamps = [], {st.j: 0}, []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if st.refiner.k == iters:
            with harness.span("bench.refine.batch_setup"):
                torch.stack(totals[-iters:]).cpu()
                st.j += 1
                st.refiner, st.noise = _start(st, st.j)
            batches[st.j] = 0
        with harness.span("bench.refine.step"):
            aux = st.refiner.step(st.noise[st.refiner.k])
        totals.append(aux["total"])
        batches[st.j] += 1
        stamps.append(time.perf_counter())
        if stamps[-1] >= deadline:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(totals))).sum()) * B
    rec = {"setup_s": st.setup_s, "window_s": window_s,
           "attempted": len(totals) * B, "failed": failed,
           "room_steps": (len(totals) * B - failed),
           "log": {"refine.steps": len(totals),
                   "refine.batches": dict(batches),
                   "refine.steps by quarter of the window":
                   harness.by_quarter(stamps, t0, seconds)}}
    if ctx.trace:
        rec["refine_flops"] = sum(
            n * step_flops(ctx, st, j) for j, n in batches.items())
    return rec


def _geometry_terms(ctx, st, j: int, ref_model, noise_k):
    """The reference's face constants of pool batch j at its start (z0,
    the checkpoint's decoder) under one step's angle noise."""
    bt = st.pool[j % len(st.pool)]
    b = bt.scenes
    with torch.no_grad():
        mu, logvar = ref_model.encode(b)
        z0 = mu + bt.eps * torch.exp(0.5 * logvar)
        boxes, ang_lp = ref_model.decode(z0, b)
        room = b.room_mask
        room_row = (b.boxes * room[..., None]).sum(1, keepdim=True)
        boxes = torch.where(room[..., None], room_row, boxes)
        idx = torch.arange(1, ang_lp.shape[-1] + 1, device=b.objs.device,
                           dtype=ang_lp.dtype)
        ang = (torch.softmax(ang_lp * ctx.traffic["softargmax_beta"], -1)
               * idx).sum(-1) - 1.0 + noise_k
        ang = torch.where(room, b.angles.float(), ang)
        dims = room_row[:, 0, 3:]
        abs0 = boxes * torch.cat([dims, dims], -1)[:, None]
        midx = torch.as_tensor(R.retrieve(b.objs.cpu().numpy(),
                                          abs0.cpu().numpy(), st.bank_host),
                               device=b.objs.device)
        tri, fcls, fvalid, dims = R.assemble(b.objs, boxes, ang, b.obj_mask,
                                             midx, st.bank_host, st.shells)
        return R.face_terms(tri, fvalid, dims, reference_camera(ctx))


def _ref_model(ctx, st):
    m = RefVAE(ctx.config["model"]["embedding_dim"],
               ctx.config["model"]["gconv_num_layers"]).to(ctx.device)
    m.load_state_dict(st.sd)
    return m.eval()


def pairs_of(ctx, st, j: int, k: int = 0) -> float:
    """Needed (pixel, face) pairs of pool batch j's render at step k."""
    cam = reference_camera(ctx)
    if not hasattr(st, "ref_model"):
        st.ref_model = _ref_model(ctx, st)
    terms = _geometry_terms(ctx, st, j, st.ref_model,
                            st.pool[j % len(st.pool)].noise[k])
    return float(RC.needed_pairs(terms, cam.image_size, cam.sigma,
                                 cam.gamma).sum())


def step_flops(ctx, st, j: int) -> float:
    """Counted operations of one step of pool batch j: the kernels' pair
    operations, the decoder forward and backward, the pyramid's resizes."""
    t = ctx.traffic
    B, O = t["rooms_per_batch"], ctx.config["data"]["max_objects"]
    T = ctx.config["data"]["max_triples"]
    e, L = (ctx.config["model"]["embedding_dim"],
            ctx.config["model"]["gconv_num_layers"])
    pairs = pairs_of(ctx, st, j)
    return (pairs * (RC.FWD_FP32_OPS + RC.FWD_TF32_OPS + RC.BWD_FP32_OPS)
            + F.decoder_step_flops(B, O, T, e, L)
            + F.psp_flops(B, 69, t["render_px"], tuple(t["pyramid_sizes"])))


def trace(ctx, st):
    """A fresh batch's first trace_steps steps under the profiler, and the
    counts of the pairs those steps' renders need."""
    from sln_tpu_torch.render import rasterizer_cuda

    n = ctx.traffic["trace_steps"]
    st.j += 1
    st.refiner, st.noise = _start(st, st.j)
    ctx.sync()
    rasterizer_cuda.reset_launch_counts()

    def steps():
        for k in range(n):
            with harness.span("bench.refine.step"):
                st.refiner.step(st.noise[k])

    tr = harness.traced(steps, ctx.device)
    launches = (rasterizer_cuda.FWD_LAUNCHES, rasterizer_cuda.BWD_LAUNCHES)
    cam = reference_camera(ctx)
    B, Fn = ctx.traffic["rooms_per_batch"], st.shells.faces.shape[1] + (
        ctx.config["data"]["max_objects"] * st.bank_host.faces.shape[1])
    P = B * cam.image_size ** 2
    pk = harness.peaks()
    fwd_bound = bwd_bound = 0.0
    for k in range(n):
        pairs = pairs_of(ctx, st, st.j, k)
        fwd_bound += RC.fwd_seconds_bound(pairs, B * Fn, P, pk)
        bwd_bound += RC.bwd_seconds_bound(pairs, B * Fn, P, pk)
    ks = tr["kernel_s"]
    fwd_s = sum(v for k, v in ks.items() if "raster_fwd" in k)
    bwd_s = sum(v for k, v in ks.items() if "raster_bwd" in k)
    return {"trace_window_s": tr["window_s"], "busy_s": tr["busy_s"],
            "breakdown": tr["breakdown"], "trace_steps": n,
            "raster_fwd_s": fwd_s, "raster_bwd_s": bwd_s,
            "raster_fwd_bound_s": fwd_bound,
            "raster_bwd_bound_s": bwd_bound,
            "glue_s": sum(ks.values()) - fwd_s - bwd_s,
            "kernels": tr["kernels"],
            "log_launches": {"fwd": launches[0], "bwd": launches[1]}}


def check(ctx, st, rec):
    """The first batch's first steps against the plain reference, after
    the program's state is freed."""
    prog_losses = [float(x) for x in st.first_losses]
    prog = (prog_losses, st.grad1, st.before, st.after, st.after1)
    rec.setdefault("log", {})["refine.launches (fwd, bwd) in trace"] = \
        rec.get("log_launches")
    for name in ("refiner", "model", "bank", "ref_model"):
        if hasattr(st, name):
            delattr(st, name)
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with harness.tf32(False):
        ref = reference_steps(ctx, st)
    numbers, log = compare.compare_steps(prog, ref, ALONE)
    numbers, log["not compared"] = compare.split(numbers, COMPARED)
    rec["log"].update({f"refine.{k}": v for k, v in log.items()})
    rec["log"]["refine.reference_s"] = time.perf_counter() - t0
    return numbers


def reference_steps(ctx, st, dtype=torch.float32):
    """The plain reference's first steps of pool batch 0: (losses, first
    gradients, leaves before, leaves after, leaves after the first step).
    `dtype` float64 gives a witness of float32's rounding."""
    bt = st.pool[0]
    with harness.default_dtype(dtype):
        scenes = S.Scenes(*(x.to(dtype) if x.is_floating_point() else x
                            for x in bt.scenes))
        ref = RefineReference(_ref_model(ctx, st).to(dtype), scenes,
                              bt.eps.to(dtype), st.bank_host, st.shells,
                              reference_camera(ctx), ctx.traffic,
                              ctx.traffic["learning_rate"])
        before = {k: v.detach().clone() for k, v in ref.leaves().items()}
        losses, g1, after, after1 = ref.steps(bt.noise.to(dtype),
                                              CHECKED_STEPS)
    return losses, g1, before, after, after1


KINDS = ("lower", "float64")


def control(ctx, st, kind: str):
    """(compared, logged) numbers of a control against the reference
    (float32, TF32 off): `lower`, the reference under TF32; `float64`, a
    witness and no control: the float32 reference against the reference
    in float64."""
    with harness.tf32(False):
        ref = reference_steps(ctx, st)
        if kind == "float64":
            ref, other = reference_steps(ctx, st, dtype=torch.float64), ref
    if kind == "lower":
        with harness.tf32(True):
            other = reference_steps(ctx, st)
    numbers, _ = compare.compare_steps(other, ref, ALONE)
    return compare.split(numbers, COMPARED)
