"""Shading loop (`--gan_shade`): one synthetic room at a time rendered by
the program's forward kernel at the generator's size, turned into the
SPADE input, and shaded with the traffic's z in chunks (`colorize`), its
images brought to the host as uint8; closed loop.

Weights are seeded on the device (the generator's convolutions do the
same work whatever the values); in bfloat16 they are stored as the
program's bfloat16 mode stores them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import flops as F
from benchmark.reference import render as R
from benchmark.reference import spade as spade_ref
from benchmark.traffic import scenes as S


class State:
    pass


def _camera(ctx) -> R.Camera:
    r = ctx.config["render"]
    return R.Camera(image_size=ctx.config["crop_size"], sigma=r["sigma_px"],
                    gamma=r["gamma"], z_far=r["z_far"], **r["camera"])


def seeded_weights(ctx, generator_cfg) -> dict:
    """The generator's state_dict from the seed, made on the device in
    one draw: weights N(0, 1 / fan_in), biases N(0, 0.05^2). In bfloat16
    every weight but the SE layers' is rounded to bfloat16, as the
    program stores it."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  spade_ref.Generator(**generator_cfg).state_dict().items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, device=ctx.device,
                       generator=S.device_generator(ctx.device, ctx.seed, 10))
    sd, at = {}, 0
    bf16 = ctx.traffic["spade_dtype"] == "bfloat16"
    for k, shape in shapes.items():
        n = int(np.prod(shape))
        v = flat[at:at + n].view(shape)
        at += n
        v = v * (n / shape[0]) ** -0.5 if len(shape) > 1 else v * 0.05
        if bf16 and "se" not in k.split("."):
            v = v.to(torch.bfloat16).float()
        sd[k] = v
    return sd


def _generator_cfg(ctx) -> dict:
    c = ctx.config
    return {"semantic_nc": c["semantic_nc"], "target_nc": c["target_nc"],
            "nz": c["nz"], "ngf": c["ngf"], "crop_size": c["crop_size"]}


def make_inputs(ctx) -> State:
    """What the benchmark hands both sides: the weights, the mesh bank
    and shell, the pool of rooms and their z."""
    st = State()
    dev, t, c = ctx.device, ctx.traffic, ctx.config
    st.sd = seeded_weights(ctx, _generator_cfg(ctx))
    ctx.mark("weights")
    r = c["render"]
    st.bank_host = R.mesh_bank(r["mesh_subdiv"])
    st.shells = R.room_shells(r["shell_subdiv"])
    size_info = S.size_table(dev)
    n = t["room_pool"]
    rooms = S.generate_rooms(n, S.host_seed(ctx.seed, 1), t["rooms"])
    gen = S.device_generator(dev, ctx.seed, 2)
    st.rooms = [S.scene_batch([room], c["max_objects"], size_info, gen, dev)
                for room in rooms]
    chunks = -(-t["num_z"] // t["z_chunk"])
    st.zs = torch.randn((n, chunks, t["z_chunk"], c["nz"]), device=dev,
                        generator=S.device_generator(dev, ctx.seed, 3))
    return st


def setup(ctx):
    from sln_tpu_torch.config import CameraConfig, RenderConfig
    from sln_tpu_torch.data.batch import SceneBatch
    from sln_tpu_torch.render import scene as scene_lib
    from sln_tpu_torch.spade.generator import SPADEGenerator4

    ctx.mark("imports")
    st = make_inputs(ctx)
    ctx.mark("inputs")
    dev, t, c = ctx.device, ctx.traffic, ctx.config
    dtype = getattr(torch, t["spade_dtype"])
    with torch.device("meta"):
        model = SPADEGenerator4(c["semantic_nc"], c["target_nc"], c["nz"],
                                c["ngf"], c["crop_size"], c["n_up"], dtype)
    model = model.to_empty(device=dev)
    model.load_state_dict(st.sd)
    if dtype != torch.float32:
        for name, p in model.named_parameters():
            if "se" not in name.split("."):
                p.data = p.data.to(dtype)
    st.model = model.eval()
    ctx.mark("model")
    r = c["render"]
    st.rcfg = RenderConfig(
        camera=CameraConfig(**{**r["camera"], "image_size": c["crop_size"]}),
        sigma_px=r["sigma_px"], gamma=r["gamma"], z_far=r["z_far"],
        mesh_subdiv=r["mesh_subdiv"], shell_subdiv=r["shell_subdiv"])
    st.bank = scene_lib.device_bank(st.bank_host, shells=st.shells,
                                    device=dev)
    st.batches = [SceneBatch(*b) for b in st.rooms]
    ctx.mark("bank")
    rng = np.random.default_rng(S.host_seed(ctx.seed, 4))
    st.keep = rng.random(1 << 16) < t["check_share"]
    st.rng = rng
    ctx.mark("program")
    # every shape of the window, once: one room's render and shading
    _shade(st, ctx, 0)
    ctx.sync()
    st.setup_s = ctx.since_start()
    return st


def _shade(st, ctx, i: int, events=None):
    """Room i (of the pool, cycled): its render, SPADE input and images
    (num_z, S, S, 3) uint8 on the host."""
    from sln_tpu_torch.workloads import gan_shade as gs

    t = ctx.traffic
    k = i % len(st.rooms)
    with torch.no_grad(), harness.span("bench.shade.render"):
        if events is not None:
            events["render"].append(_event())
        ch = gs.render_scene_channels(st.batches[k], st.bank_host, st.bank,
                                      st.rcfg)
        spade_in = gs.resize_spade_input(gs.layout_channels_to_spade_input(
            ch), st.model.crop_size)
        if events is not None:
            events["render"].append(_event())
    with harness.span("bench.shade.colorize"):
        imgs = gs.colorize(st.model, spade_in, st.zs[k], t["num_z"],
                           out_dtype="uint8")
    return imgs, spade_in


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _timed_decode(model, events):
    """model.decode with CUDA events around each call."""
    decode = model.decode

    def timed(*a, **kw):
        events["decode"].append(_event())
        out = decode(*a, **kw)
        events["decode"].append(_event())
        return out
    return timed


def window(ctx, st, seconds):
    """Rooms back to back for `seconds`; each room's latency from the
    start of its render to its images on the host."""
    t = ctx.traffic
    events = ({"render": [], "decode": []}
              if ctx.trace and ctx.device != "cpu" else None)
    if events is not None:
        st.model.decode = _timed_decode(st.model, events)
    lat, kept, stamps = [], {}, []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        r0 = time.perf_counter()
        imgs, spade_in = _shade(st, ctx, i + 1, events)
        lat.append(1e3 * (time.perf_counter() - r0))
        stamps.append(time.perf_counter())
        if st.keep[i]:
            kept[i + 1] = (imgs, spade_in)
        i += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    st.rooms_done = i
    if events is not None:
        del st.model.decode
    n = t["check_rooms"]
    pick = sorted(kept)
    st.checked = {j: kept[j] for j in (
        st.rng.choice(pick, size=min(n, len(pick)), replace=False)
        if pick else [])}
    if not st.checked:
        st.checked = {i: (imgs, spade_in)}
    rec = {"setup_s": st.setup_s, "window_s": window_s,
           "attempted": i * t["num_z"], "failed": 0,
           "images": i * t["num_z"], "room_ms": lat,
           "log": {"shade.rooms": i,
                   "shade.rooms by quarter of the window":
                   harness.by_quarter(stamps, t0, seconds),
                   "shade.checked rooms":
                   sorted(int(j) for j in st.checked)}}
    if events is not None:
        for key in ("render", "decode"):
            ev = events[key]
            ms = sum(a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2]))
            rec[f"{key}_ms_per_room"] = ms / i
    return rec


def trace(ctx, st):
    n = ctx.traffic["trace_rooms"]

    def rooms():
        for i in range(n):
            _shade(st, ctx, i)

    tr = harness.traced(rooms, ctx.device)
    # counted after the window: the count's forward on the meta device
    # imports torch._dynamo (seconds of set-up the program does not need)
    t, c = ctx.traffic, ctx.config
    per_room = F.spade_room_flops(c["ngf"], c["nz"], c["crop_size"],
                                  c["semantic_nc"], t["num_z"],
                                  t["z_chunk"])["room"]
    return {"trace_window_s": tr["window_s"], "busy_s": tr["busy_s"],
            "breakdown": tr["breakdown"],
            "shade_flops": st.rooms_done * per_room,
            "peak": ("bf16_flops" if t["spade_dtype"] == "bfloat16"
                     else "fp32_flops")}


def reference_images(ctx, st, k: int, precision: str = "fp32"):
    """The reference's images of pool room k: its own dense render, SPADE
    input and generator, in `precision` ("fp32" with TF32 off, "tf32",
    or "fp8"), as uint8 (num_z, S, S, 3) on the host."""
    t, c = ctx.traffic, ctx.config
    b = st.rooms[k % len(st.rooms)]
    cam = _camera(ctx)
    tf32 = precision == "tf32"
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=tf32):
            dims = (b.boxes * b.room_mask[..., None]).sum(1)[..., 3:]
            absb = b.boxes * torch.cat([dims, dims], -1)[:, None]
            midx = torch.as_tensor(R.retrieve(b.objs.cpu().numpy(),
                                              absb.cpu().numpy(),
                                              st.bank_host),
                                   device=b.objs.device)
            ch = R.render(b.objs, b.boxes, b.angles.float(), b.obj_mask,
                          midx, st.bank_host, st.shells, cam)[0]
            seg = spade_input(ch)[None]
            if not hasattr(st, "ref_gen"):
                st.ref_gen = spade_ref.Generator(**_generator_cfg(ctx)).to(
                    ctx.device)
                st.ref_gen.load_state_dict(st.sd)
            g = st.ref_gen.set_precision("fp8" if precision == "fp8"
                                         else "fp32")
            out = torch.cat([g(seg, z) for z in st.zs[k % len(st.zs)]])
            out = out[:t["num_z"]]
            u8 = torch.round(((out + 1.0) * 0.5).clamp(0.0, 1.0) * 255.0)
            return u8.to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy(), seg
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def spade_input(ch: torch.Tensor) -> torch.Tensor:
    """(70, S, S) render -> (41, S, S): covered depth min-max normalized to
    [-1, 1] (the uncovered at the far end), masks binarized at 0.5."""
    depth = ch[0]
    valid = depth > 0
    if valid.any():
        lo, hi = depth[valid].min(), depth[valid].max()
        depth = torch.where(valid, (depth - lo) / (hi - lo).clamp(min=1e-6),
                            1.0)
    return torch.cat([depth[None] * 2.0 - 1.0, (ch[1:41] > 0.5).float()], 0)


def image_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The worst image's mean |difference| in [0, 255] levels."""
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return float(d.reshape(d.shape[0], -1).mean(1).max())


def check(ctx, st, rec):
    for name in ("model", "bank", "batches"):
        delattr(st, name)
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps, flips = [], []
    for k, (imgs, prog_in) in st.checked.items():
        ref, seg = reference_images(ctx, st, k)
        gaps.append(image_gap(imgs, ref))
        flips.append(int((prog_in[1:] != seg[0, 1:]).sum()))
    rec["log"].update({"shade.image gaps": gaps,
                       "shade.mask pixels unlike the reference's": flips,
                       "shade.reference_s": time.perf_counter() - t0})
    return {"image_gap": max(gaps)}


KINDS = ("lower",)


def control(ctx, st, kind: str):
    """(compared, logged) numbers of the control against the reference
    (float32, TF32 off): the reference a precision lower in the program's
    place, TF32 for a float32 cell and float8 e4m3 for a bfloat16 one, on
    the rooms the check draws."""
    low = "fp8" if ctx.traffic["spade_dtype"] == "bfloat16" else "tf32"
    gaps = []
    for k in range(1, ctx.traffic["check_rooms"] + 1):
        ref, _ = reference_images(ctx, st, k, "fp32")
        ctl, _ = reference_images(ctx, st, k, low)
        gaps.append(image_gap(ctl, ref))
    return {"image_gap": max(gaps)}, {"image gaps": gaps}
