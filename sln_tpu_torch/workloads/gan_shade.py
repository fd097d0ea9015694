"""gan_shade workload: rendered semantic + depth channels -> SPADE RGB
shading (counterpart of sln_tpu/workloads/gan_shade.py).

The reference spawns Blender to write per-class mask PNGs and an EXR
depth to disk, reads them back and runs SPADEGenerator4 with 50 z samples
(testing/test_SPADE_shade.py:30-80). Here the soft rasterizer (its CUDA
forward kernel on the card) renders exactly the 41-channel stack SPADE
reads, on the device, with no process or file in between. Reading
existing Blender outputs is kept (`spade_input_from_files`).

Layouts are NCHW throughout: a SPADE input is (41, S, S), depth in
channel 0; images leave `colorize` as (num_z, S, S, 3) for the PNGs.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import SizeInfo, build_graphs
from sln_tpu_torch.data.vocab import NYU40_CLASSES
from sln_tpu_torch.render import assets, scene as scene_lib
from sln_tpu_torch.spade.generator import SPADEGenerator4
from sln_tpu_torch.spade.port import load_reference_checkpoint, \
    params_from_jax
from sln_tpu_torch.workloads import common
from sln_tpu_torch.workloads.plot2d import MAPPED_COLORS, write_png

Z_CHUNK = 10        # z samples per decode call (the JAX package's z_chunk)


def layout_channels_to_spade_input(channels: torch.Tensor) -> torch.Tensor:
    """(70, S, S) render stack -> (41, S, S) SPADE input, on its device.

    Depth is min-max normalized over the covered pixels to [-1, 1] like
    the EXR processing at test_SPADE_shade.py:50-56 (uncovered pixels go
    to the far end); masks are binarized at 0.5 (the reference thresholds
    8-bit PNGs at 120, :70-71)."""
    depth = channels[0]
    valid = depth > 0
    dmin = torch.where(valid, depth, math.inf).amin()
    span = (torch.where(valid, depth, -math.inf).amax() - dmin).clamp(
        min=1e-6)
    # with no covered pixel the depth is left as it is
    depth = torch.where(valid.any(),
                        torch.where(valid, (depth - dmin) / span, 1.0),
                        depth)
    masks = (channels[1:41] > 0.5).float()
    return torch.cat([depth[None] * 2.0 - 1.0, masks], 0)


def shading_target(spade_input: torch.Tensor) -> torch.Tensor:
    """Deterministic shaded-RGB target of the synthetic shading task: the
    per-class albedo (the ScanNet palette) times a screen-space lambertian
    shade from the depth channel, with a mild distance falloff. It stands
    in for the SUNCG photoreal renders the reference's generator was fit
    to, which are not redistributable.

    spade_input (..., 41, H, W): depth in [-1, 1] and 40 binary class
    masks -> (..., 3, H, W) RGB in [-1, 1]."""
    x = spade_input
    depth01 = (x[..., 0, :, :] + 1.0) * 0.5                   # (..., H, W)
    palette = torch.tensor(MAPPED_COLORS, dtype=torch.float32,
                           device=x.device) / 255.0           # (40, 3)
    albedo = torch.einsum("...chw,cd->...dhw", x[..., 1:, :, :], palette)
    # screen-space normals from depth gradients (one-sided at the edges);
    # the x48 gain maps the [0, 1] depth range onto visible surface tilt
    # at 256 px
    gy, gx = torch.gradient(depth01, dim=(-2, -1), edge_order=1)
    n = torch.stack([-gx * 48.0, -gy * 48.0, torch.ones_like(gx)], -3)
    n = n / torch.linalg.vector_norm(n, dim=-3, keepdim=True)
    light = torch.tensor([1.0, -1.0, 2.0], device=x.device) / math.sqrt(6.0)
    diffuse = torch.einsum("...chw,c->...hw", n, light).clamp(0.0, 1.0)
    shade = (0.35 + 0.65 * diffuse) * (1.0 - 0.3 * depth01)
    rgb = (albedo * shade[..., None, :, :]).clamp(0.0, 1.0) * 2.0 - 1.0
    return rgb.float()


def mask_class_from_stem(stem: str) -> str:
    """Mask filename stem -> underscored class name. Artifact names are
    `<room>_pred_<kk>_<class>` (reference semantic_depth_caller.py:46 and
    render_semantic_depth.py:445), so the class is everything past the
    third underscore."""
    parts = stem.split("_")
    return "_".join(parts[3:]) if len(parts) > 3 else parts[-1]


def spade_input_from_files(semantic_dir: str, room: str = "") -> np.ndarray:
    """(41, S, S) from Blender-written EXR depth (or its .npy sidecar) and
    mask PNGs (reference test_SPADE_shade.py:44-76)."""
    import imageio.v2 as imageio

    files = [os.path.join(semantic_dir, f)
             for f in os.listdir(semantic_dir) if room in f]
    npys = sorted(f for f in files if f.endswith("_depth.npy"))
    exrs = sorted(f for f in files if f.endswith(".exr"))
    masks = [f for f in files if "depth" not in f and "orig" not in f
             and not f.endswith((".exr", ".npy"))]
    depth = np.load(npys[0]) if npys else np.asarray(imageio.imread(exrs[0]))
    if depth.ndim == 3:
        depth = depth[..., 0]
    depth = depth - depth.min()
    dmax = depth[depth < 20].max()
    depth = (np.clip(depth, 0, dmax) / dmax - 0.5) * 2.0
    size = depth.shape[0]
    buf = np.zeros((40, size, size), np.float32)
    classes_us = [c.replace(" ", "_") for c in NYU40_CLASSES]
    for path in masks:
        name = mask_class_from_stem(os.path.basename(path).split(".")[0])
        if name in classes_us:
            buf[classes_us.index(name)] = np.asarray(
                imageio.imread(path))[..., 0]
    buf = (buf > 120).astype(np.float32)
    return np.concatenate([depth[None].astype(np.float32), buf], 0)


def render_scene_channels(batch, bank_host: assets.MeshBank,
                          bank: scene_lib.DeviceBank, rcfg) -> torch.Tensor:
    """Single-scene SceneBatch -> (70, S, S) render stack, meshes retrieved
    from the scene's own boxes (on the host)."""
    dims = scene_lib.room_dims_of(batch.objs, batch.boxes, batch.obj_mask)
    abs_boxes = batch.boxes * torch.cat([dims, dims], -1)[:, None]
    midx = torch.as_tensor(
        assets.retrieve_models(batch.objs.cpu().numpy(),
                               abs_boxes.cpu().numpy(), bank_host),
        device=batch.objs.device)
    return scene_lib.render_layout(batch.objs, batch.boxes,
                                   batch.angles.float(), batch.obj_mask,
                                   midx, bank, rcfg)[0]


def _room_batch(arrays, i: int, size_info: SizeInfo, cfg: Config, seed: int,
                device):
    """Room i of the arrays as a one-scene SceneBatch, its graph drawn
    from `seed`."""
    def t(name):
        return torch.as_tensor(arrays[name][i:i + 1], device=device)

    return build_graphs(t("objs"), t("boxes"), t("angles"), t("obj_mask"),
                        t("room_ids"), size_info,
                        max_on_rels=cfg.data.max_on_rels,
                        use_attr_30=cfg.data.use_attr_30,
                        generator=torch.Generator(device).manual_seed(seed))


def _render_setup(cfg: Config, crop: int, device):
    rcfg = dataclasses.replace(cfg.render, camera=dataclasses.replace(
        cfg.render.camera, image_size=crop))
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device=device)
    return rcfg, bank_host, bank


@torch.no_grad()
def render_spade_inputs(num_rooms: int, cfg: Config, crop: int,
                        synthetic_seed: int = 0, key_offset: int = 0,
                        device="cuda") -> torch.Tensor:
    """(N, 41, crop, crop) SPADE inputs of rasterized synthetic rooms.

    The one render-rooms-to-SPADE-input loop of the shading trainer and
    the quality cell, so both measure on inputs made the same way.
    `synthetic_seed` picks the room set (the quality cell holds out seed
    19; the trainer uses 0) and `key_offset` the rooms' graph draws."""
    arrays, size_info = common.load_arrays(num_rooms, cfg, device,
                                           synthetic_seed=synthetic_seed)
    rcfg, bank_host, bank = _render_setup(cfg, crop, device)
    return torch.stack([layout_channels_to_spade_input(
        render_scene_channels(
            _room_batch(arrays, i, size_info, cfg, key_offset + i, device),
            bank_host, bank, rcfg)) for i in range(num_rooms)])


def psnr_from_mse(mse: float) -> float:
    """PSNR (dB) on the [0, 1] scale from a (possibly chunk-averaged)
    MSE."""
    return -10.0 * math.log10(max(mse, 1e-10))


def make_shading_metrics(model: SPADEGenerator4):
    """(seg, rgb, z) -> (L1 on [-1, 1], PSNR dB on [0, 1], MSE on [0, 1])
    of the generator: the one PSNR definition of the trainer's val report
    and the quality cell. A chunked eval averages the MSE and takes one
    log at the end (psnr_from_mse): a mean of PSNRs is not the PSNR of
    the mean."""
    @torch.inference_mode()
    def metrics(seg, rgb, z):
        fake = model(seg, z)
        l1 = (fake - rgb).abs().mean()
        mse = ((fake - rgb) * 0.5).square().mean()       # on [0, 1] scale
        return float(l1), psnr_from_mse(float(mse)), float(mse)

    return metrics


def load_native_spade_checkpoint(path: str):
    """(state_dict, train config dict) of a shading-trainer checkpoint: a
    pickle of numpy trees with `g_params` (float16-stored leaves come back
    float32) and `config`."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return params_from_jax(payload["g_params"]), payload.get("config", {})


def default_spade_checkpoint_path() -> str:
    """The committed trained weights, <repo root>/artifacts/spade_gan.ckpt."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "artifacts", "spade_gan.ckpt")


def make_spade_model(cfg: Config, checkpoint_path: Optional[str] = None,
                     device="cuda") -> SPADEGenerator4:
    """The generator in eval mode on `device`. Weight sources, in order: an
    explicit path (.pth -> a reference checkpoint, folded; anything else
    -> a shading-trainer pickle), which raises when missing rather than
    writing noise images; a user-dropped latest_net_G_AB.pth under the
    output dir (test_SPADE_shade.py:9-14); the committed
    artifacts/spade_gan.ckpt; then seeded random init. The sentinel
    "random" forces random init at cfg's dims."""
    sp = cfg.spade
    if sp.compute_dtype != "float32":
        raise NotImplementedError(
            f"SPADE compute_dtype {sp.compute_dtype!r} (--spade_dtype) is "
            "not ported: the port shades in float32 (ROADMAP item 10)")

    def build(ngf, nz, crop):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return SPADEGenerator4(sp.semantic_nc, sp.target_nc, nz, ngf,
                                   crop, sp.n_up)

    def finish(model):
        return model.to(device).eval()

    model = build(sp.ngf, sp.nz, sp.crop_size)
    if checkpoint_path == "random":
        candidates = []
    elif checkpoint_path:
        if not os.path.isfile(checkpoint_path):
            raise FileNotFoundError(
                f"--spade_checkpoint {checkpoint_path!r} does not exist")
        candidates = [checkpoint_path]
    else:
        # a user-supplied reference checkpoint under --output_dir outranks
        # the committed artifact, which exists in every checkout
        candidates = [
            os.path.join(cfg.train.output_dir, "latest_net_G_AB.pth"),
            default_spade_checkpoint_path()]
    for path in candidates:
        if not os.path.isfile(path):
            continue
        if path.endswith(".pth"):
            model.load_state_dict(load_reference_checkpoint(path))
            print(f"Ported SPADE weights from {path}")
            return finish(model)
        sd, ck = load_native_spade_checkpoint(path)
        ck_ngf = ck.get("ngf", sp.ngf)
        ck_crop = ck.get("crop", sp.crop_size)
        if not checkpoint_path and (ck_ngf, ck_crop) != (sp.ngf,
                                                         sp.crop_size):
            # a default candidate must not override the requested
            # --spade_crop / --spade_ngf; an explicit path may (below)
            print(f"Skipping {path}: trained at ngf={ck_ngf}/"
                  f"crop={ck_crop}, requested ngf={sp.ngf}/"
                  f"crop={sp.crop_size} (pass --spade_checkpoint "
                  f"to force loading it)")
            continue
        # a checkpoint's trained dims define the model
        model = build(ck_ngf, ck.get("nz", sp.nz), ck_crop)
        model.load_state_dict(sd)
        print(f"Loaded SPADE weights from {path}")
        return finish(model)
    if checkpoint_path != "random":
        print(f"WARNING: no SPADE checkpoint at {candidates}; random init")
    return finish(model)


def draw_zs(num_z: int, nz: int, seed: int = 0, z_chunk: int = Z_CHUNK,
            device="cuda") -> torch.Tensor:
    """(ceil(num_z / z_chunk), z_chunk, nz) standard normal z from a
    torch.Generator seeded with `seed`; the last chunk's extra rows are
    decoded and dropped."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn((-(-num_z // z_chunk), z_chunk, nz), generator=gen,
                       device=device)


@torch.inference_mode()
def colorize(model: SPADEGenerator4, spade_input: torch.Tensor,
             zs: torch.Tensor, num_z: int, out_dtype: str = "float32",
             mesh=None) -> np.ndarray:
    """One room's (41, S, S) input and z chunks (C, chunk, nz) -> the first
    `num_z` images, (num_z, S, S, 3) RGB in [0, 1] (out_dtype "uint8": in
    [0, 255], converted on the device, so only the PNGs' bytes leave it).

    A room's segmentation is fixed while its z vary (the reference runs
    50 full generator passes, test_SPADE_shade.py:74-80), so the
    segmentation half of the generator runs once (`seg_mods`) and every
    z chunk's `decode` reuses it."""
    if mesh is not None:
        raise NotImplementedError(
            "colorize(mesh=) (z sharded over devices) is not ported "
            "(ROADMAP item 9)")
    mods = model.seg_mods(spade_input[None])
    imgs = []
    for z in zs:
        rgb = model.decode(mods, z)
        if out_dtype == "uint8":
            rgb = torch.round(((rgb + 1.0) * 0.5).clamp(0.0, 1.0)
                              * 255.0).to(torch.uint8)
        imgs.append(rgb)
    out = torch.cat(imgs)[:num_z].permute(0, 2, 3, 1).cpu().numpy()
    return out if out_dtype == "uint8" else (out + 1.0) / 2.0


def resize_spade_input(spade_in: torch.Tensor, crop: int) -> torch.Tensor:
    """(41, S, S) -> (41, crop, crop): bilinear, antialiased when
    downsampling as jax.image.resize is by default, then the masks
    re-binarized (the reference resizes its 1024 px Blender reads to 256,
    test_SPADE_shade.py:74)."""
    if spade_in.shape[-1] == crop:
        return spade_in
    out = F.interpolate(spade_in[None], size=(crop, crop), mode="bilinear",
                        align_corners=False, antialias=True)[0]
    return torch.cat([out[:1], (out[1:] > 0.5).float()], 0)


def run_gan_shade(val_arrays: Dict[str, np.ndarray], size_info: SizeInfo,
                  cfg: Config, num_z: int, save_dir: str, rooms=None,
                  spade_checkpoint: Optional[str] = None,
                  semantic_dir: Optional[str] = None,
                  device="cuda") -> List[str]:
    """Render the selected val rooms (the first four by default), shade
    each with `num_z` z, and write `<room>_<kkk>_color.png` like the
    reference's save_color (test_SPADE_shade.py:16-27). Returns the
    paths written.

    semantic_dir: read Blender-written masks and depth from there
    instead of rasterizing (the reference's two-process pipeline)."""
    os.makedirs(save_dir, exist_ok=True)
    rcfg, bank_host, bank = _render_setup(cfg, cfg.spade.crop_size, device)
    model = make_spade_model(cfg, spade_checkpoint, device)

    ids = val_arrays["room_ids"]
    if rooms is None or rooms == "all":
        sel = list(range(min(len(ids), 4)))
    else:
        sel = [int(np.where(ids == int(r))[0][0]) for r in rooms]

    paths = []
    for idx in sel:
        room_id = int(ids[idx])
        if semantic_dir is not None:
            spade_in = torch.as_tensor(
                spade_input_from_files(semantic_dir, room=str(room_id)),
                device=device)
        else:
            batch = _room_batch(val_arrays, idx, size_info, cfg, 0, device)
            with torch.no_grad():
                spade_in = layout_channels_to_spade_input(
                    render_scene_channels(batch, bank_host, bank, rcfg))
        # a loaded checkpoint's trained crop wins over cfg.spade.crop_size
        spade_in = resize_spade_input(spade_in, model.crop_size)
        rgb = colorize(model, spade_in, draw_zs(num_z, model.nz,
                                                device=device),
                       num_z, out_dtype="uint8")
        for k in range(num_z):
            path = os.path.join(save_dir,
                                f"{room_id}_{str(k).zfill(3)}_color.png")
            write_png(path, rgb[k])
            paths.append(path)
        print(f"room {room_id}: wrote {num_z} colorizations")
    return paths
