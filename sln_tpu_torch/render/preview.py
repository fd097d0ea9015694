"""Shaded 3D preview of generated layouts — no Blender required
(counterpart of sln_tpu/render/preview.py).

`--draw_3d` launches the bundled Blender script for photoreal Cycles
renders (reference render/render_room_color.py:29-442). This module is the
path used when no Blender binary exists (or with `--renderer preview`): the
SAME scene assembly as the Blender script (scene_spec.scene_meshes — bank
meshes, world matrices, retrieved shells with the bad-wall drop baked in),
projected through the framework's reference camera (render/camera.py),
rasterized in one soft-rasterizer pass (the CUDA forward kernel on the
card) and shaded on the device: screen-space normals from the unprojected
depth buffer, headlight Lambert over the ScanNet class palette. Artifacts
keep the reference naming contract `<room>_pred_<kk>_3d.png`
(render_caller.py:41) in the same `data/rendered/` directory the Blender
path uses.

The JAX package rasterizes the NYU-40 class of each face. The kernel takes
at most 32 classes, and every class a layout can hold (the renderable
objects' NYU classes, wall, floor, ceiling) is one of the 32 render classes
(render/scene.py RENDER_CLASSES), so the preview rasterizes render classes
and scatters them to their NYU-40 channels: the same values, since a
class that no face carries has zero mass either way.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from sln_tpu_torch.config import CameraConfig
from sln_tpu_torch.data.vocab import NYU40_CLASSES
from sln_tpu_torch.render import camera as cam_lib
from sln_tpu_torch.render.blender import scene_spec
from sln_tpu_torch.render.image_io import write_png
from sln_tpu_torch.render.rasterizer import FaceGeometry, face_geometry
from sln_tpu_torch.render.rasterizer_cuda import soft_rasterize_cuda
from sln_tpu_torch.render.scene import NUM_RENDER_CLASSES, RENDER_CLASSES
from sln_tpu_torch.workloads.plot2d import MAPPED_COLORS

_PALETTE = np.asarray(MAPPED_COLORS, np.float32) / 255.0       # (40, 3)
NUM_NYU_CLASSES = len(NYU40_CLASSES)
# render class -> its NYU-40 channel, and back (-1: not a render class)
RC_TO_NYU = np.asarray([NYU40_CLASSES.index(c.replace("_", " "))
                        for c in RENDER_CLASSES], np.int64)
NYU_TO_RC = np.full(NUM_NYU_CLASSES, -1, np.int64)
NYU_TO_RC[RC_TO_NYU] = np.arange(NUM_RENDER_CLASSES)

SIGMA, GAMMA, Z_FAR = 0.35, 0.015, 15.0


def _world_faces(meshes: List[dict]):
    """Mesh dicts (scene_spec.scene_meshes) -> flat world-space triangle
    soup: verts (V, 3), faces (F, 3) int, face_class (F,) NYU-40 ids.

    The wall/floor/ceiling entries share one vertex array under one
    matrix (disjoint face subsets); dedupe on (id(verts), id(matrix)) so
    the shared shell vertices are transformed and projected once."""
    verts, faces, fcls = [], [], []
    base, seen = 0, {}
    for m in meshes:
        f = np.asarray(m["faces"], np.int64)
        if len(f) == 0:
            continue
        key = (id(m["verts"]), id(m["matrix"]))
        if key in seen:
            off = seen[key]
        else:
            v = np.asarray(m["verts"], np.float64)
            vw = v @ m["matrix"][:3, :3].T + m["matrix"][:3, 3]
            verts.append(vw.astype(np.float32))
            seen[key] = off = base
            base += len(vw)
        faces.append(f + off)
        fcls.append(np.full(len(f), NYU40_CLASSES.index(m["class_name"]),
                            np.int32))
    if not verts:
        return (np.zeros((3, 3), np.float32), np.zeros((1, 3), np.int64),
                np.zeros(1, np.int32))
    return (np.concatenate(verts), np.concatenate(faces),
            np.concatenate(fcls))


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """np.gradient at unit spacing: central differences inside, one-sided
    at both ends."""
    n = x.shape[dim]
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim)


def shade(depth: torch.Tensor, classes: torch.Tensor, focal: float,
          z_far: float, ambient: float = 0.45) -> torch.Tensor:
    """(..., S, S) depth + (..., S, S, 40) class coverage -> (..., S, S, 3)
    RGB in [0, 1], on their device.

    Albedo is the ScanNet palette color of the winning class; lighting is
    a camera headlight: normals come from central differences of the
    unprojected camera-space positions, intensity = ambient +
    (1-ambient)*|n_z| (faces seen edge-on go dark). Background (no
    coverage / far plane) renders white like the reference's world
    backdrop."""
    S = depth.shape[-1]
    fg = (classes.sum(-1) > 0.5) & (depth < z_far * 0.99)
    palette = torch.as_tensor(_PALETTE, device=depth.device)
    albedo = palette[classes.argmax(-1)]                        # (.., S, S, 3)

    uv = (torch.arange(S, dtype=torch.float32, device=depth.device)
          - S / 2.0) / float(focal)
    P = torch.stack([uv[None, :] * depth, uv[:, None] * depth, depth], -1)
    du = _gradient(P, -2)
    dv = _gradient(P, -3)
    n = torch.linalg.cross(du, dv, dim=-1)
    nz = n[..., 2].abs() / torch.linalg.vector_norm(n, dim=-1).clamp(
        min=1e-9)
    rgb = albedo * (ambient + (1.0 - ambient) * nz)[..., None]
    return torch.where(fg[..., None], rgb, torch.ones_like(rgb))


def layout_geometry(objs: List[int], boxes: np.ndarray, angles: np.ndarray,
                    bank, shells=None, image_size: int = 256,
                    device="cuda") -> Tuple[FaceGeometry, float]:
    """One predicted layout -> (its FaceGeometry (1, Fp) on `device`, face
    classes in render classes; the camera's focal length in pixels).

    The scene is assembled in world space on the host (scene_spec, as the
    Blender scripts assemble it); the camera, projection, near culling and
    face constants run on the device."""
    meshes = scene_spec.scene_meshes(objs, boxes, angles, bank, shells)
    verts, faces, fcls = _world_faces(meshes)
    _, dims = scene_spec.denormalize_scene(boxes)
    # an untrained/degenerate model can predict a collapsed or inverted
    # room box; keep the camera finite instead of rendering NaNs
    dims = np.maximum(np.abs(dims), 0.1)
    rcls = NYU_TO_RC[fcls]
    if (rcls < 0).any():
        bad = sorted({NYU40_CLASSES[c] for c in fcls[rcls < 0]})
        raise ValueError(f"classes {bad} are not render classes")

    # the JAX package's face bucket (a multiple of the kernels' 128-face
    # chunk), padded with invalid faces
    F = len(faces)
    Fp = max(512, 1 << int(np.ceil(np.log2(F))))
    pad = Fp - F
    faces = np.concatenate([faces, np.zeros((pad, 3), np.int64)])
    rcls = np.concatenate([rcls, np.zeros(pad, np.int64)])
    fvalid = np.concatenate([np.ones(F, bool), np.zeros(pad, bool)])

    cfg = CameraConfig(image_size=image_size)
    cam = cam_lib.camera_from_room(
        torch.as_tensor(dims, dtype=torch.float32, device=device)[None], cfg)
    vc = cam_lib.to_camera(torch.as_tensor(verts, device=device)[None], cam)
    v2d, z = cam_lib.project(vc, cam)
    faces_t = torch.as_tensor(faces, device=device)
    tri2d = v2d[:, faces_t]                                     # (1, Fp, 3, 2)
    triz = z[:, faces_t]
    valid = ((triz > cfg.near).all(-1)                          # near culling
             & torch.as_tensor(fvalid, device=device)[None])
    geom = face_geometry(tri2d, triz, valid,
                         torch.as_tensor(rcls, device=device)[None])
    return geom, cam.focal


def rasterize_nyu(geom: FaceGeometry, image_size: int, sigma: float = SIGMA,
                  gamma: float = GAMMA, z_far: float = Z_FAR,
                  raster=soft_rasterize_cuda
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render-class geometry -> (depth (B, S, S), NYU-40 classes
    (B, S, S, 40)): one pass of `raster` (the kernels' wrapper: the CUDA
    forward on the card, its plain version on the CPU) over the 32 render
    classes, scattered to their NYU-40 channels."""
    depth, rc = raster(geom, NUM_RENDER_CLASSES, image_size, sigma=sigma,
                       gamma=gamma, z_far=z_far)
    classes = rc.new_zeros(rc.shape[:-1] + (NUM_NYU_CLASSES,))
    classes[..., torch.as_tensor(RC_TO_NYU, device=rc.device)] = rc
    return depth, classes


@torch.no_grad()
def render_preview(objs: List[int], boxes: np.ndarray, angles: np.ndarray,
                   bank=None, shells=None, image_size: int = 256,
                   sigma: float = SIGMA, gamma: float = GAMMA,
                   z_far: float = Z_FAR, device="cuda") -> torch.Tensor:
    """One predicted layout (data_extracted.json row) -> (S, S, 3) RGB in
    [0, 1] on `device`."""
    if bank is None:
        bank, shells = scene_spec.load_bank()
    geom, focal = layout_geometry(objs, boxes, angles, bank, shells,
                                  image_size, device)
    depth, classes = rasterize_nyu(geom, image_size, sigma, gamma, z_far)
    return shade(depth[0], classes[0], focal, z_far)


def run_preview_renders(test_dir: str, rooms: Optional[List[str]] = None,
                        num_preds: int = 4, image_size: int = 256,
                        device="cuda") -> int:
    """Render every predicted layout in <test_dir>/data/data_extracted.json
    to <test_dir>/data/rendered/ (the Blender path's output directory).
    Returns the number of images written."""
    out_dir = os.path.join(test_dir, "data", "rendered")
    os.makedirs(out_dir, exist_ok=True)
    bank, shells = scene_spec.load_bank()
    count = 0
    for room_id, k, objs, boxes, angles in scene_spec.iter_extracted_layouts(
            test_dir, num_preds=num_preds, rooms=rooms):
        rgb = render_preview(objs, boxes, angles, bank, shells,
                             image_size=image_size, device=device)
        path = os.path.join(out_dir, scene_spec.color_filename(room_id, k))
        # matplotlib imsave's conversion (x * 255, truncated), on the device;
        # one copy to the host per image
        write_png(path, (rgb.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu()
                  .numpy())
        count += 1
        print(f"preview: wrote {path}")
    return count
