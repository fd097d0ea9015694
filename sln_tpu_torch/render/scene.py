"""Differentiable scene assembly + the reference's 70-channel render stack
(counterpart of sln_tpu/render/scene.py; reference
models/diff_render.py:48-435).

denormalize boxes -> retrieved meshes -> per-object scale/rotate/translate
into padded buffers -> near-plane culling -> ONE soft-rasterizer pass ->
[depth | 40 NYU class masks | 29 per-class depth channels]. Batched over
scenes. The rasterizer launches the CUDA kernels for tensors on the card
and runs their plain versions for tensors on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sln_tpu_torch import trace
from sln_tpu_torch.config import RenderConfig
from sln_tpu_torch.data.vocab import (DO_NOT_RENDER, NYU40_CLASSES,
                                      OBJECT_IDX_TO_NAME)
from sln_tpu_torch.render import assets, camera as cam_lib
from sln_tpu_torch.render.rasterizer import FaceGeometry, face_geometry
from sln_tpu_torch.render.rasterizer_cuda import soft_rasterize_cuda

# Render-class indexing (diff_render.py:64-74, 372-377): wall first, then
# the sorted remaining classes; depth channels skip wall/floor/ceiling.
_all = sorted(set(OBJECT_IDX_TO_NAME[1:]) | {"ceiling"})
RENDER_CLASSES: Tuple[str, ...] = tuple(
    ["wall"] + [c for c in _all if c != "wall"])
DEPTH_CLASSES: Tuple[str, ...] = tuple(
    c for c in RENDER_CLASSES if c not in ("wall", "floor", "ceiling"))
NUM_RENDER_CLASSES = len(RENDER_CLASSES)          # 32
NUM_DEPTH_CLASSES = len(DEPTH_CLASSES)            # 29

WALL_RC = RENDER_CLASSES.index("wall")
FLOOR_RC = RENDER_CLASSES.index("floor")
CEIL_RC = RENDER_CLASSES.index("ceiling")

_obj2rc = np.zeros(len(OBJECT_IDX_TO_NAME), np.int64)
_renderable = np.zeros(len(OBJECT_IDX_TO_NAME), bool)
for _i, _name in enumerate(OBJECT_IDX_TO_NAME):
    if _name == "__room__":
        continue
    _obj2rc[_i] = RENDER_CLASSES.index(_name)
    _renderable[_i] = _name not in DO_NOT_RENDER
OBJ_TO_RENDER_CLASS = _obj2rc
OBJ_RENDERABLE = _renderable

# render-class -> NYU-40 channel (40-channel mask block, diff_render.py:429)
RC_TO_NYU_MATRIX = np.zeros((NUM_RENDER_CLASSES, 40), np.float32)
for _rc, _c in enumerate(RENDER_CLASSES):
    RC_TO_NYU_MATRIX[_rc, NYU40_CLASSES.index(_c.replace("_", " "))] = 1.0
DEPTH_SEL = np.asarray([RENDER_CLASSES.index(c) for c in DEPTH_CLASSES])


class SceneBuffers(NamedTuple):
    verts: torch.Tensor        # (B, V, 3) world coordinates
    faces: torch.Tensor        # (B, F, 3) int64 into verts
    face_class: torch.Tensor   # (B, F) render-class ids
    face_valid: torch.Tensor   # (B, F) bool
    vert_slots: torch.Tensor   # (B, V, W) corner slots f*3+c that read each
    #                            vertex; padding points at slot F*3


class DeviceBank(NamedTuple):
    verts: torch.Tensor        # (M, Vm, 3)
    faces: torch.Tensor        # (M, Fm, 3)
    face_valid: torch.Tensor   # (M, Fm)
    bbox_min: torch.Tensor     # (M, 3)
    bbox_max: torch.Tensor     # (M, 3)
    shell_verts: torch.Tensor  # (S, Vs, 3) in [0, 1]^3
    shell_faces: torch.Tensor  # (S, Fs, 3)
    shell_part: torch.Tensor   # (S, Fs) 0=wall 1=floor 2=ceiling
    shell_fvalid: torch.Tensor  # (S, Fs) bool
    vert_slots: torch.Tensor   # (M, Vm, W) vertex_slots of each mesh
    shell_vert_slots: torch.Tensor  # (S, Vs, W) vertex_slots of each shell
    obj_renderable: torch.Tensor  # (num_objs,) bool
    obj_render_class: torch.Tensor  # (num_objs,) int64
    rc_to_nyu: torch.Tensor    # (32, 40)
    depth_sel: torch.Tensor    # (29,) render classes with a depth channel


def vertex_slots(faces: np.ndarray, num_verts: int, width: int
                 ) -> np.ndarray:
    """Inverse of a face index: faces (..., F, 3) -> (..., V, width) int64,
    row v listing the corner slots f*3 + c with faces[f, c] == v in
    ascending order, padded with -1. `width` must be at least the largest
    vertex valence (`max_valence`)."""
    lead, n = faces.shape[:-2], faces.shape[-2] * 3
    flat = np.asarray(faces, np.int64).reshape(int(np.prod(lead)), n)
    out = np.full((len(flat), num_verts, width), -1, np.int64)
    for i, f in enumerate(flat):
        order = np.argsort(f, kind="stable")
        v = f[order]
        rank = np.arange(n) - np.searchsorted(v, v, side="left")
        out[i, v, rank] = order
    return out.reshape(lead + (num_verts, width))


def max_valence(faces: np.ndarray, num_verts: int) -> int:
    """The most corner slots that read one vertex, over every mesh; 0 for
    meshes with no faces."""
    flat = np.asarray(faces, np.int64).reshape(
        int(np.prod(faces.shape[:-2])), faces.shape[-2] * 3)
    return max((int(np.bincount(f, minlength=num_verts).max())
                for f in flat if len(f)), default=0)


def device_bank(bank: assets.MeshBank, shell_subdiv: int = 4,
                shells: assets.ShellBank = None,
                device="cuda") -> DeviceBank:
    """Mesh and shell banks (and the class tables) on `device`."""
    if shells is None:
        shells = assets.procedural_shell_bank(shell_subdiv)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    Vm, Vs = bank.verts.shape[1], shells.verts.shape[1]
    # a bank of faceless meshes (build_procedural_bank(0)) stacks its empty
    # face lists as (M, 0): give it its (M, 0, 3) face axis
    faces = np.asarray(bank.faces).reshape(bank.face_valid.shape + (3,))
    width = max(max_valence(faces, Vm), max_valence(shells.faces, Vs))

    return DeviceBank(
        verts=t(bank.verts, torch.float32), faces=t(faces, torch.long),
        face_valid=t(bank.face_valid), bbox_min=t(bank.bbox_min),
        bbox_max=t(bank.bbox_max),
        shell_verts=t(shells.verts, torch.float32),
        shell_faces=t(shells.faces, torch.long),
        shell_part=t(shells.part, torch.long),
        shell_fvalid=t(shells.face_valid),
        vert_slots=t(vertex_slots(faces, Vm, width)),
        shell_vert_slots=t(vertex_slots(shells.faces, Vs, width)),
        obj_renderable=t(OBJ_RENDERABLE),
        obj_render_class=t(OBJ_TO_RENDER_CLASS),
        rc_to_nyu=t(RC_TO_NYU_MATRIX), depth_sel=t(DEPTH_SEL))


def rotation_y(theta: torch.Tensor) -> torch.Tensor:
    """Reference rotation about y (diff_render.py:117-123)."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zero, s], -1),
                        torch.stack([zero, one, zero], -1),
                        torch.stack([-s, zero, c], -1)], -2)


def room_dims_of(objs, boxes, obj_mask) -> torch.Tensor:
    """(B, 3) room extents: the __room__ row's absolute [X, Y, Z]."""
    room_mask = (objs == 0) & obj_mask
    return (boxes * room_mask[..., None]).sum(1)[..., 3:]


def assemble_scene(objs, boxes, angles, obj_mask, model_idx,
                   bank: DeviceBank, shell_idx: int = 0) -> SceneBuffers:
    """objs/boxes (normalized, room row absolute)/angles (float bins)/mask:
    (B, O, ...); model_idx: (B, O) retrieval result; shell_idx: the bank's
    room-shell entry (0 = the procedural exact-fit shell)."""
    B, O = objs.shape
    room_mask = (objs == 0) & obj_mask
    room_dims = room_dims_of(objs, boxes, obj_mask)              # (B, 3)

    abs_boxes = boxes * torch.cat([room_dims, room_dims], -1)[:, None]
    bb_min, bb_max = abs_boxes[..., :3], abs_boxes[..., 3:]
    center = (bb_min + bb_max) / 2.0
    size = bb_max - bb_min

    mverts = bank.verts[model_idx]                               # (B,O,Vm,3)
    mfaces = bank.faces[model_idx]                               # (B,O,Fm,3)
    mf_valid = bank.face_valid[model_idx]                        # (B,O,Fm)
    msize = bank.bbox_max[model_idx] - bank.bbox_min[model_idx]
    mcenter = (bank.bbox_max[model_idx] + bank.bbox_min[model_idx]) / 2.0

    scale = (size / msize.clamp(min=1e-6)).amin(-1)             # (B, O)
    theta = -angles.float() * (2.0 * math.pi / 24.0)
    rot = rotation_y(theta)                                      # (B,O,3,3)
    local = mverts - mcenter[..., None, :]
    world = (scale[..., None, None] * torch.einsum("boij,bovj->bovi", rot,
                                                   local)
             + center[..., None, :])                             # (B,O,Vm,3)

    renderable = bank.obj_renderable[objs] & obj_mask & ~room_mask
    face_class = bank.obj_render_class[objs][..., None].expand(
        mf_valid.shape)
    face_valid = mf_valid & renderable[..., None]
    Vm = mverts.shape[2]
    offsets = (torch.arange(O, device=objs.device) * Vm)[None, :, None, None]
    faces_global = mfaces + offsets

    shell_world = bank.shell_verts[shell_idx][None] * room_dims[:, None]
    shell_faces = bank.shell_faces[shell_idx] + O * Vm
    spart = bank.shell_part[shell_idx]
    shell_class = torch.where(
        spart == 0, WALL_RC, torch.where(spart == 1, FLOOR_RC, CEIL_RC))
    Fs = shell_faces.shape[0]
    # the inverse face index, offset like the faces; padding -> the zero
    # slot past the last corner
    Fm = mfaces.shape[2]
    n_slots = (O * Fm + Fs) * 3
    obj_slots = bank.vert_slots[model_idx]                       # (B,O,Vm,W)
    obj_slots = torch.where(
        obj_slots >= 0, obj_slots + (torch.arange(O, device=objs.device)
                                     * Fm * 3)[None, :, None, None],
        n_slots)
    shell_slots = bank.shell_vert_slots[shell_idx]
    shell_slots = torch.where(shell_slots >= 0, shell_slots + O * Fm * 3,
                              n_slots)
    vert_slots = torch.cat([
        obj_slots.reshape(B, O * Vm, -1),
        shell_slots[None].expand(B, *shell_slots.shape)], 1)
    verts = torch.cat([world.reshape(B, -1, 3), shell_world], 1)
    faces = torch.cat([faces_global.reshape(B, O * Fm, 3),
                       shell_faces[None].expand(B, Fs, 3)], 1)
    fclass = torch.cat([face_class.reshape(B, O * Fm),
                        shell_class[None].expand(B, Fs)], 1)
    fvalid = torch.cat([face_valid.reshape(B, O * Fm),
                        bank.shell_fvalid[shell_idx][None].expand(B, Fs)], 1)
    return SceneBuffers(verts=verts, faces=faces, face_class=fclass,
                        face_valid=fvalid, vert_slots=vert_slots)


class GatherCorners(torch.autograd.Function):
    """x (B, V, D) at the face corners: (B, N, D), N = F * 3, as
    torch.gather. Its backward sums each vertex's corner gradients through
    the inverse index `slots` (vertex_slots) in a fixed order: torch.gather's
    own backward is a scatter_add, which on the card adds the corners of
    a shared vertex with atomics in no fixed order."""

    @staticmethod
    def forward(ctx, x, corners, slots):
        ctx.save_for_backward(slots)
        B, N = corners.shape
        return torch.gather(x, 1, corners[..., None].expand(B, N,
                                                            x.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        B, V, W = slots.shape
        D = g.shape[-1]
        padded = torch.cat([g, g.new_zeros(B, 1, D)], 1)    # the zero slot
        per_slot = torch.gather(padded, 1, slots.reshape(B, V * W, 1)
                                .expand(B, V * W, D))
        return per_slot.reshape(B, V, W, D).sum(2), None, None


def scene_geometry(scene: SceneBuffers, room_dims: torch.Tensor,
                   cfg: RenderConfig) -> FaceGeometry:
    """Project, near-cull (diff_render.py:345-357) and build the per-face
    screen-space constants."""
    cam = cam_lib.camera_from_room(room_dims, cfg.camera)
    v2d_all, z_all = cam_lib.project(cam_lib.to_camera(scene.verts, cam),
                                     cam)
    B, Fn, _ = scene.faces.shape
    tri = GatherCorners.apply(torch.cat([v2d_all, z_all[..., None]], -1),
                              scene.faces.reshape(B, Fn * 3),
                              scene.vert_slots).reshape(B, Fn, 3, 3)
    tri_v2d, tri_z = tri[..., :2], tri[..., 2]
    culled = (tri_z < cfg.camera.cull_eps).any(-1)
    return face_geometry(tri_v2d, tri_z, scene.face_valid & ~culled,
                         scene.face_class, near=cfg.camera.near)


def render_channels(scene: SceneBuffers, room_dims: torch.Tensor,
                    cfg: RenderConfig, bank: DeviceBank) -> torch.Tensor:
    """Rasterize and build the (B, 1 + 40 + 29, S, S) stack of
    diff_render.py:366-434."""
    with trace.span("sln.render.geometry"):
        geom = scene_geometry(scene, room_dims, cfg)
    depth, classes = soft_rasterize_cuda(
        geom, NUM_RENDER_CLASSES, cfg.camera.image_size,
        sigma=cfg.sigma_px, gamma=cfg.gamma, z_far=cfg.z_far)
    with trace.span("sln.render.channels"):
        return _channel_stack(depth, classes, cfg, bank)


def _channel_stack(depth, classes, cfg: RenderConfig, bank: DeviceBank
                   ) -> torch.Tensor:
    """The rasterizer's depth (B, S, S) and classes (B, S, S, 32) -> the
    (B, 70, S, S) stack."""
    classes = classes.permute(0, 3, 1, 2)                        # (B,32,S,S)

    # depth channel: infinity -> -1 (diff_render.py:367)
    depth_out = torch.where(depth > cfg.camera.depth_clip, -1.0, depth)
    nyu_masks = torch.einsum("bchw,cn->bnhw", classes, bank.rc_to_nyu)

    # per-class depth channels (diff_render.py:400-425)
    hard = classes.detach() > 0.1                                # (B,32,S,S)
    wall_mask = hard[:, WALL_RC]
    d_det = depth.detach()
    wall_max = torch.where(wall_mask, d_det, float("-inf")).amax((1, 2))
    wall_max = torch.where(wall_mask.any(2).any(1), wall_max, 10.0)  # (B,)

    counts = hard.sum((2, 3))                                    # (B, 32)
    sums = torch.where(hard, depth[:, None], 0.0).sum((2, 3))
    means = torch.where(counts > 0, sums / counts.clamp(min=1),
                        wall_max[:, None])
    per_class_depth = (torch.where(hard, depth[:, None],
                                   means[..., None, None])
                       / wall_max[:, None, None, None])
    depth_channels = per_class_depth[:, bank.depth_sel]          # (B,29,S,S)
    return torch.cat([depth_out[:, None], nyu_masks, depth_channels], 1)


def render_layout(objs, boxes, angles, obj_mask, model_idx,
                  bank: DeviceBank, cfg: RenderConfig,
                  shell_idx: int = 0) -> torch.Tensor:
    """Batched end-to-end: assemble + rasterize + channel stack.
    Returns (B, 70, S, S)."""
    with trace.span("sln.render.layout"):
        with trace.span("sln.render.assemble"):
            scene = assemble_scene(objs, boxes, angles, obj_mask, model_idx,
                                   bank, shell_idx)
            room_dims = room_dims_of(objs, boxes, obj_mask)
        return render_channels(scene, room_dims, cfg, bank)
