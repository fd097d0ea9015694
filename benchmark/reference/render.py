"""Plain PyTorch scene render of 3D-SLN's differentiable renderer
(aluo-x/3D_SLN models/diff_render.py), the reference the benchmark holds
the measured package's render against.

The procedural mesh bank and room shell, the aspect-ratio retrieval, the
scene assembly, the camera, and a dense soft rasterizer: every pixel
against every face, in blocks of pixels, each block recomputed in the
backward pass (torch.utils.checkpoint) so that a batch at 256 px fits.
Its backward is autograd's. Imports nothing of the measured package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.traffic.scenes import OBJECT_IDX_TO_NAME

DO_NOT_RENDER = ("wall", "ceiling", "floor", "person", "door", "window",
                 "curtain", "blinds")
NYU40 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "night stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop")
_all = sorted(set(OBJECT_IDX_TO_NAME[1:]) | {"ceiling"})
RENDER_CLASSES = ("wall",) + tuple(c for c in _all if c != "wall")
DEPTH_CLASSES = tuple(c for c in RENDER_CLASSES
                      if c not in ("wall", "floor", "ceiling"))
NUM_CLASSES = len(RENDER_CLASSES)                       # 32
WALL, FLOOR, CEIL = (RENDER_CLASSES.index(c)
                     for c in ("wall", "floor", "ceiling"))
OBJ_CLASS = np.array([0 if n == "__room__" else RENDER_CLASSES.index(n)
                      for n in OBJECT_IDX_TO_NAME])
OBJ_RENDERABLE = np.array([n != "__room__" and n not in DO_NOT_RENDER
                           for n in OBJECT_IDX_TO_NAME])
RC_TO_NYU = np.zeros((NUM_CLASSES, 40), np.float32)
for _rc, _c in enumerate(RENDER_CLASSES):
    RC_TO_NYU[_rc, NYU40.index(_c.replace("_", " "))] = 1.0
DEPTH_SEL = [RENDER_CLASSES.index(c) for c in DEPTH_CLASSES]
_RATIOS = [(1.0, 1.0), (0.45, 0.9), (1.8, 0.55), (0.8, 1.6)]


class Bank(NamedTuple):
    """Mesh bank and room shell, numpy, field for field what the measured
    package's device_bank reads (verts, faces, face_valid, bbox_min,
    bbox_max, model_class)."""
    verts: np.ndarray
    faces: np.ndarray
    face_valid: np.ndarray
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    model_class: np.ndarray


class Shells(NamedTuple):
    verts: np.ndarray        # (1, Vs, 3) in [0, 1]^3
    faces: np.ndarray        # (1, Fs, 3)
    part: np.ndarray         # (1, Fs) 0 wall, 1 floor, 2 ceiling
    face_valid: np.ndarray
    ratio: np.ndarray


def _quads(s: int, sides) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    grid = np.linspace(0.0, 1.0, s + 1)
    uu, vv = np.meshgrid(grid, grid, indexing="ij")
    verts, faces, part = [], [], []
    for origin, du, dv, pid in sides:
        off = len(verts)
        for u, v in zip(uu.reshape(-1), vv.reshape(-1)):
            verts.append(np.asarray(origin, np.float64) + u * np.asarray(du)
                         + v * np.asarray(dv))
        for i in range(s):
            for j in range(s):
                a = off + i * (s + 1) + j
                faces += [[a, a + 1, a + s + 2], [a, a + s + 2, a + s + 1]]
                part += [pid, pid]
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int64),
            np.asarray(part, np.int64))


def mesh_bank(subdiv: int = 2) -> Bank:
    """Per renderable class, four subdivided boxes of distinct aspect
    ratios."""
    v, f, _ = _quads(subdiv, [
        ([0, 0, 0], [1, 0, 0], [0, 1, 0], 0), ([0, 0, 1], [1, 0, 0], [0, 1, 0], 0),
        ([0, 0, 0], [1, 0, 0], [0, 0, 1], 0), ([0, 1, 0], [1, 0, 0], [0, 0, 1], 0),
        ([0, 0, 0], [0, 1, 0], [0, 0, 1], 0), ([1, 0, 0], [0, 1, 0], [0, 0, 1], 0)])
    vs, bmax, cls = [], [], []
    for idx, name in enumerate(OBJECT_IDX_TO_NAME):
        if name == "__room__" or name in DO_NOT_RENDER:
            continue
        for hr, dr in _RATIOS:
            size = np.array([1.0, hr, dr], np.float32)
            vs.append(v * size)
            bmax.append(size)
            cls.append(idx)
    M = len(vs)
    return Bank(verts=np.stack(vs), faces=np.repeat(f[None], M, 0),
                face_valid=np.ones((M, len(f)), bool),
                bbox_min=np.zeros((M, 3), np.float32),
                bbox_max=np.stack(bmax), model_class=np.asarray(cls))


def room_shells(subdiv: int = 4) -> Shells:
    """Floor, ceiling and the back, left and right walls of the unit room
    (the near wall, where the camera stands, left out)."""
    v, f, p = _quads(subdiv, [
        ([0, 0, 0], [1, 0, 0], [0, 0, 1], 1), ([0, 1, 0], [1, 0, 0], [0, 0, 1], 2),
        ([0, 0, 0], [1, 0, 0], [0, 1, 0], 0), ([0, 0, 0], [0, 0, 1], [0, 1, 0], 0),
        ([1, 0, 0], [0, 0, 1], [0, 1, 0], 0)])
    return Shells(verts=v[None], faces=f[None], part=p[None],
                  face_valid=np.ones((1, len(f)), bool),
                  ratio=np.ones((1, 2), np.float32))


def retrieve(objs: np.ndarray, boxes_abs: np.ndarray, bank: Bank
             ) -> np.ndarray:
    """Per object, the bank entry of its class nearest in aspect ratio
    ((h/w, d/w), L1); 0 for a class with no entry."""
    boxes_abs = np.asarray(boxes_abs, np.float32)
    size = boxes_abs[..., 3:] - boxes_abs[..., :3]
    dx = np.maximum(size[..., 0], np.float32(1e-6))
    ratio = np.stack([size[..., 1] / dx, size[..., 2] / dx], -1)
    msize = bank.bbox_max - bank.bbox_min
    mdx = np.maximum(msize[:, 0], np.float32(1e-6))
    mratio = np.stack([msize[:, 1] / mdx, msize[:, 2] / mdx], -1)
    dist = np.abs(ratio[..., None, :] - mratio).sum(-1)
    same = np.asarray(objs)[..., None] == bank.model_class
    dist = np.where(same, dist, np.inf)
    return np.where(same.any(-1), dist.argmin(-1), 0).astype(np.int64)


class Camera(NamedTuple):
    image_size: int = 256
    focal_pix: float = 400.0
    sensor_size: int = 1024
    pitch: float = -0.4
    height_offset_cap: float = 0.1
    near: float = 0.001
    depth_clip: float = 15.0
    cull_eps: float = 0.06
    sigma: float = 0.5
    gamma: float = 0.02
    z_far: float = 100.0


def project(verts: torch.Tensor, room_dims: torch.Tensor, cam: Camera):
    """(B, V, 3) world -> ((B, V, 2) pixel [col, row], (B, V) depth): the
    camera at the room's mid-x on the near wall, pitched down."""
    c, s = math.cos(cam.pitch), math.sin(cam.pitch)
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, -c, -s], [0.0, s, -c]],
                       device=verts.device)
    X, Y, Z = room_dims.unbind(-1)
    pos = torch.stack([X / 2, Y / 2 + (Y / 2).abs().clamp(
        max=cam.height_offset_cap), Z], -1)
    vc = (verts - pos[:, None]) @ rot.T
    f = cam.focal_pix * cam.image_size / cam.sensor_size
    z = vc[..., 2]
    zc = z.clamp(min=1e-6)
    uv = torch.stack([f * vc[..., 0] / zc, f * vc[..., 1] / zc], -1)
    return uv + cam.image_size / 2.0, z


def assemble(objs, boxes, angles, obj_mask, model_idx, bank: Bank,
             shells: Shells):
    """World-space triangles of a batch of scenes: (tri (B, F, 3, 3),
    face_class (B, F), face_valid (B, F), room_dims (B, 3)). Objects
    first (slot by slot), then the room shell."""
    dev = boxes.device
    B, O = objs.shape
    room = (objs == 0) & obj_mask
    dims = (boxes * room[..., None]).sum(1)[..., 3:]
    absb = boxes * torch.cat([dims, dims], -1)[:, None]
    center = (absb[..., :3] + absb[..., 3:]) / 2
    size = absb[..., 3:] - absb[..., :3]
    bv = torch.as_tensor(bank.verts, device=dev)[model_idx]
    bmin = torch.as_tensor(bank.bbox_min, device=dev)[model_idx]
    bmax = torch.as_tensor(bank.bbox_max, device=dev)[model_idx]
    scale = (size / (bmax - bmin).clamp(min=1e-6)).amin(-1)
    theta = -angles.to(torch.get_default_dtype()) * (2 * math.pi / 24)
    cos, sin = torch.cos(theta), torch.sin(theta)
    local = bv - ((bmin + bmax) / 2)[..., None, :]
    x, y, z = local.unbind(-1)
    rot = torch.stack([cos[..., None] * x + sin[..., None] * z, y,
                       -sin[..., None] * x + cos[..., None] * z], -1)
    world = scale[..., None, None] * rot + center[..., None, :]
    faces = torch.as_tensor(bank.faces, device=dev)[model_idx]
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    oidx = torch.arange(O, device=dev)[None, :, None, None]
    tri_o = world[bidx, oidx, faces]                       # (B, O, Fm, 3, 3)
    renderable = (torch.as_tensor(OBJ_RENDERABLE, device=dev)[objs]
                  & obj_mask & ~room)
    valid_o = (torch.as_tensor(bank.face_valid, device=dev)[model_idx]
               & renderable[..., None])
    cls_o = torch.as_tensor(OBJ_CLASS, device=dev)[objs][..., None].expand(
        valid_o.shape)
    sv = torch.as_tensor(shells.verts[0], device=dev)
    sf = torch.as_tensor(shells.faces[0], device=dev)
    tri_s = sv[sf][None] * dims[:, None, None, :]         # (B, Fs, 3, 3)
    part = torch.as_tensor(shells.part[0], device=dev)
    cls_s = torch.where(part == 0, WALL, torch.where(part == 1, FLOOR,
                                                     CEIL))
    Fs = sf.shape[0]
    tri = torch.cat([tri_o.reshape(B, -1, 3, 3), tri_s], 1)
    fcls = torch.cat([cls_o.reshape(B, -1), cls_s[None].expand(B, Fs)], 1)
    fvalid = torch.cat([valid_o.reshape(B, -1), torch.as_tensor(
        shells.face_valid[0], device=dev)[None].expand(B, Fs)], 1)
    return tri, fcls, fvalid, dims


def face_terms(tri, fvalid, dims, cam: Camera):
    """Per-face screen constants: (nx, ny, c, inv_len*sign, inv_z, valid),
    faces with a vertex within cull_eps of the camera plane, degenerate
    or behind the camera made invalid."""
    B, Fn = fvalid.shape
    v2d, z = project(tri.reshape(B, Fn * 3, 3), dims, cam)
    v2d, z = v2d.reshape(B, Fn, 3, 2), z.reshape(B, Fn, 3)
    a, b = v2d, torch.roll(v2d, -1, dims=-2)
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    c = dy * a[..., 0] - dx * a[..., 1]
    length = torch.sqrt((dx * dx + dy * dy).clamp(min=1e-12))
    area2 = (dx[..., 0] * (v2d[..., 2, 1] - v2d[..., 0, 1])
             - dy[..., 0] * (v2d[..., 2, 0] - v2d[..., 0, 0]))
    sign = torch.where(area2 >= 0, 1.0, -1.0)
    valid = (fvalid & ~(z < cam.cull_eps).any(-1) & ~(area2.abs() < 1e-9)
             & ~(z <= cam.near).any(-1))
    return (-dy, dx, c, sign[..., None] / length, 1.0 / z.clamp(
        min=cam.near), valid)


def _block(px, py, nx, ny, c, il, iz, valid, onehot, sigma, gamma, z_far):
    """One scene's pixels (P,) against all its faces: (depth (P,),
    classes (P, C))."""
    e = nx * px[:, None, None] + ny * py[:, None, None] + c     # (P, F, 3)
    d = (e * il).amin(-1)
    lam = torch.roll(e, -1, dims=-1)
    lsum = lam.sum(-1, keepdim=True)
    lam = lam / torch.where(lsum.abs() > 1e-12, lsum, torch.ones_like(lsum))
    lam = lam.clamp(0.0, 1.0)
    lam = lam / lam.sum(-1, keepdim=True).clamp(min=1e-12)
    zbuf = 1.0 / (lam * iz).sum(-1).clamp(min=1e-12)
    dd = d * (1.0 + F.relu(-d)) / sigma
    logit = torch.where(valid, F.logsigmoid(dd) - zbuf / gamma,
                        torch.full_like(dd, -1e30))
    w = torch.softmax(logit, -1)
    alpha = 1.0 - torch.exp(torch.where(valid, F.logsigmoid(-dd),
                                        torch.zeros_like(dd)).sum(-1))
    depth = alpha * (w * zbuf).sum(-1) + (1.0 - alpha) * z_far
    return depth, alpha[:, None] * (w @ onehot)


def rasterize(terms, fcls, cam: Camera, block: int = 8192):
    """Dense soft rasterizer: (depth (B, S, S), classes (B, S, S, C))."""
    nx, ny, c, il, iz, valid = terms
    S = cam.image_size
    dev = nx.device
    r = torch.arange(S, dtype=nx.dtype, device=dev) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    depths, classes = [], []
    for bi in range(nx.shape[0]):
        onehot = F.one_hot(fcls[bi], NUM_CLASSES).to(nx.dtype)
        args = (nx[bi], ny[bi], c[bi], il[bi], iz[bi], valid[bi], onehot,
                cam.sigma, cam.gamma, cam.z_far)
        parts = [checkpoint(_block, px[i:i + block], py[i:i + block], *args,
                            use_reentrant=False)
                 if torch.is_grad_enabled() else
                 _block(px[i:i + block], py[i:i + block], *args)
                 for i in range(0, S * S, block)]
        depths.append(torch.cat([p[0] for p in parts]).reshape(S, S))
        classes.append(torch.cat([p[1] for p in parts]).reshape(S, S, -1))
    return torch.stack(depths), torch.stack(classes)


def channels(depth, classes, cam: Camera):
    """The 70-channel stack: depth (background -1), 40 NYU class masks, 29
    per-class depth channels over the wall's farthest depth."""
    cls = classes.permute(0, 3, 1, 2)
    depth_out = torch.where(depth > cam.depth_clip, -1.0, depth)
    nyu = torch.einsum("bchw,cn->bnhw", cls,
                       torch.as_tensor(RC_TO_NYU, device=depth.device,
                                       dtype=cls.dtype))
    hard = cls.detach() > 0.1
    wall = hard[:, WALL]
    wall_max = torch.where(wall, depth.detach(), float("-inf")).amax((1, 2))
    wall_max = torch.where(wall.any(2).any(1), wall_max, 10.0)
    counts = hard.sum((2, 3))
    sums = torch.where(hard, depth[:, None], 0.0).sum((2, 3))
    means = torch.where(counts > 0, sums / counts.clamp(min=1),
                        wall_max[:, None])
    per = (torch.where(hard, depth[:, None], means[..., None, None])
           / wall_max[:, None, None, None])
    return torch.cat([depth_out[:, None], nyu, per[:, DEPTH_SEL]], 1)


def render(objs, boxes, angles, obj_mask, model_idx, bank: Bank,
           shells: Shells, cam: Camera) -> torch.Tensor:
    """(B, 70, S, S) render stacks of a batch of scenes."""
    tri, fcls, fvalid, dims = assemble(objs, boxes, angles, obj_mask,
                                       model_idx, bank, shells)
    terms = face_terms(tri, fvalid, dims, cam)
    return channels(*rasterize(terms, fcls, cam), cam)
