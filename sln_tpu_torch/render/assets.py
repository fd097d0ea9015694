"""Procedural mesh asset bank + aspect-ratio retrieval (numpy copy of
sln_tpu/render/assets.py).

The reference retrieves SUNCG meshes per object by closest bbox aspect
ratio (models/misc.py:34-64 over metadata/suncg_data_many.json), loads
.obj files with PyWavefront, and remeshes them with PyMesh's C++
split_long_edges (models/misc.py:66-80). SUNCG assets are not
redistributable, so this module provides:

* a procedural bank: per class, several subdivided-box variants with
  distinct aspect ratios (the subdivision plays the role of the remesher —
  small triangles so near-plane culling and per-face class masks behave);
* the same argmin-aspect-ratio retrieval, vectorized over the whole bank
  (numpy, once per room on the host);
* room-shell generation (walls/floor/ceiling) sized exactly to the room
  box, standing in for the reference's retrieved SUNCG room shells
  (models/misc.py:123-191) — the near wall is dropped like the reference's
  bad-wall heuristics (models/diff_render.py:200-213).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from sln_tpu_torch.data.vocab import DO_NOT_RENDER, OBJECT_IDX_TO_NAME


class MeshBank(NamedTuple):
    """Padded model bank (numpy on host, moved to device once)."""
    verts: np.ndarray       # (M, Vm, 3) in model-local coords
    faces: np.ndarray       # (M, Fm, 3) int32, padded with 0
    face_valid: np.ndarray  # (M, Fm) bool
    bbox_min: np.ndarray    # (M, 3)
    bbox_max: np.ndarray    # (M, 3)
    model_class: np.ndarray  # (M,) int32 object-class id
    vm: int
    fm: int


def subdivided_box(subdiv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit box [0,1]^3 with each side split into subdiv x subdiv quads.

    Returns (verts (6*(s+1)^2, 3), faces (12*s^2, 3)). Vertices are not
    welded across faces (irrelevant for rasterization).
    """
    s = subdiv
    verts, faces = [], []
    grid = np.linspace(0.0, 1.0, s + 1)
    uu, vv = np.meshgrid(grid, grid, indexing="ij")
    flat_u, flat_v = uu.reshape(-1), vv.reshape(-1)

    def add_side(origin, du, dv):
        offset = len(verts)
        for u, v in zip(flat_u, flat_v):
            verts.append(np.asarray(origin) + u * np.asarray(du)
                         + v * np.asarray(dv))
        for i in range(s):
            for j in range(s):
                a = offset + i * (s + 1) + j
                b = a + 1
                c = a + (s + 1)
                d = c + 1
                faces.append([a, b, d])
                faces.append([a, d, c])

    add_side([0, 0, 0], [1, 0, 0], [0, 1, 0])   # z=0
    add_side([0, 0, 1], [1, 0, 0], [0, 1, 0])   # z=1
    add_side([0, 0, 0], [1, 0, 0], [0, 0, 1])   # y=0
    add_side([0, 1, 0], [1, 0, 0], [0, 0, 1])   # y=1
    add_side([0, 0, 0], [0, 1, 0], [0, 0, 1])   # x=0
    add_side([1, 0, 0], [0, 1, 0], [0, 0, 1])   # x=1
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


# aspect-ratio variants (h/w, d/w) per model slot
_VARIANT_RATIOS = [(1.0, 1.0), (0.45, 0.9), (1.8, 0.55), (0.8, 1.6)]


def build_procedural_bank(subdiv: int = 2) -> MeshBank:
    """One bank entry per (renderable class, variant)."""
    base_v, base_f = subdivided_box(subdiv)
    vm, fm = len(base_v), len(base_f)
    entries_v, entries_f, entries_fv = [], [], []
    bb_min, bb_max, cls = [], [], []
    for idx, name in enumerate(OBJECT_IDX_TO_NAME):
        if name == "__room__" or name in DO_NOT_RENDER:
            continue
        for (hr, dr) in _VARIANT_RATIOS:
            size = np.array([1.0, hr, dr], np.float32)
            v = base_v * size
            entries_v.append(v)
            entries_f.append(base_f)
            entries_fv.append(np.ones(fm, bool))
            bb_min.append(np.zeros(3, np.float32))
            bb_max.append(size)
            cls.append(idx)
    return MeshBank(
        verts=np.stack(entries_v), faces=np.stack(entries_f),
        face_valid=np.stack(entries_fv),
        bbox_min=np.stack(bb_min), bbox_max=np.stack(bb_max),
        model_class=np.asarray(cls, np.int32), vm=vm, fm=fm)


def retrieve_models(objs: np.ndarray, boxes_abs: np.ndarray,
                    bank: MeshBank) -> np.ndarray:
    """Per-object argmin aspect-ratio retrieval (models/misc.py:34-64).

    objs: (..., O) class ids; boxes_abs: (..., O, 6) denormalized boxes,
    numpy on the host (retrieval runs once per room, before the loop).
    Returns (..., O) int64 bank indices (model 0 for classes with no bank
    entry, e.g. structural ones).
    """
    objs = np.asarray(objs)
    boxes_abs = np.asarray(boxes_abs, np.float32)
    size = boxes_abs[..., 3:] - boxes_abs[..., :3]              # (..., O, 3)
    dx = np.maximum(size[..., 0], np.float32(1e-6))
    ratio = np.stack([size[..., 1] / dx, size[..., 2] / dx], -1)

    msize = bank.bbox_max - bank.bbox_min                       # (M, 3)
    mdx = np.maximum(msize[:, 0], np.float32(1e-6))
    mratio = np.stack([msize[:, 1] / mdx, msize[:, 2] / mdx],
                      -1).astype(np.float32)                    # (M, 2)

    dist = np.abs(ratio[..., None, :] - mratio).sum(-1)         # (..., O, M)
    same_class = objs[..., None] == bank.model_class
    dist = np.where(same_class, dist, np.inf)
    has_any = same_class.any(-1)
    return np.where(has_any, dist.argmin(-1), 0).astype(np.int64)


class ShellBank(NamedTuple):
    """Bank of room shells (wall/floor/ceiling meshes), normalized to the
    unit cube so one entry serves every room size.

    The reference retrieves real SUNCG shells per room by aspect ratio
    (models/misc.py:123-191) and deletes occluding wall vertices per room
    (diff_render.py:200-213). A banked shell is unit-normalized when the
    bank is built, with the bad-wall drop baked into face_valid
    (`shell_wall_drop_normalized`), and retrieval is an argmin over the
    stored original aspect ratios (`retrieve_shell_np`). Entry 0 is the
    procedural exact-fit shell; a bank of real shells is built by
    tools/build_asset_bank.py and read from its .npz
    (render/blender/scene_spec.py `load_bank`)."""
    verts: np.ndarray        # (S, Vs, 3) in [0, 1]^3
    faces: np.ndarray        # (S, Fs, 3) int32, padded with 0
    part: np.ndarray         # (S, Fs) 0=wall 1=floor 2=ceiling
    face_valid: np.ndarray   # (S, Fs) bool (bad-wall drops applied)
    ratio: np.ndarray        # (S, 2) original (Y/X, Z/X) bbox ratios


def procedural_shell_bank(subdiv: int = 4) -> ShellBank:
    """S=1 bank holding the exact-fit procedural shell."""
    sv, sf, sp = room_shell(subdiv)
    return ShellBank(
        verts=sv[None], faces=sf[None], part=sp[None],
        face_valid=np.ones((1, len(sf)), bool),
        ratio=np.asarray([[1.0, 1.0]], np.float32))


def retrieve_shell_np(room_dims, shells: ShellBank) -> int:
    """Argmin aspect-ratio shell retrieval (reference wall_retrieve,
    render_room_color.py:55-68: ratio = (Y/X, Z/X), L1 distance)."""
    dims = np.asarray(room_dims, np.float64)
    target = np.array([dims[1] / max(dims[0], 1e-6),
                       dims[2] / max(dims[0], 1e-6)])
    dist = np.abs(np.asarray(shells.ratio, np.float64)
                  - target[None]).sum(-1)
    return int(np.argmin(dist))


def shell_wall_drop_normalized(verts: np.ndarray, part_of_vert: np.ndarray
                               ) -> np.ndarray:
    """Bad-wall vertex-drop mask in unit-room coordinates (reference
    diff_render.py / render_room_color.py:271-298 heuristic with X=Z=1):
    drop wall vertices with z > 0.2 that sit inside 0.1 < x < 0.9; if
    >70% of wall vertices lie at z > 0.9 the whole wall plane faces the
    camera — drop all wall vertices."""
    v = np.asarray(verts, np.float64)
    is_wall = np.asarray(part_of_vert) == 0
    frontish = v[:, 2] > 0.2
    interior = (v[:, 0] > 0.1) & (v[:, 0] < 0.9)
    drop = is_wall & frontish & interior
    n_wall = max(int(is_wall.sum()), 1)
    score = float((is_wall & (v[:, 2] > 0.9)).sum()) / n_wall
    if score > 0.7:
        return is_wall.copy()
    return drop


def room_shell(subdiv: int = 4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unit room shell: floor, ceiling, back/left/right walls (near wall at
    z=1 dropped — the camera sits there, reference diff_render.py:200-213).

    Returns (verts (Vs, 3), faces (Fs, 3), part_id (Fs,)) with part ids
    0=wall, 1=floor, 2=ceiling, in [0,1]^3 to be scaled by room dims.
    """
    s = subdiv
    verts, faces, part = [], [], []
    grid = np.linspace(0.0, 1.0, s + 1)
    uu, vv = np.meshgrid(grid, grid, indexing="ij")
    flat_u, flat_v = uu.reshape(-1), vv.reshape(-1)

    def add_quad(origin, du, dv, pid):
        offset = len(verts)
        for u, v in zip(flat_u, flat_v):
            verts.append(np.asarray(origin, np.float64)
                         + u * np.asarray(du) + v * np.asarray(dv))
        for i in range(s):
            for j in range(s):
                a = offset + i * (s + 1) + j
                b = a + 1
                c = a + (s + 1)
                d = c + 1
                faces.append([a, b, d]); part.append(pid)
                faces.append([a, d, c]); part.append(pid)

    add_quad([0, 0, 0], [1, 0, 0], [0, 0, 1], 1)   # floor y=0
    add_quad([0, 1, 0], [1, 0, 0], [0, 0, 1], 2)   # ceiling y=1
    add_quad([0, 0, 0], [1, 0, 0], [0, 1, 0], 0)   # back wall z=0
    add_quad([0, 0, 0], [0, 0, 1], [0, 1, 0], 0)   # left wall x=0
    add_quad([1, 0, 0], [0, 0, 1], [0, 1, 0], 0)   # right wall x=1
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(part, np.int32))
