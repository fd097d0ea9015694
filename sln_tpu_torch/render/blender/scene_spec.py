"""Scene math for the Blender render scripts — pure numpy, no bpy (own
copy of sln_tpu/render/blender/scene_spec.py).

Everything the Blender-side scripts need that is NOT a bpy call lives
here so it can be unit-tested without a Blender binary: box
denormalization (reference render/render_room_color.py:151-171 semantics),
object/shell world transforms (:205-345), the bad-wall vertex-drop
heuristic (:271-298), the viewpoint sampling distribution and depth
acceptance rule (:346-383), mesh retrieval from the asset bank, and the
artifact-naming contract consumed by
sln_tpu_torch.workloads.gan_shade.spade_input_from_files, and the
preview renderer (render/preview.py) assembles its scenes here too.

This module is imported by Blender's bundled Python, which has no torch:
keep it and what it imports (the package __init__, data/vocab.py,
render/assets.py) numpy + stdlib only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sln_tpu_torch.data.vocab import (DO_NOT_RENDER, NYU40_CLASSES,
                                      OBJ_TO_NYU40, OBJECT_IDX_TO_NAME)
from sln_tpu_torch.render import assets

# objects the reference never imports into Blender
# (render/render_room_color.py:240: structural + person classes)
SKIP_IMPORT = DO_NOT_RENDER


# ---------------------------------------------------------------------------
# box denormalization
# ---------------------------------------------------------------------------
def denormalize_scene(boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """data_extracted.json boxes -> (absolute object boxes, room_dims).

    The last row is the room node holding absolute min/max; object rows
    are normalized to the room. Matches the reference's in-script denorm
    (render_room_color.py:151-165) plus its height snap: objects whose
    |y_min| <= 0.02 are pushed flush to the floor (:167-171).
    """
    boxes = np.asarray(boxes, np.float64).copy()
    room = boxes[-1]
    dims = room[3:] - room[:3]                      # (3,)
    out = boxes[:-1].copy()
    out[:, :3] *= dims[None]
    out[:, 3:] *= dims[None]
    snap = np.abs(out[:, 1]) <= 0.02
    out[snap, 4] -= out[snap, 1]
    out[snap, 1] = 0.0
    return out, dims


# ---------------------------------------------------------------------------
# asset bank (numpy-side)
# ---------------------------------------------------------------------------
def load_bank(bank_path: Optional[str] = None):
    """(MeshBank, ShellBank-or-None): procedural, or an .npz bank from
    tools/build_asset_bank.py (path argument or SLN_TPU_ASSET_BANK env
    var; shells present when the bank was built with --room_dir)."""
    path = bank_path or os.environ.get("SLN_TPU_ASSET_BANK", "")
    if path and os.path.isfile(path):
        d = np.load(path, allow_pickle=False)
        bank = assets.MeshBank(
            verts=d["verts"], faces=d["faces"], face_valid=d["face_valid"],
            bbox_min=d["bbox_min"], bbox_max=d["bbox_max"],
            model_class=d["model_class"], vm=int(d["vm"]), fm=int(d["fm"]))
        shells = None
        if "shell_verts" in d:
            shells = assets.ShellBank(
                verts=d["shell_verts"], faces=d["shell_faces"],
                part=d["shell_part"], face_valid=d["shell_face_valid"],
                ratio=d["shell_ratio"])
        return bank, shells
    return assets.build_procedural_bank(subdiv=1), None


def retrieve_models_np(objs: np.ndarray, boxes_abs: np.ndarray,
                       bank) -> np.ndarray:
    """Numpy twin of assets.retrieve_models (argmin aspect-ratio distance
    over same-class bank entries, reference models/misc.py:34-64)."""
    objs = np.asarray(objs)
    size = boxes_abs[:, 3:] - boxes_abs[:, :3]
    dx = np.maximum(size[:, 0], 1e-6)
    ratio = np.stack([size[:, 1] / dx, size[:, 2] / dx], -1)     # (O, 2)
    msize = bank.bbox_max - bank.bbox_min
    mdx = np.maximum(msize[:, 0], 1e-6)
    mratio = np.stack([msize[:, 1] / mdx, msize[:, 2] / mdx], -1)
    dist = np.abs(ratio[:, None] - mratio[None]).sum(-1)          # (O, M)
    same = objs[:, None] == np.asarray(bank.model_class)[None]
    dist = np.where(same, dist, np.inf)
    has = same.any(axis=1)
    return np.where(has, np.argmin(dist, axis=1), 0).astype(np.int32)


# ---------------------------------------------------------------------------
# world transforms
# ---------------------------------------------------------------------------
def object_world_matrix(box: np.ndarray, angle: float,
                        model_bbox_min: np.ndarray,
                        model_bbox_max: np.ndarray) -> np.ndarray:
    """4x4 world matrix placing a bank mesh into an absolute box.

    Reference semantics (render_room_color.py:205-228): uniform scale =
    min per-axis ratio; rotation about +y by theta = angle * 2pi/24; the
    object's y-center drops by half the slack so it rests on the box
    bottom; translation aligns the scaled/rotated model center with the
    (adjusted) box center.
    """
    bmin = np.asarray(box[:3], np.float64)
    bmax = np.asarray(box[3:], np.float64)
    center = (bmin + bmax) / 2.0
    size = bmax - bmin
    msize = np.asarray(model_bbox_max, np.float64) - np.asarray(
        model_bbox_min, np.float64)
    msize = np.maximum(msize, 1e-9)
    mcenter = (np.asarray(model_bbox_min, np.float64)
               + np.asarray(model_bbox_max, np.float64)) / 2.0
    scale = float(np.min(size / msize))
    theta = float(angle) * (2.0 * np.pi / 24.0)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    center = center.copy()
    center[1] -= (size[1] - scale * msize[1]) / 2.0
    trans = center - scale * rot @ mcenter
    m = np.eye(4)
    m[:3, :3] = scale * rot
    m[:3, 3] = trans
    return m


def shell_world_matrix(room_dims: np.ndarray, part: str,
                       model_bbox_min: np.ndarray,
                       model_bbox_max: np.ndarray) -> np.ndarray:
    """4x4 matrix placing a retrieved wall/floor/ceiling mesh.

    Reference semantics (render_room_color.py:260-345): walls scale by
    the MAX axis ratio so they always enclose the room; floors/ceilings
    scale in xz only and sit at y=0 / y=H with half their own scaled
    thickness outside the room.
    """
    dims = np.asarray(room_dims, np.float64)
    mmin = np.asarray(model_bbox_min, np.float64)
    mmax = np.asarray(model_bbox_max, np.float64)
    msize = np.maximum(mmax - mmin, 1e-9)
    mcenter = (mmin + mmax) / 2.0
    center = dims / 2.0
    if part == "wall":
        scale = float(np.max(dims / msize))
    else:
        scale = float(np.max([dims[0] / msize[0], dims[2] / msize[2]]))
        if part == "floor":
            center[1] = -0.5 * scale * msize[1]
        elif part == "ceiling":
            center[1] = 0.5 * scale * msize[1] + dims[1]
        else:
            raise ValueError(part)
    trans = center - scale * mcenter
    m = np.eye(4)
    m[:3, :3] = scale * np.eye(3)
    m[:3, 3] = trans
    return m


def wall_vertex_drop(world_verts: np.ndarray,
                     room_dims: np.ndarray) -> np.ndarray:
    """Bad-wall heuristic: bool mask of wall vertices to DELETE.

    Reference (render_room_color.py:271-298): delete vertices with
    z > 0.2*Z that sit inside 0.1*X < x < 0.9*X (front + interior walls
    would occlude the camera, which looks in from z = Z + 0.4); if >70%
    of the mesh's vertices lie at z > 0.9*Z the whole mesh is a front
    wall — delete everything.
    """
    v = np.asarray(world_verts, np.float64)
    X, _, Z = np.asarray(room_dims, np.float64)
    frontish = v[:, 2] > 0.2 * Z
    interior = (v[:, 0] > 0.1 * X) & (v[:, 0] < 0.9 * X)
    drop = frontish & interior
    score = float((v[:, 2] > 0.9 * Z).sum()) / max(len(v), 1)
    if score > 0.7:
        return np.ones(len(v), bool)
    return drop


# ---------------------------------------------------------------------------
# viewpoint sampling
# ---------------------------------------------------------------------------
F_MM = 50.0
SENSOR_MM = 50.0
NUM_VIEW_SAMPLES = 5          # render_room_color.py:351
MIN_MEAN_DEPTH = 0.7          # :377


def sample_camera(rng: np.random.Generator, room_dims: np.ndarray
                  ) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """One camera draw from the reference distribution
    (render_room_color.py:354-361): position slides along the near wall
    at 90% room height, 0.4 outside the room; pitch points at the far
    floor with f/sensor correction and up to 0.1 rad of jitter; yaw turns
    toward the room center, overdriven 1.1x.

    Returns (xyz, rot_vec_rad) with rotation = (-pitch, yaw, 0) Euler.
    """
    dims = np.asarray(room_dims, np.float64)
    t = 0.2 + 0.6 * rng.random()
    xyz = np.array([t * dims[0], 0.9 * dims[1], dims[2] + 0.4])
    pitch = (np.pi / 2 - np.arctan(0.4 / (0.9 * dims[1]))
             - np.arctan(25.0 / F_MM))
    pitch -= rng.random() * 0.1
    yaw = np.arctan((xyz[0] - 0.5 * dims[0]) / xyz[2]) * 1.1
    return xyz, (-pitch, yaw, 0.0)


def accept_view(zbuffer: np.ndarray, invalid_above: float = 1e5) -> bool:
    """Mean finite z-buffer depth must exceed MIN_MEAN_DEPTH
    (render_room_color.py:366-378) — rejects cameras staring into a
    nearby wall/object."""
    z = np.asarray(zbuffer, np.float64).ravel()
    valid = z[np.isfinite(z) & (z < invalid_above)]
    if valid.size == 0:
        return False
    return float(valid.mean()) > MIN_MEAN_DEPTH


# ---------------------------------------------------------------------------
# artifact naming (the contract gan_shade.spade_input_from_files parses)
# ---------------------------------------------------------------------------
def pred_name(room_id: str, k: int) -> str:
    """Base name for predicted-layout artifacts:
    `<room>_pred_<kk>` (reference semantic_depth_caller.py:46)."""
    return f"{room_id}_pred_{str(k).zfill(2)}"


def color_filename(room_id: str, k: int) -> str:
    """`<room>_pred_<kk>_3d.png` (reference render_caller.py:41)."""
    return pred_name(room_id, k) + "_3d.png"


def depth_filename(name: str) -> str:
    return name + "_depth.exr"


def orig_filename(name: str) -> str:
    return name + "_orig.png"


def mask_filename(name: str, class_name: str) -> str:
    """Per-class mask: `<name>_<class>.png` with spaces underscored so
    spade_input_from_files' `"_".join(parts[3:])` parse recovers the
    NYU-40 class."""
    return f"{name}_{class_name.replace(' ', '_')}.png"


def mask_classes_for(objs: List[int]) -> List[str]:
    """NYU-40 class names to render masks for: every NYU class the
    scene's renderable objects map to, plus the structural trio
    (reference render_semantic_depth.py:440-447 renders the full class
    list + ceiling/floor/wall; rendering only present classes is
    equivalent — absent classes load as empty masks)."""
    names = set()
    for o in objs:
        o = int(o)
        if o == 0:
            continue
        cls = OBJECT_IDX_TO_NAME[o]
        if cls in SKIP_IMPORT:
            continue
        names.add(NYU40_CLASSES[OBJ_TO_NYU40[o - 1]])
    names.update(["wall", "floor", "ceiling"])
    return sorted(names)


def nyu_class_of(obj_idx: int) -> str:
    return NYU40_CLASSES[OBJ_TO_NYU40[int(obj_idx) - 1]]


# ---------------------------------------------------------------------------
# data_extracted.json iteration (reference render_caller.py:22-41)
# ---------------------------------------------------------------------------
def iter_extracted_layouts(test_dir: str, num_preds: int = 4,
                           rooms: Optional[List[str]] = None
                           ) -> Iterator[Tuple[str, int, List[int],
                                               np.ndarray, np.ndarray]]:
    """Yield (room_id, k, objs, boxes, angles) for each predicted layout
    in <test_dir>/data/data_extracted.json."""
    path = os.path.join(test_dir, "data", "data_extracted.json")
    with open(path) as f:
        data = json.load(f)
    for room_id, room in data.items():
        if rooms is not None and room_id not in rooms:
            continue
        objs = room["gt"]["objs"]
        for k in range(num_preds):
            if str(k) not in room:
                break
            pred = room[str(k)]
            yield (room_id, k, objs, np.asarray(pred["boxes"], np.float64),
                   np.asarray(pred["angles"], np.float64))


def scene_meshes(objs: List[int], boxes: np.ndarray, angles: np.ndarray,
                 bank, shells=None) -> List[Dict]:
    """Assemble the full per-scene mesh list for Blender.

    Returns dicts {name, class_name, verts (V,3), faces (F,3), matrix
    (4,4)}: one entry per renderable object (bank mesh + world matrix)
    and one per shell part. `shells` is an assets.ShellBank (built via
    tools/build_asset_bank.py --room_dir): the closest-aspect-ratio
    entry is retrieved and scaled to the room, with bad-wall faces
    already dropped at bank-build time; without it, the procedural
    exact-fit shell is used.
    """
    abs_boxes, dims = denormalize_scene(boxes)
    n = len(abs_boxes)
    model_idx = retrieve_models_np(np.asarray(objs[:n]), abs_boxes, bank)
    out: List[Dict] = []
    for i in range(n):
        o = int(objs[i])
        if o == 0:
            continue
        cls = OBJECT_IDX_TO_NAME[o]
        if cls in SKIP_IMPORT:
            continue
        m = int(model_idx[i])
        fv = bank.face_valid[m]
        mat = object_world_matrix(abs_boxes[i], angles[i],
                                  bank.bbox_min[m], bank.bbox_max[m])
        out.append({"name": f"obj{i}_{cls}",
                    "class_name": nyu_class_of(o),
                    "verts": np.asarray(bank.verts[m], np.float64),
                    "faces": np.asarray(bank.faces[m][fv], np.int64),
                    "matrix": mat})

    if shells is None:
        shells = assets.procedural_shell_bank(subdiv=2)
        sidx = 0
    else:
        sidx = assets.retrieve_shell_np(dims, shells)
    scale = np.eye(4)
    scale[0, 0], scale[1, 1], scale[2, 2] = dims
    sverts = np.asarray(shells.verts[sidx], np.float64)
    sfaces = np.asarray(shells.faces[sidx], np.int64)
    spart = np.asarray(shells.part[sidx])
    svalid = np.asarray(shells.face_valid[sidx], bool)
    for pid, part in enumerate(("wall", "floor", "ceiling")):
        faces = sfaces[(spart == pid) & svalid]
        if len(faces) == 0:
            continue
        out.append({"name": part, "class_name": part,
                    "verts": sverts, "faces": faces, "matrix": scale})
    return out
