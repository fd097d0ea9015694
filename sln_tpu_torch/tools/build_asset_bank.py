"""Offline asset pipeline: SUNCG-style .obj directory -> padded mesh bank
(the port's counterpart of the JAX package's tools/build_asset_bank.py).

    python -m sln_tpu_torch.tools.build_asset_bank --obj_dir <dir> \\
        --metadata suncg_data_many.json --out bank.npz [--max_len 0.6] \\
        [--max_faces 2048] [--room_dir <dir> --wall_metadata <json>]

Replaces the reference's lazy per-object mesh loading and PyMesh
remeshing (models/misc.py:66-121): every model .obj is parsed
(data/objio.py), remeshed by the native C++ edge splitter
(sln_tpu_torch/native.py, built with g++ at first use), padded to fixed
vertex and face counts and saved as an .npz with the JAX package's keys.
render/blender/scene_spec.py `load_bank` and render/scene.py
`device_bank(..., shells=...)` read it; so does the JAX package.

metadata (reference metadata/suncg_data_many.json):
  {class_name: [{"id": model_id, "bbox_min": [3], "bbox_max": [3]}, ...]}
with meshes at <obj_dir>/<model_id>/<model_id>.obj. This runs on the host
only: no card is needed.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple

import numpy as np

from sln_tpu_torch import native
from sln_tpu_torch.data.objio import load_obj
from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME
from sln_tpu_torch.render import assets


def _largest_faces(v: np.ndarray, fcs: np.ndarray, max_faces: int
                   ) -> np.ndarray:
    """Indices of the max_faces largest triangles, in their mesh order."""
    tri = v[fcs]
    areas = np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    return np.sort(np.argsort(-areas)[:max_faces])


def build_shells(room_dir: str, wall_metadata_path: str,
                 max_len: float = 0.6, max_faces: int = 4096,
                 max_shells: int = 16) -> assets.ShellBank:
    """Retrieved wall/floor/ceiling shells -> ShellBank arrays.

    wall_metadata (reference metadata/wall_data_wfc.json): a list of
    {house_id, model_id, wall_bbox_min/max, ...}, with meshes at
    <room_dir>/<house_id>/<model_id>{w,f,c}.obj (reference
    render_room_color.py:267,316,336). Each shell is unit-normalized by its
    wall bbox; the bad-wall vertex drop (diff_render.py:200-213) is baked
    into face_valid in normalized coordinates. Entry 0 is the procedural
    exact-fit shell (the fallback when retrieval is off)."""
    with open(wall_metadata_path) as f:
        wall_data = json.load(f)

    entries = [None]  # slot 0 = procedural fallback; its sentinel ratio
    # makes retrieval prefer any real shell
    ratios = [np.array([1e9, 1e9], np.float32)]
    for shell in wall_data[:max_shells - 1]:
        parts = []
        wmin = np.asarray(shell["wall_bbox_min"], np.float64)
        wmax = np.asarray(shell["wall_bbox_max"], np.float64)
        span = np.maximum(wmax - wmin, 1e-9)
        for pid, suffix in ((0, "w"), (1, "f"), (2, "c")):
            path = os.path.join(room_dir, shell["house_id"],
                                shell["model_id"] + suffix + ".obj")
            if not os.path.isfile(path):
                break
            verts, faces = load_obj(path)
            if len(faces) == 0:
                break
            v, fcs = native.split_long_edges(verts, faces,
                                             max_len * float(span.max()))
            v = (v - wmin[None]) / span[None]          # unit-normalize
            parts.append((v.astype(np.float32), fcs, pid))
        else:
            # the parts as one mesh with per-face part ids
            offs, av, af, ap = 0, [], [], []
            for v, fcs, pid in parts:
                av.append(v)
                af.append(fcs + offs)
                ap.append(np.full(len(fcs), pid, np.int32))
                offs += len(v)
            v, fcs, pid = (np.concatenate(av), np.concatenate(af),
                           np.concatenate(ap))
            if len(fcs) > max_faces:
                keep = _largest_faces(v, fcs, max_faces)
                fcs, pid = fcs[keep], pid[keep]
            # bad-wall drop in normalized coordinates -> face validity
            part_of_vert = np.zeros(len(v), np.int32)
            for f, p in zip(fcs, pid):
                part_of_vert[f] = p
            drop = assets.shell_wall_drop_normalized(v, part_of_vert)
            entries.append({"verts": v, "faces": fcs, "part": pid,
                            "fvalid": ~drop[fcs].any(axis=1)})
            ratios.append(np.array([span[1] / span[0], span[2] / span[0]],
                                   np.float32))
            print(f"shell {shell['house_id']}/{shell['model_id']}: "
                  f"{len(fcs)} faces, {int(drop.sum())} wall verts dropped")

    proc = assets.procedural_shell_bank(subdiv=4)
    if len(entries) == 1:
        return proc
    vs = max([proc.verts.shape[1]] + [len(e["verts"]) for e in entries[1:]])
    fs = max([proc.faces.shape[1]] + [len(e["faces"]) for e in entries[1:]])
    S = len(entries)
    verts = np.zeros((S, vs, 3), np.float32)
    faces = np.zeros((S, fs, 3), np.int32)
    part = np.zeros((S, fs), np.int32)
    fvalid = np.zeros((S, fs), bool)
    nf0 = proc.faces.shape[1]
    verts[0, :proc.verts.shape[1]] = proc.verts[0]
    faces[0, :nf0] = proc.faces[0]
    part[0, :nf0] = proc.part[0]
    fvalid[0, :nf0] = True
    for i, e in enumerate(entries[1:], start=1):
        nv, nf = len(e["verts"]), len(e["faces"])
        verts[i, :nv] = e["verts"]
        faces[i, :nf] = e["faces"]
        part[i, :nf] = e["part"]
        fvalid[i, :nf] = e["fvalid"]
    return assets.ShellBank(verts=verts, faces=faces, part=part,
                            face_valid=fvalid, ratio=np.stack(ratios))


def build_bank(obj_dir: str, metadata_path: str, out_path: str,
               max_len: float = 0.6, max_faces: int = 2048,
               max_models_per_class: int = 8, room_dir: str = "",
               wall_metadata: str = "") -> None:
    """Write the .npz bank: verts, faces, face_valid, bbox_min, bbox_max,
    model_class, vm, fm, ids, and with room_dir and wall_metadata the
    shell_* arrays of build_shells. Metadata entries whose mesh is missing
    or empty are skipped; no mesh at all raises SystemExit."""
    with open(metadata_path) as f:
        metadata = json.load(f)

    entries = []
    for cls_name, models in metadata.items():
        if cls_name not in OBJECT_IDX_TO_NAME:
            continue
        cls_idx = OBJECT_IDX_TO_NAME.index(cls_name)
        for model in models[:max_models_per_class]:
            mid = model["id"]
            path = os.path.join(obj_dir, mid, mid + ".obj")
            if not os.path.isfile(path):
                continue
            verts, faces = load_obj(path)
            if len(faces) == 0:
                continue
            v, fcs = native.split_long_edges(verts, faces, max_len)
            if len(fcs) > max_faces:
                # decimate: keep the largest triangles
                fcs = fcs[_largest_faces(v, fcs, max_faces)]
            entries.append({
                "verts": v, "faces": fcs, "class": cls_idx,
                "bbox_min": np.asarray(model["bbox_min"], np.float32),
                "bbox_max": np.asarray(model["bbox_max"], np.float32),
                "id": mid})
            print(f"{cls_name}/{mid}: {len(fcs)} faces")

    if not entries:
        raise SystemExit("no meshes found")
    vm = max(len(e["verts"]) for e in entries)
    fm = max(len(e["faces"]) for e in entries)
    M = len(entries)
    verts = np.zeros((M, vm, 3), np.float32)
    faces = np.zeros((M, fm, 3), np.int32)
    fvalid = np.zeros((M, fm), bool)
    bb_min = np.zeros((M, 3), np.float32)
    bb_max = np.zeros((M, 3), np.float32)
    cls = np.zeros((M,), np.int32)
    for i, e in enumerate(entries):
        nv, nf = len(e["verts"]), len(e["faces"])
        verts[i, :nv] = e["verts"]
        faces[i, :nf] = e["faces"]
        fvalid[i, :nf] = True
        bb_min[i], bb_max[i] = e["bbox_min"], e["bbox_max"]
        cls[i] = e["class"]
    arrays = dict(verts=verts, faces=faces, face_valid=fvalid,
                  bbox_min=bb_min, bbox_max=bb_max, model_class=cls,
                  vm=vm, fm=fm, ids=np.asarray([e["id"] for e in entries]))
    if room_dir and wall_metadata:
        shells = build_shells(room_dir, wall_metadata, max_len)
        arrays.update(
            shell_verts=shells.verts, shell_faces=shells.faces,
            shell_part=shells.part, shell_face_valid=shells.face_valid,
            shell_ratio=shells.ratio)
        print(f"shell bank: {shells.verts.shape[0]} entries "
              "(entry 0 = procedural fallback)")
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {M} models, Vm={vm}, Fm={fm}")


def load_bank_npz(path: str
                  ) -> Tuple[assets.MeshBank, Optional[assets.ShellBank]]:
    """An .npz bank -> (MeshBank, ShellBank or None)."""
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


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--obj_dir", required=True)
    p.add_argument("--metadata", required=True)
    p.add_argument("--out", default="asset_bank.npz")
    p.add_argument("--max_len", default=0.6, type=float)
    p.add_argument("--max_faces", default=2048, type=int)
    p.add_argument("--room_dir", default="",
                   help="SUNCG room dir with <house>/<model>{w,f,c}.obj "
                        "shells (reference render_room_color.py:267)")
    p.add_argument("--wall_metadata", default="",
                   help="wall_data_wfc.json (reference metadata)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    build_bank(args.obj_dir, args.metadata, args.out, args.max_len,
               args.max_faces, room_dir=args.room_dir,
               wall_metadata=args.wall_metadata)


if __name__ == "__main__":
    main()
