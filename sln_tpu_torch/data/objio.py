"""Wavefront .obj parsing (host-side asset IO; own copy of
sln_tpu/data/objio.py).

Replaces the reference's PyWavefront dependency (models/misc.py:17,66-80):
vertices + fan-triangulated faces, tolerant of normals, texture
coordinates and negative indices, with per-group splitting for wall meshes
(custom_load_wall semantics, misc.py:82-107).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _face_indices(line: str, num_verts: int) -> List[int]:
    """The vertex indices of an `f` line (v, v/vt, v//vn or v/vt/vn
    tokens; 1-based, or negative from the end of the vertices so far)."""
    idx = []
    for tok in line.split()[1:]:
        k = int(tok.split("/")[0])
        idx.append(k - 1 if k > 0 else num_verts + k)
    return idx


def _vertex(line: str) -> List[float]:
    parts = line.split()
    return [float(parts[1]), float(parts[2]), float(parts[3])]


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (verts (V, 3) float32, faces (F, 3) int32), fan-triangulated."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                verts.append(_vertex(line))
            elif line.startswith("f "):
                idx = _face_indices(line, len(verts))
                for t in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[t], idx[t + 1]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load_obj_groups(path: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-group (o/g/usemtl) submeshes sharing the global vertex list;
    the wall loader remeshes each group separately (reference
    misc.py:92-107). Groups without faces are left out."""
    verts: List[List[float]] = []
    groups: Dict[str, List[List[int]]] = {}
    current = "default"
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                verts.append(_vertex(line))
            elif line.startswith(("g ", "o ", "usemtl ")):
                current = line.strip()
            elif line.startswith("f "):
                idx = _face_indices(line, len(verts))
                tris = groups.setdefault(current, [])
                for t in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[t], idx[t + 1]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    return [(v, np.asarray(f, np.int32).reshape(-1, 3))
            for f in groups.values() if f]
