"""ctypes bindings for the port's host runtime library (csrc/native.cpp):
the edge splitter, the rotated-cuboid IoU and the room-JSON packer
(counterpart of sln_tpu/native.py).

The library is host C++ with an `extern "C"` interface. It is compiled by
`g++` (or `c++`) from csrc/native.cpp into sln_tpu_torch/_build/
(git-ignored) at first use, under a name that fingerprints the source and
the flags, and loaded with ctypes; nothing here runs at import time. A
failed build or load raises with the compiler's log: no entry point falls
back to Python. The one Python path is the packer's own: `pack_rooms`
returns None when the C++ scanner rejects the text, and
data/tensorize.py `tensorize_file` then parses it with `json`.

Beside each entry point is its plain Python version
(`split_long_edges_py`, `cuboid_iou_py`, `count_top_level_keys_py`; the
packer's is data/tensorize.py `tensorize_rooms`). The tests hold the
library against them; nothing else calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCE = "native.cpp"
# no -march=native: the library must not depend on the CPU that built it,
# and without it the compiler contracts no a*b+c into an FMA
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
last_build_log = ""


def compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                       "library is built from sln_tpu_torch/csrc/native.cpp "
                       "at first use")


def _fingerprint() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.encode())
    h.update((CSRC / SOURCE).read_bytes())
    return h.hexdigest()[:12]


def library_path() -> Path:
    return BUILD_DIR / f"libsln_native_{_fingerprint()}.so"


def build_command(out: Path) -> list:
    return [compiler(), *CXX_FLAGS, "-o", str(out), str(CSRC / SOURCE)]


def build(timeout: float = BUILD_TIMEOUT_S) -> Path:
    """Compile csrc/native.cpp unless an up-to-date library exists. Returns
    its path; raises on a failed or timed-out build. Concurrent builds
    (test workers) each write a temporary file and rename it into place."""
    global last_build_log
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = build_command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    last_build_log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                      f"[{time.perf_counter() - t0:.1f} s]")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed "
                           f"({proc.returncode}):\n{last_build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built if needed, with every argtype and restype
    declared (without them ctypes would cut 64-bit pointers to 32 bits)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.split_long_edges.restype = ctypes.c_int
    lib.split_long_edges.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int64)]
    lib.cuboid_iou.restype = ctypes.c_double
    lib.cuboid_iou.argtypes = [f64p, ctypes.c_double, ctypes.c_double,
                               f64p, ctypes.c_double, ctypes.c_double]
    lib.count_top_level_keys.restype = ctypes.c_int64
    lib.count_top_level_keys.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.pack_rooms_json.restype = ctypes.c_int64
    lib.pack_rooms_json.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32,
        i32p, f32p, i32p, ctypes.POINTER(ctypes.c_uint8), i32p,
        ctypes.c_int64]
    lib.native_free.restype = None
    lib.native_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# edge splitter
# ---------------------------------------------------------------------------
def split_long_edges(verts: np.ndarray, faces: np.ndarray,
                     max_len: float) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivide triangles until all edges <= max_len (longest-edge
    bisection, at most 24 levels deep).

    Returns (verts (3T, 3) float32, faces (T, 3) int32) as unwelded
    triangle soup, the role of pymesh.split_long_edges_raw (reference
    models/misc.py:79). Raises on a non-positive max_len or a face index
    outside the vertex list."""
    lib = load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out_v = ctypes.POINTER(ctypes.c_float)()
    out_n = ctypes.c_int64()
    rc = lib.split_long_edges(_ptr(verts, ctypes.c_float), len(verts),
                              _ptr(faces, ctypes.c_int32), len(faces),
                              max_len, ctypes.byref(out_v),
                              ctypes.byref(out_n))
    if rc != 0:
        raise ValueError(f"split_long_edges failed ({rc}): max_len "
                         f"{max_len}, {len(verts)} vertices")
    n = out_n.value
    try:
        v = (np.ctypeslib.as_array(out_v, shape=(3 * n, 3)).copy() if n
             else np.zeros((0, 3), np.float32))
    finally:
        lib.native_free(out_v)
    return v, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def split_long_edges_py(verts: np.ndarray, faces: np.ndarray,
                        max_len: float) -> Tuple[np.ndarray, np.ndarray]:
    """Plain Python version of split_long_edges (float32 arithmetic)."""
    verts = np.asarray(verts, np.float32)
    max2 = np.float32(max_len) * np.float32(max_len)
    out = []

    def rec(a, b, c, depth):
        ab = ((a - b) ** 2).sum()
        bc = ((b - c) ** 2).sum()
        ca = ((c - a) ** 2).sum()
        if depth <= 0 or (ab <= max2 and bc <= max2 and ca <= max2):
            out.extend([a, b, c])
            return
        if ab >= bc and ab >= ca:
            m = (a + b) * np.float32(0.5)
            rec(a, m, c, depth - 1)
            rec(m, b, c, depth - 1)
        elif bc >= ab and bc >= ca:
            m = (b + c) * np.float32(0.5)
            rec(a, b, m, depth - 1)
            rec(a, m, c, depth - 1)
        else:
            m = (c + a) * np.float32(0.5)
            rec(a, b, m, depth - 1)
            rec(m, b, c, depth - 1)

    for f in np.asarray(faces):
        rec(verts[f[0]], verts[f[1]], verts[f[2]], 24)
    v = np.asarray(out, np.float32).reshape(-1, 3)
    return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)


# ---------------------------------------------------------------------------
# rotated-cuboid IoU
# ---------------------------------------------------------------------------
def cuboid_iou(quad1: np.ndarray, y1: Tuple[float, float],
               quad2: np.ndarray, y2: Tuple[float, float]) -> float:
    """Host-side rotated-cuboid IoU in float64 (reference
    test_utils.py:33-40): quads are 4 xz corners, y = (ymin, ymax)."""
    lib = load()
    q1 = np.ascontiguousarray(quad1, np.float64).reshape(8)
    q2 = np.ascontiguousarray(quad2, np.float64).reshape(8)
    return float(lib.cuboid_iou(_ptr(q1, ctypes.c_double), y1[0], y1[1],
                                _ptr(q2, ctypes.c_double), y2[0], y2[1]))


def cuboid_iou_py(quad1: np.ndarray, y1: Tuple[float, float],
                  quad2: np.ndarray, y2: Tuple[float, float]) -> float:
    """Plain version of cuboid_iou: ops/iou.py's float32 torch function."""
    import torch

    from sln_tpu_torch.ops import iou

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    return float(iou.cuboid_iou(t(quad1).reshape(4, 2), t(y1[0]), t(y1[1]),
                                t(quad2).reshape(4, 2), t(y2[0]), t(y2[1])))


# ---------------------------------------------------------------------------
# the room-JSON packer
# ---------------------------------------------------------------------------
def count_top_level_keys(json_text: str) -> int:
    """Number of keys at depth 1 of a JSON object (= rooms in the
    reference schema)."""
    data = json_text.encode("utf-8")
    return int(load().count_top_level_keys(data, len(data)))


def count_top_level_keys_py(json_text: str) -> int:
    """Plain Python version of count_top_level_keys (the same byte scan)."""
    data = json_text.encode("utf-8")
    count, depth, i, n = 0, 0, 0, len(data)
    while i < n:
        c = data[i]
        if c == 0x22:  # '"'
            i += 1
            while i < n and data[i] != 0x22:
                i += 2 if data[i] == 0x5C else 1
            i += 1
            if depth == 1:
                while i < n and data[i] in b" \t\n\r":
                    i += 1
                if i < n and data[i] == 0x3A:  # ':'
                    count += 1
            continue
        if c in b"{[":
            depth += 1
        elif c in b"}]":
            depth -= 1
        i += 1
    return count


def pack_rooms(json_text: str, max_objects: int,
               max_rooms: int = 1 << 20
               ) -> Optional[Dict[str, np.ndarray]]:
    """The C++ packer: room JSON text -> tensorize_rooms' array dict, or
    None when the scanner rejects the text (malformed JSON, or a schema it
    does not take; the caller then parses with json)."""
    from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME

    lib = load()
    data = json_text.encode("utf-8")
    # the exact room count (one top-level key per room): counting every
    # '":' would allocate rooms x objects-per-room rows on real metadata
    est = max(min(int(lib.count_top_level_keys(data, len(data))) + 1,
                  max_rooms), 1)
    O = max_objects
    objs = np.zeros((est, O), np.int32)
    boxes = np.zeros((est, O, 6), np.float32)
    angles = np.zeros((est, O), np.int32)
    mask = np.zeros((est, O), np.uint8)
    room_ids = np.zeros((est,), np.int32)
    names = "\n".join(OBJECT_IDX_TO_NAME).encode("utf-8")
    n = lib.pack_rooms_json(
        data, len(data), names, O, _ptr(objs, ctypes.c_int32),
        _ptr(boxes, ctypes.c_float), _ptr(angles, ctypes.c_int32),
        _ptr(mask, ctypes.c_uint8), _ptr(room_ids, ctypes.c_int32), est)
    if n < 0:
        return None
    n = int(n)
    return {"objs": objs[:n], "boxes": boxes[:n], "angles": angles[:n],
            "obj_mask": mask[:n].astype(bool), "room_ids": room_ids[:n]}
