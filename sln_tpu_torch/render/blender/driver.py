"""Shared Blender-side scene driver: assemble one layout, sample an
accepted camera (reference render_room_color.py:346-383 loop), return the
objects grouped by NYU class for mask rendering (own copy of
sln_tpu/render/blender/driver.py).

Used by both entry scripts (render_color.py, render_semantic_depth.py);
bpy-dependent, while all math is delegated to scene_spec.
"""

from __future__ import annotations

import sys
import os
from typing import Dict, List, Tuple

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", "..", ".."))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from sln_tpu_torch.render.blender import bpy_scene, scene_spec  # noqa: E402


def script_argv() -> List[str]:
    """Args after `--` in `blender -b -P script -- <test_dir>`
    (reference render_caller.py:12-13)."""
    argv = sys.argv
    if "--" in argv:
        return argv[argv.index("--") + 1:]
    return argv[1:]


def build_scene(objs, boxes, angles, bank, rng: np.random.Generator,
                shells=None) -> Tuple[Dict[str, List], np.ndarray]:
    """Fresh Blender scene with all meshes placed + an accepted camera.

    Returns (objects grouped by NYU class name, room_dims). Camera
    acceptance: up to NUM_VIEW_SAMPLES draws, keep the first whose mean
    probe depth clears MIN_MEAN_DEPTH; fall back to the last draw
    (reference render_room_color.py:351-383).
    """
    bpy_scene.reset_scene()
    meshes = scene_spec.scene_meshes(objs, boxes, angles, bank, shells)
    _, dims = scene_spec.denormalize_scene(np.asarray(boxes, np.float64))
    by_class: Dict[str, List] = {}
    for spec in meshes:
        obj = bpy_scene.add_mesh(spec["name"], spec["verts"],
                                 spec["faces"], spec["matrix"])
        by_class.setdefault(spec["class_name"], []).append(obj)

    bpy_scene.set_cycles(samples=1)
    accepted = False
    for _ in range(scene_spec.NUM_VIEW_SAMPLES):
        xyz, rot = scene_spec.sample_camera(rng, dims)
        bpy_scene.add_camera(xyz, rot, scene_spec.F_MM,
                             scene_spec.SENSOR_MM)
        z = bpy_scene.get_camera_zbuffer()
        if scene_spec.accept_view(z):
            accepted = True
            break
    if not accepted:
        print("Failed to sample good view point")
    return by_class, dims
