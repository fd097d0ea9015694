"""Photoreal Cycles render of generated layouts (python -m sln_tpu_torch.test
--draw_3d; own copy of sln_tpu/render/blender/render_color.py).

Run as:  blender -b -P sln_tpu_torch/render/blender/render_color.py -- <test_dir>

Consumes <test_dir>/data/data_extracted.json (written by
--batch_gen) and writes
<test_dir>/data/rendered/<room>_pred_<kk>_3d.png for each predicted
layout — the artifact set of the reference pipeline
(render/render_caller.py -> render_room_color.py:29-442), rebuilt for
modern Blender: meshes come from the asset bank as raw arrays (no SUNCG
checkout), per-class diffuse colors stand in for bundled textures, an
area light plus optional HDRI environment (SLN_TPU_HDRI_DIR) lights the
room, and the camera is drawn from the reference's sampling distribution
with the same depth-acceptance rule.
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", "..", ".."))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

from sln_tpu_torch.render.blender import (  # noqa: E402
    bpy_scene, driver, scene_spec)

CYCLES_SAMPLES = int(os.environ.get("SLN_TPU_CYCLES_SAMPLES", "50"))


def _class_color(class_name: str):
    """Deterministic per-class diffuse color (the 2D plotter's ScanNet
    table, reference testing/test_plot2d.py:16-28)."""
    from sln_tpu_torch.data.vocab import NYU40_CLASSES
    from sln_tpu_torch.workloads.plot2d import MAPPED_COLORS

    if class_name in NYU40_CLASSES:
        rgb = MAPPED_COLORS[NYU40_CLASSES.index(class_name)]
        return tuple(float(c) / 255.0 for c in rgb)
    return (0.7, 0.7, 0.7)


def render_layout(objs, boxes, angles, out_path: str,
                  rng: np.random.Generator, bank,
                  shells=None) -> None:
    by_class, dims = driver.build_scene(objs, boxes, angles, bank, rng,
                                        shells)
    for cls, objects in by_class.items():
        rgb = _class_color(cls)
        for obj in objects:
            bpy_scene.assign_diffuse(obj, rgb)
    bpy_scene.add_area_light(
        xyz=(dims[0] / 2, dims[1] * 0.9, dims[2] / 2), energy=1.2,
        size=0.1)
    bpy_scene.set_world_background(
        strength=1.0, hdri_dir=os.environ.get("SLN_TPU_HDRI_DIR"), rng=rng)
    bpy_scene.set_cycles(samples=CYCLES_SAMPLES, res_x=1024, res_y=1024,
                         percentage=25)
    bpy_scene.render_color(out_path)
    print("wrote", out_path)


def main() -> None:
    test_dir = driver.script_argv()[0]
    out_dir = os.path.join(test_dir, "data", "rendered")
    os.makedirs(out_dir, exist_ok=True)
    bank, shells = scene_spec.load_bank()
    rng = np.random.default_rng(int(os.environ.get("SLN_TPU_RENDER_SEED",
                                                   "0")))
    for room_id, k, objs, boxes, angles in \
            scene_spec.iter_extracted_layouts(test_dir):
        out = os.path.join(out_dir, scene_spec.color_filename(room_id, k))
        render_layout(objs, boxes, angles, out, rng, bank, shells)


if __name__ == "__main__":
    main()
