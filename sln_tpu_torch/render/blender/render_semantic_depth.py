"""Per-class semantic masks + EXR depth via Blender (python -m
sln_tpu_torch.test --gan_shade --semantic_source blender; own copy of
sln_tpu/render/blender/render_semantic_depth.py).

Run as:  blender -b -P sln_tpu_torch/render/blender/render_semantic_depth.py -- <test_dir>

Consumes <test_dir>/data/data_extracted.json and writes, per predicted
layout, into <test_dir>/data/semantic_masks/:

    <room>_pred_<kk>_depth.exr   32-bit z-pass depth
    <room>_pred_<kk>_orig.png    the raw render from the same camera
    <room>_pred_<kk>_<class>.png one binary mask per NYU-40 class present

— exactly the artifact contract the reference produces
(render/semantic_depth_caller.py -> render_semantic_depth.py:152-454)
and that sln_tpu_torch.workloads.gan_shade.spade_input_from_files parses
back into the 41-channel SPADE input. The in-process rasterizer path
(--gan_shade without Blender) supersedes this for speed; this
script exists so Blender-quality masks/depth remain producible.

Limit rooms/preds with SLN_TPU_RENDER_ROOMS="33433" SLN_TPU_RENDER_K="1"
(the reference hardcodes one room/pred in its caller).
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


def render_semantic_depth(objs, boxes, angles, out_dir: str, name: str,
                          rng: np.random.Generator, bank,
                          shells=None) -> None:
    by_class, dims = driver.build_scene(objs, boxes, angles, bank, rng,
                                        shells)
    bpy_scene.set_world_background(strength=0.0)
    bpy_scene.set_cycles(samples=10, res_x=1024, res_y=1024, percentage=25)

    bpy_scene.render_depth_exr(os.path.join(
        out_dir, scene_spec.depth_filename(name)))
    bpy_scene.render_color(os.path.join(
        out_dir, scene_spec.orig_filename(name)))

    classes = scene_spec.mask_classes_for(objs)
    path_for = {cls: os.path.join(out_dir,
                                  scene_spec.mask_filename(name, cls))
                for cls in classes}
    targets = {cls: by_class.get(cls, []) for cls in classes}
    bpy_scene.render_class_masks(targets, path_for)
    print("wrote", name, "->", len(classes), "masks + depth + orig")


def main() -> None:
    test_dir = driver.script_argv()[0]
    out_dir = os.path.join(test_dir, "data", "semantic_masks")
    os.makedirs(out_dir, exist_ok=True)
    bank, shells = scene_spec.load_bank()
    rng = np.random.default_rng(int(os.environ.get("SLN_TPU_RENDER_SEED",
                                                   "0")))
    rooms = os.environ.get("SLN_TPU_RENDER_ROOMS")
    rooms = rooms.split(",") if rooms else None
    only_k = os.environ.get("SLN_TPU_RENDER_K")
    for room_id, k, objs, boxes, angles in \
            scene_spec.iter_extracted_layouts(test_dir, rooms=rooms):
        if only_k is not None and int(only_k) != k:
            continue
        render_semantic_depth(objs, boxes, angles, out_dir,
                              scene_spec.pred_name(room_id, k), rng,
                              bank, shells)


if __name__ == "__main__":
    main()
