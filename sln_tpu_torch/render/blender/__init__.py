"""Blender-side rendering subsystem: own copies of sln_tpu/render/blender/
(reference render/ directory), modern-Blender (>= 3.x bpy API) scripts:

* ``render_color.py``          — photoreal Cycles renders of generated
                                 layouts (reference render/render_caller.py
                                 -> render_room_color.py:29-442)
* ``render_semantic_depth.py`` — per-class binary masks + EXR depth for
                                 SPADE (reference
                                 render/semantic_depth_caller.py ->
                                 render_semantic_depth.py:152-454)
* ``bpy_scene.py``             — the bpy helper library (camera, lights,
                                 Cycles config, z-buffer readback, mask
                                 rendering; reference
                                 render/xiuminglib/blender/)
* ``driver.py``                — the scene driver both entry scripts share
* ``scene_spec.py``            — ALL scene math (box denorm, transforms,
                                 wall heuristics, camera sampling, artifact
                                 naming) in pure numpy, so it is tested
                                 without a Blender binary and shared with
                                 the preview renderer (render/preview.py).

Both entry scripts run as ``blender -b -P <script> -- <test_dir>`` — the
exact subprocess contract of the reference (testing/test_plot3d.py:4-8),
launched by render/blender_bridge.py — and consume
``<test_dir>/data/data_extracted.json`` produced by
``python -m sln_tpu_torch.test --batch_gen``. Meshes come from the
procedural asset bank (or a real .npz bank via SLN_TPU_ASSET_BANK), fed to
Blender as raw vertex/face arrays. Blender's bundled Python has no torch:
nothing here imports it, directly or through a package __init__.
"""
