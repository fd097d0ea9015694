"""Minimal bpy helper library for modern Blender (>= 3.x API); own copy of
sln_tpu/render/blender/bpy_scene.py.

Own re-implementation of the capabilities the reference pulls from
render/xiuminglib/blender/ (camera.py add_camera / get_camera_zbuffer,
lighting.py add_light_area, scene.py set_cycles, scene_2.py render_mask /
render_depth): scene reset, meshes from raw numpy arrays, camera + area
light, Cycles config, z-buffer readback through the compositor Viewer
node, 32-bit EXR depth via a File Output node, and the
white-emission-on-target / black-elsewhere binary-mask trick.

Only importable inside Blender (``import bpy``); all scene *math* lives
in scene_spec.py which is unit-tested without Blender.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import bpy
import numpy as np


# ---------------------------------------------------------------------------
# scene lifecycle
# ---------------------------------------------------------------------------
def reset_scene() -> None:
    """Fresh empty scene (the reference re-reads factory settings then
    deletes every object, render_room_color.py:186-191)."""
    bpy.ops.wm.read_factory_settings(use_empty=True)
    scene = bpy.context.scene
    scene.render.resolution_x = 512
    scene.render.resolution_y = 512
    scene.render.resolution_percentage = 25


def add_mesh(name: str, verts: np.ndarray, faces: np.ndarray,
             matrix: np.ndarray):
    """Create a mesh object directly from (V,3)/(F,3) arrays + 4x4 world
    matrix — replaces the reference's .obj import path
    (xiuminglib/blender/object.py import_object)."""
    import mathutils

    mesh = bpy.data.meshes.new(name)
    mesh.from_pydata([tuple(v) for v in np.asarray(verts, float)], [],
                     [tuple(int(i) for i in f) for f in faces])
    mesh.update()
    obj = bpy.data.objects.new(name, mesh)
    obj.matrix_world = mathutils.Matrix(
        [tuple(row) for row in np.asarray(matrix, float)])
    bpy.context.collection.objects.link(obj)
    return obj


def add_camera(xyz: Sequence[float], rot_vec_rad: Sequence[float],
               f_mm: float = 50.0, sensor_mm: float = 50.0):
    """Camera with XYZ-Euler rotation (the reference xiuminglib
    camera.add_camera contract: at rotation zero it looks down -Z, which
    in the y-up SUNCG frame means into the room from the near wall)."""
    cam_data = bpy.data.cameras.new("camera")
    cam_data.lens = f_mm
    cam_data.sensor_width = sensor_mm
    cam_data.sensor_height = sensor_mm
    cam_data.sensor_fit = "VERTICAL"
    cam_data.clip_start = 0.01
    cam_data.clip_end = 1000.0
    cam = bpy.data.objects.new("camera", cam_data)
    cam.location = tuple(float(v) for v in xyz)
    cam.rotation_mode = "XYZ"
    cam.rotation_euler = tuple(float(v) for v in rot_vec_rad)
    bpy.context.collection.objects.link(cam)
    bpy.context.scene.camera = cam
    return cam


def add_area_light(xyz: Sequence[float], energy: float = 1.2,
                   size: float = 0.1):
    """Area light (reference lighting.add_light_area; energy is scaled
    up for modern Blender's watt-based units)."""
    light_data = bpy.data.lights.new("arealight", type="AREA")
    light_data.energy = energy * 100.0
    light_data.size = size
    light = bpy.data.objects.new("arealight", light_data)
    light.location = tuple(float(v) for v in xyz)
    bpy.context.collection.objects.link(light)
    return light


def set_cycles(samples: int, res_x: int = 1024, res_y: int = 1024,
               percentage: int = 25) -> None:
    """Cycles CPU config (reference scene.set_cycles + the render
    settings at render_room_color.py:346-350)."""
    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.cycles.samples = samples
    scene.cycles.use_denoising = False
    scene.render.resolution_x = res_x
    scene.render.resolution_y = res_y
    scene.render.resolution_percentage = percentage
    scene.render.use_file_extension = True


def set_world_background(strength: float = 1.0,
                         color=(0.8, 0.8, 0.8),
                         hdri_dir: Optional[str] = None,
                         rng: Optional[np.random.Generator] = None) -> None:
    """Uniform background, or a random equirectangular HDRI when a
    directory of them exists (reference render_room_color.py:409-430)."""
    world = bpy.data.worlds.new("World")
    bpy.context.scene.world = world
    world.use_nodes = True
    nodes = world.node_tree.nodes
    links = world.node_tree.links
    bg = nodes["Background"]
    bg.inputs["Strength"].default_value = strength
    if hdri_dir and os.path.isdir(hdri_dir):
        images = sorted(os.listdir(hdri_dir))
        if images:
            rng = rng or np.random.default_rng()
            pick = images[int(rng.integers(len(images)))]
            env = nodes.new(type="ShaderNodeTexEnvironment")
            env.image = bpy.data.images.load(os.path.join(hdri_dir, pick))
            env.projection = "EQUIRECTANGULAR"
            links.new(env.outputs["Color"], bg.inputs["Color"])
            return
    bg.inputs["Color"].default_value = (*color, 1.0)


def assign_diffuse(obj, rgb) -> None:
    """Principled-BSDF diffuse color (the reference re-wires each
    material to a Diffuse BSDF, render_room_color.py:88-129; bank meshes
    carry no materials so a per-class color is created)."""
    mat = bpy.data.materials.new(obj.name + "_mat")
    mat.use_nodes = True
    bsdf = mat.node_tree.nodes["Principled BSDF"]
    bsdf.inputs["Base Color"].default_value = (*rgb, 1.0)
    bsdf.inputs["Roughness"].default_value = 0.8
    obj.data.materials.clear()
    obj.data.materials.append(mat)


def _emission_material(name: str, value: float):
    mat = bpy.data.materials.new(name)
    mat.use_nodes = True
    nodes = mat.node_tree.nodes
    nodes.clear()
    em = nodes.new("ShaderNodeEmission")
    em.inputs["Color"].default_value = (value, value, value, 1.0)
    out = nodes.new("ShaderNodeOutputMaterial")
    mat.node_tree.links.new(em.outputs["Emission"],
                            out.inputs["Surface"])
    return mat


# ---------------------------------------------------------------------------
# z-buffer readback (camera acceptance probe)
# ---------------------------------------------------------------------------
def _enable_depth_compositor():
    scene = bpy.context.scene
    scene.view_layers[0].use_pass_z = True
    scene.use_nodes = True
    tree = scene.node_tree
    tree.nodes.clear()
    rl = tree.nodes.new("CompositorNodeRLayers")
    return tree, rl


def get_camera_zbuffer(probe_res: int = 128) -> np.ndarray:
    """Render a 1-sample depth pass and read it back through the
    compositor Viewer node (replaces xiuminglib
    camera.get_camera_zbuffer's linked-scene EXR + cv2 round trip)."""
    scene = bpy.context.scene
    old = (scene.render.resolution_x, scene.render.resolution_y,
           scene.render.resolution_percentage, scene.cycles.samples)
    tree, rl = _enable_depth_compositor()
    viewer = tree.nodes.new("CompositorNodeViewer")
    viewer.use_alpha = False
    tree.links.new(rl.outputs["Depth"], viewer.inputs["Image"])
    scene.render.resolution_x = probe_res
    scene.render.resolution_y = probe_res
    scene.render.resolution_percentage = 100
    scene.cycles.samples = 1
    bpy.ops.render.render(write_still=False)
    img = bpy.data.images["Viewer Node"]
    w, h = img.size
    z = np.array(img.pixels[:], np.float32).reshape(h, w, 4)[..., 0]
    (scene.render.resolution_x, scene.render.resolution_y,
     scene.render.resolution_percentage, scene.cycles.samples) = old
    return z


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------
def render_color(path: str) -> None:
    scene = bpy.context.scene
    scene.render.image_settings.file_format = "PNG"
    scene.render.filepath = path
    bpy.ops.render.render(write_still=True)


def render_depth_exr(path: str) -> None:
    """32-bit EXR depth via a compositor File Output node (replaces
    xiuminglib scene_2.render_depth). File Output appends the frame
    number, so the product is renamed to the exact target path."""
    scene = bpy.context.scene
    tree, rl = _enable_depth_compositor()
    out = tree.nodes.new("CompositorNodeOutputFile")
    out.base_path = os.path.dirname(os.path.abspath(path))
    out.format.file_format = "OPEN_EXR"
    out.format.color_depth = "32"
    stem = os.path.basename(path)
    if stem.endswith(".exr"):
        stem = stem[:-4]
    out.file_slots[0].path = stem + "#"
    tree.links.new(rl.outputs["Depth"], out.inputs[0])
    samples = scene.cycles.samples
    scene.cycles.samples = 1
    bpy.ops.render.render(write_still=False)
    scene.cycles.samples = samples
    frame = scene.frame_current
    produced = os.path.join(out.base_path, f"{stem}{frame}.exr")
    if os.path.isfile(produced):
        os.replace(produced, path)
    tree.nodes.remove(out)
    # reader-independent sidecar: EXR decoding is an optional extra for
    # consumers, so dump the same depth as float32 .npy via Blender's own
    # EXR reader (gan_shade.spade_input_from_files prefers it)
    try:
        img = bpy.data.images.load(path)
        w, h = img.size
        z = np.array(img.pixels[:], np.float32).reshape(h, w, 4)[::-1, :, 0]
        np.save(path[:-4] + ".npy", z)
        bpy.data.images.remove(img)
    except Exception as e:  # EXR still on disk; sidecar is best-effort
        print("depth .npy sidecar failed:", e)


def render_class_masks(objects_by_class: Dict[str, List],
                       path_for: Dict[str, str]) -> None:
    """Binary per-class masks: target objects get white emission,
    everything else black, black world, 1 Cycles sample (the reference
    emission trick, xiuminglib scene_2.render_mask:287-419, caller
    render_semantic_depth.py:439-447)."""
    scene = bpy.context.scene
    white = _emission_material("mask_white", 1.0)
    black = _emission_material("mask_black", 0.0)
    world = bpy.data.worlds.new("mask_world")
    world.use_nodes = True
    world.node_tree.nodes["Background"].inputs[
        "Strength"].default_value = 0.0
    old_world = scene.world
    scene.world = world
    scene.use_nodes = False
    samples = scene.cycles.samples
    scene.cycles.samples = 1
    meshes = [o for o in bpy.data.objects if o.type == "MESH"]
    saved = {o.name: list(o.data.materials) for o in meshes}
    try:
        for cls, targets in objects_by_class.items():
            target_names = {t.name for t in targets}
            for o in meshes:
                o.data.materials.clear()
                o.data.materials.append(
                    white if o.name in target_names else black)
                for poly in o.data.polygons:
                    poly.material_index = 0
            scene.render.image_settings.file_format = "PNG"
            scene.render.filepath = path_for[cls]
            bpy.ops.render.render(write_still=True)
    finally:
        scene.cycles.samples = samples
        scene.world = old_world
        for o in meshes:
            o.data.materials.clear()
            for m in saved[o.name]:
                o.data.materials.append(m)
