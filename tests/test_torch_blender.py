"""The port's Blender side against the JAX package's: scene_spec and the
shell functions of render/assets.py give the same arrays on the same
inputs; the preview's classes are all render classes; the bridge runs
`blender -b -P <the port's script> -- <test_dir>` (a fake binary records
its argv) and raises BlenderNotAvailable without one; the bpy scripts
compile, and they and the scene math import with torch, JAX and sln_tpu
blocked (a stub bpy stands in for Blender's); `--gan_shade
--semantic_source blender` through main raises BlenderNotAvailable with no
binary, as the JAX package's test.py does."""

import json
import os
import pathlib
import py_compile
import stat
import subprocess
import sys

import numpy as np
import pytest

from sln_tpu.render import assets as jassets
from sln_tpu.render.blender import scene_spec as jss
from sln_tpu_torch import test as entry
from sln_tpu_torch.data.vocab import NYU40_CLASSES, OBJECT_IDX_TO_NAME
from sln_tpu_torch.render import assets as tassets, blender_bridge
from sln_tpu_torch.render.blender import scene_spec as tss
from sln_tpu_torch.render.scene import RENDER_CLASSES
from sln_tpu_torch.workloads.plot2d import MAPPED_COLORS

REPO = pathlib.Path(__file__).resolve().parents[1]
BLENDER_DIR = REPO / "sln_tpu_torch" / "render" / "blender"
BPY_SCRIPTS = ("bpy_scene.py", "driver.py", "render_color.py",
               "render_semantic_depth.py")


def random_layout(rng, n=5):
    """(objs, boxes (n + 1, 6) normalized with the absolute room row last,
    angles): renderable and skipped classes, some boxes on the floor."""
    objs = [int(o) for o in rng.integers(1, len(OBJECT_IDX_TO_NAME), n)]
    lo = rng.uniform(0.0, 0.6, (n, 3))
    lo[::2, 1] = rng.uniform(-0.02, 0.02, len(lo[::2]))   # height snap
    hi = lo + rng.uniform(0.1, 0.4, (n, 3))
    room = np.concatenate([[0.0, 0.0, 0.0], rng.uniform(2.5, 6.0, 3)])
    boxes = np.concatenate([np.concatenate([lo, hi], 1), room[None]])
    return objs + [0], boxes, rng.uniform(0, 24, n + 1)


def shell_banks(rng, S=3):
    """The same three-entry shell bank in both packages' ShellBank."""
    sv, sf, sp = tassets.room_shell(2)
    verts = np.stack([sv] * S)
    verts[1:] = rng.uniform(0, 1, verts[1:].shape).astype(np.float32)
    fields = dict(verts=verts, faces=np.stack([sf] * S),
                  part=np.stack([sp] * S),
                  face_valid=rng.random((S, len(sf))) > 0.2,
                  ratio=rng.uniform(0.3, 2.0, (S, 2)).astype(np.float32))
    return jassets.ShellBank(**fields), tassets.ShellBank(**fields)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_math_matches_jax(seed):
    rng = np.random.default_rng(seed)
    objs, boxes, angles = random_layout(rng)
    for got, want in zip(tss.denormalize_scene(boxes),
                         jss.denormalize_scene(boxes)):
        np.testing.assert_array_equal(got, want)
    abs_boxes, dims = jss.denormalize_scene(boxes)
    mmin, mmax = rng.uniform(-1, 0, 3), rng.uniform(0.1, 2, 3)
    np.testing.assert_array_equal(
        tss.object_world_matrix(abs_boxes[0], angles[0], mmin, mmax),
        jss.object_world_matrix(abs_boxes[0], angles[0], mmin, mmax))
    for part in ("wall", "floor", "ceiling"):
        np.testing.assert_array_equal(
            tss.shell_world_matrix(dims, part, mmin, mmax),
            jss.shell_world_matrix(dims, part, mmin, mmax))
    with pytest.raises(ValueError):
        tss.shell_world_matrix(dims, "roof", mmin, mmax)
    world = rng.uniform(0, 1, (200, 3)) * dims
    np.testing.assert_array_equal(tss.wall_vertex_drop(world, dims),
                                  jss.wall_vertex_drop(world, dims))
    front = world.copy()
    front[:, 2] = dims[2]                        # a whole front wall
    assert tss.wall_vertex_drop(front, dims).all()
    unit = rng.uniform(0, 1, (200, 3))
    part = rng.integers(0, 3, 200)
    np.testing.assert_array_equal(
        tassets.shell_wall_drop_normalized(unit, part),
        jassets.shell_wall_drop_normalized(unit, part))
    unit[:, 2] = 0.95
    assert (tassets.shell_wall_drop_normalized(unit, part) == (part == 0)
            ).all()
    jshells, tshells = shell_banks(rng)
    for d in (dims, [1.0, 2.0, 0.5], [3.0, 1.0, 4.0]):
        assert tassets.retrieve_shell_np(d, tshells) == \
            jassets.retrieve_shell_np(d, jshells)
    bank = tassets.build_procedural_bank(1)
    np.testing.assert_array_equal(
        tss.retrieve_models_np(np.asarray(objs[:-1]), abs_boxes, bank),
        jss.retrieve_models_np(np.asarray(objs[:-1]), abs_boxes,
                               jassets.build_procedural_bank(1)))


@pytest.mark.parametrize("seed", [0, 5])
def test_camera_sampling_and_names_match_jax(seed):
    dims = np.random.default_rng(seed).uniform(2.0, 6.0, 3)
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        (xt, at), (xj, aj) = (tss.sample_camera(rt, dims),
                              jss.sample_camera(rj, dims))
        np.testing.assert_array_equal(xt, xj)
        assert at == aj
    z = np.random.default_rng(seed).uniform(0.1, 2.0, (32, 32))
    z[:4] = np.inf
    for zb in (z, z * 0.2, np.full((4, 4), np.inf)):
        assert tss.accept_view(zb) == jss.accept_view(zb)
    name = tss.pred_name("33433", 1)
    assert name == jss.pred_name("33433", 1) == "33433_pred_01"
    assert tss.color_filename("7", 3) == jss.color_filename("7", 3)
    for fn in ("depth_filename", "orig_filename"):
        assert getattr(tss, fn)(name) == getattr(jss, fn)(name)
    objs = list(range(len(OBJECT_IDX_TO_NAME)))
    assert tss.mask_classes_for(objs) == jss.mask_classes_for(objs)
    for cls in tss.mask_classes_for(objs):
        assert tss.mask_filename(name, cls) == jss.mask_filename(name, cls)
    for o in objs[1:]:
        assert tss.nyu_class_of(o) == jss.nyu_class_of(o)


def test_preview_classes_are_render_classes():
    """Every class the preview can rasterize (the NYU class of each
    renderable object, and the shell's wall, floor, ceiling) is one of the
    32 render classes: the fact the 32-class route rests on."""
    render = {c.replace("_", " ") for c in RENDER_CLASSES}
    classes = {tss.nyu_class_of(o) for o, name in
               enumerate(OBJECT_IDX_TO_NAME)
               if o and name not in tss.SKIP_IMPORT}
    classes |= {"wall", "floor", "ceiling"}
    assert classes <= render, classes - render
    assert classes <= set(NYU40_CLASSES)
    assert len(classes) == 27


def write_extracted(folder, layouts):
    data = {}
    for room_id, preds in layouts.items():
        objs = preds[0][0]
        data[room_id] = {"gt": {"objs": objs, "boxes": preds[0][1].tolist(),
                                "angles": preds[0][2].tolist()}}
        for k, (_, b, a) in enumerate(preds):
            data[room_id][str(k)] = {"boxes": b.tolist(),
                                     "angles": a.tolist()}
    os.makedirs(os.path.join(folder, "data"), exist_ok=True)
    with open(os.path.join(folder, "data", "data_extracted.json"), "w") as f:
        json.dump(data, f)


@pytest.mark.parametrize("banked", [False, True])
def test_layouts_and_scene_meshes_match_jax(banked, tmp_path, monkeypatch):
    """iter_extracted_layouts and scene_meshes (verts, faces, matrices and
    class names) on a data_extracted.json, with the procedural bank and
    shell, or with an .npz bank holding shells (SLN_TPU_ASSET_BANK)."""
    rng = np.random.default_rng(7)
    layouts = {"12": [random_layout(rng) for _ in range(3)],
               "40": [random_layout(rng) for _ in range(2)]}
    for preds in layouts.values():
        for p in preds[1:]:
            p[0][:] = preds[0][0]
    write_extracted(str(tmp_path), layouts)
    if banked:
        bank = jassets.build_procedural_bank(1)
        shells, _ = shell_banks(rng)
        path = tmp_path / "bank.npz"
        np.savez(path, **bank._asdict(), shell_verts=shells.verts,
                 shell_faces=shells.faces, shell_part=shells.part,
                 shell_face_valid=shells.face_valid,
                 shell_ratio=shells.ratio)
        monkeypatch.setenv("SLN_TPU_ASSET_BANK", str(path))
    tbank, tshells = tss.load_bank()
    jbank, jshells = jss.load_bank()
    assert (tshells is None) == (jshells is None) == (not banked)
    for field in tbank._fields:
        np.testing.assert_array_equal(getattr(tbank, field),
                                      getattr(jbank, field))
    args = dict(num_preds=3, rooms=["12", "40"])
    got = list(tss.iter_extracted_layouts(str(tmp_path), **args))
    want = list(jss.iter_extracted_layouts(str(tmp_path), **args))
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert len(got) == 5
    for (_, _, objs, boxes, angles), w in zip(got, want):
        np.testing.assert_array_equal(boxes, w[3])
        np.testing.assert_array_equal(angles, w[4])
        tm = tss.scene_meshes(objs, boxes, angles, tbank, tshells)
        jm = jss.scene_meshes(objs, boxes, angles, jbank, jshells)
        assert [m["name"] for m in tm] == [m["name"] for m in jm]
        assert [m["class_name"] for m in tm] == [m["class_name"] for m in jm]
        for a, b in zip(tm, jm):
            for key in ("verts", "faces", "matrix"):
                np.testing.assert_array_equal(a[key], b[key])


def fake_blender(folder) -> str:
    """A `blender` executable that writes its argv, one per line, to
    <folder>/argv.txt."""
    path = os.path.join(folder, "blender")
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\nprintf '%s\\n' \"$@\" > {folder}/argv.txt\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


@pytest.mark.parametrize("run,script", [
    (blender_bridge.run_color_render, "render_color.py"),
    (blender_bridge.run_mask_depth_render, "render_semantic_depth.py")])
def test_bridge_runs_the_ports_scripts(run, script, tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    binary = fake_blender(str(bin_dir))
    monkeypatch.setenv("PATH", str(bin_dir))
    assert blender_bridge.find_blender() == binary
    test_dir = str(tmp_path / "out")
    run(test_dir)
    argv = (bin_dir / "argv.txt").read_text().splitlines()
    assert argv == ["-b", "-P", str(BLENDER_DIR / script), "--", test_dir]
    assert os.path.isfile(argv[2])
    # --blender_path names the binary's directory; --blender_script wins
    monkeypatch.setenv("PATH", str(tmp_path))
    assert blender_bridge.find_blender(str(bin_dir)) == binary
    run(test_dir, str(bin_dir), "other.py")
    assert (bin_dir / "argv.txt").read_text().splitlines()[2] == "other.py"


def test_bridge_raises_without_blender(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(blender_bridge.BlenderNotAvailable):
        blender_bridge.find_blender()
    with pytest.raises(blender_bridge.BlenderNotAvailable):
        blender_bridge.find_blender(str(tmp_path / "nowhere"))
    for run in (blender_bridge.run_color_render,
                blender_bridge.run_mask_depth_render):
        with pytest.raises(blender_bridge.BlenderNotAvailable):
            run(str(tmp_path))


def test_gan_shade_blender_source_without_blender(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(blender_bridge.BlenderNotAvailable):
        entry.main(["--gan_shade", "--semantic_source", "blender",
                    "--device", "cpu", "--synthetic", "8",
                    "--allow_random_weights", "--test_dir",
                    str(tmp_path / "o")])


@pytest.mark.parametrize("fname", BPY_SCRIPTS)
def test_bpy_scripts_compile(fname):
    py_compile.compile(str(BLENDER_DIR / fname), doraise=True)


def test_blender_side_imports_without_torch():
    """scene_spec and the chain under it, then the bpy scripts (a stub bpy
    and mathutils in Blender's place), import with torch, JAX and sln_tpu
    unimportable, as in Blender's bundled Python."""
    code = (
        "import sys, types\n"
        "for m in ('torch', 'jax', 'jaxlib', 'flax', 'optax', 'sln_tpu',\n"
        "          'matplotlib', 'imageio', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "from sln_tpu_torch.render.blender import scene_spec\n"
        "scene_spec.scene_meshes([9, 0], [[0.1, 0, 0.1, 0.5, 0.4, 0.5],\n"
        "                        [0, 0, 0, 4, 3, 5]], [0.0, 0.0],\n"
        "                        *scene_spec.load_bank())\n"
        "for m in ('bpy', 'mathutils'):\n"
        "    sys.modules[m] = types.ModuleType(m)\n"
        "from sln_tpu_torch.render.blender import (bpy_scene, driver,\n"
        "    render_color, render_semantic_depth)\n"
        "print(render_color._class_color('bed'))\n"
        "print(sorted(k for k in sys.modules if k.startswith('sln_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    color, modules = out.stdout.splitlines()
    bed = MAPPED_COLORS[NYU40_CLASSES.index("bed")]
    assert color == str(tuple(float(c) / 255.0 for c in bed))
    assert "sln_tpu_torch.render.blender.render_color" in modules
