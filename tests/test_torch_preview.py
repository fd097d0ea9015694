"""The rasterizer-shaded preview (sln_tpu_torch/render/preview.py) against
the JAX package's (sln_tpu/render/preview.py), both on the CPU:

- shade on random depth and classes, atol 1e-5;
- render_preview on tests/test_preview.py's demo layout and three seeded
  layouts at 64 px: before shading, depth within atol 1e-3 / rtol 1e-4
  and the 40 class channels within 1e-4 (the kernel gates), the same
  foreground and the same winning class wherever the top two differ by
  more than 1e-4; after shading, RGB within 2e-3;
- the 32-render-class route scattered to NYU-40 against a direct 40-class
  render, within 1e-6;
- run_preview_renders: the same file names, uint8 pixels within 1 at
  99.9 % of pixels or more;
- `python -m sln_tpu_torch.test --draw_3d` through main after
  `--batch_gen`, under each renderer."""

import json
import os
import pathlib

import numpy as np
import imageio.v2 as imageio
import jax.numpy as jnp
import pytest
import torch

from sln_tpu.config import CameraConfig as JCameraConfig
from sln_tpu.data.vocab import NYU40_CLASSES as J_NYU40
from sln_tpu.render import camera as jcam, preview as jp, rasterizer as jrz
from sln_tpu.render.blender import scene_spec as jss
from sln_tpu_torch import test as entry
from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME
from sln_tpu_torch.render import preview as tp
from sln_tpu_torch.render import rasterizer as trz, rasterizer_cuda as trc

torch.set_num_threads(2)
ARTIFACTS = str(pathlib.Path(__file__).resolve().parents[1] / "artifacts")
S = 64
DEPTH_TOL = dict(rtol=1e-4, atol=1e-3)


def demo_layout():
    """tests/test_preview.py's 2-object room (last row = absolute room)."""
    boxes = np.array([[0.15, 0.0, 0.20, 0.45, 0.35, 0.50],
                      [0.55, 0.0, 0.30, 0.80, 0.30, 0.55],
                      [0.0, 0.0, 0.0, 4.0, 2.6, 4.5]])
    return [17, 7, 31], boxes, np.array([0.0, 6.0, 0.0])


def seeded_layout(seed, n=6):
    """n objects of renderable classes, some flush with the floor, in a
    room of random extent."""
    rng = np.random.default_rng(seed)
    renderable = [i for i, name in enumerate(OBJECT_IDX_TO_NAME)
                  if i and name not in jss.SKIP_IMPORT]
    objs = [int(o) for o in rng.choice(renderable, n)]
    lo = rng.uniform(0.0, 0.65, (n, 3))
    lo[::2, 1] = 0.0
    hi = lo + rng.uniform(0.1, 0.35, (n, 3))
    room = np.concatenate([[0.0, 0.0, 0.0], rng.uniform(2.5, 6.0, 3)])
    boxes = np.concatenate([np.concatenate([lo, hi], 1), room[None]])
    return objs + [0], boxes, rng.uniform(0, 24, n + 1)


LAYOUTS = {"demo": demo_layout(), **{f"seed{s}": seeded_layout(s)
                                     for s in (0, 1, 2)}}


def jax_preshade(objs, boxes, angles, bank, shells, image_size=S):
    """sln_tpu/render/preview.py render_preview up to its shade call:
    (depth (S, S), classes (S, S, 40), focal)."""
    meshes = jss.scene_meshes(objs, boxes, angles, bank, shells)
    verts, faces, fcls = jp._world_faces(meshes)
    _, dims = jss.denormalize_scene(boxes)
    dims = np.maximum(np.abs(dims), 0.1)
    F = len(faces)
    Fp = max(512, 1 << int(np.ceil(np.log2(F))))
    pad = Fp - F
    faces = np.concatenate([faces, np.zeros((pad, 3), np.int64)])
    fcls = np.concatenate([fcls, np.zeros(pad, np.int32)])
    fvalid = np.concatenate([np.ones(F, bool), np.zeros(pad, bool)])
    cfg = JCameraConfig(image_size=image_size)
    cam = jcam.camera_from_room(jnp.asarray(dims, jnp.float32), cfg)
    v2d, z = jcam.project(jcam.to_camera(jnp.asarray(verts), cam), cam)
    tri2d, triz = v2d[faces], z[faces]
    valid = (triz > cfg.near).all(-1) & jnp.asarray(fvalid)
    geom = jrz.face_geometry(tri2d, triz, valid, jnp.asarray(fcls))
    depth, classes = jrz.soft_rasterize(geom, len(J_NYU40), image_size,
                                        sigma=0.35, gamma=0.015, z_far=15.0)
    return np.asarray(depth), np.asarray(classes), float(cam.focal)


@pytest.fixture(scope="module")
def banks():
    return jss.load_bank(), tp.scene_spec.load_bank()


@pytest.mark.parametrize("seed", [0, 1])
def test_shade_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 8.0, (48, 48)).astype(np.float32)
    depth[:5] = 15.0                                  # far plane
    classes = (rng.random((48, 48, 40)) ** 8).astype(np.float32)
    classes[10:20, 10:20] = 0.0                       # uncovered
    want = jp.shade(depth, classes, focal=25.0, z_far=15.0)
    got = tp.shade(torch.as_tensor(depth), torch.as_tensor(classes),
                   focal=25.0, z_far=15.0).numpy()
    print(f"shade seed {seed}: max abs err {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (want[:5] == 1.0).all() and (want[10:20, 10:20] == 1.0).all()


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_render_preview_matches_jax(name, banks):
    (jbank, jshells), (tbank, tshells) = banks
    objs, boxes, angles = LAYOUTS[name]
    d_j, c_j, focal_j = jax_preshade(objs, boxes, angles, jbank, jshells)
    geom, focal = tp.layout_geometry(objs, boxes, angles, tbank, tshells, S,
                                     device="cpu")
    assert focal == focal_j
    with torch.no_grad():
        d_t, c_t = tp.rasterize_nyu(geom, S)
    d_t, c_t = d_t[0].numpy(), c_t[0].numpy()
    np.testing.assert_allclose(d_t, d_j, **DEPTH_TOL)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-4)
    fg_j = (c_j.sum(-1) > 0.5) & (d_j < 15.0 * 0.99)
    fg_t = (c_t.sum(-1) > 0.5) & (d_t < 15.0 * 0.99)
    np.testing.assert_array_equal(fg_t, fg_j)
    assert fg_j.mean() > 0.3
    top2 = np.sort(c_j, -1)[..., -2:]
    clear = fg_j & (top2[..., 1] - top2[..., 0] > 1e-4)
    np.testing.assert_array_equal(c_t.argmax(-1)[clear],
                                  c_j.argmax(-1)[clear])
    rgb_j = jp.shade(d_j, c_j, focal_j, 15.0)
    np.testing.assert_allclose(
        jp.render_preview(objs, boxes, angles, jbank, jshells,
                          image_size=S), rgb_j, rtol=0, atol=1e-6)
    rgb_t = tp.render_preview(objs, boxes, angles, tbank, tshells,
                              image_size=S, device="cpu").numpy()
    print(f"{name}: depth max abs err {np.abs(d_t - d_j).max():.3e}, "
          f"classes {np.abs(c_t - c_j).max():.3e}, RGB "
          f"{np.abs(rgb_t - rgb_j).max():.3e}; winning class compared at "
          f"{int(clear.sum())} of {int(fg_j.sum())} foreground pixels")
    np.testing.assert_allclose(rgb_t, rgb_j, rtol=0, atol=2e-3)


@pytest.mark.parametrize("raster", [trz.soft_rasterize,
                                    trc.soft_rasterize_cuda])
def test_render_class_route_equals_40_classes(raster, banks):
    """Render classes scattered to NYU-40 against the same faces carrying
    their NYU-40 class, in the port's plain dense and culled paths."""
    _, (tbank, tshells) = banks
    geom, _ = tp.layout_geometry(*LAYOUTS["seed1"], tbank, tshells, S,
                                 device="cpu")
    nyu = torch.as_tensor(tp.RC_TO_NYU)[geom.face_class]
    with torch.no_grad():
        d32, c32 = tp.rasterize_nyu(geom, S, raster=raster)
        d40, c40 = raster(geom._replace(face_class=nyu), 40, S, sigma=0.35,
                          gamma=0.015, z_far=15.0)
    print(f"{raster.__name__}: 32 + scatter vs 40 classes, depth "
          f"{(d32 - d40).abs().max():.3e}, classes "
          f"{(c32 - c40).abs().max():.3e}")
    np.testing.assert_allclose(d32.numpy(), d40.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c32.numpy(), c40.numpy(), rtol=0, atol=1e-6)
    assert float(c40.sum()) > 0


def write_extracted(folder, layouts):
    """{room: [(objs, boxes, angles), ...]} -> data/data_extracted.json."""
    data = {}
    for room, preds in layouts.items():
        data[room] = {"gt": {"objs": preds[0][0]}}
        for k, (_, b, a) in enumerate(preds):
            data[room][str(k)] = {"boxes": b.tolist(), "angles": a.tolist()}
    os.makedirs(os.path.join(folder, "data"), exist_ok=True)
    with open(os.path.join(folder, "data", "data_extracted.json"), "w") as f:
        json.dump(data, f)


def test_run_preview_renders_matches_jax(tmp_path):
    objs, boxes, angles = LAYOUTS["seed2"]
    layouts = {"42": [(objs, boxes, angles),
                      (objs, boxes * 1.01, angles + 3)],
               "7": [LAYOUTS["demo"]]}
    for d in ("j", "t"):
        write_extracted(str(tmp_path / d), layouts)
    assert jp.run_preview_renders(str(tmp_path / "j"), image_size=S) == 3
    assert tp.run_preview_renders(str(tmp_path / "t"), image_size=S,
                                  device="cpu") == 3
    names = sorted(os.listdir(tmp_path / "j" / "data" / "rendered"))
    assert sorted(os.listdir(tmp_path / "t" / "data" / "rendered")) == names
    assert names == ["42_pred_00_3d.png", "42_pred_01_3d.png",
                     "7_pred_00_3d.png"]
    for name in names:
        want = imageio.imread(tmp_path / "j" / "data" / "rendered" / name)
        got = imageio.imread(tmp_path / "t" / "data" / "rendered" / name)
        assert got.shape[:2] == want.shape[:2] == (S, S)
        diff = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))
        print(f"{name}: max level difference {diff.max()}, "
              f"{(diff > 0).any(-1).mean():.4%} of pixels differ")
        assert diff.max() <= 1, name
        assert (diff == 0).all(-1).mean() >= 0.999, name


@pytest.fixture(scope="module")
def batch_gen_dir(tmp_path_factory):
    """`--batch_gen` through main on the committed checkpoint, its
    data_extracted.json cut to one room of two layouts."""
    out = str(tmp_path_factory.mktemp("draw3d"))
    path = entry.main(["--batch_gen", "--synthetic", "8", "--batch_size",
                       "8", "--output_dir", ARTIFACTS, "--checkpoint_name",
                       "bench", "--test_dir", out, "--device", "cpu"])
    with open(path) as f:
        data = json.load(f)
    room = sorted(data)[0]
    data = {room: {k: v for k, v in data[room].items() if k in
                   ("gt", "0", "1")}}
    with open(path, "w") as f:
        json.dump(data, f)
    return out, room


@pytest.mark.parametrize("renderer", ["preview", "auto", "blender"])
def test_draw_3d_through_main(renderer, batch_gen_dir, tmp_path, capsys,
                              monkeypatch):
    """--draw_3d after --batch_gen, with no Blender binary on PATH: preview
    and auto (which says it falls back) write one PNG per layout, the same
    bytes; blender says it is unavailable and writes nothing. The preview
    is cut to 64 px here (the CLI renders 256)."""
    src, room = batch_gen_dir
    test_dir = tmp_path / "o"
    os.makedirs(test_dir / "data")
    os.link(os.path.join(src, "data", "data_extracted.json"),
            test_dir / "data" / "data_extracted.json")
    monkeypatch.setenv("PATH", str(tmp_path))
    run = tp.run_preview_renders
    monkeypatch.setattr(tp, "run_preview_renders", lambda d, **kw: run(
        d, image_size=S, **kw))
    n = entry.main(["--draw_3d", "--renderer", renderer, "--test_dir",
                    str(test_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    rendered = test_dir / "data" / "rendered"
    if renderer == "blender":
        assert n is None and "draw_3d unavailable" in out
        assert not rendered.exists()
        return
    assert ("using the rasterizer preview renderer" in out) == (
        renderer == "auto")
    assert n == 2
    names = sorted(os.listdir(rendered))
    assert names == [f"{room}_pred_0{k}_3d.png" for k in (0, 1)]
    ref = tmp_path / "ref"
    os.makedirs(ref / "data")
    os.link(test_dir / "data" / "data_extracted.json",
            ref / "data" / "data_extracted.json")
    run(str(ref), image_size=S, device="cpu")
    for name in names:
        assert (rendered / name).read_bytes() == \
            (ref / "data" / "rendered" / name).read_bytes()
        img = imageio.imread(rendered / name)
        assert img.shape == (S, S, 3) and (img < 250).any(-1).mean() > 0.3
