"""The port's image files (sln_tpu_torch/render/image_io.py) against the
libraries the JAX package writes and reads them with:

- read_png on files matplotlib wrote (RGB, RGBA, a gray colormap) and on
  Pillow's, whose adaptive filtering uses all five PNG filter types, equal
  to imageio's decode;
- write_png, write_png_gray and write_gif decoded by imageio, equal to the
  array, to plt.imsave(cmap="gray") and to imageio's own GIF;
- the refine loop's save_channel_images against the JAX package's on the
  same (70, S, S) stack: the same files, the same decoded pixels;
- spade_input_from_files on the Blender artifact set against the JAX
  loader's 41 channels, again with imageio and matplotlib unimportable;
- `--fine_tune --save_semantic_gifs` through the port's main: the JAX
  package's target set for the same room, the iteration dumps, and the
  same loss history as without the flag."""

import dataclasses
import os
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import matplotlib
import pytest
import torch
from PIL import Image

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from sln_tpu import config as jcfg  # noqa: E402
from sln_tpu.data import synthetic as jsyn, tensorize as jtens  # noqa: E402
from sln_tpu.data.augment import SizeInfo as JSizeInfo  # noqa: E402
from sln_tpu.render import assets as jassets, scene as jscene  # noqa: E402
from sln_tpu.workloads import gan_shade as jg, refine as jref  # noqa: E402
from sln_tpu_torch import test as entry  # noqa: E402
from sln_tpu_torch.render import image_io  # noqa: E402
from sln_tpu_torch.render.blender import scene_spec  # noqa: E402
from sln_tpu_torch.workloads import gan_shade as tg  # noqa: E402
from sln_tpu_torch.workloads import refine as tref  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


def filter_types(path) -> set:
    """The PNG filter type of every scanline of an 8-bit file."""
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    raw = zlib.decompress(idat)
    return {raw[r * stride] for r in range(h)}


def sample_image(rng, c=3, h=64, w=48):
    """Five bands, each best predicted by another PNG filter: a horizontal
    ramp (Sub), constant columns (Up), a diagonal ramp, a curved surface
    (Average, Paeth) and noise (None)."""
    yy, xx = np.mgrid[:h, :w]
    bands = [(xx * 7)[..., None] + np.zeros(c, int),
             (yy * 7)[..., None] + rng.integers(0, 256, (1, w, c)),
             ((xx + yy) * 5)[..., None] + np.arange(c) * 30,
             ((xx * yy) // 3)[..., None] + np.arange(c) * 50,
             rng.integers(0, 256, (h, w, c))]
    k = h // len(bands)
    img = np.concatenate([b[i * k:(i + 1) * k] for i, b in enumerate(bands)])
    return (img % 256).astype(np.uint8)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray_cmap"])
def test_read_png_matplotlib_files(kind, tmp_path):
    rng = np.random.default_rng(0)
    a = rng.random((33, 47, 4)).astype(np.float32)
    path = str(tmp_path / "m.png")
    if kind == "rgb":
        plt.imsave(path, a[..., :3])
    elif kind == "rgba":
        plt.imsave(path, a)
    else:
        plt.imsave(path, a[..., 0], cmap="gray")
    np.testing.assert_array_equal(image_io.read_png(path),
                                  imageio.imread(path))


@pytest.mark.parametrize("mode,c", [("L", 1), ("LA", 2), ("RGB", 3),
                                    ("RGBA", 4)])
def test_read_png_every_filter_type(mode, c, tmp_path):
    img = sample_image(np.random.default_rng(1), c=c)
    if c == 1:
        img = img[..., 0]
    path = str(tmp_path / "p.png")
    Image.fromarray(img, mode).save(path, optimize=True)
    assert filter_types(path) == {0, 1, 2, 3, 4}
    got = image_io.read_png(path)
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_write_png_decodes_to_the_array(c, tmp_path):
    img = sample_image(np.random.default_rng(2), c=c)
    img = img[..., 0] if c == 1 else img
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(image_io.read_png(path), img)


GRAY_CASES = {
    "random": lambda r: (r.random((40, 50)) * 3 - 1).astype(np.float32),
    "ramp": lambda r: np.linspace(0, 1, 2000, dtype=np.float32).reshape(
        40, 50),
    "constant": lambda r: np.full((20, 30), 0.5, np.float32),
    "float64": lambda r: r.random((33, 21)) * 7.0,
}


@pytest.mark.parametrize("case", sorted(GRAY_CASES))
def test_write_png_gray_matches_imsave(case, tmp_path):
    a = GRAY_CASES[case](np.random.default_rng(3))
    plt.imsave(tmp_path / "mpl.png", a, cmap="gray")
    image_io.write_png_gray(str(tmp_path / "port.png"), a)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "port.png"),
                                  imageio.imread(tmp_path / "mpl.png"))


GIF_CASES = {
    "random": lambda r: r.integers(0, 256, (64, 80)),
    "binary": lambda r: (r.random((96, 96)) > 0.5) * 255,
    "zeros": lambda r: np.zeros((5, 7)),
    "three_levels": lambda r: r.integers(0, 3, (200, 300)),
    "all_256_levels": lambda r: np.tile(np.arange(256), (40, 1)),
    # long enough to fill the 4,096-entry code table several times
    "table_resets": lambda r: r.integers(0, 256, (256, 256)),
}


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_write_gif_matches_imageio(case, tmp_path):
    a = GIF_CASES[case](np.random.default_rng(4)).astype(np.uint8)
    imageio.imwrite(tmp_path / "lib.gif", a)
    image_io.write_gif(str(tmp_path / "port.gif"), a)
    got = imageio.imread(tmp_path / "port.gif")
    np.testing.assert_array_equal(got, imageio.imread(tmp_path / "lib.gif"))
    np.testing.assert_array_equal(got if got.ndim == 2 else got[..., 0], a)


def render_stack(rng, S=40):
    """A (70, S, S) render stack: depth with background at -1 and beyond
    10, a few class channels with mass, the rest empty."""
    img = np.zeros((70, S, S), np.float32)
    img[0] = rng.uniform(1.0, 6.0, (S, S))
    img[0, :4] = -1.0
    img[0, -3:] = 12.0
    for c in (1, 2, 9, 33):
        img[1 + c] = np.clip(rng.normal(0.4, 0.5, (S, S)), -0.2, 1.3)
    img[41:] = rng.random((29, S, S))
    return img


@pytest.mark.parametrize("save_semantic", [False, True])
def test_save_channel_images_matches_jax(save_semantic, tmp_path):
    img = render_stack(np.random.default_rng(5))
    jref.save_channel_images(img, str(tmp_path / "jax"), "007",
                             save_semantic=save_semantic)
    tref.save_channel_images(img, str(tmp_path / "port"), "007",
                             save_semantic=save_semantic)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == (2 + 4 if save_semantic else 2)
    for name in names:
        np.testing.assert_array_equal(
            imageio.imread(tmp_path / "port" / name),
            imageio.imread(tmp_path / "jax" / name), err_msg=name)


def write_blender_artifacts(folder, size=64):
    """The semantic-masks artifact set as tests/test_blender_scripts.py's
    round trip writes it: the .npy depth sidecar, mask PNGs by plt.imsave
    in the Blender artifact names, and an _orig decoy; plus another room's
    mask to be ignored."""
    name = scene_spec.pred_name("42", 0)
    rng = np.random.default_rng(6)
    depth = rng.uniform(1.0, 3.0, (size, size)).astype(np.float32)
    np.save(os.path.join(folder, scene_spec.depth_filename(name).replace(
        ".exr", ".npy")), depth)
    bed = np.zeros((size, size), np.float32)
    bed[10:30, 10:30] = 1.0
    for cls, mask in (("bed", bed), ("wall", np.ones_like(bed)),
                      ("floor mat", bed),
                      ("sofa", (rng.random((size, size)) > 0.5) * 1.0)):
        plt.imsave(os.path.join(folder, scene_spec.mask_filename(name, cls)),
                   np.stack([mask] * 3, -1))
    plt.imsave(os.path.join(folder, scene_spec.orig_filename(name)),
               np.zeros((8, 8, 3)))
    plt.imsave(os.path.join(folder, scene_spec.mask_filename(
        scene_spec.pred_name("7", 0), "bed")), np.ones((size, size, 3)))


def test_spade_input_from_files_matches_jax_without_imageio(tmp_path):
    write_blender_artifacts(str(tmp_path))
    want = jg.spade_input_from_files(str(tmp_path), room="42")
    got = tg.spade_input_from_files(str(tmp_path), room="42")
    assert got.shape == (41, 64, 64)
    np.testing.assert_array_equal(got.transpose(1, 2, 0), want)
    # the same read with imageio and matplotlib unimportable, as on the
    # card's machine
    out = tmp_path / "got.npy"
    code = ("import sys, numpy as np\n"
            "for m in ('imageio', 'matplotlib', 'PIL', 'jax', 'sln_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from sln_tpu_torch.workloads.gan_shade import "
            "spade_input_from_files\n"
            f"np.save({str(out)!r}, spade_input_from_files("
            f"{str(tmp_path)!r}, room='42'))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(out), got)


FINE_TUNE = ["--fine_tune", "--device", "cpu", "--synthetic", "8",
             "--allow_random_weights", "--embedding_dim", "16",
             "--gconv_num_layers", "2", "--refine_iters", "3",
             "--refine_render_size", "32", "--refine_pyramid", "16,32"]


def jax_target_images(room_id, folder, size=32):
    """The JAX package's finetune_rooms target render of the same room
    (synthetic val rooms, seed 99, as the port's --synthetic 8 loads them)
    and its save_channel_images set. The target is the GT layout's render:
    no random stream reaches it."""
    cfg = jcfg.default_config()
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(8, seed=99),
                                   cfg.data.max_objects)
    si = JSizeInfo(*(jnp.asarray(x) for x in jsyn.default_size_table()))
    batch = jref._single_scene_batch(arrays, si, cfg, room_id)
    rcfg = dataclasses.replace(cfg.render, backend="jax",
                               camera=dataclasses.replace(
                                   cfg.render.camera, image_size=size))
    bank_host = jassets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = jscene.device_bank(bank_host, cfg.render.shell_subdiv)
    dims = np.asarray((batch.boxes * batch.room_mask[..., None]).sum(1))[0]
    abs_gt = np.asarray(batch.boxes[0]) * np.concatenate(
        [dims[3:], dims[3:]])[None]
    midx = jassets.retrieve_models(batch.objs[0], jnp.asarray(abs_gt),
                                   bank_host)
    target = jscene.render_layout(batch.objs[0], batch.boxes[0],
                                  batch.angles.astype(jnp.float32)[0],
                                  batch.obj_mask[0], midx, bank, rcfg)
    jref.save_channel_images(np.asarray(jax.device_get(target)), folder,
                             "target")


def test_fine_tune_dumps_through_main(tmp_path):
    hist = {flag: entry.main(FINE_TUNE + ["--test_dir", str(tmp_path / flag)]
                             + (["--save_semantic_gifs"] if flag == "gifs"
                                else []))
            for flag in ("plain", "gifs")}
    # the dumps leave the trajectory alone: the same bits
    assert hist["gifs"] == hist["plain"]
    (room, losses), = hist["gifs"].items()
    assert len(losses) == 3
    sets = {flag: set(os.listdir(tmp_path / flag / "data" / "finetune" /
                                 room)) for flag in hist}
    pkls = {"z_value.pkl", "bbox_rot_0.pkl", "bbox_rot_2.pkl",
            "bbox_rot_gt.pkl"}
    depth = {f"{p}_depth.{x}" for p in ("target", "000", "002")
             for x in ("png", "gif")}
    assert sets["plain"] == pkls | depth
    classes = sets["gifs"] - pkls - depth
    for prefix in ("000", "002"):
        assert f"{prefix}_wall.gif" in classes
        assert f"{prefix}_floor.gif" in classes
    assert all(c.split("_", 1)[0] in ("000", "002") for c in classes)
    jax_target_images(room, str(tmp_path / "jax"))
    out = tmp_path / "gifs" / "data" / "finetune" / room
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["target_depth.gif", "target_depth.png"]
    # two renders equal to float rounding: a truncated gray level may move
    # by one at a few pixels
    for name in names:
        want = imageio.imread(tmp_path / "jax" / name).astype(int)
        got = imageio.imread(out / name).astype(int)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        print(f"{name}: max level difference {diff.max()}, "
              f"{(diff > 0).mean():.4%} of values differ")
        assert diff.max() <= 1, name
        assert (diff == 0).mean() >= 0.995, name
