"""The port's shading workload (sln_tpu_torch.workloads.gan_shade) and its
entry point (python -m sln_tpu_torch.test --gan_shade) against the JAX
package's on the CPU, at a small size (ngf 8, nz 16, crop 64):

- the SPADE input (rendered or read from Blender's files), the shading
  target and the input resize (1e-6 / 1e-5);
- make_spade_model's weight sources, in the JAX package's order, on a
  float16 pickle written from JAX parameters;
- colorize fed JAX's own z draws (uint8 within one level at every pixel)
  and the quality metrics;
- the rendered SPADE inputs of held-out rooms (the quality cell's
  render_spade_inputs);
- the entry point's PNGs, whose pixels equal matplotlib's imsave's.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import matplotlib
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from sln_tpu import config as jcfg  # noqa: E402
from sln_tpu.spade.generator import SPADEGenerator4 as JGen  # noqa: E402
from sln_tpu.workloads import gan_shade as jg  # noqa: E402
from sln_tpu_torch import test as entry  # noqa: E402
from sln_tpu_torch import config as tcfg  # noqa: E402
from sln_tpu_torch.render import rasterizer as trz  # noqa: E402
from sln_tpu_torch.render import scene as tscene  # noqa: E402
from sln_tpu_torch.spade.generator import SPADEGenerator4  # noqa: E402
from sln_tpu_torch.workloads import gan_shade as tg  # noqa: E402
from sln_tpu_torch.workloads.plot2d import write_png  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

NGF, NZ, CROP = 8, 16, 64


def seg_map(rng, S, B=None):
    """(S, S, 41) (or (B, S, S, 41)): depth in [-1, 1] and one class mask
    set per pixel."""
    lead = () if B is None else (B,)
    seg = np.zeros(lead + (S, S, 41), np.float32)
    seg[..., 0] = rng.uniform(-1, 1, lead + (S, S))
    cls = rng.integers(1, 41, lead + (S, S))
    np.put_along_axis(seg, cls[..., None], 1.0, -1)
    return seg


def chw(x):
    """(..., H, W, C) numpy -> (..., C, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def hwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small generator's params (seeded normals) and its float16 pickle
    in the shading trainer's format."""
    jm = JGen(ngf=NGF, nz=NZ, crop_size=CROP)
    shapes = jax.eval_shape(lambda s, z: jm.init(jax.random.PRNGKey(0), s,
                                                 z),
                            jnp.zeros((1, CROP, CROP, 41)),
                            jnp.zeros((1, NZ)))["params"]
    rng = np.random.default_rng(0)

    def fill(x):
        if len(x.shape) == 1:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float16)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            np.float16)
    p16 = jax.tree.map(fill, shapes)
    path = tmp_path_factory.mktemp("spade") / "small.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"g_params": p16,
                     "config": {"ngf": NGF, "nz": NZ, "crop": CROP}}, f)
    return jm, jax.tree.map(lambda a: a.astype(np.float32), p16), str(path)


def port_cfg(tmp_path, **spade):
    return tcfg.default_config().replace(
        spade=tcfg.SpadeConfig(**spade),
        train=tcfg.TrainConfig(output_dir=str(tmp_path)))


# ---------------------------------------------------------------------------
# inputs and targets
# ---------------------------------------------------------------------------
def test_layout_channels_to_spade_input_matches_jax():
    rng = np.random.default_rng(0)
    ch = rng.uniform(0, 1, (70, 32, 32)).astype(np.float32)
    ch[0] = rng.uniform(1, 8, (32, 32))
    ch[0, :4, :4] = -1.0                      # uncovered pixels
    got = hwc(tg.layout_channels_to_spade_input(torch.from_numpy(ch)))
    np.testing.assert_allclose(got, jg.layout_channels_to_spade_input(ch),
                               rtol=0, atol=1e-6)
    ch[0] = -1.0                              # no covered pixel at all
    got = hwc(tg.layout_channels_to_spade_input(torch.from_numpy(ch)))
    np.testing.assert_allclose(got, jg.layout_channels_to_spade_input(ch),
                               rtol=0, atol=1e-6)


def test_shading_target_matches_jax():
    """Batched and single, borders included: the depth gradient is
    one-sided first order at the image edges in both packages."""
    rng = np.random.default_rng(1)
    seg = seg_map(rng, 32, B=2)
    seg[0, ..., 0] = np.linspace(-1, 1, 32)[None, :] ** 3   # smooth ramp
    want = np.asarray(jg.shading_target(seg))
    got = hwc(tg.shading_target(chw(seg)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hwc(tg.shading_target(chw(seg[1]))),
                               want[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [(128, 32), (100, 64), (32, 64)])
def test_resize_spade_input_matches_jax(src, dst):
    """Downsampling is antialiased, as jax.image.resize's default is; the
    masks are re-binarized."""
    s = seg_map(np.random.default_rng(2), src)
    want = jg.resize_spade_input(s, dst)
    got = hwc(tg.resize_spade_input(chw(s), dst))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert set(np.unique(got[..., 1:])) <= {0.0, 1.0}
    same = chw(s)
    assert tg.resize_spade_input(same, src) is same


def test_spade_input_from_files_matches_jax(tmp_path):
    """Blender-written outputs (the .npy depth sidecar and mask PNGs, with
    decoys to ignore) read into the same 41-channel stack."""
    rng = np.random.default_rng(3)
    np.save(tmp_path / "42_pred_00_depth.npy",
            rng.uniform(1.0, 3.0, (48, 48)).astype(np.float32))
    for cls in ("bed", "wall", "floor_mat"):
        mask = (rng.random((48, 48)) > 0.5).astype(np.float32)
        plt.imsave(tmp_path / f"42_pred_00_{cls}.png",
                   np.stack([mask] * 3, -1))
    plt.imsave(tmp_path / "42_pred_00_orig.png", np.ones((8, 8, 3)))
    plt.imsave(tmp_path / "7_pred_00_bed.png", np.ones((48, 48, 3)))
    got = tg.spade_input_from_files(str(tmp_path), room="42")
    want = jg.spade_input_from_files(str(tmp_path), room="42")
    assert got.shape == (41, 48, 48)
    np.testing.assert_array_equal(got.transpose(1, 2, 0), want)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def test_native_checkpoint_loads_at_its_dims(small, tmp_path):
    """An explicit pickle defines the model's dims (not cfg.spade's), and
    its float16 leaves load as float32."""
    _, p32, path = small
    model = tg.make_spade_model(port_cfg(tmp_path), path, device="cpu")
    assert (model.ngf, model.nz, model.crop_size) == (NGF, NZ, CROP)
    assert not model.training
    w = model.state_dict()["up_3.conv_0.1.weight"]
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), p32["up_3"]["conv_0"]["conv"]["kernel"].transpose(
            3, 2, 0, 1))


def test_weight_source_order(small, tmp_path, monkeypatch, capsys):
    """Mirrors tests/test_gan_shade.py: a missing explicit path raises; a
    default candidate trained at other ngf/crop than requested is skipped
    (then random init, with its WARNING); the same file named explicitly
    wins; <output_dir>/latest_net_G_AB.pth outranks the committed
    artifact; the "random" sentinel prints no warning."""
    _, _, path = small
    cfg = port_cfg(tmp_path, ngf=4, crop_size=64, nz=NZ)
    with pytest.raises(FileNotFoundError):
        tg.make_spade_model(cfg, str(tmp_path / "missing.ckpt"),
                            device="cpu")

    monkeypatch.setattr(tg, "default_spade_checkpoint_path", lambda: path)
    model = tg.make_spade_model(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "Skipping" in out and "WARNING" in out and "random init" in out
    assert (model.ngf, model.crop_size) == (4, 64)
    model = tg.make_spade_model(cfg, path, device="cpu")
    assert model.ngf == NGF and "Loaded SPADE weights" in \
        capsys.readouterr().out

    ref = SPADEGenerator4(41, 3, NZ, 4, 64).state_dict()
    torch.save(ref, tmp_path / "latest_net_G_AB.pth")
    model = tg.make_spade_model(cfg, device="cpu")
    assert "Ported SPADE weights" in capsys.readouterr().out
    for k, v in ref.items():
        assert torch.equal(model.state_dict()[k], v), k

    tg.make_spade_model(cfg, "random", device="cpu")
    assert "WARNING" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# colorize and the metrics
# ---------------------------------------------------------------------------
def test_colorize_matches_jax_draws(small):
    """13 z in chunks of 10 (the last one padded, then trimmed), JAX's own
    z draws fed to the port: uint8 images within one level of JAX's at
    every pixel, float images within 1e-5."""
    jm, p32, path = small
    seg = seg_map(np.random.default_rng(3), CROP)
    cfg = tcfg.default_config()
    model = tg.make_spade_model(cfg, path, device="cpu")
    zs = torch.from_numpy(np.array(jg._draw_zs(jax.random.PRNGKey(0), 2,
                                                 10, 10, NZ)))
    want = jg.colorize(jm, p32, seg, num_z=13, out_dtype="uint8")
    got = tg.colorize(model, chw(seg), zs, 13, out_dtype="uint8")
    assert got.dtype == np.uint8 and got.shape == want.shape == (13, CROP,
                                                                 CROP, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    f = tg.colorize(model, chw(seg), zs, 13)
    q = np.round(np.clip(f, 0, 1) * 255.0)
    assert np.abs(got.astype(np.float64) - q).max() <= 1.0
    assert ((f >= 0) & (f <= 1)).all()


def test_shading_metrics_match_jax(small):
    jm, p32, path = small
    rng = np.random.default_rng(4)
    seg = seg_map(rng, CROP, B=2)
    rgb = np.asarray(jg.shading_target(seg))
    z = rng.standard_normal((2, NZ)).astype(np.float32)
    l1_j, psnr_j, mse_j = jg.make_shading_metrics(jm)(p32, seg, rgb, z)
    model = tg.make_spade_model(tcfg.default_config(), path, device="cpu")
    l1, psnr, mse = tg.make_shading_metrics(model)(
        chw(seg), chw(rgb), torch.from_numpy(z))
    np.testing.assert_allclose([l1, mse], [float(l1_j), float(mse_j)],
                               rtol=1e-5)
    assert abs(psnr - float(psnr_j)) < 1e-4
    assert tg.psnr_from_mse(mse) == jg.psnr_from_mse(mse)


# ---------------------------------------------------------------------------
# the rendered inputs of held-out rooms
# ---------------------------------------------------------------------------
def test_render_spade_inputs_matches_jax(monkeypatch):
    """The quality cell's rooms (synthetic seed 19, graph keys from 100)
    through mesh retrieval, the render and the SPADE input conversion.
    Both sides rasterize with the dense formula (the JAX package's CPU
    path): the culled path that the card runs drops sliver faces' wide
    line-distance coverage, an open fault of both packages' tiled
    rasterizers (ROADMAP §3)."""
    monkeypatch.setattr(tscene, "soft_rasterize_cuda",
                        lambda g, C, S, **kw: trz.soft_rasterize(g, C, S,
                                                                 **kw))
    O = 12
    jc = jcfg.default_config().replace(data=jcfg.DataConfig(
        max_objects=O, max_triples=3 * O, max_on_rels=O))
    tc = tcfg.default_config().replace(data=tcfg.DataConfig(
        max_objects=O, max_triples=3 * O, max_on_rels=O))
    want = jg.render_spade_inputs(2, jc, 48, synthetic_seed=19,
                                  key_offset=100)
    got = hwc(tg.render_spade_inputs(2, tc, 48, synthetic_seed=19,
                                     key_offset=100, device="cpu"))
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def test_png_writer_matches_imsave(tmp_path):
    a = np.random.default_rng(5).integers(0, 256, (17, 23, 3), np.uint8)
    write_png(str(tmp_path / "a.png"), a)
    plt.imsave(tmp_path / "b.png", a)
    ours, theirs = (mpimg.imread(tmp_path / n) for n in ("a.png", "b.png"))
    np.testing.assert_array_equal(ours, theirs[..., :3])
    np.testing.assert_array_equal(np.round(ours * 255).astype(np.uint8), a)


def test_gan_shade_entry_point_writes_pngs(small, tmp_path):
    """--gan_shade on the CPU: the first four val rooms, num_z images each,
    named <room>_<kkk>_color.png; the first room's images are colorize's
    for that room, pixel for pixel as imsave writes them."""
    _, _, path = small
    argv = ["--gan_shade", "--device", "cpu", "--synthetic", "16",
            "--allow_random_weights", "--spade_crop", "64", "--spade_ngf",
            "8", "--num_z", "3", "--spade_checkpoint", path,
            "--test_dir", str(tmp_path)]
    paths = entry.main(argv)
    cfg = entry.build_cfg(entry.parse_args(argv))
    _, val, size_info = entry.setup(entry.parse_args(argv), cfg, "cpu",
                                    train=False)[1:]
    rooms = [int(r) for r in val["room_ids"][:4]]
    out_dir = tmp_path / "data" / "SPADE_out"
    names = sorted(f"{r}_{k:03d}_color.png" for r in rooms for k in range(3))
    assert sorted(os.listdir(out_dir)) == names
    assert sorted(paths) == sorted(str(out_dir / n) for n in names)

    rcfg, bank_host, bank = tg._render_setup(cfg, 64, "cpu")
    with torch.no_grad():
        seg = tg.layout_channels_to_spade_input(tg.render_scene_channels(
            tg._room_batch(val, 0, size_info, cfg, 0, "cpu"), bank_host,
            bank, rcfg))
    model = tg.make_spade_model(cfg, path, device="cpu")
    rgb = tg.colorize(model, seg, tg.draw_zs(3, NZ, device="cpu"), 3,
                      out_dtype="uint8")
    for k in range(3):
        plt.imsave(tmp_path / "ref.png", rgb[k])
        ours = mpimg.imread(out_dir / f"{rooms[0]}_{k:03d}_color.png")
        assert ours.shape == (64, 64, 3)
        np.testing.assert_array_equal(
            ours, mpimg.imread(tmp_path / "ref.png")[..., :3])


def test_unported_paths_raise(small, tmp_path):
    """bf16 shading (ROADMAP item 10), the Blender mask render (item 8)
    and the z-sharded colorize (item 9) raise, naming their item."""
    _, _, path = small
    with pytest.raises(NotImplementedError, match="item 10"):
        tg.make_spade_model(port_cfg(tmp_path, compute_dtype="bfloat16"),
                            "random", device="cpu")
    base = ["--gan_shade", "--device", "cpu", "--synthetic", "8",
            "--allow_random_weights", "--spade_checkpoint", path,
            "--test_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="item 10"):
        entry.main(base + ["--spade_dtype", "bfloat16"])
    with pytest.raises(NotImplementedError, match="item 8"):
        entry.main(base + ["--semantic_source", "blender"])
    model = tg.make_spade_model(tcfg.default_config(), path, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        tg.colorize(model, torch.zeros(41, CROP, CROP),
                    torch.zeros(1, 10, NZ), 10, mesh=object())
