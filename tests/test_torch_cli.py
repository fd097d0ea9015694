"""The port's entry points accept every invocation of the reference CLI
that the root test.py accepts (tests/test_cli.py's REFERENCE_FLAGS with
each of its TEST_MODES, read from that file so the two lists never drift);
the flags that raised until their ROADMAP items were ported (8a, 8b) reach
their paths, and every mode parses at its defaults; --compute_dtype
and --spade_dtype reach the configuration and run, on the CPU at a tiny
size, through main."""

import ast
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sln_tpu.spade.generator import SPADEGenerator4 as JGen
from sln_tpu_torch import test as entry
from sln_tpu_torch.train import cli as train_cli
from sln_tpu_torch.workloads import common

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))


def _reference_lists():
    """REFERENCE_FLAGS and TEST_MODES as tests/test_cli.py assigns them."""
    with open(os.path.join(HERE, "test_cli.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("REFERENCE_FLAGS", "TEST_MODES"):
                out[name] = ast.literal_eval(node.value)
    return out["REFERENCE_FLAGS"], out["TEST_MODES"]


REFERENCE_FLAGS, TEST_MODES = _reference_lists()


@pytest.mark.parametrize("mode", TEST_MODES)
def test_every_reference_invocation_parses(mode, monkeypatch):
    monkeypatch.delenv("SUNCG_DIR", raising=False)
    args = entry.parse_args(REFERENCE_FLAGS + [mode, "--blender_path", "b"])
    assert getattr(args, mode.lstrip("-")) is True
    assert args.batch_size == 128 and args.embedding_dim == 64
    assert os.environ.get("SUNCG_DIR") == "/tmp/suncg"
    # the train-only flags parse and change nothing the modes read
    cfg = entry.build_cfg(args)
    assert cfg == entry.build_cfg(entry.parse_args(
        [mode, "--batch_size", "128", "--suncg_data_dir", "/tmp/suncg"]))


@pytest.mark.parametrize("argv,item", [
    (["--draw_3d"], "8a"),
    (["--draw_3d", "--renderer", "preview"], "8a"),
    (["--draw_3d", "--renderer", "blender"], "8b"),
    (["--fine_tune", "--renderer", "preview"], "8a"),
    (["--fine_tune", "--save_semantic_gifs"], "8a"),
    (["--gan_shade", "--semantic_source", "blender"], "8b"),
])
def test_unported_flags_raise_naming_their_item(argv, item, tmp_path,
                                                monkeypatch):
    """The invocations that raised until ROADMAP items 8a (the preview and
    the refine dumps) and 8b (the Blender bridge) were ported now reach
    their paths: each path is replaced by a recorder, the Blender bridge
    finding no binary."""
    from sln_tpu_torch.render import blender_bridge, preview
    from sln_tpu_torch.workloads import gan_shade, refine

    calls = []

    def record(name, result=None):
        def fn(*args, **kwargs):
            calls.append((name, kwargs))
            if isinstance(result, Exception):
                raise result
            return result
        return fn

    no_binary = blender_bridge.BlenderNotAvailable("no blender")
    monkeypatch.setattr(blender_bridge, "run_color_render",
                        record("color", no_binary))
    monkeypatch.setattr(blender_bridge, "run_mask_depth_render",
                        record("mask_depth"))
    monkeypatch.setattr(preview, "run_preview_renders", record("preview", 3))
    monkeypatch.setattr(refine, "finetune_rooms", record("fine_tune", {}))
    monkeypatch.setattr(gan_shade, "run_gan_shade", record("gan_shade", []))
    entry.main(argv + ["--device", "cpu", "--synthetic", "8",
                       "--allow_random_weights",
                       "--test_dir", str(tmp_path)])
    names = [c[0] for c in calls]
    renderer = argv[-1] if "--renderer" in argv else "auto"
    if argv[0] == "--draw_3d":
        assert names == {"auto": ["color", "preview"],
                         "preview": ["preview"],
                         "blender": ["color"]}[renderer]
        assert item == ("8b" if renderer == "blender" else "8a")
    elif argv[0] == "--fine_tune":
        assert names == ["fine_tune"]
        assert calls[0][1]["save_semantic"] == (
            "--save_semantic_gifs" in argv)
    else:
        assert names == ["mask_depth", "gan_shade"]
        assert calls[1][1]["semantic_dir"] == str(
            tmp_path / "data" / "semantic_masks")


@pytest.mark.parametrize("mode", TEST_MODES)
def test_defaults_never_raise(mode):
    """Every mode parses at its defaults into a configuration, with the
    JAX package's default renderer and mask source."""
    args = entry.parse_args([mode])
    assert getattr(args, mode.lstrip("-")) is True
    assert args.renderer == "auto" and args.semantic_source == "rasterizer"
    assert entry.build_cfg(args).test_dir == args.test_dir


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_flags_reach_the_config(dtype, tmp_path):
    cfg = entry.build_cfg(entry.parse_args(
        ["--fine_tune", "--compute_dtype", dtype, "--spade_dtype", dtype]))
    assert cfg.model.compute_dtype == cfg.spade.compute_dtype == dtype
    tcfg = train_cli.config_from_args(train_cli.parse_args(
        ["--compute_dtype", dtype]))
    assert tcfg.model.compute_dtype == dtype
    model = common.restore_model(
        cfg.replace(train=cfg.train.__class__(output_dir=str(tmp_path))),
        "cpu", allow_random=True)
    assert model.box_net.dtype == getattr(torch, dtype)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        cfg.model.__class__(compute_dtype="float16")


FINE_TUNE = ["--fine_tune", "--device", "cpu", "--synthetic", "8",
             "--allow_random_weights", "--embedding_dim", "16",
             "--gconv_num_layers", "2", "--refine_iters", "3",
             "--refine_render_size", "32", "--refine_pyramid", "16,32"]


def test_fine_tune_bf16_through_main(tmp_path):
    """The refine loop with a bfloat16 VAE: finite losses, the refine's
    pickles written, and another history than float32's."""
    hist = {dt: entry.main(FINE_TUNE + ["--compute_dtype", dt,
                                        "--test_dir", str(tmp_path / dt)])
            for dt in ("float32", "bfloat16")}
    (room, losses), = hist["bfloat16"].items()
    totals = np.array([h["total"] for h in losses])
    assert len(totals) == 3 and np.isfinite(totals).all()
    fp32 = np.array([h["total"] for h in hist["float32"][room]])
    assert not np.array_equal(totals, fp32)
    out = tmp_path / "bfloat16" / "data" / "finetune" / room
    assert {"z_value.pkl", "bbox_rot_gt.pkl"} <= set(os.listdir(out))


def test_gan_shade_bf16_through_main(tmp_path):
    """--gan_shade --spade_dtype bfloat16 on a 4-wide generator at 32 px:
    4 val rooms x 2 z PNGs."""
    ngf, nz, crop = 4, 8, 32
    jm = JGen(ngf=ngf, nz=nz, crop_size=crop)
    shapes = jax.eval_shape(lambda s, z: jm.init(jax.random.PRNGKey(0), s, z),
                            jnp.zeros((1, crop, crop, 41)),
                            jnp.zeros((1, nz)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (rng.standard_normal(x.shape) / np.sqrt(
        max(np.prod(x.shape[:-1]), 1))).astype(np.float32), shapes)
    path = tmp_path / "small.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"g_params": params,
                     "config": {"ngf": ngf, "crop": crop, "nz": nz}}, f)
    paths = entry.main(["--gan_shade", "--device", "cpu", "--synthetic", "8",
                        "--allow_random_weights", "--spade_dtype", "bfloat16",
                        "--spade_checkpoint", str(path), "--spade_crop",
                        str(crop), "--spade_ngf", str(ngf), "--num_z", "2",
                        "--test_dir", str(tmp_path / "o")])
    assert len(paths) == 4 * 2 and all(os.path.isfile(p) for p in paths)
