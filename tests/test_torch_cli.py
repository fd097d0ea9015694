"""The port's entry points accept every invocation of the reference CLI
that the root test.py accepts (tests/test_cli.py's REFERENCE_FLAGS with
each of its TEST_MODES, read from that file so the two lists never drift);
the flags whose paths are not ported raise NotImplementedError naming
their ROADMAP item when used, and never at their defaults; --compute_dtype
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
def test_unported_flags_raise_naming_their_item(argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}\\)"):
        entry.main(argv + ["--device", "cpu", "--synthetic", "8",
                           "--allow_random_weights",
                           "--test_dir", str(tmp_path)])


@pytest.mark.parametrize("mode", TEST_MODES)
def test_defaults_never_raise(mode):
    argv = [] if mode == "--draw_3d" else [mode]
    entry.check_ported(entry.parse_args(argv + ["--renderer", "auto"]))


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
