"""The port's plots and its test.py sampling and evaluation modes
(--batch_gen, --measure_acc_l1_std, --heat_map, --draw_2d) on the CPU:
the 2D plot's geometry against the JAX package, and each mode through
sln_tpu_torch.test.main(["--device", "cpu", ...]) writing its files."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from sln_tpu.workloads import plot2d as jplot
from sln_tpu_torch import test as entry
from sln_tpu_torch.workloads import plot2d as tplot

torch.set_num_threads(2)

CKPT = dict(output_dir="artifacts", checkpoint_name="bench")


def test_plot2d_matches_jax_and_writes_png(tmp_path):
    rng = np.random.default_rng(2)
    room = np.array([4.0, 2.8, 5.0])
    for _ in range(5):
        lo = rng.uniform(0, 0.6, 3)
        box = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, 3)])
        angle = rng.uniform(0, 24)
        np.testing.assert_array_equal(
            tplot.rotated_footprint(box, angle, room),
            jplot.rotated_footprint(box, angle, room))
    out = str(tmp_path / "demo.png")
    tplot.plot2d(entry.DEMO_BOXES, entry.DEMO_ROTS, entry.DEMO_OBJS, out)
    assert os.path.getsize(out) > 0


# ---------------------------------------------------------------------------
# the entry point's modes, on the CPU
# ---------------------------------------------------------------------------
def cli(tmp_path, *mode):
    return entry.main([*mode, "--synthetic", "16", "--batch_size", "8",
                       "--output_dir",
                       CKPT["output_dir"], "--checkpoint_name",
                       CKPT["checkpoint_name"], "--test_dir", str(tmp_path),
                       "--device", "cpu"])


@pytest.mark.parametrize("mode", ["--batch_gen", "--measure_acc_l1_std",
                                  "--heat_map", "--draw_2d"])
def test_cli_mode_writes_its_files(mode, tmp_path, capsys):
    extra = ("--heatmap_iters", "64") if mode == "--heat_map" else ()
    out = cli(tmp_path, mode, *extra)
    printed = capsys.readouterr().out
    if mode == "--batch_gen":
        assert os.path.isfile(tmp_path / "mean_cov.pkl")
        with open(out) as f:
            assert len(json.load(f)) == 8      # the 16 // 4 -> 8 val rooms
    elif mode == "--measure_acc_l1_std":
        assert os.path.isfile(tmp_path / "mean_cov.pkl")
        assert "PRED, RAND, PERT ACC: " in printed
        assert "mean pos std:" in printed
        assert all(np.isfinite(v) for v in out.values())
        assert 0.5 < out["acc_pred"] <= 1.0
    elif mode == "--heat_map":
        assert len(out) == 5 and all(os.path.isfile(p) for p in out)
        with open(tmp_path / "data" / "heat" / "0000_heat.pkl", "rb") as f:
            assert pickle.load(f)[2].shape == (64, 6, 6)
    else:
        assert out == os.path.join(str(tmp_path), "data", "2D_rendered",
                                   "demo.png")
        assert os.path.getsize(out) > 0


def test_cli_takes_another_model_shape(tmp_path):
    """The model flags reach the config: a narrower random model is built
    and sampled."""
    args = entry.parse_args(["--embedding_dim", "32", "--gconv_num_layers",
                             "2", "--decoder_cat", "0", "--max_objects",
                             "16"])
    cfg = entry.build_cfg(args)
    assert (cfg.model.embedding_dim, cfg.model.gconv_num_layers,
            cfg.model.decoder_cat) == (32, 2, False)
    assert (cfg.data.max_objects, cfg.data.max_triples,
            cfg.data.max_on_rels) == (16, 48, 16)
    out = entry.main(["--batch_gen", "--synthetic", "16",
                      "--embedding_dim", "32", "--gconv_num_layers", "2",
                      "--allow_random_weights", "--output_dir",
                      str(tmp_path / "none"), "--test_dir", str(tmp_path),
                      "--device", "cpu"])
    with open(tmp_path / "mean_cov.pkl", "rb") as f:
        mean, cov = pickle.load(f)
    assert mean.shape == (32,) and cov.shape == (32, 32)
    assert os.path.isfile(out)
