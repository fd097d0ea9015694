"""python -m sln_tpu_torch.tools.train_spade against the JAX package's
tools/train_spade.py on its CPU backend, at a small size (ngf 8, nz 8, crop
32, ndf 4): the checkpoint and serving pickles both ways (the port writes,
the JAX driver's --resume and the JAX package's make_spade_model read; the
JAX driver writes, the port resumes with JAX blocked), two driver steps
fed the JAX driver's own batch indices and z, and the held-out split's identity
and val_heldout_clean across a resume chain. Parameters after Adam steps
are compared as tests/test_torch_spade_train.py compares them."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sln_tpu.config import default_config as jdefault
from sln_tpu.workloads import gan_shade as jg
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.tools import train_spade as tts
from sln_tpu_torch.workloads import gan_shade as tg

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NGF, NZ, CROP, NDF, B = 8, 8, 32, 4, 2
LR_D = 4e-4


def chw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, -3)))


def hwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def seg_batch(rng, n=B, S=CROP):
    seg = np.zeros((n, S, S, 41), np.float32)
    seg[..., 0] = rng.uniform(-1, 1, (n, S, S))
    cls = rng.integers(1, 41, (n, S, S))
    np.put_along_axis(seg, cls[..., None], 1.0, -1)
    return seg


def _paths(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def close_trees_after_adam(got, want, lr=LR_D):
    """Two checkpoints' trees after Adam steps: the same structure and
    dtypes; every value within 2 lr per step of the other's, and all but
    one in 10^3 of the tree's values within 1e-5 (Adam with b1 = 0 turns a
    gradient at the rounding level into an lr-sized step of either sign);
    a discriminator conv bias that instance norm cancels counts only
    against the first bound."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    n_far, n_all = 0, 0
    for path, a in _paths(got):
        b = want
        for k in path:
            b = b[k]
        assert a.dtype == np.float32 and a.shape == b.shape, path
        d = np.abs(a - b)
        assert d.max() <= 4 * lr, (path, d.max())
        cancelled = (path[-1] == "bias" and path[-2] in ("conv1", "conv2")
                     and path[0].startswith("discriminator_"))
        if not cancelled:
            n_far += int((d > 1e-5).sum())
            n_all += d.size
    assert n_far <= n_all * 1e-3, (n_far, n_all)


@pytest.fixture
def pairs(tmp_path):
    rng = np.random.default_rng(7)
    d = tmp_path / "pairs"
    d.mkdir()
    for i in range(6):
        seg = seg_batch(rng, 1)[0]
        np.savez(d / f"{i}.npz", seg=seg,
                 rgb=np.asarray(jg.shading_target(seg), np.float32))
    return d


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _cli(pairs_dir, out, steps, *extra):
    return ["--pairs_dir", str(pairs_dir), "--crop", str(CROP), "--ngf",
            str(NGF), "--ndf", str(NDF), "--nz", str(NZ), "--batch_size",
            str(B), "--steps", str(steps), "--eval_every", "0",
            "--print_every", "1", "--output_dir", str(out), *extra]


def test_entry_point_pickles_round_trip_with_jax(pairs, tmp_path):
    """The port writes its initial checkpoint; the JAX driver resumes it
    and takes two steps (its jitted step takes the port's trees only if
    their structure is its own), while the port resumes it and takes the
    same two steps fed the JAX driver's own batch indices and z: the two
    checkpoints agree. The JAX package's make_spade_model shades with the
    port's serving artifact as the port does; the port reads the JAX
    driver's checkpoint in a process with JAX blocked."""
    sys.path.insert(0, REPO)
    from tools import train_spade as jts

    p0, j2, p2 = (tmp_path / n for n in ("p0", "j2", "p2"))
    tts.main(_cli(pairs, p0, 0, "--device", "cpu"))
    start = str(p0 / "spade_gan.ckpt")
    jts.main(_cli(pairs, j2, 2, "--resume", start))

    rng = np.random.default_rng(0)
    n_train = 6                        # --eval_every 0 holds nothing out

    def draws(t):
        idx = rng.integers(0, n_train, B)
        z = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(2), t),
                              (B, NZ))
        return torch.from_numpy(idx), torch.from_numpy(np.array(z))

    art = tmp_path / "p2_art.ckpt"
    trainer = tts.main(_cli(pairs, p2, 2, "--resume", start, "--device",
                            "cpu", "--artifact", str(art)), draws=draws)
    assert trainer.state.step == 2
    want, got = _load(j2 / "spade_gan.ckpt"), _load(p2 / "spade_gan.ckpt")
    close_trees_after_adam(got["g_params"], want["g_params"])
    close_trees_after_adam(got["d_params"], want["d_params"])
    close_trees_after_adam(got["d_spectral"], want["d_spectral"])
    for k in ("trained_steps", "val_split", "val_heldout_clean"):
        assert got["config"][k] == want["config"][k], k
    assert got["config"]["trained_steps"] == 2

    # the serving artifact: float16 g_params, read by both packages
    slim = _load(art)
    assert set(slim) == {"g_params", "config"}
    assert all(a.dtype == np.float16 for a in jax.tree.leaves(
        slim["g_params"]))
    jm, jp = jg.make_spade_model(jdefault(), str(art))
    seg = seg_batch(np.random.default_rng(8), 1)
    z = np.random.default_rng(9).standard_normal((1, NZ)).astype(np.float32)
    model = tg.make_spade_model(tcfg.default_config(), str(art), "cpu")
    with torch.no_grad():
        got_img = hwc(model(chw(seg), torch.from_numpy(z)))
    want_img = jax.jit(lambda s_, z_: jm.apply({"params": jp}, s_, z_))(
        jnp.asarray(seg), jnp.asarray(z))
    np.testing.assert_allclose(got_img, np.asarray(want_img), atol=1e-5,
                               rtol=1e-4)

    # the port reads the JAX driver's checkpoint in a process without JAX
    argv = _cli(pairs, tmp_path / "p_from_j", 0, "--resume",
                str(j2 / "spade_gan.ckpt"), "--device", "cpu")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'optax', 'flax', 'sln_tpu'): "
            "sys.modules[m] = None\n"
            "from sln_tpu_torch.tools import train_spade\n"
            f"train_spade.main({argv!r})\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    read = _load(tmp_path / "p_from_j" / "spade_gan.ckpt")
    assert read["config"]["trained_steps"] == 2
    for key in ("g_params", "d_params", "d_spectral"):
        assert jax.tree.structure(read[key]) == jax.tree.structure(want[key])
        for a, b in zip(jax.tree.leaves(read[key]),
                        jax.tree.leaves(want[key])):
            np.testing.assert_array_equal(a, b)


def test_split_identity_and_clean_flag_across_resumes(pairs, tmp_path):
    """The held-out split's identity equals the JAX driver's for the same
    pairs (the memo file included), and val_heldout_clean carries across a
    resume chain: clean while the split matches, unclean once it moves,
    and unclean after that even where it matches again."""
    sys.path.insert(0, REPO)
    from tools import train_spade as jts

    jts.main(_cli(pairs, tmp_path / "j", 0, "--val_frac", "0.25",
                  "--eval_every", "1"))
    memo = _load_json(pairs / ".split_digests.json")
    out = tmp_path / "p"

    def run(frac, *extra):
        tts.main(_cli(pairs, out, 1, "--val_frac", frac, "--eval_every",
                      "1", "--device", "cpu", *extra))
        return _load(out / "spade_gan.ckpt")["config"]

    c1 = run("0.25")
    assert c1["val_split"] == _load(
        tmp_path / "j" / "spade_gan.ckpt")["config"]["val_split"]
    assert _load_json(pairs / ".split_digests.json") == memo
    assert c1["val_heldout_clean"] is True and c1["trained_steps"] == 1
    ck = str(out / "spade_gan.ckpt")
    c2 = run("0.25", "--resume", ck)
    assert c2["val_heldout_clean"] is True and c2["trained_steps"] == 2
    c3 = run("0.5", "--resume", ck)
    assert c3["val_heldout_clean"] is False
    assert c3["val_split"]["n_val"] == 3
    c4 = run("0.5", "--resume", ck)
    assert c4["val_split"] == c3["val_split"]
    assert c4["val_heldout_clean"] is False and c4["trained_steps"] == 4
    assert all(np.isfinite(c[k]) for c in (c1, c2, c3, c4)
               for k in ("val_l1", "val_psnr"))


def _load_json(path):
    with open(path) as f:
        return json.load(f)
