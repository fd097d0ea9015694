"""The port's SPADE generator (sln_tpu_torch.spade) against the JAX
package's (sln_tpu.spade) on the CPU: the same numpy-seeded weights,
carried over by params_from_jax, and the same inputs through every layer
and the whole generator (max abs 1e-5); a reference-layout state dict
folded by both packages; the committed checkpoint read without JAX."""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from sln_tpu.spade import layers as jl
from sln_tpu.spade.generator import SPADEGenerator4 as JGen
from sln_tpu.spade.port import port_spade_generator4
from sln_tpu_torch.spade import layers as tl
from sln_tpu_torch.spade.generator import SPADEGenerator4 as TGen
from sln_tpu_torch.spade.port import fold_reference_state_dict, \
    params_from_jax

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_params(module, *args, seed=0):
    """The module's flax parameter tree filled with seeded normals: conv
    and Dense kernels scaled by 1/sqrt(fan in), biases by 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a), *args)["params"]

    def fill(x):
        if len(x.shape) == 1:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree.map(fill, shapes)


def seg_map(rng, B, S):
    """(B, S, S, 41): depth in [-1, 1] and one class mask set per pixel."""
    seg = np.zeros((B, S, S, 41), np.float32)
    seg[..., 0] = rng.uniform(-1, 1, (B, S, S))
    cls = rng.integers(1, 41, (B, S, S))
    idx = np.indices((B, S, S))
    seg[idx[0], idx[1], idx[2], cls] = 1.0
    return seg


def port_module(cls, params, *args):
    m = cls(*args)
    m.load_state_dict(params_from_jax(params))
    return m.eval()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layer_norm_2d_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 5, 7, 6)) + 1.5).astype(np.float32)
    x[1] = 2.0                        # constant sample: the var clamp
    got = nhwc(tl.layer_norm_2d(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jl.layer_norm_2d(x)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("src,dst", [(8, 16), (16, 8), (12, 7), (7, 12),
                                     (10, 4)])
def test_resizes_match_jax(src, dst):
    """Up, down and non-integer ratios; nearest uses torch's asymmetric
    floor(dst * in / out) rule on both sides."""
    x = np.random.default_rng(1).standard_normal(
        (2, src, src, 3)).astype(np.float32)
    np.testing.assert_allclose(
        nhwc(tl.resize_bilinear(nchw(x), dst, dst)),
        np.asarray(jl.resize_bilinear(x, dst, dst)), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        nhwc(tl.resize_nearest(nchw(x), dst, dst)),
        np.asarray(jl.resize_nearest(x, dst, dst)))


def test_padconv_matches_jax():
    x = np.random.default_rng(2).standard_normal(
        (2, 9, 9, 5)).astype(np.float32)
    jm = jl.PadConv(features=6, kernel=3, pad=1)
    p = random_params(jm, x)
    tm = port_module(tl.PadConv, p, 5, 6, 3, 1)
    assert set(tm.state_dict()) == {"1.weight", "1.bias"}
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": p}, x)),
                               rtol=0, atol=ATOL)


def test_spade4_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    seg = seg_map(rng, 2, 16)
    jm = jl.SPADE4(norm_nc=6)
    p = random_params(jm, x, seg)
    tm = port_module(tl.SPADE4, p, 6)
    g_j, b_j = jm.apply({"params": p}, seg, 8, 8, method="mods")
    with torch.no_grad():
        g_t, b_t = tm.mods(nchw(seg), 8, 8)
        out_t = tm(nchw(x), nchw(seg))
    np.testing.assert_allclose(nhwc(g_t), np.asarray(g_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(b_t), np.asarray(b_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(out_t),
                               np.asarray(jm.apply({"params": p}, x, seg)),
                               rtol=0, atol=ATOL)


def test_seblock2_matches_jax():
    x = np.random.default_rng(4).standard_normal(
        (2, 5, 5, 16)).astype(np.float32)
    jm = jl.SEBlock2(channels=16)
    p = random_params(jm, x)
    tm = port_module(tl.SEBlock2, p, 16)
    assert set(tm.state_dict()) == {"fc.0.weight", "fc.2.weight"}
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": p}, x)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fin,fout", [(8, 8), (8, 4)])
def test_resnet_block_matches_jax(fin, fout):
    """fin == fout adds the input; fin != fout adds the learned shortcut
    (norm_s, conv_s)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, fin)).astype(np.float32)
    seg = seg_map(rng, 2, 16)
    jm = jl.SPADEResnetBlock4(fin=fin, fout=fout)
    p = random_params(jm, x, seg)
    tm = port_module(tl.SPADEResnetBlock4, p, fin, fout)
    assert ("conv_s.weight" in tm.state_dict()) == (fin != fout)
    with torch.no_grad():
        got = nhwc(tm(nchw(x), nchw(seg)))
    np.testing.assert_allclose(got,
                               np.asarray(jm.apply({"params": p}, x, seg)),
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
def flat_mods(mods, to_nhwc):
    out = {}
    for blk, norms in mods.items():
        for norm, (g, b) in norms.items():
            out[f"{blk}.{norm}.gamma"] = to_nhwc(g)
            out[f"{blk}.{norm}.beta"] = to_nhwc(b)
    return out


# n_up sets the bottom width sw = crop / 2^(5|6|7); crop keeps sw = 2 (a
# 1 x 1 map cannot be reflection-padded, in torch as in the reference)
@pytest.mark.parametrize("n_up,crop", [("normal", 64), ("more", 128),
                                       ("most", 256)])
def test_generator_matches_jax(n_up, crop):
    """seg_mods of one room, decode of two z with those batch-1 mods (as
    the serving path broadcasts them), and the whole forward on the room
    repeated for each z, which is the same function."""
    ngf, nz = 4, 16
    rng = np.random.default_rng(6)
    seg = seg_map(rng, 1, crop)
    z = rng.standard_normal((2, nz)).astype(np.float32)
    jm = JGen(ngf=ngf, nz=nz, crop_size=crop, n_up=n_up)
    p = random_params(jm, seg, z[:1])

    @jax.jit
    def run(p, seg, z):
        mods = jm.apply({"params": p}, seg, method="seg_mods")
        return mods, jm.apply({"params": p}, mods, z, method="decode")
    mods_j, out_j = run(p, seg, z)

    tm = port_module(TGen, p, 41, 3, nz, ngf, crop, n_up)
    assert tm.sw == 2
    with torch.no_grad():
        seg_t, z_t = nchw(seg), torch.from_numpy(z)
        mods_t = tm.seg_mods(seg_t)
        dec_t = tm.decode(mods_t, z_t)
        out_t = tm(seg_t.expand(2, -1, -1, -1), z_t)
    want = flat_mods(mods_j, np.asarray)
    got = flat_mods(mods_t, nhwc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    assert out_t.shape == (2, 3, 64, 64)
    for t in (dec_t, out_t):
        np.testing.assert_allclose(nhwc(t), np.asarray(out_j), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# weights from a reference checkpoint and from the committed artifact
# ---------------------------------------------------------------------------
SPECTRAL = (".conv_0.1.weight", ".conv_1.1.weight", ".conv_s.weight")


def reference_state_dict(ngf, nz, crop, seed=7):
    """A reference-layout SPADEGenerator4 state dict: random weights, the
    spectral-normed convs as weight_orig / weight_u / weight_v."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in TGen(41, 3, nz, ngf, crop).state_dict().items():
        w = (rng.standard_normal(tuple(v.shape))
             / np.sqrt(max(v[0].numel(), 1))).astype(np.float32)
        if k.endswith(SPECTRAL):
            m = k[:-len(".weight")]
            u = rng.standard_normal(v.shape[0]).astype(np.float32)
            vv = rng.standard_normal(v[0].numel()).astype(np.float32)
            sd[m + ".weight_orig"] = torch.from_numpy(w)
            sd[m + ".weight_u"] = torch.from_numpy(u / np.linalg.norm(u))
            sd[m + ".weight_v"] = torch.from_numpy(vv / np.linalg.norm(vv))
        else:
            sd[k] = torch.from_numpy(w)
    return sd


def test_folded_reference_matches_jax_port():
    """fold_reference_state_dict and the JAX package's
    port_spade_generator4 read the same reference state dict into the same
    kernels (bit for bit) and the same generator output; the folded dict
    loads strictly."""
    ngf, nz, crop = 4, 16, 64
    sd = reference_state_dict(ngf, nz, crop)
    folded = fold_reference_state_dict(sd)
    tm = TGen(41, 3, nz, ngf, crop)
    tm.load_state_dict(folded, strict=True)
    tm.eval()
    jp = port_spade_generator4(sd, ngf=ngf)
    via_jax = params_from_jax(jp)
    assert set(via_jax) == set(folded)
    for k, v in via_jax.items():
        np.testing.assert_array_equal(folded[k].numpy(), v.numpy(),
                                      err_msg=k)
    rng = np.random.default_rng(8)
    seg = seg_map(rng, 1, crop)
    z = rng.standard_normal((1, nz)).astype(np.float32)
    jm = JGen(ngf=ngf, nz=nz, crop_size=crop)
    out_j = jax.jit(lambda p, s, z: jm.apply({"params": p}, s, z))(
        jp, seg, z)
    with torch.no_grad():
        out_t = tm(nchw(seg), torch.from_numpy(z))
    np.testing.assert_allclose(nhwc(out_t), np.asarray(out_j), rtol=0,
                               atol=ATOL)


def test_committed_checkpoint_loads_without_jax():
    """artifacts/spade_gan.ckpt (float16 flax leaves) becomes the full-width
    generator's state dict, float32, in a process where jax, jaxlib, optax
    and flax cannot be imported (the card's machine has none of them)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'flax'): sys.modules[m] = None\n"
        "import pickle, numpy as np, torch\n"
        "from sln_tpu_torch.spade.generator import SPADEGenerator4\n"
        "from sln_tpu_torch.workloads import gan_shade\n"
        "path = gan_shade.default_spade_checkpoint_path()\n"
        "sd, ck = gan_shade.load_native_spade_checkpoint(path)\n"
        "assert (ck['ngf'], ck['crop'], ck['nz']) == (64, 256, 256), ck\n"
        "with torch.device('meta'):\n"
        "    ref = SPADEGenerator4(41, 3, ck['nz'], ck['ngf'], ck['crop'])\n"
        "want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}\n"
        "assert {k: tuple(v.shape) for k, v in sd.items()} == want\n"
        "assert all(v.dtype == torch.float32 for v in sd.values())\n"
        "with open(path, 'rb') as f:\n"
        "    g = pickle.load(f)['g_params']\n"
        "k16 = g['up_3']['conv_0']['conv']['kernel']\n"
        "assert k16.dtype == np.float16\n"
        "assert np.array_equal(sd['up_3.conv_0.1.weight'].numpy(),\n"
        "    k16.astype(np.float32).transpose(3, 2, 0, 1))\n"
        "print(sum(v.numel() for v in sd.values()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert int(run.stdout.split()[-1]) == 110_852_099
