"""The rest of the port's SPADE (sln_tpu_torch.spade.classic, variants,
discriminator.ConvEncoder, the PSP-SE encoders and the MMD discriminator
wrappers of spade/encoders.py) against the JAX package's (sln_tpu.spade)
on its CPU backend, at small widths: the same numpy-seeded flax tree
carried by params_from_jax (spectral convs with u and v converged as the
JAX init converges them), the same inputs, max abs 1e-5 (one float32-bound
case at 3e-5; GEN_CASES says why). Each carried module also goes back
through params_to_jax to the same tree. Generator 3's gradients are held
within 1e-4 of their largest value, as tests/test_torch_spade_train.py
holds the shading trainer's, but for a ReLU-kink flip (the test says
how)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sln_tpu.spade import classic as jc
from sln_tpu.spade import discriminator as jd
from sln_tpu.spade import encoders as je
from sln_tpu.spade import variants as jv
from sln_tpu_torch.spade import classic as tc
from sln_tpu_torch.spade import discriminator as td
from sln_tpu_torch.spade import encoders as te
from sln_tpu_torch.spade import port
from sln_tpu_torch.spade import variants as tv
from test_torch_spade import nchw, nhwc, random_params, seg_map

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

ATOL = 1e-5
L = 41                  # depth + 40 classes, as seg_map draws them


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


def carried(tm, params, spectral=None):
    """tm with the JAX trees loaded; params_to_jax gives them back."""
    port.load_from_jax(tm, params, spectral)
    back, back_sp = port.params_to_jax(tm)
    for want, got in ((params, back), (spectral or {}, back_sp)):
        w = dict(port._flatten(jax.tree.map(np.asarray, want)))
        g = dict(port._flatten(got))
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
    return tm.eval()


# ---------------------------------------------------------------------------
# norms and blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["instance", "batch", "layer"])
def test_param_free_norms_match_jax(kind):
    x = (2.0 * np.random.default_rng(0).standard_normal((3, 5, 6, 4))
         + 0.7).astype(np.float32)
    close(nhwc(tv.param_free_norm(nchw(x), kind)),
          jv.param_free_norm(jnp.asarray(x), kind))
    with pytest.raises(ValueError):
        tv.param_free_norm(nchw(x), "group")


NORM_CASES = [("classic", "instance")] + [
    (v, k) for v in (2, 3, 5) for k in ("instance", "batch", "layer")]


@pytest.mark.parametrize("variant,param_free", NORM_CASES)
def test_spade_norms_match_jax(variant, param_free):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    seg = seg_map(rng, 2, 16)
    if variant == "classic":
        jm, tm = jc.SPADE(6, L, nhidden=16), tc.SPADE(6, L, nhidden=16)
    else:
        jm = {2: jv.SPADE2, 3: jv.SPADE3, 5: jv.SPADE5}[variant](
            6, L, nhidden=16, param_free=param_free)
        tm = tv.NORMS[variant](6, L, nhidden=16, param_free=param_free)
    p = random_params(jm, x, seg)
    tm = carried(tm, p)
    with torch.no_grad():
        got = nhwc(tm(nchw(x), nchw(seg)))
    close(got, jm.apply({"params": p}, x, seg))


@pytest.mark.parametrize("variant", ["classic", 2, 3, 5])
@pytest.mark.parametrize("fin,fout", [(8, 8), (8, 4)])
def test_resnet_blocks_match_jax(variant, fin, fout):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, fin)).astype(np.float32)
    seg = seg_map(rng, 2, 16)
    if variant == "classic":
        jm = jc.SPADEResnetBlock(fin, fout, L)
        tm = tc.SPADEResnetBlock(fin, fout, L)
    else:
        jm = jv.SPADEResnetBlockV(fin, fout, variant, L)
        tm = tv.SPADEResnetBlockV(fin, fout, variant, L)
    p = random_params(jm, x, seg)
    assert ("conv_s" in p) == (fin != fout)
    tm = carried(tm, p)
    with torch.no_grad():
        got = nhwc(tm(nchw(x), nchw(seg)))
    close(got, jm.apply({"params": p}, x, seg))


def test_seresblock2_matches_jax():
    x = np.random.default_rng(3).standard_normal(
        (2, 6, 6, 8)).astype(np.float32)
    jm = jc.SEResBlock2(8)
    p = random_params(jm, x)
    tm = carried(tc.SEResBlock2(8), p)
    assert {"conv0.1.weight", "conv1.1.weight", "se.fc.0.weight"} <= set(
        tm.state_dict())
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    close(got, jm.apply({"params": p}, x))


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------
NZ = 8
# 'most' stacks nine blocks whose instance norms run over maps from 1 x 1
# up: there float32 itself is the limit, and the JAX package's own float32
# output is more than 1e-5 from a float64 evaluation of the same weights
# (the port's modules in float64; the test asserts it), so that case is
# held at 3e-5; every other case at 1e-5. Generator 3 is held in
# test_generator3_gradients_match_jax, its output and its gradients.
GEN_CASES = [  # (variant, n_up, ngf, crop, batch, param_free, atol)
    ("classic", "normal", 4, 32, 2, "instance", ATOL),
    ("classic", "more", 2, 64, 2, "instance", ATOL),
    ("classic", "most", 4, 128, 1, "instance", 3e-5),
    (2, "normal", 2, 64, 2, "instance", ATOL),
    (5, "normal", 2, 64, 2, "layer", ATOL),
]


def generators(variant, n_up, ngf, crop, param_free):
    kw = dict(semantic_nc=L, nz=NZ, ngf=ngf, crop_size=crop, n_up=n_up)
    if variant == "classic":
        return jc.SPADEGenerator(**kw), tc.SPADEGenerator(**kw)
    kw["param_free"] = param_free
    return (jv.SPADEGeneratorV(variant=variant, **kw),
            {2: tv.SPADEGenerator2, 3: tv.SPADEGenerator3,
             5: tv.SPADEGenerator5}[variant](**kw))


def gen_inputs(B, crop, seed=4):
    rng = np.random.default_rng(seed)
    return (seg_map(rng, B, crop),
            rng.standard_normal((B, NZ)).astype(np.float32))


@pytest.mark.parametrize("variant,n_up,ngf,crop,B,param_free,atol",
                         GEN_CASES)
def test_generators_match_jax(variant, n_up, ngf, crop, B, param_free, atol):
    jm, tm = generators(variant, n_up, ngf, crop, param_free)
    seg, z = gen_inputs(B, crop)
    p = random_params(jm, seg, z)
    tm = carried(tm, p)
    with torch.no_grad():
        got = nhwc(tm(nchw(seg), torch.from_numpy(z)))
    want = np.asarray(jax.jit(jm.apply)({"params": p}, seg, z))
    assert got.shape == want.shape == (B, crop, crop, 3)
    close(got, want, atol)
    if atol > ATOL:
        t64 = copy.deepcopy(tm)
        for m in t64.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
        with torch.no_grad():
            exact = nhwc(t64.double()(nchw(seg).double(),
                                      torch.from_numpy(z).double()))
        assert np.abs(want - exact).max() > ATOL
        close(got, exact, atol)


@pytest.mark.parametrize("n_up", ["more", "most"])
def test_generator5_refuses_more_and_most(n_up):
    seg, z = gen_inputs(1, 128)
    with pytest.raises(ValueError):
        jv.SPADEGenerator5(nz=NZ, ngf=2, crop_size=128, n_up=n_up).init(
            jax.random.PRNGKey(0), seg, z)
    with pytest.raises(ValueError):
        tv.SPADEGenerator5(nz=NZ, ngf=2, crop_size=128, n_up=n_up)


def test_generator3_gradients_match_jax():
    """Generator 3 (the batch param-free norm), its output and
    d(sum(w * G(seg, z)))/d(params) through SE and reflection pads: every
    gradient within 1e-3 of the largest, all but one in 10^3 of them within
    1e-4. A pre-activation within rounding of a ReLU's kink switches that
    pixel's share of a gradient on in one package and off in the other (in
    this draw one pixel of up_2.norm_1.mlp_shared moves one element of its
    bias gradient past 1e-4 of the largest)."""
    jm, tm = generators(3, "normal", 2, 64, "batch")
    seg, z = gen_inputs(2, 64, seed=5)
    w = np.random.default_rng(6).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    p = random_params(jm, seg, z)
    tm = carried(tm, p)
    (_, out_j), grads = jax.jit(jax.value_and_grad(
        lambda q, s, z: (lambda y: ((y * w).sum(), y))(
            jm.apply({"params": q}, s, z)), has_aux=True))(p, seg, z)
    out_t = tm(nchw(seg), torch.from_numpy(z))
    close(nhwc(out_t), out_j)
    (out_t * nchw(w)).sum().backward()
    want = port.params_from_jax(jax.tree.map(np.asarray, grads))
    scale = max(float(g.abs().max()) for g in want.values())
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    n_far = n_all = 0
    for k, g in want.items():
        d = np.abs(got[k].grad.numpy() - g.numpy())
        assert d.max() <= 1e-3 * scale, (k, d.max() / scale)
        n_far += int((d > 1e-4 * scale).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


# ---------------------------------------------------------------------------
# encoders and the MMD discriminator wrappers (spectral convs: the JAX
# init's trees, params and spectral vectors, carried)
# ---------------------------------------------------------------------------
def spectral_vars(module, *args):
    """random_params and, for each spectral conv, its u and v after 8
    power-iteration steps from a seeded draw, as the JAX init converges
    them (the init itself compiles for many seconds)."""
    params = random_params(module, *args)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a), *args)["spectral"]
    rng = np.random.default_rng(1)

    def converge(sp, pr):
        if "u" not in sp:
            return {k: converge(sp[k], pr[k]) for k in sp}
        k = np.asarray(pr["kernel"], np.float64)
        w = k.transpose(3, 2, 0, 1).reshape(k.shape[-1], -1)
        u = rng.standard_normal(sp["u"].shape)
        u /= np.linalg.norm(u)
        for _ in range(8):
            v = w.T @ u
            v /= np.linalg.norm(v)
            u = w @ v
            u /= np.linalg.norm(u)
        return {"u": u.astype(np.float32), "v": v.astype(np.float32)}
    return {"params": params, "spectral": converge(shapes, params)}


def images(B, S, C=3, seed=8):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, S, S, C)).astype(np.float32)


def run_both(jm, tm, x, train):
    """Both modules' outputs on x (and, with train, the spectral trees
    their power-iteration step leaves)."""
    v = spectral_vars(jm, x, False)
    tm = carried(tm, v["params"], v["spectral"])
    want, upd = jax.jit(lambda v, x: jm.apply(v, x, train,
                                              mutable=["spectral"]))(v, x)
    with torch.no_grad():
        got = tm(nchw(x), train)
    if train:
        _, sp = port.params_to_jax(tm)
        w = dict(port._flatten(jax.tree.map(np.asarray, upd["spectral"])))
        g = dict(port._flatten(sp))
        assert set(g) == set(w) and len(w) > 0
        for k in w:
            close(g[k], w[k], msg=str(k))
    return got, want


@pytest.mark.parametrize("crop_size,size", [(128, 256), (256, 64)])
def test_conv_encoder_matches_jax(crop_size, size):
    """layer6 and the fifth leaky only at crop_size >= 256; the input is
    resized to 256 px whatever its size."""
    jm = jd.ConvEncoder(nef=4, output_nc=NZ, crop_size=crop_size)
    tm = td.ConvEncoder(4, NZ, crop_size)
    assert hasattr(tm, "layer6") == (crop_size >= 256)
    (mu, lv), (jmu, jlv) = run_both(jm, tm, images(2, size), False)
    close(mu.numpy(), jmu)
    close(lv.numpy(), jlv)


@pytest.mark.parametrize("vae,train", [(True, True), (False, False)])
def test_psp_se_encoder_matches_jax(vae, train):
    """Both heads; with train, one power-iteration step of every spectral
    conv: the output and the new u, v as the JAX spectral collection's."""
    got, want = run_both(je.ConvEncoderPSPSE(nef=2, output_nc=NZ, vae=vae),
                         te.ConvEncoderPSPSE(2, NZ, vae), images(2, 128),
                         train)
    if vae:
        close(got[0].numpy(), want[0])
        close(got[1].numpy(), want[1])
    else:
        close(got.numpy(), want)


def test_psp_se_mmd2_encoder_matches_jax():
    """The (4, 4) map flattened in the JAX package's (H, W, C) order."""
    got, want = run_both(je.ConvEncoderPSPSEMMD2(nef=2, output_nc=NZ),
                         te.ConvEncoderPSPSEMMD2(2, NZ), images(2, 256),
                         False)
    close(got.numpy(), want)


def _flat_outputs(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat_outputs(o)]
    return [out]


@pytest.mark.parametrize("multiscale,train", [(False, False), (True, True)])
def test_mmd_discriminator_wrappers_match_jax(multiscale, train):
    """The shared trunk under `trunk`: every feature map, the logits and z,
    and with train the spectral vectors."""
    if multiscale:
        jm = je.MultiscaleDiscriminatorMMD(ndf=4, n_layers=3, num_d=2, nz=NZ)
        tm = te.MultiscaleDiscriminatorMMD(5, 4, 3, 2, NZ)
    else:
        jm = je.NLayerDiscriminatorMMD(ndf=4, n_layers=3, nz=NZ)
        tm = te.NLayerDiscriminatorMMD(5, 4, 3, NZ)
    assert all(k.startswith("trunk.") for k in tm.state_dict())
    got, want = run_both(jm, tm, images(2, 32, C=5), train)
    got, want = _flat_outputs(got), _flat_outputs(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        close(g if g.ndim == 2 else nhwc(torch.from_numpy(g)), w)


# ---------------------------------------------------------------------------
# init_like_jax on every class (their trees are carried() above)
# ---------------------------------------------------------------------------
INIT_CASES = {
    "SPADEGenerator": lambda: tc.SPADEGenerator(nz=NZ, ngf=2, crop_size=32),
    "SPADEGenerator2": lambda: tv.SPADEGenerator2(nz=NZ, ngf=2,
                                                  crop_size=32),
    "SPADEGenerator3": lambda: tv.SPADEGenerator3(nz=NZ, ngf=2,
                                                  crop_size=32),
    "SPADEGenerator5": lambda: tv.SPADEGenerator5(nz=NZ, ngf=2,
                                                  crop_size=32),
    "ConvEncoder": lambda: td.ConvEncoder(2, NZ),
    "ConvEncoderPSPSE": lambda: te.ConvEncoderPSPSE(2, NZ),
    "ConvEncoderPSPSEMMD2": lambda: te.ConvEncoderPSPSEMMD2(2, NZ),
    "NLayerDiscriminatorMMD": lambda: te.NLayerDiscriminatorMMD(5, 4, nz=NZ),
    "MultiscaleDiscriminatorMMD": lambda: te.MultiscaleDiscriminatorMMD(
        5, 4, nz=NZ),
}


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_init_like_jax_draws_every_tensor(name):
    """init_like_jax draws every kernel as flax's lecun_normal (a normal of
    variance 1 / fan_in truncated at two standard deviations: its spread
    within 20 % where a kernel has 256 values or more), zeroes every bias
    and leaves unit spectral vectors: no tensor keeps its construction
    value."""
    tm = port.init_like_jax(INIT_CASES[name](), 5)
    for key, g in tm.state_dict().items():
        if key.endswith("bias"):
            assert (g == 0).all(), key
        elif key.endswith("weight"):
            bound = 2.0 * (1.0 / g[0].numel()) ** 0.5 / 0.87962566103423978
            assert 0 < float(g.abs().max()) <= bound + 1e-6, key
            if g.numel() >= 256:
                ratio = float(g.std()) * g[0].numel() ** 0.5
                assert 0.8 < ratio < 1.2, (key, ratio)
        else:
            close(float(torch.linalg.vector_norm(g)), 1.0, msg=key)
