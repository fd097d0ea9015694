"""The port's SPADE training modules (sln_tpu_torch.spade.spectral,
discriminator, encoders, losses, port) against the JAX package on its CPU
backend, at a small size (ngf 8, nz 8, crop 32, ndf 4, nef 4), the JAX
weights carried across. Tolerances: the modules' outputs 1e-5 (abs) /
1e-4 (rel); gradients 1e-4 of their largest value; losses rtol 1e-4;
parameters after Adam steps within 1e-5 but for the weights whose
gradient is at the rounding level (close_after_adam says which and how
far). The entry point's tests are in tests/test_torch_spade_train_cli.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sln_tpu.spade import discriminator as jd
from sln_tpu.spade import encoders as je
from sln_tpu.spade import losses as jl
from sln_tpu.spade.generator import SPADEGenerator4 as JGen
from sln_tpu.spade.spectral import SpectralConv as JSpectral
from sln_tpu_torch.spade import discriminator as td
from sln_tpu_torch.spade import encoders as te
from sln_tpu_torch.spade import losses as tl
from sln_tpu_torch.spade import port
from sln_tpu_torch.spade.classic import SPADEGenerator
from sln_tpu_torch.spade.generator import SPADEGenerator4
from sln_tpu_torch.spade.spectral import SpectralConv, power_iteration

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

NGF, NZ, CROP, NDF, NEF, B = 8, 8, 32, 4, 4, 2
LR_G, LR_D, LR_E, L1 = 1e-4, 4e-4, 1e-4, 50.0


def chw(x):
    """(..., H, W, C) numpy -> (..., C, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, -3)))


def hwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def close(got, want, atol=1e-5, rtol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=msg)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def seg_batch(rng, n=B, S=CROP):
    seg = np.zeros((n, S, S, 41), np.float32)
    seg[..., 0] = rng.uniform(-1, 1, (n, S, S))
    cls = rng.integers(1, 41, (n, S, S))
    np.put_along_axis(seg, cls[..., None], 1.0, -1)
    return seg


def close_state(net, params, spectral=None, atol=1e-5):
    """net's state_dict against a JAX params (and spectral) tree."""
    want = port.params_from_jax(np_tree(params))
    if spectral:
        want.update(port.spectral_from_jax(np_tree(spectral)))
    got = net.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        close(got[k].detach().numpy(), w.numpy(), atol=atol, rtol=0, msg=k)


def close_after_adam(net, params, spectral=None, lr=LR_D):
    """Parameters after Adam steps, against the JAX package's. Adam with
    b1 = 0 moves each weight by lr g / (|g| + eps) on its first step, so a
    gradient at the rounding level (|g| near eps = 1e-8) moves by an
    arbitrary fraction of lr, whose value rounding decides. So: every
    weight within 2 lr per step, and all but one in 10^3 of the network's
    weights within 1e-5; the instance-normed biases, whose gradient is
    rounding alone, count only against the first bound. The spectral
    vectors are held the same way."""
    want = port.params_from_jax(np_tree(params))
    if spectral:
        want.update(port.spectral_from_jax(np_tree(spectral)))
    got = net.state_dict()
    assert set(got) == set(want)
    cancelled = td.instance_normed_biases(net)
    n_far, n_all = 0, 0
    for k, w in want.items():
        d = np.abs(got[k].detach().numpy() - w.numpy())
        assert d.max() <= 4 * lr, (k, d.max())
        if k not in cancelled:
            n_far += int((d > 1e-5).sum())
            n_all += d.size
    assert n_far <= n_all * 1e-3, (n_far, n_all)


# ---------------------------------------------------------------------------
# spectral norm, pooling, discriminators, encoder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    """JAX-initialised G, D (plain and MMD heads) and E, as the driver
    initialises them, and the batches."""
    rng = np.random.default_rng(6)
    seg0 = seg_batch(rng)
    real0 = rng.uniform(-1, 1, (B, CROP, CROP, 3)).astype(np.float32)
    gen = JGen(ngf=NGF, nz=NZ, crop_size=CROP)
    g_vars = jax.jit(lambda s_, z_: gen.init(jax.random.PRNGKey(0), s_, z_))(
        jnp.asarray(seg0), jax.random.normal(jax.random.PRNGKey(0), (B, NZ)))
    x0 = jnp.concatenate([jnp.asarray(seg0), jnp.asarray(real0)], -1)
    discs = {}
    for mmd_nz in (0, NZ):
        d = jd.MultiscaleDiscriminator(ndf=NDF, n_layers=3, num_d=2,
                                       mmd_nz=mmd_nz)
        discs[mmd_nz] = (d, jax.jit(lambda x_, d=d: d.init(
            jax.random.PRNGKey(1), x_, False))(x0))
    enc = je.ConvEncoderPSPSEMMD(nef=NEF, output_nc=NZ)
    e_vars = jax.jit(lambda x_: enc.init(jax.random.PRNGKey(3), x_, False))(
        jnp.asarray(real0))
    batches = [(seg_batch(rng),
                rng.uniform(-1, 1, (B, CROP, CROP, 3)).astype(np.float32),
                rng.standard_normal((B, NZ)).astype(np.float32))
               for _ in range(2)]
    return gen, g_vars, discs, enc, e_vars, batches


@pytest.mark.parametrize("k,stride,pad", [(4, 2, 2), (3, 1, 1)])
def test_spectral_conv_matches_jax(k, stride, pad):
    """Init (8 power-iteration steps from JAX's own u0), eval, train (one
    step of u and v) and the gradient through sigma = u . (W v)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    jm = JSpectral(6, (k, k), strides=stride, padding=pad)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    tm = port.load_from_jax(SpectralConv(5, 6, k, stride, pad),
                            np_tree(v["params"]), np_tree(v["spectral"]))

    u0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (6,)))
    u, vv = power_iteration(tm.w_mat(), torch.from_numpy(
        u0 / np.linalg.norm(u0)), 8, 1e-12)
    close(u, v["spectral"]["u"], atol=1e-6)
    close(vv, v["spectral"]["v"], atol=1e-6)

    close(hwc(tm(chw(x))), jm.apply(v, jnp.asarray(x), False))
    y_j, mut = jm.apply(v, jnp.asarray(x), True, mutable=["spectral"])
    w = rng.standard_normal(y_j.shape).astype(np.float32)

    def loss_j(params):
        y, _ = jm.apply({"params": params, "spectral": v["spectral"]},
                        jnp.asarray(x), True, mutable=["spectral"])
        return (y * w).sum()

    g_j = jax.grad(loss_j)(v["params"])
    y_t = tm(chw(x), True)
    close(hwc(y_t), y_j)
    close(tm.u, mut["spectral"]["u"], atol=1e-6)
    close(tm.v, mut["spectral"]["v"], atol=1e-6)
    (y_t * chw(w)).sum().backward()
    g_k = np.asarray(g_j["kernel"]).transpose(3, 2, 0, 1)
    scale = np.abs(g_k).max()
    close(tm.weight.grad, g_k, atol=1e-4 * scale, rtol=1e-4)
    close(tm.bias.grad, g_j["bias"], atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 9, 10, 3), (1, 8, 8, 4)])
def test_avg_pool_down_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    close(hwc(td.avg_pool_down(chw(x))), jd.avg_pool_down(jnp.asarray(x)),
          atol=1e-6, rtol=1e-6)


def _tree_outputs(out):
    """Flatten a discriminator's nested outputs (lists, (logits, z))."""
    flat = []
    for feats in out:
        for f in feats:
            flat += list(f) if isinstance(f, tuple) else [f]
    return flat


@pytest.mark.parametrize("mmd_nz", [0, NZ])
def test_multiscale_discriminator_matches_jax(nets, mmd_nz):
    """Every feature map and head of both scales, in eval mode and in
    training mode (the spectral vectors advance), with and without the MMD
    heads."""
    jm, v = nets[2][mmd_nz]
    x = np.random.default_rng(2).standard_normal(
        (B, CROP, CROP, 44)).astype(np.float32)
    tm = port.load_from_jax(td.MultiscaleDiscriminator(44, NDF, 3, 2,
                                                       mmd_nz),
                            np_tree(v["params"]), np_tree(v["spectral"]))
    want = jax.jit(lambda x_: jm.apply(v, x_, False))(jnp.asarray(x))
    got = tm(chw(x))
    assert [len(f) for f in got] == [len(f) for f in want] == [4, 3]
    for a, b in zip(_tree_outputs(got), _tree_outputs(want)):
        close(hwc(a) if a.dim() == 4 else a.detach().numpy(), b)
    want, mut = jax.jit(lambda x_: jm.apply(v, x_, True, mutable=[
        "spectral"]))(jnp.asarray(x))
    got = tm(chw(x), True)
    for a, b in zip(_tree_outputs(got), _tree_outputs(want)):
        close(hwc(a) if a.dim() == 4 else a.detach().numpy(), b)
    close_state(tm, v["params"], mut["spectral"])


def test_conv_encoder_psp_se_mmd_matches_jax(nets):
    """ConvEncoderPSPSEMMD on 32 px images (resized to 256 inside), eval
    and training mode, and its spectral vectors after one training
    forward; its input gradient through the fixed-order backward of the
    PSP module's bilinear resizes and the SE blocks."""
    jm, v = nets[3], nets[4]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, CROP, CROP, 3)).astype(np.float32)
    tm = port.load_from_jax(te.ConvEncoderPSPSEMMD(NEF, NZ),
                            np_tree(v["params"]), np_tree(v["spectral"]))
    close(tm(chw(x)).detach().numpy(),
          jax.jit(lambda x_: jm.apply(v, x_, False))(jnp.asarray(x)))
    want, mut = jax.jit(lambda x_: jm.apply(v, x_, True, mutable=[
        "spectral"]))(jnp.asarray(x))
    xt = chw(x).requires_grad_(True)
    got = tm(xt, True)
    close(got.detach().numpy(), want)
    close_state(tm, v["params"], mut["spectral"])

    w = rng.standard_normal(want.shape).astype(np.float32)
    v1 = {"params": v["params"], "spectral": mut["spectral"]}
    g_j = jax.jit(jax.grad(lambda x_: (jm.apply(v1, x_, False) * w).sum()))(
        jnp.asarray(x))
    (tm(xt) * torch.from_numpy(w)).sum().backward()
    g_j = np.asarray(g_j)
    close(hwc(xt.grad), g_j, atol=1e-4 * np.abs(g_j).max(), rtol=1e-4)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["original", "ls", "hinge", "wgan"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("for_d", [True, False])
def test_gan_loss_matches_jax(mode, real, for_d):
    rng = np.random.default_rng(4)
    logits = [[rng.standard_normal((2, 5, 5, 1)).astype(np.float32) * 2]
              for _ in range(2)]
    want = jl.gan_loss([[jnp.asarray(f) for f in s] for s in logits], real,
                       for_d, mode)
    got = tl.gan_loss([[chw(f) for f in s] for s in logits], real, for_d,
                      mode)
    close(float(got), float(want), atol=1e-6, rtol=1e-6)


def test_feature_matching_and_mmd_match_jax():
    rng = np.random.default_rng(5)

    def feats():
        return [[rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
                 for _ in range(3)] for _ in range(2)]

    fake, real = feats(), feats()
    want = jl.feature_matching_loss(
        [[jnp.asarray(f) for f in s] for s in fake],
        [[jnp.asarray(f) for f in s] for s in real])
    got = tl.feature_matching_loss([[chw(f) for f in s] for s in fake],
                                   [[chw(f) for f in s] for s in real])
    close(float(got), float(want), atol=1e-6, rtol=1e-6)
    x = rng.standard_normal((5, NZ)).astype(np.float32)
    y = rng.standard_normal((5, NZ)).astype(np.float32)
    close(float(tl.mmd_rbf(torch.from_numpy(x), torch.from_numpy(y))),
          float(jl.mmd_rbf(jnp.asarray(x), jnp.asarray(y))), atol=1e-6,
          rtol=1e-5)


# ---------------------------------------------------------------------------
# the training steps, fed the same batches and z
# ---------------------------------------------------------------------------
def port_state(g_vars, d_vars, mmd_nz, e_vars=None):
    G = port.load_from_jax(SPADEGenerator4(nz=NZ, ngf=NGF, crop_size=CROP),
                           np_tree(g_vars["params"]))
    D = port.load_from_jax(td.MultiscaleDiscriminator(44, NDF, 3, 2, mmd_nz),
                           np_tree(d_vars["params"]),
                           np_tree(d_vars["spectral"]))
    E = None if e_vars is None else port.load_from_jax(
        te.ConvEncoderPSPSEMMD(NEF, NZ), np_tree(e_vars["params"]),
        np_tree(e_vars["spectral"]))
    return tl.GanState(G, D, LR_G, LR_D, E, LR_E)


def test_two_gan_steps_match_jax(nets):
    """Two hinge + feature-matching + L1 steps from the same weights on
    the same batches and z: losses, both networks' parameters and D's
    spectral vectors after each."""
    gen, g_vars, discs, _, _, batches = nets
    disc, d_vars = discs[0]
    g_tx, d_tx = optax.adam(LR_G, b1=0.0, b2=0.9), optax.adam(LR_D, b1=0.0,
                                                             b2=0.9)
    js = jl.GanState(g_params=g_vars["params"], d_params=d_vars["params"],
                     d_spectral=d_vars["spectral"],
                     g_opt=g_tx.init(g_vars["params"]),
                     d_opt=d_tx.init(d_vars["params"]),
                     step=jnp.zeros((), jnp.int32))
    jstep = jl.make_gan_train_step(gen, disc, g_tx, d_tx, lambda_l1=L1)
    ts = port_state(g_vars, d_vars, 0)
    tstep = tl.make_gan_train_step(ts, lambda_l1=L1)
    for seg, real, z in batches:
        js, jloss = jstep(js, jnp.asarray(seg), jnp.asarray(real),
                          jnp.asarray(z))
        tloss = tstep(chw(seg), chw(real), torch.from_numpy(z))
        for k in ("d_loss", "g_loss"):
            close(float(tloss[k]), float(jloss[k]), atol=0, rtol=1e-4,
                  msg=k)
        close_after_adam(ts.generator, js.g_params)
        close_after_adam(ts.discriminator, js.d_params, js.d_spectral)
    assert ts.step == int(js.step) == 2


def test_mmd_gan_step_matches_jax(nets):
    """One MMD step (D with z-regression, G with z-recovery, E with
    reconstruction through the updated G and MMD to the prior)."""
    gen, g_vars, discs, enc, e_vars, batches = nets
    disc, d_vars = discs[NZ]
    txs = [optax.adam(lr, b1=0.0, b2=0.9) for lr in (LR_G, LR_D, LR_E)]
    js = jl.MmdGanState(
        g_params=g_vars["params"], d_params=d_vars["params"],
        d_spectral=d_vars["spectral"], e_params=e_vars["params"],
        e_spectral=e_vars["spectral"], g_opt=txs[0].init(g_vars["params"]),
        d_opt=txs[1].init(d_vars["params"]),
        e_opt=txs[2].init(e_vars["params"]), step=jnp.zeros((), jnp.int32))
    jstep = jl.make_mmd_gan_train_step(gen, disc, enc, *txs, lambda_l1=L1)
    ts = port_state(g_vars, d_vars, NZ, e_vars)
    tstep = tl.make_mmd_gan_train_step(ts, lambda_l1=L1)
    seg, real, z = batches[0]
    js, jloss = jstep(js, jnp.asarray(seg), jnp.asarray(real),
                      jnp.asarray(z))
    tloss = tstep(chw(seg), chw(real), torch.from_numpy(z))
    for k in ("d_loss", "g_loss", "e_loss"):
        close(float(tloss[k]), float(jloss[k]), atol=0, rtol=1e-4, msg=k)
    close_after_adam(ts.generator, js.g_params)
    close_after_adam(ts.discriminator, js.d_params, js.d_spectral)
    close_after_adam(ts.encoder, js.e_params, js.e_spectral)


def test_init_statistics_like_flax(nets):
    """init_like_jax draws as flax's default init does: per kernel the
    spread of a normal of variance 1 / fan_in truncated at two standard
    deviations (within 10 % of flax's own draw where a kernel has 512
    values or more), zero biases, and unit spectral vectors whose sigma
    approaches the top singular value from below."""
    _, g_vars, discs, _, e_vars, _ = nets
    d_vars = discs[0][1]
    pairs = [(port.init_like_jax(SPADEGenerator4(nz=NZ, ngf=NGF,
                                                 crop_size=CROP), 0),
              g_vars),
             (port.init_like_jax(td.MultiscaleDiscriminator(44, NDF), 1),
              d_vars),
             (port.init_like_jax(te.ConvEncoderPSPSEMMD(NEF, NZ), 3),
              e_vars)]
    n_checked = 0
    for net, v in pairs:
        want = port.params_from_jax(np_tree(v["params"]))
        got = net.state_dict()
        for k, w in want.items():
            g = got[k]
            if k.endswith("bias"):
                assert (g == 0).all() and (w == 0).all(), k
                continue
            fan_in = g[0].numel()
            assert float(g.abs().max()) <= 2.0 * (1.0 / fan_in) ** 0.5 \
                / 0.87962566103423978 + 1e-6, k
            if g.numel() >= 512:
                ratio = float(g.std()) / float(w.std())
                assert 0.9 < ratio < 1.1, (k, ratio)
                n_checked += 1
        for m in net.modules():
            if isinstance(m, SpectralConv):
                close(float(torch.linalg.vector_norm(m.u)), 1.0, atol=1e-5)
                close(float(torch.linalg.vector_norm(m.v)), 1.0, atol=1e-5)
                sigma = float(m.u @ (m.w_mat().detach() @ m.v))
                top = float(torch.linalg.matrix_norm(m.w_mat().detach(), 2))
                assert 0.5 * top < sigma <= top * (1 + 1e-5)
    assert n_checked >= 20


# ---------------------------------------------------------------------------
# the default forms, unchanged by GauGAN's options
# ---------------------------------------------------------------------------
# sums and absolute sums (float64 of the float32 results) that the default
# classic SPADEGenerator, MultiscaleDiscriminator and make_gan_train_step
# gave before GauGAN's options (label_input, the syncbatch SPADE, spectral
# blocks, gaugan=True) were added to them
DEFAULT_FINGERPRINT = {
    'classic_generator': [-1362.0838646694465, 3225.704623067184],
    'discriminator': [[169.9786146960514, 247.65100308998353], [400.9649365658188, 601.447410709945], [1000.0841480064555, 1500.1262319213129], [50.600029485474806, 73.79043311643181], [13.84943456533074, 21.688905689356034], [506.3676130017848, 759.5514217451564], [5.857589424587786, 92.33229016885161]],
    'discriminator_u': [3.153157263994217, 11.827333986759186],
    'gan_losses': [2.021401882171631, 36.738861083984375, 2.012927293777466, 31.367525100708008],
    'gan_g_params': [16.768447561238148, 148889.93110743666],
    'gan_d_state': [2.1325861552668357, 511.0415793319862],
}


def default_fingerprint():
    def s(t):
        t = t.detach().double()
        return [float(t.sum()), float(t.abs().sum())]

    gen = torch.Generator().manual_seed(5)
    seg = torch.zeros(2, 41, 32, 32)
    seg[:, 0] = torch.rand(2, 32, 32, generator=gen) * 2 - 1
    cls = torch.randint(1, 41, (2, 1, 32, 32), generator=gen)
    seg[:, 1:] = torch.zeros(2, 40, 32, 32).scatter_(1, cls - 1, 1.0)
    real = torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
    z = torch.randn(2, 8, generator=gen)
    out = {}
    g = port.init_like_jax(SPADEGenerator(nz=8, ngf=8, crop_size=32), 0)
    with torch.no_grad():
        out["classic_generator"] = s(g(seg, z))
    d = port.init_like_jax(td.MultiscaleDiscriminator(44, 4, 3, 2), 1)
    with torch.no_grad():
        feats = d(torch.cat([seg, real], 1), True)
    out["discriminator"] = [s(f) for fs in feats for f in fs]
    out["discriminator_u"] = s(torch.cat([b for n, b in d.named_buffers()
                                          if n.endswith(".u")]))
    st = tl.GanState(port.init_like_jax(
        SPADEGenerator4(nz=8, ngf=8, crop_size=32), 0), port.init_like_jax(
        td.MultiscaleDiscriminator(44, 4, 3, 2), 1), 1e-4, 4e-4)
    step = tl.make_gan_train_step(st, lambda_l1=50.0)
    losses = [step(seg, real, z), step(seg.flip(0), real.flip(0), z)]
    out["gan_losses"] = [float(x[k]) for x in losses
                         for k in ("d_loss", "g_loss")]
    out["gan_g_params"] = s(torch.cat([p.flatten() for p in
                                       st.generator.parameters()]))
    out["gan_d_state"] = s(torch.cat([p.flatten() for p in
                                      st.discriminator.state_dict().values()]))
    return out


def test_default_forms_unchanged_by_gaugan_options():
    """The default classic generator's output, the default discriminators'
    features, logits and advanced u, and two default GAN steps' losses and
    states, against their values from before GauGAN's options (rtol 1e-5:
    the same code, float32's rounding across CPUs and thread counts)."""
    got = default_fingerprint()
    assert set(got) == set(DEFAULT_FINGERPRINT)
    for k, want in DEFAULT_FINGERPRINT.items():
        close(np.array(got[k]), np.array(want), atol=0, rtol=1e-5, msg=k)
