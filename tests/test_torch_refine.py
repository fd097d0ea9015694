"""Port parity for the render-and-refine path
(sln_tpu_torch.workloads.refine): the loss pyramid's resize matrices, the
gradient hooks, the optimizer, and three refinement iterations of the
whole slice against the JAX package from the same params, batch, z0 and
target."""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sln_tpu import config as jcfg
from sln_tpu.data import synthetic as jsyn, tensorize as jtens
from sln_tpu.data.augment import SizeInfo as JSizeInfo
from sln_tpu.data.augment import build_graphs as j_build_graphs
from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.render import assets as jassets, scene as jscene
from sln_tpu.workloads import refine as jref
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.render import assets as tassets, scene as tscene
from sln_tpu_torch.workloads import refine as tref

torch.set_num_threads(2)


def random_bn_stats(batch_stats, rng):
    """Running statistics of a plausibly trained net: means near 0,
    variances in [0.5, 1.5] (means far from the activations would leave
    every ReLU dead and the decoder constant)."""
    def draw(path, x):
        if path[-1].key == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(x.shape),
                               jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, batch_stats)

PYRAMID = (32, 48, 64, 96)


@pytest.mark.parametrize("render_size", [32, 96, 256])
def test_resize_matrices_match_jax(render_size):
    """Every (src, dst) pair the pyramid uses, antialiased downsamples
    included (plain bilinear differs from JAX's by 0.67 at 96 -> 32)."""
    sizes = (16, 24, 32) if render_size == 32 else PYRAMID
    pairs = {(render_size, s) for s in sizes if s != render_size}
    pairs |= {(s, sizes[-1]) for s in sizes if s != sizes[-1]}
    for src, dst in sorted(pairs):
        np.testing.assert_allclose(tref.resize_matrix(src, dst),
                                   jref._resize_matrix(src, dst),
                                   rtol=0, atol=1e-6,
                                   err_msg=f"{src} -> {dst}")


def test_psp_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (2, 70, 32, 32)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 70, 32, 32)).astype(np.float32)
    sizes = (16, 24, 32)
    d_t, s_t = tref.refine_losses(torch.as_tensor(a), torch.as_tensor(b),
                                  sizes)
    for i in range(2):
        d_j, s_j = jref.refine_losses(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                      sizes)
        np.testing.assert_allclose(float(d_t[i]), float(d_j), rtol=1e-5)
        np.testing.assert_allclose(float(s_t[i]), float(s_j), rtol=1e-5)


def test_hooks_and_softargmax_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    g_j = jax.grad(lambda x: (jref.fix_grad(x) * w).sum())(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (tref.fix_grad(xt) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), atol=1e-6)
    assert torch.equal(tref.fix_grad(xt), xt)

    xt = torch.as_tensor(x).requires_grad_(True)
    (tref.quad_grad(xt) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), 4.0 * w, atol=1e-6)

    lp = rng.standard_normal((3, 5, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tref.softargmax(torch.as_tensor(lp)).numpy(),
        np.asarray(jref.softargmax(jnp.asarray(lp))), rtol=1e-5, atol=1e-5)


def test_sgd_nesterov_matches_optax():
    """The port's two-group optimizer equals optax.sgd(nesterov=True) under
    the JAX package's multi_transform, on a toy quadratic."""
    cfg = tcfg.default_config()
    ref = cfg.refine
    rng = np.random.default_rng(0)
    M = rng.standard_normal((5, 5)).astype(np.float32)
    A = M @ M.T + np.eye(5, dtype=np.float32)
    c = rng.standard_normal(5).astype(np.float32)
    z0 = rng.standard_normal(5).astype(np.float32)
    p0 = rng.standard_normal(3).astype(np.float32)

    def loss_j(zp):
        z, p = zp
        return 0.5 * z @ A @ z - c @ z + 50.0 * jnp.sum(p ** 2) * (z @ z)

    tx = optax.multi_transform(
        {"z": optax.sgd(ref.lr_z, momentum=ref.momentum, nesterov=True),
         "params": optax.sgd(cfg.train.learning_rate * ref.lr_model_scale,
                             momentum=ref.momentum, nesterov=True)},
        ("z", "params"))
    zp = (jnp.asarray(z0), jnp.asarray(p0))
    st = tx.init(zp)
    for _ in range(8):
        g = jax.grad(loss_j)(zp)
        up, st = tx.update(g, st, zp)
        zp = optax.apply_updates(zp, up)

    z = torch.as_tensor(z0).requires_grad_(True)
    p = torch.as_tensor(p0).requires_grad_(True)
    opt = tref.refine_optimizer(z, [p], cfg)
    At, ct = torch.as_tensor(A), torch.as_tensor(c)
    for _ in range(8):
        opt.zero_grad()
        (0.5 * z @ At @ z - ct @ z + 50.0 * (p ** 2).sum() * (z @ z)
         ).backward()
        opt.step()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(zp[0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(zp[1]),
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the slice: 3 refinement iterations, B = 2, both packages
# ---------------------------------------------------------------------------
O, B, ITERS = 8, 2, 3
SIZES = (16, 24, 32)
# z moves by lr_z * grad per step; at the default lr_z (2e-4) the three
# steps move z by ~2e-5, a few fp32 ulps of z itself, so z - z0 would
# compare rounding. Both sides take a 100x larger z step instead.
LR_Z = 2e-2


def make_slice_inputs():
    refine_j = dataclasses.replace(
        jcfg.default_config().refine, render_size=32, pyramid_sizes=SIZES,
        angle_noise_scale=0.0, lr_z=LR_Z)
    render_j = jcfg.RenderConfig(camera=jcfg.CameraConfig(image_size=32),
                                 mesh_subdiv=1, shell_subdiv=2,
                                 backend="jax")
    cfg_j = jcfg.default_config().replace(
        model=jcfg.ModelConfig(embedding_dim=16, gconv_num_layers=2),
        data=jcfg.DataConfig(max_objects=O, max_triples=3 * O,
                             max_on_rels=O),
        render=render_j, refine=refine_j)
    cfg_t = tcfg.default_config().replace(
        model=tcfg.ModelConfig(embedding_dim=16, gconv_num_layers=2),
        data=tcfg.DataConfig(max_objects=O, max_on_rels=O),
        render=tcfg.RenderConfig(camera=tcfg.CameraConfig(image_size=32),
                                 mesh_subdiv=1, shell_subdiv=2),
        refine=dataclasses.replace(tcfg.default_config().refine,
                                   render_size=32, pyramid_sizes=SIZES,
                                   angle_noise_scale=0.0, lr_z=LR_Z))

    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(B, seed=3), O)
    t, m, a = jsyn.default_size_table(64, seed=1)
    jb = j_build_graphs(jax.random.PRNGKey(0),
                        *(jnp.asarray(arrays[k]) for k in
                          ("objs", "boxes", "angles", "obj_mask",
                           "room_ids")),
                        JSizeInfo(jnp.asarray(t), jnp.asarray(m),
                                  jnp.asarray(a)), max_on_rels=O)
    jmodel = JVAE(cfg_j.model)
    v = jmodel.init(jax.random.PRNGKey(0), jb, None, False)
    rng = np.random.default_rng(0)
    stats = random_bn_stats(v["batch_stats"], rng)
    # random decoder weights scatter boxes outside the room, where the
    # render carries no gradient: shrink the box head's weights and centre
    # its bias so every object decodes to a visible box near mid-room
    params = jax.tree.map(lambda x: x, v["params"])
    head = dict(params["box_net"]["dense_1"])
    head["kernel"] = head["kernel"] * 0.05
    head["bias"] = jnp.asarray([0.25, 0.0, 0.3, 0.55, 0.4, 0.6], jnp.float32)
    params = {**params, "box_net": {**params["box_net"], "dense_1": head}}
    z0 = (0.5 * rng.standard_normal((B, O, cfg_j.model.latent_dim))
          ).astype(np.float32)

    tb = SceneBatch(*(torch.as_tensor(np.array(x)) for x in jb))
    tb = tb._replace(**{k: getattr(tb, k).long() for k in
                        ("objs", "angles", "attrs", "triples", "room_ids")})
    tmodel = Sg2ScVAE(cfg_t.model)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats})))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jb=jb, jmodel=jmodel,
                params=params, stats=stats, z0=z0, tb=tb, tmodel=tmodel)


@pytest.fixture(scope="module")
def slice_setup():
    return make_slice_inputs()


def _port_inputs(s):
    bank_host = tassets.build_procedural_bank(1)
    bank = tscene.device_bank(bank_host, 2, device="cpu")
    rcfg = tref.refine_render_config(s["cfg_t"])
    return bank, tref.prepare_refine_inputs(s["tb"], bank_host, bank, rcfg)


def test_refine_slice_matches_jax(slice_setup):
    s = slice_setup
    # JAX: targets and three scanned refinement steps
    bank_host = jassets.build_procedural_bank(1)
    bank = jscene.device_bank(bank_host, 2)
    rcfg = dataclasses.replace(s["cfg_j"].render, camera=dataclasses.replace(
        s["cfg_j"].render.camera, image_size=32))
    midx, target, size_t, room_row = jref.prepare_refine_inputs(
        s["jb"], bank_host, bank, rcfg)
    tx, _, _, run_scan = jref.make_refine_step(
        s["jmodel"], s["stats"], s["jb"], midx, bank, target, size_t,
        room_row, s["cfg_j"])
    z0 = jnp.asarray(s["z0"])
    state = jref.RefineState(z0, s["params"], tx.init((z0, s["params"])),
                             jnp.zeros((), jnp.int32))
    state, aux_j = run_scan(state, jax.random.split(jax.random.PRNGKey(0),
                                                    ITERS))

    # the port, from the same params, batch, z0 and (its own) target
    tbank, (t_midx, t_target, t_size, t_room) = _port_inputs(s)
    np.testing.assert_array_equal(t_midx.numpy(), np.asarray(midx))
    np.testing.assert_allclose(t_size.numpy(), np.asarray(size_t),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_target[:, 0].numpy(),
                               np.asarray(target)[:, 0], rtol=1e-4,
                               atol=1e-3)
    refiner = tref.make_refine_step(s["tmodel"], s["tb"], t_midx, tbank,
                                    t_target, t_size, t_room, s["cfg_t"],
                                    torch.as_tensor(s["z0"]))
    aux_t = refiner.run(ITERS)

    for k in ("total", "depth_loss", "semantic_loss"):
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(aux_j[k]),
                                   rtol=1e-3, err_msg=k)
    dz_j = np.asarray(state.z) - s["z0"]
    dz_t = refiner.z.detach().numpy() - s["z0"]
    assert np.abs(dz_j).max() > 1e-3
    np.testing.assert_allclose(dz_t, dz_j, rtol=0,
                               atol=2e-3 * np.abs(dz_j).max())


def test_angle_noise_scale(slice_setup):
    """Angle jitter is N(0, 1) * angle_noise_scale, drawn from the
    refiner's generator (JAX draws it from threefry keys instead)."""
    g = torch.Generator().manual_seed(0)
    n = tref.angle_noise((512, 32), 0.1, g, "cpu")
    assert abs(float(n.std()) - 0.1) < 0.005
    assert abs(float(n.mean())) < 0.005

    s = slice_setup
    cfg = s["cfg_t"].replace(refine=dataclasses.replace(
        s["cfg_t"].refine, angle_noise_scale=0.25))
    tbank, (midx, target, size_t, room) = _port_inputs(s)
    make = lambda: tref.make_refine_step(  # noqa: E731
        s["tmodel"], s["tb"], midx, tbank, target, size_t, room, cfg,
        torch.as_tensor(s["z0"]), torch.Generator().manual_seed(7))
    noise = make().draw_noise()
    want = torch.randn(s["tb"].objs.shape,
                       generator=torch.Generator().manual_seed(7)) * 0.25
    assert torch.equal(noise, want)


def test_snapshot_leaves_the_loop_noise_alone(slice_setup):
    """A snapshot renders with step 0's noise and draws nothing new from
    the loop's generator, as the JAX package's dump(state, k) reuses
    keys[k]: run(n)'s losses are bitwise the same with and without a
    snapshot before it."""
    s = slice_setup
    cfg = s["cfg_t"].replace(refine=dataclasses.replace(
        s["cfg_t"].refine, angle_noise_scale=0.25))
    tbank, (midx, target, size_t, room) = _port_inputs(s)

    def make():
        return tref.make_refine_step(
            copy.deepcopy(s["tmodel"]), s["tb"], midx, tbank, target,
            size_t, room, cfg, torch.as_tensor(s["z0"]),
            torch.Generator().manual_seed(7))

    plain = make().run(2)
    snapped = make()
    _, _, _, ang = snapped.snapshot()
    hist = snapped.run(2)
    for k in plain:
        assert torch.equal(hist[k], plain[k]), k
    # the snapshot's angles are the ones step 0 renders with
    fresh = make()
    with torch.no_grad():
        _, _, _, _, ang0 = fresh.forward(tref.angle_noise(
            s["tb"].objs.shape, 0.25, torch.Generator().manual_seed(7),
            "cpu"))
    assert torch.equal(ang, ang0)
    assert torch.equal(snapped.noise(0), fresh.noise(0))
