"""Port parity: the soft rasterizer's packing, culling and the plain
PyTorch versions of the two kernels (sln_tpu_torch.render.rasterizer_cuda)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_rasterizer_pallas.py runs them, at that file's tolerances."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sln_tpu.render import rasterizer as jr
from sln_tpu.render import rasterizer_pallas as jp
from sln_tpu_torch.render import rasterizer as tr
from sln_tpu_torch.render import rasterizer_cuda as tc

torch.set_num_threads(2)

S = 32
C = 5
SIGMA, GAMMA, ZFAR = 0.7, 0.02, 100.0
JAX_TILE = jp.PT   # feed the plain versions the JAX kernels' own tiling


def random_faces(n=23, seed=0, all_invalid=False):
    rng = np.random.default_rng(seed)
    tris, zs, cls, valid = [], [], [], []
    for _ in range(n):
        a = rng.uniform(0, S, 2)
        tris.append([a, a + rng.uniform(-12, 12, 2),
                     a + rng.uniform(-12, 12, 2)])
        zs.append(rng.uniform(2, 12, 3))
        cls.append(rng.integers(0, C))
        valid.append(rng.random() > 0.2 and not all_invalid)
    return (np.array(tris, np.float32), np.array(zs, np.float32),
            np.array(valid), np.array(cls, np.int32))


def jax_geom(faces):
    return jr.face_geometry(*(jnp.asarray(x) for x in faces))


def torch_geom(*scenes):
    """Stack per-scene numpy faces into one batched torch FaceGeometry."""
    v2d, z, valid, cls = (torch.as_tensor(np.stack(x))
                          for x in zip(*scenes))
    return tr.face_geometry(v2d, z, valid, cls)


def jax_sorted(geom):
    ycen = jnp.where(geom.valid, geom.v2d[..., 1].mean(-1), jnp.inf)
    return jax.tree.map(lambda x: x[jnp.argsort(ycen)], geom)


def jax_packed(faces):
    g = jax_sorted(jax_geom(faces))
    fdata, onehot = jp.pack_faces(g, C)
    mask = jp.chunk_tile_mask(g, S)
    counts, clist = jp.chunk_lists(mask)
    return g, fdata, onehot, mask, counts, clist


def to_t(*xs):
    return [torch.as_tensor(np.array(x))[None] for x in xs]


@pytest.mark.parametrize("n,seed", [(23, 0), (200, 5)])
def test_packing_and_culling_match_jax(n, seed):
    """The packing equals the JAX kernel's. The culling keeps every (tile,
    chunk) pair that the JAX kernel keeps, and more: the JAX package culls
    on each face's row span widened by the halo, which misses a sliver
    face's coverage along its edge lines; the port culls on the face
    dilated in line distance (test_culled_render_matches_dense_on_slivers
    holds the result)."""
    faces = random_faces(n, seed)
    _, fdata, onehot, mask, counts, clist = jax_packed(faces)
    g = torch_geom(faces)
    ycen = torch.where(g.valid, g.v2d[..., 1].mean(-1),
                       torch.tensor(float("inf")))
    g = g.take(torch.argsort(ycen, dim=-1, stable=True))
    t_fdata, t_onehot = tc.pack_faces(g, C)
    t_mask = tc.chunk_tile_mask(g, S, tile=JAX_TILE)
    t_counts, t_clist = tc.chunk_lists(t_mask)
    np.testing.assert_allclose(t_fdata[0].numpy(), np.asarray(fdata),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t_onehot[0].numpy(), np.asarray(onehot))
    kept_by_jax = np.asarray(mask) > 0
    assert t_mask[0].numpy()[kept_by_jax].all()
    # clist lists each tile's active chunks first, in ascending order
    m = t_mask[0].numpy()
    for t in range(m.shape[0]):
        n_act = int(t_counts[0, t, 0])
        assert n_act == m[t].sum()
        np.testing.assert_array_equal(t_clist[0, t, :n_act].numpy(),
                                      np.flatnonzero(m[t]))


S_SLIVER = 64     # two rows per 128-pixel tile: room for chunks to cull


def sliver_faces(kind, n_bulk=500, seed=11):
    """Small faces far behind, and near slivers in front of them, each
    spanning a few rows only: "thin" (long and a fraction of a pixel
    wide), "long" (a needle), "degenerate" (near-zero area, still valid,
    beside a collinear one, which is invalid). The coverage of each reaches
    along its edge lines far beyond its rows. Enough faces for several
    chunks, so that tiles far from a chunk's rows are culled."""
    rng = np.random.default_rng(seed)
    tris, zs, cls = [], [], []
    for _ in range(n_bulk):
        a = rng.uniform(0, S_SLIVER, 2)
        side = rng.uniform(2, 4)
        tris.append([a, a + [side, 0], a + [side / 2, side * 0.87]])
        zs.append(rng.uniform(8, 12, 3))
        cls.append(rng.integers(0, C))
    slivers = {
        "thin": [[[20, 24], [32, 38], [26.4, 30.6]],
                 [[44, 10], [36, 24], [40.2, 16.8]]],
        "long": [[[32, 24], [33.2, 24], [32.6, 40]],
                 [[12, 52], [13, 52], [16, 34]]],
        "degenerate": [[[16, 24], [24, 36], [20, 30.001]],
                       [[40, 40], [48, 48], [44, 44]]]}[kind]
    for tri in slivers:
        tris.append(tri)
        zs.append([2.0, 2.5, 3.0])
        cls.append(C - 1)
    valid = np.ones(len(tris), bool)
    return (np.array(tris, np.float32), np.array(zs, np.float32), valid,
            np.array(cls, np.int32))


@pytest.mark.parametrize("kind", ["thin", "long", "degenerate"])
def test_culled_render_matches_dense_on_slivers(kind):
    """The port's culled path (sort, pack, cull, the forward kernel's plain
    version) against the dense soft_rasterize on sliver faces, whose
    coverage reaches far beyond their row span: depth within 1e-4, no
    class-mask value flipped at 0.5, and some tiles really culled."""
    g = torch_geom(sliver_faces(kind))
    d_t, c_t = tc.soft_rasterize_cuda(g, C, S_SLIVER, sigma=SIGMA,
                                      gamma=GAMMA, z_far=ZFAR)
    d_o, c_o = tr.soft_rasterize(g, C, S_SLIVER, sigma=SIGMA, gamma=GAMMA,
                                 z_far=ZFAR)
    np.testing.assert_allclose(d_t.numpy(), d_o.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(c_t.numpy(), c_o.numpy(), rtol=0, atol=1e-4)
    assert ((c_t > 0.5) == (c_o > 0.5)).all()
    counts = tc.prepare_faces(g, C, S_SLIVER, SIGMA, GAMMA)[2]
    mask = tc.chunk_tile_mask(g, S_SLIVER, SIGMA, GAMMA)
    assert int(counts.sum()) < mask.numel()


def test_chunk_lists_prefix_matches_mask():
    mask = torch.tensor([[[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]]],
                        dtype=torch.bool)
    counts, clist = tc.chunk_lists(mask)
    assert counts.shape == (1, 3, 1) and counts.dtype == torch.int32
    assert counts[0, :, 0].tolist() == [2, 0, 4]
    assert clist[0, 0, :2].tolist() == [0, 2]
    assert clist[0, 2].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("n,seed,skew", [
    pytest.param(23, 0, False, id="23-0"),
    pytest.param(200, 5, False, id="200-5"),
    pytest.param(600, 7, False, id="600-7"),
    pytest.param(600, 8, True, id="600-8-skewed")])
def test_fwd_plain_matches_pallas_interpret(n, seed, skew):
    _, fdata, onehot, _, counts, clist = jax_packed(random_faces(n, seed))
    if skew:
        # tile 0 walks every chunk, tile 1 only the last: lists as unequal
        # as the kernels' work items see them
        T, K = np.asarray(clist).shape
        counts = jnp.asarray([[K]] + [[1]] * (T - 1), jnp.int32)
        clist = jnp.asarray([list(range(K))]
                            + [[K - 1] + list(range(K - 1))] * (T - 1),
                            jnp.int32)
    d_j, c_j, r_j = jp._core_fwd_impl(fdata, onehot, counts, clist, C, S,
                                      SIGMA, GAMMA, ZFAR)
    d_t, c_t, r_t = tc.raster_fwd_plain(*to_t(fdata, onehot, counts, clist),
                                        S, SIGMA, GAMMA, ZFAR)
    np.testing.assert_allclose(d_t[0].numpy(), np.asarray(d_j),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(c_t[0].numpy(), np.asarray(c_j),
                               rtol=1e-4, atol=1e-4)
    # residuals: running max, alt exact-ish; s and sum w*z on covered px
    r_j = np.asarray(r_j)
    covered = (1.0 - np.exp(r_j[:, 3])) > 1e-6
    np.testing.assert_allclose(r_t[0, covered].numpy(), r_j[covered],
                               rtol=1e-4, atol=1e-4)


def _cotangents(P, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((P, 1)).astype(np.float32),
            rng.standard_normal((P, C)).astype(np.float32))


def _assert_grad_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-3)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * scale)


@pytest.mark.parametrize("n,seed", [(23, 0), (200, 5)])
def test_bwd_plain_matches_jax_vjp_and_autograd(n, seed):
    _, fdata, onehot, _, counts, clist = jax_packed(random_faces(n, seed))
    gd, gc = _cotangents(S * S)

    def core(fd):
        return jp.rasterize_core(fd, onehot, counts, clist, C, S, SIGMA,
                                 GAMMA, ZFAR)

    _, vjp = jax.vjp(core, fdata)
    (fgrad_j,) = vjp((jnp.asarray(gd), jnp.asarray(gc)))

    tf, toh, tcn, tcl = to_t(fdata, onehot, counts, clist)
    _, classes, res = tc.raster_fwd_plain(tf, toh, tcn, tcl, S, SIGMA,
                                          GAMMA, ZFAR)
    tgd, tgc = to_t(gd, gc)
    fgrad_t = tc.raster_bwd_plain(tf, toh, tcn, tcl, res, classes, tgd, tgc,
                                  S, SIGMA, GAMMA, ZFAR)
    _assert_grad_close(fgrad_t[0].numpy(), fgrad_j)

    # the closed form equals autograd through the plain forward
    tf_req = tf.clone().requires_grad_(True)
    d, c, _ = tc.raster_fwd_plain(tf_req, toh, tcn, tcl, S, SIGMA, GAMMA,
                                  ZFAR)
    ((d * tgd).sum() + (c * tgc).sum()).backward()
    _assert_grad_close(fgrad_t.numpy(), tf_req.grad.numpy())


def test_batched_scenes_match_per_scene_jax():
    """B = 2 in one call (the port's batch axis) equals each scene alone
    in the JAX kernel, forward and backward."""
    scenes = [random_faces(23, 0), random_faces(60, 2)]
    packed = [jax_packed(f) for f in scenes]
    K = max(p[1].shape[1] for p in packed) // jp.FC
    assert all(p[1].shape[1] // jp.FC == K for p in packed)
    tf, toh, tcn, tcl = (torch.as_tensor(np.stack([np.asarray(p[i])
                                                   for p in packed]))
                         for i in (1, 2, 4, 5))
    d_t, c_t, res = tc.raster_fwd_plain(tf, toh, tcn, tcl, S, SIGMA, GAMMA,
                                        ZFAR)
    gd, gc = _cotangents(S * S, seed=4)
    g_t = tc.raster_bwd_plain(tf, toh, tcn, tcl, res, c_t,
                              torch.as_tensor(gd)[None].repeat(2, 1, 1),
                              torch.as_tensor(gc)[None].repeat(2, 1, 1),
                              S, SIGMA, GAMMA, ZFAR)
    for b, (_, fdata, onehot, _, counts, clist) in enumerate(packed):
        def core(fd):
            return jp.rasterize_core(fd, onehot, counts, clist, C, S,
                                     SIGMA, GAMMA, ZFAR)
        (d_j, c_j), vjp = jax.vjp(core, fdata)
        np.testing.assert_allclose(d_t[b].numpy(), np.asarray(d_j),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(c_t[b].numpy(), np.asarray(c_j),
                                   rtol=1e-4, atol=1e-4)
        _assert_grad_close(g_t[b].numpy(),
                           vjp((jnp.asarray(gd), jnp.asarray(gc)))[0])


def test_zero_counts_scene():
    """All faces invalid: every tile's active list is empty, the image is
    background, and the gradient is zero — as in the JAX kernel."""
    faces = random_faces(23, 3, all_invalid=True)
    _, fdata, onehot, _, counts, clist = jax_packed(faces)
    assert int(np.asarray(counts).sum()) == 0
    d_j, c_j, _ = jp._core_fwd_impl(fdata, onehot, counts, clist, C, S,
                                    SIGMA, GAMMA, ZFAR)
    tf, toh, tcn, tcl = to_t(fdata, onehot, counts, clist)
    d_t, c_t, res = tc.raster_fwd_plain(tf, toh, tcn, tcl, S, SIGMA, GAMMA,
                                        ZFAR)
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c_t[0].numpy(), np.asarray(c_j))
    assert (d_t == ZFAR).all() and (c_t == 0).all()
    gd, gc = to_t(*_cotangents(S * S))
    g = tc.raster_bwd_plain(tf, toh, tcn, tcl, res, c_t, gd, gc, S, SIGMA,
                            GAMMA, ZFAR)
    assert (g == 0).all()


def test_soft_rasterize_end_to_end_and_vertex_grads():
    """The port's path (sort, pack, cull at its own tile size, plain core
    on the CPU) against the JAX package's pure-JAX soft_rasterize: values
    and gradients to projected vertices and depths."""
    v2d, z, valid, cls = random_faces(11, 3)
    w = np.arange(C, dtype=np.float32)

    def loss_j(v2d, z):
        g = jr.face_geometry(v2d, z, jnp.asarray(valid), jnp.asarray(cls))
        d, c = jr.soft_rasterize(g, C, S, sigma=SIGMA, gamma=GAMMA,
                                 z_far=ZFAR)
        return d.mean() + (c * w).sum() * 1e-2, (d, c)

    (_, (d_j, c_j)), g_j = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(v2d),
                                              jnp.asarray(z))

    tv = torch.as_tensor(v2d)[None].requires_grad_(True)
    tz = torch.as_tensor(z)[None].requires_grad_(True)
    g = tr.face_geometry(tv, tz, torch.as_tensor(valid)[None],
                         torch.as_tensor(cls)[None])
    d_t, c_t = tc.soft_rasterize_cuda(g, C, S, sigma=SIGMA, gamma=GAMMA,
                                      z_far=ZFAR)
    (d_t.mean() + (c_t * torch.as_tensor(w)).sum() * 1e-2).backward()
    np.testing.assert_allclose(d_t[0].detach().numpy(), np.asarray(d_j),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(c_t[0].detach().numpy(), np.asarray(c_j),
                               rtol=1e-4, atol=1e-4)
    _assert_grad_close(tv.grad[0].numpy(), g_j[0])
    _assert_grad_close(tz.grad[0].numpy(), g_j[1])

    # and the port's own chunked oracle agrees with its kernel path
    d_o, c_o = tr.soft_rasterize(g, C, S, sigma=SIGMA, gamma=GAMMA,
                                 z_far=ZFAR)
    np.testing.assert_allclose(d_o.detach().numpy(), d_t.detach().numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(c_o.detach().numpy(), c_t.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_cuda_wrappers_refuse_cpu_tensors():
    """No hidden fallback: the kernel wrappers take only tensors on the
    card, and raise before launching anything otherwise."""
    packed = tc.prepare_faces(torch_geom(random_faces(23, 0)), C, S)
    before = (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="on the card"):
        tc.raster_fwd_cuda(*packed, S, SIGMA, GAMMA, ZFAR)
    P = S * S
    with pytest.raises(ValueError, match="on the card"):
        tc.raster_bwd_cuda(*packed, torch.zeros(1, P, 4),
                           torch.zeros(1, P, C), torch.zeros(1, P, 1),
                           torch.zeros(1, P, C), S, SIGMA, GAMMA, ZFAR)
    assert (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES) == before
