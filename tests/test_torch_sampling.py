"""Port parity for the sampling and evaluation workloads
(sln_tpu_torch.workloads.posterior / acc_l1_std / batch_gen / heatmap)
against the JAX package on the CPU (the plots and the test.py modes:
tests/test_torch_sampling_modes.py).

JAX draws its randomness from threefry keys that torch cannot reproduce;
the port's per-batch functions take their random numbers as tensors, so
these tests hand them JAX's own draws (made from the keys JAX's loops
use) and compare values. Tolerances: 2e-4 on encoder / decoder outputs
(tests/test_torch_model.py's), 1e-6 where no network is involved, exact
for integer counts and for values only copied.
"""

import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sln_tpu import config as jcfg
from sln_tpu.data import synthetic as jsyn, tensorize as jtens
from sln_tpu.data.augment import SizeInfo as JSizeInfo
from sln_tpu.data.augment import build_graphs as j_build_graphs
from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.workloads import acc_l1_std as jacc, batch_gen as jgen
from sln_tpu.workloads import common as jcommon, heatmap as jheat
from sln_tpu.workloads import posterior as jpost
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.data.augment import GraphDraws, SizeInfo
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.workloads import acc_l1_std as tacc, batch_gen as tgen
from sln_tpu_torch.workloads import common as tcommon, heatmap as theat
from sln_tpu_torch.workloads import posterior as tpost

torch.set_num_threads(2)

O = 12
NARROW = dict(embedding_dim=16, gconv_num_layers=2)
CKPT = dict(output_dir="artifacts", checkpoint_name="bench")


def t_(x):
    return torch.as_tensor(np.array(x))


def jax_graph_draws(key, B, n_obj=O) -> GraphDraws:
    """The draws JAX's build_graphs makes from `key` (augment.py:57-118)."""
    k_partner, k_swap, k_a1, k_a2 = jax.random.split(key, 4)
    return GraphDraws(
        gumbel=t_(jax.random.gumbel(k_partner, (B, n_obj, n_obj))),
        swap=t_(jax.random.bernoulli(k_swap, 0.5, (B, n_obj))),
        u_none=t_(jax.random.uniform(k_a1, (B, n_obj))),
        u_height=t_(jax.random.uniform(k_a2, (B, n_obj))))


def rooms(n, seed=3, max_objects=O):
    return jtens.tensorize_rooms(jsyn.generate_rooms(n, seed=seed),
                                 max_objects)


@pytest.fixture(scope="module")
def size_tables():
    t, m, a = jsyn.default_size_table(64, seed=1)
    return (JSizeInfo(*(jnp.asarray(x) for x in (t, m, a))),
            SizeInfo(*(torch.as_tensor(x) for x in (t, m, a))))


@pytest.fixture(scope="module")
def narrow():
    """A narrow random JAX model with non-trivial BatchNorm statistics,
    its port, and both packages' configs at O objects."""
    data = dict(max_objects=O, max_triples=3 * O, max_on_rels=O)
    cfg_j = jcfg.default_config().replace(
        model=jcfg.ModelConfig(**NARROW), data=jcfg.DataConfig(**data))
    cfg_t = tcfg.default_config().replace(
        model=tcfg.ModelConfig(**NARROW), data=tcfg.DataConfig(**data))
    arrays = rooms(4)
    t, m, a = jsyn.default_size_table(64, seed=1)
    jb = j_build_graphs(jax.random.PRNGKey(0),
                        *(jnp.asarray(arrays[k]) for k in
                          ("objs", "boxes", "angles", "obj_mask",
                           "room_ids")),
                        JSizeInfo(*(jnp.asarray(x) for x in (t, m, a))),
                        max_on_rels=O)
    jmodel = JVAE(cfg_j.model)
    v = jmodel.init(jax.random.PRNGKey(0), jb, None, False)
    rng = np.random.default_rng(0)

    def stats(path, x):
        if path[-1].key == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(x.shape),
                               jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map_with_path(
             stats, v["batch_stats"])}
    model = Sg2ScVAE(cfg_t.model)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v)))
    return cfg_j, cfg_t, jmodel, v, model.eval()


@pytest.fixture(scope="module")
def posterior_stats():
    with open("artifacts/mean_cov.pkl", "rb") as f:
        mean, cov = pickle.load(f)
    return np.asarray(mean), np.asarray(cov)


def narrow_mean_cov(d, seed=9):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) * 0.3
    return rng.standard_normal(d) * 0.1, a @ a.T + 0.1 * np.eye(d)


# ---------------------------------------------------------------------------
# posterior
# ---------------------------------------------------------------------------
def test_sample_z_with_jax_eps_matches_jax(posterior_stats):
    mean, cov = posterior_stats
    key = jax.random.PRNGKey(4)
    shape = (3, 5, 7)
    want = np.asarray(jpost.sample_z(key, mean, cov, shape))
    eps = jax.random.normal(key, shape + (mean.shape[0],), jnp.float32)
    got = tpost.sample_z(mean, cov, t_(eps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_posterior_batch_and_reduction_match_jax(narrow, size_tables):
    """One batch of the sweep with JAX's graph draws: mu within 2e-4; the
    mean / cov reduction of JAX's own mus within 1e-9 (float64)."""
    cfg_j, cfg_t, jmodel, v, model = narrow
    jsi, tsi = size_tables
    arrays = rooms(8, seed=5)
    key = jax.random.fold_in(jax.random.PRNGKey(123), 0)
    jb = j_build_graphs(key, *(jnp.asarray(arrays[k]) for k in
                               ("objs", "boxes", "angles", "obj_mask",
                                "room_ids")), jsi, max_on_rels=O)
    mu_j, _ = jmodel.apply(v, jb, False, method=JVAE.encode)
    batch = tpost.scene_batch(arrays, np.arange(8), tsi, cfg_t,
                              jax_graph_draws(key, 8), "cpu")
    with torch.inference_mode():
        mu_t, _ = model.encode(batch)
    m = np.asarray(jb.obj_mask)
    np.testing.assert_allclose(mu_t.numpy()[m], np.asarray(mu_j)[m],
                               rtol=2e-4, atol=2e-4)

    class FixedMu:
        """Stands in for the model in JAX's sweep: returns JAX's mus."""
        def apply(self, *args, **kwargs):
            return jnp.asarray(mu_j), None

    mean_j, cov_j = jpost.collect_posterior_stats(FixedMu(), v, arrays, jsi,
                                                  cfg_j, batch_size=8)
    mean_t, cov_t = tpost.mean_cov(np.asarray(mu_j, np.float64)[m])
    np.testing.assert_allclose(mean_t, mean_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(cov_t, cov_j, rtol=0, atol=1e-9)


def test_posterior_sweep_with_jax_draws_matches_jax(narrow, size_tables):
    """The whole sweep (two batches, the last one wrapped and masked) fed
    JAX's graph draws per batch gives JAX's statistics."""
    cfg_j, cfg_t, jmodel, v, model = narrow
    jsi, tsi = size_tables
    arrays = rooms(11, seed=6)
    key = jax.random.PRNGKey(123)
    mean_j, cov_j = jpost.collect_posterior_stats(jmodel, v, arrays, jsi,
                                                  cfg_j, batch_size=8)
    mean_t, cov_t = tpost.collect_posterior_stats(
        model, arrays, tsi, cfg_t, batch_size=8, device="cpu",
        graph_draws=lambda start, B, n: jax_graph_draws(
            jax.random.fold_in(key, start), B, n))
    np.testing.assert_allclose(mean_t, mean_j, rtol=0, atol=2e-4)
    np.testing.assert_allclose(cov_t, cov_j, rtol=0,
                               atol=2e-4 * np.abs(cov_j).max())


def test_posterior_sweep_on_the_checkpoint_within_noise_of_jax():
    """256 synthetic rooms (seed 42) through the committed checkpoint: the
    port's own graph draws against JAX's. Measured on the CPU: mean
    max-abs difference 0.0148, covariance relative Frobenius difference
    0.264. The bounds, 0.03 and 0.5, are the JAX sweep's own spread on
    these rooms between its key 123 and keys 5 and 77 (up to 0.0196 and
    0.348) times 1.5: 256 rooms hold about 2,400 objects, so the noise is
    about four times that of bench.py's 4,096-room posterior."""
    cfg_j = jcfg.default_config().replace(train=jcfg.TrainConfig(**CKPT))
    cfg_t = tcfg.default_config().replace(train=tcfg.TrainConfig(**CKPT))
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(256, seed=42), 32)
    t, m, a = jsyn.default_size_table()
    jsi = JSizeInfo(*(jnp.asarray(x) for x in (t, m, a)))
    jmodel, v = jcommon.restore_model(cfg_j, None)
    mean_j, cov_j = jpost.collect_posterior_stats(jmodel, v, arrays, jsi,
                                                  cfg_j)
    model = tcommon.restore_model(cfg_t, "cpu")
    tsi = SizeInfo(*(torch.as_tensor(x) for x in (t, m, a)))
    mean_t, cov_t = tpost.collect_posterior_stats(model, arrays, tsi, cfg_t,
                                                  device="cpu")
    d_mean = np.abs(mean_t - mean_j).max()
    d_cov = np.linalg.norm(cov_t - cov_j) / np.linalg.norm(cov_j)
    assert d_mean <= 0.03, d_mean
    assert d_cov <= 0.5, d_cov


def test_get_or_compute_mean_cov_writes_the_reference_format(narrow,
                                                             size_tables,
                                                             tmp_path):
    _, cfg_t, _, _, model = narrow
    _, tsi = size_tables
    mean, cov = tpost.get_or_compute_mean_cov(model, rooms(8), tsi, cfg_t,
                                              str(tmp_path), "cpu")
    with open(tmp_path / "mean_cov.pkl", "rb") as f:
        saved = pickle.load(f)
    d = cfg_t.model.latent_dim
    assert isinstance(saved, list) and len(saved) == 2
    assert saved[0].shape == (d,) and saved[1].shape == (d, d)
    assert saved[0].dtype == saved[1].dtype == np.float64
    np.testing.assert_array_equal(saved[1], cov)
    again = tpost.get_or_compute_mean_cov(None, None, None, cfg_t,
                                          str(tmp_path))
    np.testing.assert_array_equal(again[0], mean)


# ---------------------------------------------------------------------------
# acc / L1 / std
# ---------------------------------------------------------------------------
def random_layouts(B=5, n=O, seed=0):
    """Boxes in [0, 1] with a room row (class 0, absolute dims) per
    scene, padding past n_valid, and triples over the valid objects."""
    rng = np.random.default_rng(seed)
    objs = rng.integers(1, 32, (B, n))
    mask = np.zeros((B, n), bool)
    lo = rng.uniform(0, 0.7, (B, n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (B, n, 3))], -1)
    T = 3 * n
    triples = np.zeros((B, T, 3), np.int64)
    tmask = np.zeros((B, T), bool)
    for b in range(B):
        nv = rng.integers(4, n + 1)
        mask[b, :nv] = True
        objs[b, nv - 1] = 0
        boxes[b, nv - 1] = [0, 0, 0, *rng.uniform(2.5, 6, 3)]
        nt = rng.integers(3, T)
        triples[b, :nt, 0] = rng.integers(0, nv, nt)
        triples[b, :nt, 2] = rng.integers(0, nv, nt)
        triples[b, :nt, 1] = rng.integers(0, 16, nt)
        triples[b, nt - 2:nt, 2] = nv - 1          # edges to the room
        tmask[b, :nt] = True
    return (objs, mask, triples, tmask, boxes.astype(np.float32))


def test_per_batch_eval_functions_match_jax():
    objs, mask, triples, tmask, boxes = random_layouts()
    B, n = objs.shape
    key_r, key_p = jax.random.split(jax.random.PRNGKey(8))
    jo, jm, jt, jtm, jbx = (jnp.asarray(x) for x in
                            (objs, mask, triples, tmask, boxes))
    to, tm, tt, ttm, tbx = (torch.as_tensor(x) for x in
                            (objs, mask, triples, tmask, boxes))
    # the random and perturbed scenes with JAX's draws (acc_l1_std.py:57-81)
    k_c, k_a = jax.random.split(key_r)
    center = jax.random.uniform(k_c, (B, n, 3))
    angle = jax.random.randint(k_a, (B, n), 0, 24)
    rand_j, ang_j = jacc.random_scene(key_r, jo, jbx, jm)
    rand_t, ang_t = tacc.random_scene(to, tbx, t_(center), t_(angle))
    np.testing.assert_allclose(rand_t.numpy(), np.asarray(rand_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ang_t.numpy(), np.asarray(ang_j))
    pert_j = jacc.perturbed_scene(key_p, jbx)
    pert_t = tacc.perturbed_scene(tbx, t_(jax.random.normal(key_p,
                                                            (B, n, 3))))
    np.testing.assert_allclose(pert_t.numpy(), np.asarray(pert_j), rtol=0,
                               atol=1e-6)
    for jx, tx in ((jbx, tbx), (rand_j, rand_t), (pert_j, pert_t)):
        good_j, total_j = jacc.scene_graph_acc_batch(jo, jm, jt, jtm, jx)
        good_t, total_t = tacc.scene_graph_acc_batch(to, tm, tt, ttm, tx)
        assert (int(good_t), int(total_t)) == (int(good_j), int(total_j))
        np.testing.assert_allclose(
            float(tacc.masked_l1(tx, tbx, tm)),
            float(jacc.masked_l1(jx, jbx, jm)), rtol=0, atol=1e-6)
    assert 0 < int(good_j) < int(total_j)


def test_std_reduction_matches_jax():
    """masked_std is run_std's reduction (acc_l1_std.py:186-193): jnp.std
    over the samples (population std), averaged over the valid objects."""
    rng = np.random.default_rng(1)
    mask = rng.random((4, 6)) > 0.3
    for shape in ((10, 4, 6), (10, 4, 6, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        sd = jnp.std(jnp.asarray(x), axis=0)
        m = jnp.asarray(mask, jnp.float32)
        mn = jnp.maximum(m.sum(), 1.0)
        want = ((sd * m[..., None]).sum() / (mn * sd.shape[-1])
                if sd.ndim == 3 else (sd * m).sum() / mn)
        got = tacc.masked_std(torch.as_tensor(x), torch.as_tensor(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-6)


def jax_eval_draws(seed, d):
    """run_acc_l1's draws for the batch at `start`, as JAX's loop makes
    them (fold_in(PRNGKey(seed), start), split in four)."""
    def draw(start, B, n):
        kg, kz, kr, kp = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), start), 4)
        k_c, k_a = jax.random.split(kr)
        return tacc.EvalDraws(
            graph=jax_graph_draws(kg, B, n),
            eps=t_(jax.random.normal(kz, (B, n, d), jnp.float32)),
            center=t_(jax.random.uniform(k_c, (B, n, 3))),
            angle=t_(jax.random.randint(k_a, (B, n), 0, 24)),
            offset=t_(jax.random.normal(kp, (B, n, 3))))
    return draw


def test_run_acc_l1_with_jax_draws_matches_jax(narrow, size_tables):
    """Two batches, the second wrapped and masked. The random and
    perturbed baselines involve no network: their counts are equal and
    their L1 within 1e-6; the decoded layout's L1 within 2e-4 and its
    correct-triple count within one triple (a box within 2e-4 of a
    relation's threshold may flip it)."""
    cfg_j, cfg_t, jmodel, v, model = narrow
    jsi, tsi = size_tables
    val = rooms(13, seed=7)
    d = cfg_t.model.latent_dim
    mean, cov = narrow_mean_cov(d)
    want = jacc.run_acc_l1(jmodel, v, val, jsi, cfg_j, mean, cov,
                           batch_size=8, seed=0)
    got = tacc.run_acc_l1(model, val, tsi, cfg_t, mean, cov, batch_size=8,
                          device="cpu", draw_fn=jax_eval_draws(0, d))
    total = want["total_triples"]
    assert got["total_triples"] == total > 0
    for name in ("rand", "pert"):
        assert got[f"acc_{name}"] == want[f"acc_{name}"]
        np.testing.assert_allclose(got[f"l1_{name}"], want[f"l1_{name}"],
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["l1_pred"], want["l1_pred"], rtol=0,
                               atol=2e-4)
    assert abs(got["acc_pred"] - want["acc_pred"]) * total <= 1


def test_run_std_with_jax_draws_matches_jax(narrow, size_tables):
    """nsample decodes as one batch of nsample x B scenes: the stds within
    2e-4 of JAX's vmapped decodes."""
    cfg_j, cfg_t, jmodel, v, model = narrow
    jsi, tsi = size_tables
    val = rooms(9, seed=8)
    d = cfg_t.model.latent_dim
    mean, cov = narrow_mean_cov(d)

    def draw(start, B, n):
        kg, kz = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(1), start))
        return tacc.StdDraws(jax_graph_draws(kg, B, n), t_(
            jax.random.normal(kz, (4, B, n, d), jnp.float32)))

    want = jacc.run_std(jmodel, v, val, jsi, cfg_j, mean, cov, nsample=4,
                        batch_size=8, seed=0)
    got = tacc.run_std(model, val, tsi, cfg_t, mean, cov, nsample=4,
                       batch_size=8, device="cpu", draw_fn=draw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# batch_gen
# ---------------------------------------------------------------------------
def test_run_batch_gen_with_jax_draws_matches_jax(narrow, size_tables,
                                                  tmp_path):
    """One batch of 8 rooms: the same keys, 'gt' equal, sampled boxes
    within 1e-4 and the sampled angles' argmax equal."""
    cfg_j, cfg_t, jmodel, v, model = narrow
    jsi, tsi = size_tables
    d = cfg_t.model.latent_dim
    mean, cov = narrow_mean_cov(d)
    for sub in ("jax", "torch"):                # a shared posterior cache
        os.makedirs(tmp_path / sub)
        with open(tmp_path / sub / "mean_cov.pkl", "wb") as f:
            pickle.dump([mean, cov], f)
    val = rooms(8, seed=9)
    path_j = jgen.run_batch_gen(jmodel, v, None, val, jsi, cfg_j,
                                str(tmp_path / "jax"), batch_size=8)

    def draw(start, B, n):
        kg, kz = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(7), start))
        return tgen.GenDraws(jax_graph_draws(kg, B, n), t_(
            jax.random.normal(kz, (tgen.NSAMPLE, B, n, d), jnp.float32)))

    path_t = tgen.run_batch_gen(model, None, val, tsi, cfg_t,
                                str(tmp_path / "torch"), batch_size=8,
                                device="cpu", draw_fn=draw)
    assert path_t.endswith(os.path.join("data", "data_extracted.json"))
    with open(path_j) as f:
        want = json.load(f)
    with open(path_t) as f:
        got = json.load(f)
    assert got.keys() == want.keys() and len(got) == 8
    for room, w in want.items():
        g = got[room]
        assert g.keys() == w.keys() == {"gt", "0", "1", "2", "3"}
        assert g["gt"] == w["gt"]
        for k in "0123":
            np.testing.assert_allclose(g[k]["boxes"], w[k]["boxes"],
                                       rtol=0, atol=1e-4)
            assert g[k]["angles"] == w[k]["angles"]


# ---------------------------------------------------------------------------
# heat map and plots
# ---------------------------------------------------------------------------
def test_heatmap_scene_graph_matches_jax():
    objs = ["bed", "desk", "chair:1", "chair:2"]
    rels = [("bed", "left of", "desk"), ("chair:1", "in front of", "desk"),
            ("chair:2", "behind", "bed")]
    for a, b in zip(theat.sg_from_words(objs, rels),
                    jheat.sg_from_words(objs, rels)):
        np.testing.assert_array_equal(a, b)
    tb = theat.heatmap_scene_batch(6, 8, 24, device="cpu")
    jb = jheat.heatmap_scene_batch(6, 8, 24)
    for name, a, b in zip(tb._fields, tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_sampler_with_jax_eps_matches_jax(narrow, tmp_path):
    cfg_j, cfg_t, jmodel, v, model = narrow
    d = cfg_t.model.latent_dim
    mean, cov = narrow_mean_cov(d)
    jbatch = jheat.heatmap_scene_batch(16, 8, 24)
    key = jax.random.PRNGKey(3)
    box_j, ang_j = jheat.make_sampler(jmodel, v, jbatch, mean, cov)(key)
    sample = theat.make_sampler(
        model, theat.heatmap_scene_batch(16, 8, 24, device="cpu"), mean,
        cov)
    box_t, ang_t = sample(t_(jax.random.normal(key, (16, 8, d),
                                               jnp.float32)))
    m = np.asarray(jbatch.obj_mask)
    np.testing.assert_allclose(box_t.numpy()[m], np.asarray(box_j)[m],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ang_t.numpy()[m], np.asarray(ang_j)[m])

    path = theat.produce_heatmap(model, mean, cov, str(tmp_path),
                                 num_iter=40, batch_size=16, device="cpu")
    assert path == os.path.join(str(tmp_path), "data", "heat",
                                "0000_heat.pkl")
    with open(path, "rb") as f:
        heat = pickle.load(f)
    objs_j, _, attrs_j = jheat.sg_from_words(jheat.DEFAULT_OBJECTS,
                                             jheat.DEFAULT_RELATIONS)
    assert isinstance(heat, list) and len(heat) == 4 and heat[3] == []
    np.testing.assert_array_equal(heat[0], objs_j)
    np.testing.assert_array_equal(heat[1], attrs_j)
    assert heat[2].shape == (40, 6, 6) and np.isfinite(heat[2]).all()
    pngs = theat.plot_heatmap(path, str(tmp_path / "png"))
    assert len(pngs) == 5 and all(os.path.getsize(p) > 0 for p in pngs)
