"""Port parity: scene-graph construction and the Sg2ScVAE forward
(sln_tpu_torch.data.augment / models.vae) against the JAX package on the
same inputs, weights carried across by params_from_jax."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sln_tpu.config import ModelConfig as JModelConfig
from sln_tpu.data import synthetic as jsyn, tensorize as jtens
from sln_tpu.data.augment import SizeInfo as JSizeInfo
from sln_tpu.data.augment import build_graphs as j_build_graphs
from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.ops.relations import relation_matrix as j_relation_matrix
from sln_tpu_torch.config import ModelConfig
from sln_tpu_torch.data.augment import GraphDraws, SizeInfo, build_graphs
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.ops.relations import relation_matrix

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

O = 12
NARROW = dict(embedding_dim=16, gconv_num_layers=2)


def rooms(n=6, seed=3):
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(n, seed=seed), O)
    t, m, a = jsyn.default_size_table(64, seed=1)
    return arrays, (t, m, a)


def jax_batch(arrays, table, key=0):
    return j_build_graphs(
        jax.random.PRNGKey(key), *(jnp.asarray(arrays[k]) for k in
                                   ("objs", "boxes", "angles", "obj_mask",
                                    "room_ids")),
        JSizeInfo(*(jnp.asarray(x) for x in table)), max_on_rels=O)


def to_torch_batch(jb) -> SceneBatch:
    return SceneBatch(*(torch.as_tensor(np.array(x)) for x in jb)) \
        ._replace(objs=torch.as_tensor(np.array(jb.objs)).long(),
                  angles=torch.as_tensor(np.array(jb.angles)).long(),
                  attrs=torch.as_tensor(np.array(jb.attrs)).long(),
                  triples=torch.as_tensor(np.array(jb.triples)).long(),
                  room_ids=torch.as_tensor(np.array(jb.room_ids)).long())


def test_relation_matrix_matches_jax():
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 3, (3, 10, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 1.5, (3, 10, 3))],
                           -1).astype(np.float32)
    want = np.stack([np.asarray(j_relation_matrix(jnp.asarray(b)))
                     for b in boxes])
    got = relation_matrix(torch.as_tensor(boxes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_build_graphs_with_jax_draws_matches_jax():
    arrays, table = rooms()
    key = jax.random.PRNGKey(5)
    jb = jax_batch(arrays, table, key=5)
    # JAX's own draws, reproduced as augment.py:57-118 makes them
    B = arrays["objs"].shape[0]
    k_partner, k_swap, k_a1, k_a2 = jax.random.split(key, 4)
    draws = GraphDraws(
        gumbel=torch.as_tensor(np.array(jax.random.gumbel(k_partner,
                                                          (B, O, O)))),
        swap=torch.as_tensor(np.array(jax.random.bernoulli(k_swap, 0.5,
                                                           (B, O)))),
        u_none=torch.as_tensor(np.array(jax.random.uniform(k_a1, (B, O)))),
        u_height=torch.as_tensor(np.array(jax.random.uniform(k_a2,
                                                             (B, O)))))
    tb = build_graphs(*(torch.as_tensor(arrays[k]) for k in
                        ("objs", "boxes", "angles", "obj_mask", "room_ids")),
                      SizeInfo(*(torch.as_tensor(x) for x in table)),
                      max_on_rels=O, draws=draws)
    for name, a, b in zip(SceneBatch._fields, tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_build_graphs_generator_draws_are_valid():
    arrays, table = rooms()
    args = [torch.as_tensor(arrays[k]) for k in
            ("objs", "boxes", "angles", "obj_mask", "room_ids")]
    si = SizeInfo(*(torch.as_tensor(x) for x in table))
    a = build_graphs(*args, si, max_on_rels=O,
                     generator=torch.Generator().manual_seed(1))
    b = build_graphs(*args, si, max_on_rels=O,
                     generator=torch.Generator().manual_seed(1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    m = a.triple_mask
    O_ = a.objs.shape[1]
    assert ((a.triples[..., 0] < O_) & (a.triples[..., 2] < O_))[m].all()
    # every real object has its __in_room__ triple to the room slot
    real = a.obj_mask & (a.objs != 0)
    assert torch.equal(m[:, -O_:], real)


def _jax_model(train_stats_seed=0):
    cfg = JModelConfig(**NARROW)
    arrays, table = rooms()
    jb = jax_batch(arrays, table)
    model = JVAE(cfg)
    v = model.init(jax.random.PRNGKey(0), jb, None, False)
    # non-trivial running statistics so eval-mode BN is exercised
    rng = np.random.default_rng(train_stats_seed)
    stats = random_bn_stats(v["batch_stats"], rng)
    v = {"params": v["params"], "batch_stats": stats}
    return cfg, model, v, jb


def _port_model(v):
    model = Sg2ScVAE(ModelConfig(**NARROW))
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, dict(v))))
    return model


def test_vae_eval_encode_decode_match_jax():
    _, jmodel, v, jb = _jax_model()
    mu_j, lv_j = jmodel.apply(v, jb, False, method=JVAE.encode)
    z = np.random.default_rng(2).standard_normal(
        np.shape(mu_j)).astype(np.float32)
    box_j, ang_j = jmodel.apply(v, jnp.asarray(z), jb, False,
                                method=JVAE.decode)

    model = _port_model(v).eval()
    tb = to_torch_batch(jb)
    with torch.no_grad():
        mu_t, lv_t = model.encode(tb)
        box_t, ang_t = model.decode(torch.as_tensor(z), tb)
    m = np.asarray(jb.obj_mask)
    for a, b in ((mu_t, mu_j), (lv_t, lv_j), (box_t, box_j),
                 (ang_t, ang_j)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=2e-4, atol=2e-4)


def test_vae_train_mode_batch_norm_matches_jax():
    _, jmodel, v, jb = _jax_model()
    (mu_j, lv_j, box_j, ang_j), upd = jmodel.apply(
        v, jb, None, True, mutable=["batch_stats"])
    model = _port_model(v).train()
    with torch.no_grad():
        mu_t, lv_t, box_t, ang_t = model(to_torch_batch(jb))
    m = np.asarray(jb.obj_mask)
    for a, b in ((mu_t, mu_j), (lv_t, lv_j), (box_t, box_j),
                 (ang_t, ang_j)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=2e-4, atol=2e-4)
    # the running-statistics update matches too
    sd = params_from_jax({"params": jax.tree.map(np.asarray, v["params"]),
                          "batch_stats": jax.tree.map(
                              np.asarray, upd["batch_stats"])})
    ours = model.state_dict()
    for k, want in sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ours[k].numpy(), want.numpy(),
                                       rtol=2e-4, atol=2e-4, err_msg=k)


def test_params_from_jax_loads_committed_checkpoint():
    with open("artifacts/latest_bench_with_model.ckpt", "rb") as f:
        ms = pickle.load(f)["model_state"]
    sd = params_from_jax(ms)
    n_leaves = len(jax.tree.leaves(ms["params"])) + len(
        jax.tree.leaves(ms["batch_stats"]))
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) == n_leaves + n_bn          # every leaf consumed once
    model = Sg2ScVAE(ModelConfig())
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    k = ms["params"]["gconv_net_ec"]["gconv_0"]["net1"]["dense_0"]["kernel"]
    np.testing.assert_array_equal(
        model.gconv_net_ec.gconvs[0].net1[0].weight.detach().numpy(), k.T)
    np.testing.assert_array_equal(
        model.gconv_net_ec.gconvs[0].net1[1].running_var.numpy(),
        ms["batch_stats"]["gconv_net_ec"]["gconv_0"]["net1"]["bn_0"]["var"])


def test_reference_torch_checkpoint_loads_directly():
    """The modules keep the reference state_dict layout: the committed
    reference-trained checkpoint loads with strict=True, and decodes as the
    JAX package does with the same weights imported by its own
    utils/torch_port.py."""
    from sln_tpu.config import ModelConfig as JFull
    from sln_tpu.utils.torch_port import port_sg2scvae

    ckpt = torch.load(
        "artifacts/ref_baseline/checkpoints/latest_checkpoint_with_model.pt",
        map_location="cpu", weights_only=False)
    model = Sg2ScVAE(ModelConfig())
    result = model.load_state_dict(ckpt["model_state"], strict=True)
    assert not result.missing_keys and not result.unexpected_keys

    params, stats = port_sg2scvae(ckpt["model_state"], JFull())
    arrays, table = rooms(n=3)
    jb = jax_batch(arrays, table)
    z = np.random.default_rng(4).standard_normal(
        (3, O, JFull().latent_dim)).astype(np.float32)
    box_j, ang_j = JVAE(JFull()).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z), jb, False,
        method=JVAE.decode)
    with torch.no_grad():
        box_t, ang_t = model.eval().decode(torch.as_tensor(z),
                                           to_torch_batch(jb))
    m = np.asarray(jb.obj_mask)
    np.testing.assert_allclose(box_t.numpy()[m], np.asarray(box_j)[m],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ang_t.numpy()[m], np.asarray(ang_j)[m],
                               rtol=2e-4, atol=2e-4)


def test_restore_model_falls_back_to_reference_pt():
    """With no `.ckpt` in output_dir, restore_model takes the reference
    trainer's latest_<name>_with_model.pt, as the JAX package's does, and
    the two restored models decode a fixed batch alike."""
    from sln_tpu import config as jcfg
    from sln_tpu.workloads import common as jcommon
    from sln_tpu_torch import config as tcfg
    from sln_tpu_torch.workloads import common as tcommon

    out = "artifacts/ref_baseline/checkpoints"
    train_j = jcfg.TrainConfig(output_dir=out, checkpoint_name="checkpoint")
    train_t = tcfg.TrainConfig(output_dir=out, checkpoint_name="checkpoint")
    model_t = tcommon.restore_model(
        tcfg.default_config().replace(train=train_t), "cpu")
    arrays, table = rooms(n=3)
    jb = jax_batch(arrays, table)
    cfg_j = jcfg.default_config().replace(train=train_j)
    model_j, variables = jcommon.restore_model(cfg_j, jb)
    z = np.random.default_rng(5).standard_normal(
        (3, O, cfg_j.model.latent_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        box_j, ang_j = model_j.apply(variables, jnp.asarray(z), jb, False,
                                     method=JVAE.decode)
    with torch.no_grad():
        box_t, ang_t = model_t.decode(torch.as_tensor(z), to_torch_batch(jb))
    assert not model_t.training
    m = np.asarray(jb.obj_mask)
    np.testing.assert_allclose(box_t.numpy()[m], np.asarray(box_j)[m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ang_t.numpy()[m], np.asarray(ang_j)[m],
                               rtol=1e-5, atol=1e-5)
