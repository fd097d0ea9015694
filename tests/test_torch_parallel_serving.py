"""The port's sharded serving paths (make_sampler, the Refiner through
shard_refine_inputs, colorize, each under a mesh) against the JAX
package's mesh paths on the 8-device CPU mesh that conftest forces
(tests/test_workloads.py:142, tests/test_refine_mesh.py,
tests/test_gan_shade.py:197), at those tests' small sizes.

The port's ranks are processes launched through tests/torch_dist_worker.py
(gloo, a FileStore per launch), which imports nothing of JAX; the JAX
references run here while the ranks run.

Gates, the single-device port-against-JAX tests' own: the sampler's boxes
atol 1e-4 and its angle bins equal (tests/test_torch_sampling.py); the
refine's losses rtol 1e-3 and z - z0 within 2e-3 of its largest move
(tests/test_torch_refine.py); colorize's images within 1e-5, and 1 level
in uint8 (tests/test_torch_gan_shade.py). Every rank returns the same
all-gathered outputs, and the refine's decoder parameters stay the same
bits on every rank.
"""

import dataclasses
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
from sln_tpu.parallel import mesh as jmesh
from sln_tpu.render import assets as jassets, scene as jscene
from sln_tpu.spade.generator import SPADEGenerator4 as JGen
from sln_tpu.workloads import gan_shade as jg, heatmap as jheat
from sln_tpu.workloads import refine as jref
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.models.vae import params_from_jax

from torch_dist_worker import launch

torch.set_num_threads(2)

NARROW = dict(embedding_dim=16, gconv_num_layers=2)
# the sampler: 16 copies of the heat map's graph, 8 object slots
S_BATCH = (16, 8, 24)
# the refine slice of tests/test_torch_refine.py, 4 rooms on 2 ranks
R_ROOMS, R_O, R_STEPS, R_SIZES, R_LR_Z = 4, 8, 4, (16, 24, 32), 2e-2
# colorize: a small generator, 7 z in chunks of 3 on 4 ranks (each chunk
# padded to 4, as the JAX package's rounding case)
NGF, NZ, CROP, NUM_Z, Z_CHUNK = 8, 16, 64, 7, 3


def plain(tree):
    """A tree of nested dicts of numpy arrays (no flax or JAX types, which
    the ranks cannot unpickle)."""
    if hasattr(tree, "items"):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def refine_configs():
    cfg_j = jcfg.default_config().replace(
        model=jcfg.ModelConfig(**NARROW),
        data=jcfg.DataConfig(max_objects=R_O, max_triples=3 * R_O,
                             max_on_rels=R_O),
        render=jcfg.RenderConfig(camera=jcfg.CameraConfig(image_size=32),
                                 mesh_subdiv=1, shell_subdiv=2,
                                 backend="jax"),
        refine=dataclasses.replace(
            jcfg.default_config().refine, render_size=32,
            pyramid_sizes=R_SIZES, angle_noise_scale=0.0, lr_z=R_LR_Z))
    cfg_t = tcfg.default_config().replace(
        model=tcfg.ModelConfig(**NARROW),
        data=tcfg.DataConfig(max_objects=R_O, max_on_rels=R_O),
        render=tcfg.RenderConfig(camera=tcfg.CameraConfig(image_size=32),
                                 mesh_subdiv=1, shell_subdiv=2),
        refine=dataclasses.replace(
            tcfg.default_config().refine, render_size=32,
            pyramid_sizes=R_SIZES, angle_noise_scale=0.0, lr_z=R_LR_Z))
    return cfg_j, cfg_t


def model_inputs():
    """The refine's graph batch, and a JAX-initialised narrow model with
    BatchNorm running statistics away from 0 / 1 (eval mode normalizes for
    real) and its box head scaled so that boxes decode near mid-room, where
    the render carries gradient (as tests/test_torch_refine.py does)."""
    cfg_j, _ = refine_configs()
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(R_ROOMS, seed=3), R_O)
    table = jsyn.default_size_table(64, seed=1)
    jb = j_build_graphs(jax.random.PRNGKey(0),
                        *(jnp.asarray(arrays[k]) for k in
                          ("objs", "boxes", "angles", "obj_mask",
                           "room_ids")),
                        JSizeInfo(*(jnp.asarray(x) for x in table)),
                        max_on_rels=R_O)
    jm = JVAE(cfg_j.model)
    v = jax.jit(lambda key, b: jm.init(key, b, None, False))(
        jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(0)

    def stats(path, x):
        if path[-1].key == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(x.shape),
                               jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
    head = dict(v["params"]["box_net"]["dense_1"])
    head["kernel"] = head["kernel"] * 0.05
    head["bias"] = jnp.asarray([0.25, 0.0, 0.3, 0.55, 0.4, 0.6], jnp.float32)
    params = {**v["params"], "box_net": {**v["params"]["box_net"],
                                         "dense_1": head}}
    return jb, {"params": params, "batch_stats":
                jax.tree_util.tree_map_with_path(stats, v["batch_stats"])}


def sampler_case(v):
    _, cfg_t = refine_configs()
    d = cfg_t.model.latent_dim
    rng = np.random.default_rng(9)
    a = rng.standard_normal((d, d)) * 0.3
    mean, cov = rng.standard_normal(d) * 0.1, a @ a.T + 0.1 * np.eye(d)
    key = jax.random.PRNGKey(3)
    job = {"kind": "sampler", "model_cfg": cfg_t.model,
           "state_dict": params_from_jax(plain(v)), "batch": S_BATCH,
           "mean": mean, "cov": cov,
           "eps": np.array(jax.random.normal(key, S_BATCH[:2] + (d,),
                                             jnp.float32))}

    def reference():
        cfg_j, _ = refine_configs()
        out = jheat.make_sampler(JVAE(cfg_j.model), v,
                                 jheat.heatmap_scene_batch(*S_BATCH), mean,
                                 cov, mesh=jmesh.make_mesh(num_data=2))(key)
        return [np.asarray(x) for x in out]
    return job, reference


def refine_case(jb, v):
    cfg_j, cfg_t = refine_configs()
    z0 = (0.5 * np.random.default_rng(0).standard_normal(
        (R_ROOMS, R_O, cfg_j.model.latent_dim))).astype(np.float32)
    batch = [torch.as_tensor(np.array(x)) for x in jb]
    batch = [x.long() if x.dtype == torch.int32 else x for x in batch]
    job = {"kind": "refine", "cfg": cfg_t, "model_cfg": cfg_t.model,
           "state_dict": params_from_jax(plain(v)), "batch": batch,
           "z0": z0, "steps": R_STEPS}

    def reference():
        """4 steps of the JAX package's refine on a 2-device mesh
        (shard_refine_inputs, as tests/test_refine_mesh.py)."""
        bank_host = jassets.build_procedural_bank(1)
        bank = jscene.device_bank(bank_host, 2)
        rcfg = dataclasses.replace(cfg_j.render, camera=dataclasses.replace(
            cfg_j.render.camera, image_size=32))
        midx, target, size_t, room_row = jref.prepare_refine_inputs(
            jb, bank_host, bank, rcfg)
        (jb_s, midx_s, target_s, size_s, row_s, z0_s,
         params_s) = jref.shard_refine_inputs(
            jmesh.make_mesh(num_data=2), jb, midx, target, size_t, room_row,
            jnp.asarray(z0), v["params"])
        tx, _, _, run_scan = jref.make_refine_step(
            JVAE(cfg_j.model), v["batch_stats"], jb_s, midx_s, bank,
            target_s, size_s, row_s, cfg_j)
        state = jref.RefineState(z0_s, params_s, tx.init((z0_s, params_s)),
                                 jnp.zeros((), jnp.int32))
        state, aux = run_scan(state, jax.random.split(jax.random.PRNGKey(0),
                                                      R_STEPS))
        return ({k: np.asarray(x) for k, x in aux.items()},
                np.asarray(state.z), z0)
    return job, reference


def colorize_case(tmp_path):
    """A small generator (seeded normal weights, in the shading trainer's
    pickle format), a segmentation map and JAX's z draws."""
    jm = JGen(ngf=NGF, nz=NZ, crop_size=CROP)
    shapes = jax.eval_shape(lambda s, z: jm.init(jax.random.PRNGKey(0), s,
                                                 z),
                            jnp.zeros((1, CROP, CROP, 41)),
                            jnp.zeros((1, NZ)))["params"]
    rng = np.random.default_rng(0)

    def fill(x):
        if len(x.shape) == 1:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float16)
        return (rng.standard_normal(x.shape) / np.sqrt(
            int(np.prod(x.shape[:-1])))).astype(np.float16)
    p16 = jax.tree.map(fill, shapes)
    path = tmp_path / "small.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"g_params": p16,
                     "config": {"ngf": NGF, "nz": NZ, "crop": CROP}}, f)
    seg = np.zeros((CROP, CROP, 41), np.float32)
    seg[..., 0] = rng.uniform(-1, 1, (CROP, CROP))
    np.put_along_axis(seg, rng.integers(1, 41, (CROP, CROP, 1)), 1.0, -1)
    n_chunks = -(-NUM_Z // Z_CHUNK)
    zs = np.array(jg._draw_zs(jax.random.PRNGKey(0), n_chunks, Z_CHUNK,
                              Z_CHUNK, NZ))
    job = {"kind": "colorize", "checkpoint": str(path),
           "seg": np.ascontiguousarray(np.moveaxis(seg, -1, 0)), "zs": zs,
           "num_z": NUM_Z}

    def reference():
        p32 = jax.tree.map(lambda a: a.astype(np.float32), p16)
        mesh = jmesh.make_mesh(num_data=4)
        return {dtype: jg.colorize(jm, p32, seg, num_z=NUM_Z,
                                   z_chunk=Z_CHUNK, mesh=mesh,
                                   out_dtype=dtype)
                for dtype in ("float32", "uint8")}
    return job, reference


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sampler and the refine on 2 ranks, colorize on 4; the JAX
    references computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("dp_serving")
    jb, v = model_inputs()
    (s_job, s_ref), (r_job, r_ref), (c_job, c_ref) = (
        sampler_case(v), refine_case(jb, v), colorize_case(tmp))
    waits = {2: launch(2, {"device": "cpu", "tasks": {
                 "sampler": s_job, "refine": r_job}}, tmp / "world2"),
             4: launch(4, {"device": "cpu", "tasks": {"colorize": c_job}},
                       tmp / "world4")}
    want = {"sampler": s_ref(), "refine": r_ref(), "colorize": c_ref()}
    return {w: wait() for w, wait in waits.items()}, want


def test_sharded_sampler_matches_jax_mesh(runs):
    got, want = runs
    box_j, ang_j = want["sampler"]
    m = np.asarray(jheat.heatmap_scene_batch(*S_BATCH).obj_mask)
    for rank in got[2]:
        out = rank["sampler"]
        assert out["boxes"].shape == box_j.shape
        np.testing.assert_allclose(out["boxes"].numpy()[m], box_j[m],
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(out["angles"].numpy()[m], ang_j[m])


def test_sharded_refine_matches_jax_mesh(runs):
    """4 rooms on 2 ranks, 4 steps: the global losses, every room's z, and
    the decoder's parameters the same bits on both ranks."""
    got, want = runs
    aux_j, z_j, z0 = want["refine"]
    ranks = [r["refine"] for r in got[2]]
    dz_j = z_j - z0
    assert np.abs(dz_j).max() > 1e-3
    for out in ranks:
        for k in ("total", "depth_loss", "semantic_loss"):
            np.testing.assert_allclose(out["hist"][k].numpy(), aux_j[k],
                                       rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(out["z"].numpy() - z0, dz_j, rtol=0,
                                   atol=2e-3 * np.abs(dz_j).max())
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        assert torch.equal(a, b)


def test_sharded_colorize_matches_jax_mesh(runs):
    """7 z in chunks of 3 on 4 ranks: each chunk padded to 4 and the pad
    rows dropped, as the JAX package's mesh path does."""
    got, want = runs
    want = want["colorize"]
    for rank in got[4]:
        out = rank["colorize"]
        assert out["float32"].shape == want["float32"].shape == (
            NUM_Z, CROP, CROP, 3)
        np.testing.assert_allclose(out["float32"], want["float32"],
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(out["uint8"].astype(int)
                      - want["uint8"].astype(int)).max() <= 1
