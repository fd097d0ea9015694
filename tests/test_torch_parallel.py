"""Data-parallel training in the port (sln_tpu_torch.parallel, the train
step under a mesh, the epoch stream and the CLI under torchrun) against
the JAX package's mesh step on the 8-device CPU mesh that conftest forces
(tests/test_train.py:174). The serving paths are in
tests/test_torch_parallel_serving.py.

The port's ranks are processes: each check launches them through
tests/torch_dist_worker.py (gloo, a FileStore per launch), which imports
nothing of JAX; the JAX references run here while the ranks run.

Gates: losses rtol 1e-5 and parameters atol 2.5e-3 after two steps (the
bound of tests/test_train.py:191-200: Adam moves a parameter whose
gradient is near zero by ~lr whatever the gradient's sign), BatchNorm
running statistics within 1e-4 of their largest; every rank's parameters,
Adam state and BatchNorm buffers equal bit for bit; a world of 1 equal to
the plain step bit for bit; the 2-rank CLI's losses within 1e-4 of the
single-process CLI's.
"""

import functools
import os
import subprocess
import sys

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
from sln_tpu.parallel import mesh as jmesh
from sln_tpu.train import loop as jloop
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.parallel import mesh as tmesh
from sln_tpu_torch.train import cli, loop as tloop

from torch_dist_worker import REPO, launch

torch.set_num_threads(2)

O, B = 12, 8
NARROW = dict(embedding_dim=16, gconv_num_layers=2)
KEY = 7
STEPS = 2
# the DP train step's configurations by world size
TRAIN = {2: {"plain": {}, "free_bits": dict(kl_free_bits=0.05)},
         4: {"microbatch_free_bits": dict(microbatch=4, kl_free_bits=0.05)}}


def configs(**train):
    data = dict(max_objects=O, max_triples=3 * O, max_on_rels=O)
    train = dict(dict(batch_size=B), **train)
    return (jcfg.default_config().replace(
                model=jcfg.ModelConfig(**NARROW), data=jcfg.DataConfig(**data),
                train=jcfg.TrainConfig(**train)),
            tcfg.default_config().replace(
                model=tcfg.ModelConfig(**NARROW), data=tcfg.DataConfig(**data),
                train=tcfg.TrainConfig(**train)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_step_draws(step, k, latent):
    rng_step = jax.random.fold_in(jax.random.PRNGKey(KEY), step)
    keys = ([rng_step] if k == 1 else
            [jax.random.fold_in(rng_step, i) for i in range(k)])
    out = []
    for key in keys:
        rng_graph, rng_z = jax.random.split(key)
        k_partner, k_swap, k_a1, k_a2 = jax.random.split(rng_graph, 4)
        n = B // k
        out.append(((jax.random.gumbel(k_partner, (n, O, O)),
                     jax.random.bernoulli(k_swap, 0.5, (n, O)),
                     jax.random.uniform(k_a1, (n, O)),
                     jax.random.uniform(k_a2, (n, O))),
                    jax.random.normal(rng_z, (n, O, latent))))
    return out


def jax_step_draws(step, k, latent):
    """(graph draws, z noise) per global chunk as numpy, as the JAX step
    draws them at `step` from PRNGKey(KEY) (loop.py:146-147, :158-159)."""
    return [(tuple(np.array(x) for x in graph), np.array(z))
            for graph, z in _jax_step_draws(step, k, latent)]


@pytest.fixture(scope="module")
def setup():
    """24 synthetic rooms, the size table, a JAX-initialised narrow model's
    variables and the first batch."""
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(24, seed=3), O)
    table = jsyn.default_size_table(64, seed=1)
    jsi = JSizeInfo(*(jnp.asarray(x) for x in table))
    raw = jloop.RawBatch(*(arrays[k][:B] for k in tloop.RawBatch._fields))
    example = j_build_graphs(jax.random.PRNGKey(0),
                             *(jnp.asarray(x) for x in raw), jsi,
                             max_on_rels=O)
    cfg_j, _ = configs()
    jm = JVAE(cfg_j.model)
    variables = jax.jit(lambda key, b: jm.init(key, b, None, False))(
        jax.random.PRNGKey(0), example)
    return arrays, table, jsi, raw, variables


def plain(tree):
    """A tree of nested dicts of numpy arrays (no flax or JAX types, which
    the ranks cannot unpickle)."""
    if hasattr(tree, "items"):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def train_job(setup, **train):
    _, table, _, raw, variables = setup
    _, cfg_t = configs(**train)
    mb = train.get("microbatch", 0)
    k = B // mb if mb else 1
    return {"kind": "train", "cfg": cfg_t, "size_table": table,
            "raw": raw._asdict(), "steps": STEPS,
            "draws": [jax_step_draws(s, k, cfg_t.model.latent_dim)
                      for s in range(STEPS)],
            "restored": {"model_state": plain(variables),
                         "optim_state": None, "counters": {"t": 0}}}


def jax_dp_steps(setup, world, **train):
    """STEPS of the JAX package's step on make_mesh(num_data=world):
    (loss dicts, final TrainState)."""
    _, _, jsi, raw, variables = setup
    cfg_j, _ = configs(**train)
    tx = optax.adam(cfg_j.train.learning_rate)
    state = jloop.TrainState(variables["params"], variables["batch_stats"],
                             tx.init(variables["params"]), jnp.int32(0))
    step = jloop.make_train_step(JVAE(cfg_j.model), tx, cfg_j, jsi)
    mesh = jmesh.make_mesh(num_data=world)
    state = jmesh.replicate(jax.tree.map(jnp.copy, state), mesh)
    raw_s = jmesh.shard_batch(jax.tree.map(jnp.asarray, raw), mesh)
    losses = []
    for _ in range(STEPS):
        state, ls = step(state, raw_s, jax.random.PRNGKey(KEY))
        losses.append(jax.tree.map(np.asarray, ls))
    return losses, state


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The DP train step's configurations on 2 and 4 ranks, and a world of 1
    against the plain step; the JAX package's mesh steps computed while
    the ranks run."""
    tmp = tmp_path_factory.mktemp("dp")
    jobs = {w: {"device": "cpu", "tasks": {
        name: train_job(setup, **train) for name, train in cases.items()}}
        for w, cases in TRAIN.items()}
    jobs[1] = {"device": "cpu", "tasks": {
        "free_bits": dict(train_job(setup, kl_free_bits=0.05),
                          plain_too=True)}}
    waits = {w: launch(w, job, tmp / f"world{w}") for w, job in jobs.items()}
    want = {w: {name: jax_dp_steps(setup, w, **train)
                for name, train in cases.items()}
            for w, cases in TRAIN.items()}
    return {w: wait() for w, wait in waits.items()}, want


# ---------------------------------------------------------------------------
# the DP train step
# ---------------------------------------------------------------------------
def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


TRAIN_CASES = [(w, name) for w, cases in TRAIN.items() for name in cases]


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_dp_train_step_matches_jax_mesh(runs, world, name):
    got, want = runs
    losses_j, state_j = want[world][name]
    out = got[world][0][name]["mesh"]
    for s in range(STEPS):
        assert set(out["losses"][s]) == set(losses_j[s])
        for k, v in losses_j[s].items():
            np.testing.assert_allclose(float(out["losses"][s][k]), float(v),
                                       rtol=1e-5, err_msg=f"step {s} {k}")
    for path, v in jax.tree_util.tree_flatten_with_path(state_j.params)[0]:
        np.testing.assert_allclose(
            _leaf(out["model_state"]["params"], [p.key for p in path]),
            np.asarray(v), rtol=0, atol=2.5e-3, err_msg=str(path))
    # running statistics of the global batch, not of a rank's rows (those
    # would differ by the rows' spread, ~1e-1 of the largest); 1e-4 of the
    # largest, since the second step's statistics come from parameters
    # that agree only to the first Adam step's sign flips
    for path, v in jax.tree_util.tree_flatten_with_path(
            state_j.batch_stats)[0]:
        v = np.asarray(v)
        np.testing.assert_allclose(
            _leaf(out["model_state"]["batch_stats"], [p.key for p in path]),
            v, rtol=0, atol=1e-4 * np.abs(v).max(), err_msg=str(path))
    assert out["adam"]["count"] == STEPS


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_dp_replicas_stay_bit_identical(runs, world, name):
    """Every rank's parameters, Adam state and BatchNorm buffers, and the
    losses it returns, are rank 0's bits."""
    ranks = [r[name]["mesh"] for r in runs[0][world]]
    first = ranks[0]
    assert len(first["state"]) > len(first["names"])
    for other in ranks[1:]:
        for a, b in zip(first["state"], other["state"]):
            assert torch.equal(a, b)
        for la, lb in zip(first["losses"], other["losses"]):
            assert all(torch.equal(la[k], lb[k]) for k in la)


def test_world_of_one_gives_the_plain_step_bits(runs):
    """A process group of one rank (gloo): the collectives are identities
    and the step is the plain step, bit for bit."""
    out = runs[0][1][0]["free_bits"]
    assert runs[0][1][0]["backend"] == "gloo"
    for key in ("state", "grads"):
        for a, b in zip(out["mesh"][key], out["plain"][key]):
            assert torch.equal(a, b), key
    for la, lb in zip(out["mesh"]["losses"], out["plain"]["losses"]):
        assert all(torch.equal(la[k], lb[k]) for k in la)


# ---------------------------------------------------------------------------
# the epoch stream
# ---------------------------------------------------------------------------
def test_host_sharded_batches_match_jax(setup):
    """Two ranks' shards concatenate to the JAX package's global stream;
    under microbatching each rank takes its share of every chunk, and the
    shards together are each batch's rows; an indivisible batch raises."""
    arrays = setup[0]
    want = list(jloop.batches_from_arrays(arrays, 8,
                                          np.random.default_rng(7)))
    jshards = [list(jloop.host_sharded_batches(
        arrays, 8, np.random.default_rng(7), process_index=i,
        process_count=2)) for i in range(2)]
    shards = [list(tloop.host_sharded_batches(
        arrays, 8, np.random.default_rng(7), i, 2)) for i in range(2)]
    assert len(shards[0]) == len(want) == 3
    for w, a, b, ja, jb in zip(want, *shards, *jshards):
        for f in tloop.RawBatch._fields:
            got = np.concatenate([getattr(a, f), getattr(b, f)])
            np.testing.assert_array_equal(got, np.asarray(getattr(w, f)))
            np.testing.assert_array_equal(getattr(a, f), getattr(ja, f))
            np.testing.assert_array_equal(getattr(b, f), getattr(jb, f))

    rows = [tloop.shard_rows(8, 4, r, 2) for r in range(2)]
    np.testing.assert_array_equal(rows[0], [0, 1, 4, 5])
    np.testing.assert_array_equal(rows[1], [2, 3, 6, 7])
    mb = [list(tloop.host_sharded_batches(arrays, 8,
                                          np.random.default_rng(7), r, 2,
                                          microbatch=4)) for r in range(2)]
    for w, a, b in zip(want, *mb):
        np.testing.assert_array_equal(a.objs, np.asarray(w.objs)[rows[0]])
        np.testing.assert_array_equal(b.objs, np.asarray(w.objs)[rows[1]])
    for bad in ((9, 0), (8, 3), (8, 2 * 3)):
        with pytest.raises(ValueError):
            next(tloop.host_sharded_batches(arrays, bad[0],
                                            np.random.default_rng(0), 0, 4,
                                            microbatch=bad[1]))


def test_mesh_helpers_without_a_launcher():
    """No launcher: a world of 1, no process group, and the helpers are
    identities; rows() splits evenly or raises."""
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.distributed) == (0, 1, False)
    x = torch.arange(12.0).reshape(6, 2)
    assert tmesh.shard_batch({"x": x}, mesh)["x"] is x
    assert tmesh.global_from_host_shards(x, mesh) is x
    assert tmesh.all_reduce_sum_grad(x, mesh) is x
    two = tmesh.Mesh(1, 2, torch.device("cpu"))
    assert two.rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="split"):
        two.rows(5)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--synthetic", "32", "--batch_size", "8", "--print_every", "2",
       "--checkpoint_every", "3", "--snapshot_every", "6",
       "--embedding_dim", "16", "--gconv_num_layers", "2", "--device", "cpu"]


def test_cli_refuses_a_shard_count_that_is_not_the_world(monkeypatch,
                                                         tmp_path):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="nproc_per_node 2"):
        cli.main([*CLI, "--num_iterations", "1", "--output_dir",
                  str(tmp_path), "--num_data_shards", "2"])
    # under a launcher of 2 ranks, 4 shards: refused before any group
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="launcher started 2"):
        tmesh.make_mesh(4, device="cpu")
    assert not torch.distributed.is_initialized()
    assert not os.listdir(tmp_path)


def _torchrun(nproc, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "-m", "sln_tpu_torch.train",
         *CLI, "--num_data_shards", str(nproc), *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return run.stdout


def test_cli_trains_on_two_ranks_and_resumes(tmp_path):
    """torchrun with 2 CPU ranks: rank 0 alone prints and writes the
    checkpoint trio and metrics.jsonl; the losses are the single-process
    run's; --restore_from_checkpoint 1 resumes on 2 ranks."""
    from sln_tpu_torch.train.checkpoint import latest_path, load_checkpoint
    from sln_tpu_torch.train.metrics import read_metrics

    out = str(tmp_path / "dp")
    log = _torchrun(2, ["--num_iterations", "6", "--output_dir", out],
                    tmp_path)
    assert log.count("On batch 6 out of 6") == 1
    assert "backend gloo" in log
    assert sorted(os.listdir(out)) == [
        "latest_checkpoint_no_model.ckpt",
        "latest_checkpointsnapshot_000000K.ckpt",
        "latest_latest_checkpoint_with_model.ckpt", "metrics.jsonl"]
    dp = read_metrics(os.path.join(out, "metrics.jsonl"))
    assert [r["step"] for r in dp] == [2, 4, 6]

    # the same run in one process
    ref_dir = str(tmp_path / "one")
    _, ckpt = cli.main([*CLI, "--num_iterations", "6", "--output_dir",
                        ref_dir])
    one = read_metrics(os.path.join(ref_dir, "metrics.jsonl"))
    for a, b in zip(dp, one):
        for k in ("total_loss", "bbox_pred", "angle_pred", "KLD_raw"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)

    log = _torchrun(2, ["--num_iterations", "9", "--output_dir", out,
                        "--restore_from_checkpoint", "1"], tmp_path)
    assert "Restoring from checkpoint" in log
    assert log.count("On batch 8 out of 9") == 1
    resumed = load_checkpoint(latest_path(out, "latest_checkpoint"))
    assert resumed["losses_ts"] == [2, 4, 6, 8]
    assert resumed["counters"]["t"] == 9
