"""Port checkpoints (sln_tpu_torch.train.checkpoint, models.vae
params_to_jax) and the training entry point (python -m
sln_tpu_torch.train), against the JAX package on the CPU.

- A checkpoint the JAX trainer writes, optax state and all, restores in
  the port in a process where jax, jaxlib, optax and flax cannot be
  imported (the card's machine has none of them): the weights equal
  params_from_jax's bit for bit, the Adam state optax's.
- A checkpoint the port writes has the JAX package's schema: the trio
  appears, restore_model gives back the trained weights bit for bit, and
  the JAX model decodes with it as the port does (atol 1e-5).
- A step from a restored state is the step the in-memory state would have
  taken, bit for bit on the CPU.
"""

import os
import pickle
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
from sln_tpu.train import checkpoint as jckpt
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.data.augment import SizeInfo
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import params_from_jax, params_to_jax
from sln_tpu_torch.train import checkpoint as tckpt
from sln_tpu_torch.train import cli
from sln_tpu_torch.train import loop as tloop
from sln_tpu_torch.workloads import common

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O, B = 12, 8
NARROW = dict(embedding_dim=16, gconv_num_layers=2)


def t_(x):
    return torch.as_tensor(np.array(x))


def configs(tmp_path, **model):
    model = dict(NARROW, **model)
    data = dict(max_objects=O, max_triples=3 * O, max_on_rels=O)
    train = dict(batch_size=B, output_dir=str(tmp_path),
                 checkpoint_name="port")
    return (jcfg.default_config().replace(
                model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(**data),
                train=jcfg.TrainConfig(**train)),
            tcfg.default_config().replace(
                model=tcfg.ModelConfig(**model), data=tcfg.DataConfig(**data),
                train=tcfg.TrainConfig(**train)))


@pytest.fixture(scope="module")
def data():
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(16, seed=3), O)
    t, m, a = jsyn.default_size_table(64, seed=1)
    jsi = JSizeInfo(*(jnp.asarray(x) for x in (t, m, a)))
    tsi = SizeInfo(*(torch.as_tensor(x) for x in (t, m, a)))
    jb = j_build_graphs(jax.random.PRNGKey(0),
                        *(jnp.asarray(arrays[k][:B]) for k in
                          tloop.RawBatch._fields), jsi, max_on_rels=O)
    return arrays, tsi, jb


def jax_variables(cfg_j, jb, seed=0):
    """The JAX model's variable tree (its init, traced by jax.eval_shape)
    filled with seeded normal values: unlike init's zeros and ones, no two
    leaves of a shape hold the same values, so a swapped or transposed
    leaf shows."""
    jm = JVAE(cfg_j.model)
    shapes = jax.eval_shape(lambda k, b: jm.init(k, b, None, False),
                            jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg="/".join(k))


# ---------------------------------------------------------------------------
# a JAX-written checkpoint, read without JAX
# ---------------------------------------------------------------------------
def test_jax_checkpoint_restores_with_jax_blocked(tmp_path, data):
    _, _, jb = data
    cfg_j, cfg_t = configs(tmp_path)
    v = jax_variables(cfg_j, jb)
    tx = optax.adam(1e-4)

    @jax.jit
    def one_update(params):                    # count 1, moments set
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
        return tx.update(grads, tx.init(params), params)[1]

    opt = one_update(v["params"])
    jckpt.save_checkpoint(jckpt.new_checkpoint({}, {}), str(tmp_path),
                          "port", 5, 1, v, opt)

    out = tmp_path / "restored.pkl"
    code = (
        "import sys, pickle\n"
        "for m in ('jax', 'jaxlib', 'optax', 'flax'): sys.modules[m] = None\n"
        "from sln_tpu_torch import config\n"
        "from sln_tpu_torch.train import checkpoint\n"
        "from sln_tpu_torch.workloads import common\n"
        f"model = config.ModelConfig(embedding_dim=16, gconv_num_layers=2)\n"
        f"cfg = config.default_config().replace(model=model, train="
        f"config.TrainConfig(output_dir={str(tmp_path)!r}, "
        "checkpoint_name='port'))\n"
        "sd = common.restore_model(cfg, 'cpu').state_dict()\n"
        "ck = checkpoint.load_checkpoint(checkpoint.latest_path("
        "cfg.train.output_dir, 'port'))\n"
        f"with open({str(out)!r}, 'wb') as f:\n"
        "    pickle.dump(({k: v.numpy() for k, v in sd.items()}, "
        "ck['optim_state'], ck['counters']), f)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    with open(out, "rb") as f:
        sd, adam, counters = pickle.load(f)

    want = params_from_jax(jax.tree.map(np.asarray, v))
    assert set(sd) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(sd[k], w.numpy(), err_msg=k)
    assert counters == {"t": 5, "epoch": 1}
    assert adam["count"] == int(opt[0].count) == 1
    assert_trees_equal(adam["mu"], jax.tree.map(np.asarray, opt[0].mu))
    assert_trees_equal(adam["nu"], jax.tree.map(np.asarray, opt[0].nu))


# ---------------------------------------------------------------------------
# params_to_jax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["committed", "recurrent", "no_batch_norm"])
def test_params_to_jax_inverts_params_from_jax(shape, tmp_path, data):
    """Leaf for leaf and dtype for dtype: the committed checkpoint, and
    narrow JAX models with a shared gconv layer or without BatchNorm."""
    if shape == "committed":
        with open("artifacts/latest_bench_with_model.ckpt", "rb") as f:
            ms = pickle.load(f)["model_state"]
        model_cfg = tcfg.ModelConfig()
    else:
        extra = (dict(gconv_mode="recurrent") if shape == "recurrent"
                 else dict(mlp_normalization="none"))
        cfg_j, cfg_t = configs(tmp_path, **extra)
        ms = jax.tree.map(np.asarray, jax_variables(cfg_j, data[2]))
        ms.setdefault("batch_stats", {})
        model_cfg = cfg_t.model
    back = params_to_jax(params_from_jax(ms), model_cfg)
    assert_trees_equal(back["params"], ms["params"])
    assert_trees_equal(back["batch_stats"], ms["batch_stats"])


# ---------------------------------------------------------------------------
# a port-written checkpoint
# ---------------------------------------------------------------------------
def trained_state(cfg_t, arrays, tsi, steps=2):
    state = tloop.create_state(cfg_t, "cpu")
    step = tloop.make_train_step(state, cfg_t, tsi)
    staged = tloop.stage_arrays(arrays, "cpu")
    rng = np.random.default_rng(0)
    while state.step < steps:
        for idx in tloop.batch_indices(len(arrays["objs"]), B, rng):
            if state.step < steps:
                step(tloop.gather_batch(staged, idx))
    return state, step, staged


def save(state, cfg_t, t, snapshot=False):
    ckpt = tckpt.new_checkpoint({}, {})
    tckpt.record_losses(ckpt, t, {"total_loss": 1.0})
    return tckpt.save_checkpoint(
        ckpt, cfg_t.train.output_dir, "port", t, 1,
        tckpt.model_state_of(state.model, cfg_t.model),
        tckpt.adam_state_of(state.model, state.optimizer, cfg_t.model),
        snapshot=snapshot)


def test_port_checkpoint_trio_and_restore(tmp_path, data):
    arrays, tsi, jb = data
    cfg_j, cfg_t = configs(tmp_path)
    state, _, _ = trained_state(cfg_t, arrays, tsi)
    latest = save(state, cfg_t, 2000, snapshot=True)
    assert sorted(os.listdir(tmp_path)) == [
        "latest_port_with_model.ckpt", "port_no_model.ckpt",
        "portsnapshot_000002K.ckpt"]
    with open(tmp_path / "port_no_model.ckpt", "rb") as f:
        small = pickle.load(f)
    assert "model_state" not in small and "optim_state" not in small
    assert small["counters"] == {"t": 2000, "epoch": 1}
    # the JAX package's own loader reads it; optim_state is plain numpy
    ck = jckpt.load_checkpoint(latest)
    assert set(ck["optim_state"]) == {"count", "mu", "nu"}
    assert ck["optim_state"]["count"] == 2

    # restore_model gives back the trained weights; the JAX schema holds
    # no num_batches_tracked (it restores as 0)
    got = common.restore_model(cfg_t, "cpu").state_dict()
    want = state.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 0 and int(w) == 2
        else:
            assert torch.equal(got[k], w), k

    # the JAX model decodes with the port-written weights as the port does
    z = np.random.default_rng(1).standard_normal(
        (B, O, cfg_t.model.latent_dim)).astype(np.float32)
    jm = JVAE(cfg_j.model)
    want_j = jax.jit(lambda v, z, b: jm.apply(v, z, b, False,
                                              method=JVAE.decode))(
        ck["model_state"], jnp.asarray(z), jb)
    tb = SceneBatch(*(t_(x) for x in jb))._replace(
        **{k: t_(getattr(jb, k)).long() for k in
           ("objs", "angles", "attrs", "triples", "room_ids")})
    model = state.model.eval()
    with torch.no_grad():
        got_t = model.decode(t_(z), tb)
    m = np.asarray(jb.obj_mask)
    for a, b in zip(got_t, want_j):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], rtol=0,
                                   atol=1e-5)


def test_step_from_restored_state_is_bitwise_the_same(tmp_path, data):
    arrays, tsi, _ = data
    _, cfg_t = configs(tmp_path)
    state, step, staged = trained_state(cfg_t, arrays, tsi, steps=3)
    path = save(state, cfg_t, state.step)
    loaded = tckpt.load_checkpoint(path)
    restored = tloop.create_state(cfg_t, "cpu", loaded)
    assert restored.step == state.step == 3
    step_r = tloop.make_train_step(restored, cfg_t, tsi)
    raw = tloop.gather_batch(staged, np.arange(B))
    a, b = step(raw), step_r(raw)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for x, y in zip(state.state_tensors(), restored.state_tensors()):
        if x.dtype != torch.long:          # num_batches_tracked restarts
            assert torch.equal(x, y)
    # the state owns its tensors: its step left the loaded dict as it was
    again = tckpt.load_checkpoint(path)
    for key in ("mu", "nu"):
        assert_trees_equal(loaded["optim_state"][key],
                           again["optim_state"][key])
    assert_trees_equal(loaded["model_state"], again["model_state"])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
CLI = ["--synthetic", "32", "--batch_size", "8", "--print_every", "2",
       "--checkpoint_every", "3", "--snapshot_every", "6",
       "--embedding_dim", "16", "--gconv_num_layers", "2", "--device",
       "cpu"]


def test_train_cli_end_to_end_and_resume(tmp_path):
    out = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "sln_tpu_torch.train", *CLI,
         "--num_iterations", "6", "--output_dir", out], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    assert "On batch 6 out of 6" in run.stdout
    assert sorted(os.listdir(out)) == [
        "latest_checkpoint_no_model.ckpt",
        "latest_checkpointsnapshot_000000K.ckpt",
        "latest_latest_checkpoint_with_model.ckpt", "metrics.jsonl"]
    from sln_tpu_torch.train.metrics import read_metrics, summarize
    records = read_metrics(os.path.join(out, "metrics.jsonl"))
    assert [r["step"] for r in records] == [2, 4, 6]
    assert summarize(records, "total_loss")["count"] == 3

    # resume at t = 6 and go on to 8, in process
    state, ckpt = cli.main([*CLI, "--num_iterations", "8", "--output_dir",
                            out, "--restore_from_checkpoint", "1"])
    assert state.step == 8
    assert ckpt["losses_ts"] == [2, 4, 6, 8]
    assert ckpt["counters"]["t"] == 6           # saved at 3 and 6 only
    # what the trainer writes, the inference entry point restores
    cfg = cli.config_from_args(cli.parse_args([*CLI, "--output_dir", out]))
    restored = common.restore_model(cfg, "cpu")
    assert restored.cfg.embedding_dim == 16

    for flag in (["--compute_dtype", "bfloat16"],
                 ["--num_data_shards", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP item"):
            cli.main([*CLI, "--num_iterations", "1", "--output_dir",
                      str(tmp_path / "x"), *flag])
