"""Tensor parallelism and the multi-slice mesh in the port
(sln_tpu_torch.parallel.sharding, the model axis of parallel/mesh.py, the
Megatron MLP of models/layers.py, the train step under a dp x tp mesh, the
dry run) against the JAX package: its partition_specs, and its step on a
2 x 2 mesh with shard_params on the 8-device CPU mesh that conftest forces
(tests/test_train.py:203-243).

One launch of 4 gloo ranks (tests/torch_dist_worker.py, which imports
nothing of JAX) runs as two nodes of two ranks, the environment torchrun
gives ranks on two nodes: the dp x tp mesh (make_mesh(2, 2)) and the
multi-slice mesh 2 x 1 x 2, whose slices are those two nodes (a real slice
boundary, not a simulated one). The dry run runs beside it on 4 ranks
under torch.distributed.run; the JAX references run here meanwhile.

Gates: losses rtol 1e-5 and parameters atol 2.5e-3 after two steps (the
DP tests' and tests/test_train.py:191-200's bound: Adam moves a parameter
whose gradient is near zero by ~lr whatever the gradient's sign);
BatchNorm running statistics within 1e-4 of their largest; every rank of a
data group the same bits in its shards, every rank of a model group the
same bits in the replicated tensors; shard_params then gather_params the
same bits; the TP MLP against the plain one within 1e-5 of each output's
and gradient's largest (the row-parallel sum adds its partial products in
another order), or of a tenth of the MLP's largest gradient for a bias
whose gradient is rounding noise around 0.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.parallel import mesh as jmesh
from sln_tpu.parallel import sharding as jshard
from sln_tpu.train import loop as jloop
from sln_tpu_torch.models.layers import MLP
from sln_tpu_torch.models.vae import Sg2ScVAE, jax_path
from sln_tpu_torch.parallel import mesh as tmesh
from sln_tpu_torch.parallel.sharding import partition_specs

from test_torch_parallel import (KEY, STEPS, _leaf, configs, jax_step_draws,
                                 plain, setup)  # noqa: F401
from torch_dist_worker import REPO, launch

torch.set_num_threads(2)

WORLD = 4
MESHES = {"dp_tp": ("mesh", 2, 2), "multislice": ("multislice", 2, 1, 2)}
# (dims, batch_norm, final_plain): a gconv-style MLP with BatchNorm, a
# one-stage head (its output all-gathered), a two-stage head without
MLPS = [((8, 16, 6), "batch", False), ((8, 4), "batch", True),
        ((8, 16, 6), "none", True)]
ROWS = 12


def mlp_job():
    rng = np.random.default_rng(0)
    mlps = []
    for dims, bn, final_plain in MLPS:
        torch.manual_seed(len(mlps))
        mlps.append((dims, bn, final_plain, MLP(dims, bn, final_plain)
                     .state_dict()))
    x = rng.standard_normal((ROWS, 8)).astype(np.float32)
    mask = rng.random(ROWS) < 0.8
    w = [rng.standard_normal((ROWS, d[-1])).astype(np.float32)
         for d, _, _ in MLPS]
    return {"kind": "tp_mlp", "mesh": MESHES["dp_tp"], "device": "cpu",
            "mlps": mlps, "x": x, "mask": mask, "w": w}


def train_job(setup, mesh):
    _, table, _, raw, variables = setup
    _, cfg_t = configs()
    return {"kind": "tp_train", "mesh": mesh, "device": "cpu",
            "cfg": cfg_t, "size_table": table, "raw": raw._asdict(),
            "steps": STEPS,
            "draws": [jax_step_draws(s, 1, cfg_t.model.latent_dim)
                      for s in range(STEPS)],
            "restored": {"model_state": plain(variables),
                         "optim_state": None, "counters": {"t": 0}}}


def jax_tp_steps(setup, mesh):
    """STEPS of the JAX package's step on `mesh` with its state placed by
    shard_params (tests/test_train.py:203-243)."""
    _, _, jsi, raw, variables = setup
    cfg_j, _ = configs()
    tx = optax.adam(cfg_j.train.learning_rate)
    state = jloop.TrainState(
        params=jshard.shard_params(jax.tree.map(jnp.copy,
                                                variables["params"]), mesh),
        batch_stats=jshard.shard_params(
            jax.tree.map(jnp.copy, variables["batch_stats"]), mesh),
        opt_state=jshard.shard_params(tx.init(variables["params"]), mesh),
        step=jax.device_put(jnp.int32(0), jmesh.replicated(mesh)))
    step = jloop.make_train_step(JVAE(cfg_j.model), tx, cfg_j, jsi)
    raw_s = jmesh.shard_batch(jax.tree.map(jnp.asarray, raw), mesh)
    losses = []
    for _ in range(STEPS):
        state, ls = step(state, raw_s, jax.random.PRNGKey(KEY))
        losses.append(jax.tree.map(np.asarray, ls))
    return losses, state


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The 4 ranks' results, the JAX package's steps on its 2 x 2 mesh, the
    dry run's exit code and log, and the TP MLP job."""
    tmp = tmp_path_factory.mktemp("tp")
    job = {"device": "cpu", "tasks": {
        "mlp": mlp_job(), **{name: train_job(setup, m)
                             for name, m in MESHES.items()}}}
    wait = launch(WORLD, job, tmp / "ranks", nodes=2)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    dry = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", "sln_tpu_torch.dryrun",
         "--device", "cpu"], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    want = jax_tp_steps(setup, jmesh.make_mesh(
        num_data=2, num_model=2, devices=jax.devices()[:WORLD]))
    try:
        log = dry.communicate(timeout=300)[0]
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    return wait(), want, (dry.returncode, log), job["tasks"]["mlp"]


# ---------------------------------------------------------------------------
# partition_specs and the mesh layout (no ranks)
# ---------------------------------------------------------------------------
def test_partition_specs_match_jax(setup):
    """Leaf by leaf through the port's name map (jax_path): the dimension
    JAX splits over 'model', transposed for Dense kernels."""
    variables = setup[4]
    _, cfg_t = configs()
    want = {c: jshard.partition_specs(variables[c])
            for c in ("params", "batch_stats")}
    with torch.device("meta"):
        specs = partition_specs(Sg2ScVAE(cfg_t.model))
    split = 0
    for name, dim in specs.items():
        where = jax_path(name, cfg_t.model)
        if where is None:           # num_batches_tracked
            assert dim is None, name
            continue
        collection, path, transpose = where
        spec = tuple(_leaf(want[collection], path))
        jdim = spec.index(jmesh.MODEL_AXIS) if jmesh.MODEL_AXIS in spec \
            else None
        if jdim is not None and transpose:
            jdim = 1 - jdim
        assert dim == jdim, (name, spec)
        split += dim is not None
    # every MLP's first Linear (weight, bias), its BatchNorm (4) and the
    # second Linear's weight, where there is one
    assert split > 50


@pytest.mark.parametrize("args,match", [
    ((4, 1, 2, [0] * 4 + [1] * 4), "span only"),
    ((2, 1, 2, [0, 0, 1, 1, None, None, None, None]), "mix"),
    ((2, 2, 2, [0, 0, 0, 1, 1, 1, 1, 1]), "unequal"),
    ((2, 2, 2, [0, 0, 1, 1, 2, 2, 3, 3]), "straddle"),
    ((2, 4, 2, [0] * 8), "> 8 ranks"),
    ((1, 2, 2, [0] * 4 + [1] * 4), "places 4 of 8"),
])
def test_multislice_layout_refuses_what_does_not_fit(args, match):
    """The refusals of tests/test_train.py:245-277 (more slices than the
    ranks' nodes, node-indexed and nodeless ranks mixed) and the port's
    own: nodes of unequal size, a slice larger than a node, a mesh larger
    than the world or smaller than it."""
    with pytest.raises(ValueError, match=match):
        tmesh.multislice_layout(*args)


def test_multislice_layout_places_slices_on_nodes():
    """A slice is one node's ranks; model innermost; on one node (or none
    named) contiguous ranks simulate the slices."""
    grid = tmesh.multislice_layout(2, 2, 2, [1] * 4 + [0] * 4)
    np.testing.assert_array_equal(grid[0].reshape(-1), [4, 5, 6, 7])
    np.testing.assert_array_equal(grid[1].reshape(-1), [0, 1, 2, 3])
    for nodes in ([0] * 8, [None] * 8):
        np.testing.assert_array_equal(
            tmesh.multislice_layout(2, None, 2, nodes).reshape(-1),
            np.arange(8))
    mesh = tmesh.make_mesh(device="cpu")
    assert tmesh.data_axes(mesh) == ("data",)
    assert (mesh.data_size, mesh.data_index, mesh.num_model) == (1, 0, 1)


# ---------------------------------------------------------------------------
# on 4 ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(MLPS)))
def test_tp_mlp_matches_the_plain_mlp(runs, i):
    """Each model group of the 2 x 2 mesh runs the MLP tensor-parallel on
    its data rows: its outputs, its input's gradient, and the parameters'
    gradients (summed over the data group) are the plain MLP's on all rows,
    forward and backward."""
    ranks, *_, job = runs
    dims, bn, final_plain, sd = job["mlps"][i]
    mlp = MLP(dims, bn, final_plain)
    mlp.load_state_dict(sd)
    x = torch.as_tensor(job["x"]).requires_grad_(True)
    y = mlp.train()(x, torch.as_tensor(job["mask"]))
    (y * torch.as_tensor(job["w"][i])).sum().backward()
    # a Linear's bias before a train-mode BatchNorm has a zero gradient in
    # exact arithmetic: rounding noise on both sides, held to 1e-6 of the
    # largest gradient
    top = max(float(p.grad.abs().max()) for p in mlp.parameters())
    half = ROWS // 2
    for r, out in enumerate(ranks):
        got = out["mlp"][i]
        rows = slice(r // 2 * half, (r // 2 + 1) * half)
        for a, b in ((got["y"], y.detach()[rows]),
                     (got["x_grad"], x.grad[rows])):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * b.abs().max())
        for name, p in mlp.named_parameters():
            scale = max(float(p.grad.abs().max()), 0.1 * top)
            np.testing.assert_allclose(
                got["grads"][name], p.grad, rtol=0,
                atol=1e-5 * scale, err_msg=name)
        for name, t in mlp.state_dict().items():
            if name.endswith("running_mean") or name.endswith("running_var"):
                np.testing.assert_allclose(got["state"][name], t, rtol=0,
                                           atol=1e-5 * t.abs().max())


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_step_matches_jax(runs, name):
    """Two steps on the dp x tp mesh, and on the multi-slice mesh over two
    nodes, against the JAX package's step on its 2 x 2 mesh (its 2 x 1 x 2
    multi-slice mesh places the same shards on 4 devices, and
    tests/test_train.py:203 holds that one to the single device's step)."""
    ranks, (losses_j, state_j), *_ = runs
    out = ranks[0][name]
    for s in range(STEPS):
        assert set(out["losses"][s]) == set(losses_j[s])
        for k, v in losses_j[s].items():
            np.testing.assert_allclose(float(out["losses"][s][k]), float(v),
                                       rtol=1e-5, err_msg=f"step {s} {k}")
    for path, v in jax.tree_util.tree_flatten_with_path(state_j.params)[0]:
        np.testing.assert_allclose(
            _leaf(out["model_state"]["params"], [p.key for p in path]),
            np.asarray(v), rtol=0, atol=2.5e-3, err_msg=str(path))
    for path, v in jax.tree_util.tree_flatten_with_path(
            state_j.batch_stats)[0]:
        v = np.asarray(v)
        np.testing.assert_allclose(
            _leaf(out["model_state"]["batch_stats"], [p.key for p in path]),
            v, rtol=0, atol=1e-4 * np.abs(v).max(), err_msg=str(path))


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_replicas_and_shards_keep_their_bits(runs, name):
    """shard_params then gather_params gives the weights back bit for bit;
    after the steps the ranks of a data group hold the same bits in their
    shards (parameters, BatchNorm buffers, Adam state), the ranks of a
    model group the same bits in every replicated tensor, and every rank
    the same losses; the multi-slice mesh puts its slices on the nodes."""
    outs = [r[name] for r in runs[0]]
    assert all(o["roundtrip"] for o in outs)
    specs = outs[0]["specs"]
    assert any(d is not None for d in specs.values())
    for a in outs:
        for b in outs:
            same_model = a["coords"][2] == b["coords"][2]
            same_place = a["coords"][:2] == b["coords"][:2]
            for n, t in a["local"].items():
                if same_model or (same_place and specs[n] is None):
                    assert torch.equal(t, b["local"][n]), n
            for n, ts in a["adam"].items():
                if same_model or (same_place and specs[n] is None):
                    assert all(torch.equal(x, y)
                               for x, y in zip(ts, b["adam"][n])), n
            for la, lb in zip(a["losses"], b["losses"]):
                assert all(torch.equal(la[k], lb[k]) for k in la)
    if name == "multislice":
        # GROUP_RANK 0 holds ranks 0 and 1: slice 0
        assert [o["coords"] for o in outs] == [(0, 0, 0), (0, 0, 1),
                                               (1, 0, 0), (1, 0, 1)]


def test_dryrun_on_four_ranks(runs):
    """python -m torch.distributed.run --nproc_per_node 4 -m
    sln_tpu_torch.dryrun --device cpu: every variant's line (no
    multi-slice below 8 ranks) and its JSON line."""
    rc, log = runs[2]
    assert rc == 0, log
    for line in ("mesh: data=2 model=2", "dryrun_multichip ok:",
                 "dryrun_staged ok:", "dryrun_microbatch ok:",
                 "dryrun_serving ok:", '{"dryrun": '):
        assert line in log, (line, log)
    assert "dryrun_multislice" not in log
