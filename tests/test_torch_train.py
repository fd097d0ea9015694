"""Port parity for training (sln_tpu_torch.train: losses, the KL schedule,
the epoch stream, the train step with its NaN guard and microbatching)
against the JAX package on the CPU, from the same JAX-initialised weights
(params_from_jax) and the same seeded numpy inputs.

JAX draws its randomness from threefry keys that torch cannot reproduce,
so the port's step is handed JAX's own draws: the keys are split exactly
as sln_tpu/train/loop.py:146-147 (unchunked) and :158-159 (per chunk)
split them.

Tolerances: loss dicts rtol 1e-6 for vae_losses alone (the same float32
arithmetic) and rtol 1e-5 after a whole forward; every gradient within
1e-5 of its tensor's max |g| (with microbatching, of the chunks' max |g_i|
as the step weights them, since chunks' gradients can cancel in the sum),
the Adam moments likewise (tensors whose gradient is zero in exact
arithmetic held to being rounding noise on both sides); BatchNorm running
statistics within 1e-5 of their tensor's max magnitude; parameters after
Adam within 1e-7 where JAX's |g| > 1e-4, elsewhere within 2 lr (Adam's
first update is lr g / (|g| + eps): a gradient near zero flips its sign
on rounding).
"""

import functools
import types

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
from sln_tpu.train import loop as jloop
from sln_tpu.train import losses as jlosses
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.data.augment import GraphDraws, SizeInfo
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE, jax_path, params_from_jax
from sln_tpu_torch.train import loop as tloop
from sln_tpu_torch.train import losses as tlosses
from sln_tpu_torch.train.checkpoint import adam_state_of, model_state_of

torch.set_num_threads(2)

O, B = 12, 8
NARROW = dict(embedding_dim=16, gconv_num_layers=2)
KEY = 7


def t_(x):
    return torch.as_tensor(np.array(x))


def configs(model=None, **train):
    model = dict(NARROW, **(model or {}))
    data = dict(max_objects=O, max_triples=3 * O, max_on_rels=O)
    train = dict(dict(batch_size=B), **train)
    return (jcfg.default_config().replace(
                model=jcfg.ModelConfig(**model), data=jcfg.DataConfig(**data),
                train=jcfg.TrainConfig(**train)),
            tcfg.default_config().replace(
                model=tcfg.ModelConfig(**model), data=tcfg.DataConfig(**data),
                train=tcfg.TrainConfig(**train)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_step_draws(step, k, latent):
    """The draws of each of k chunks at `step`, from the keys the JAX step
    splits out of PRNGKey(KEY): build_graphs' from rng_graph
    (augment.py:57-118) and the z noise from rng_z."""
    rng_step = jax.random.fold_in(jax.random.PRNGKey(KEY), step)
    keys = ([rng_step] if k == 1 else
            [jax.random.fold_in(rng_step, i) for i in range(k)])
    out = []
    for key in keys:
        rng_graph, rng_z = jax.random.split(key)
        k_partner, k_swap, k_a1, k_a2 = jax.random.split(rng_graph, 4)
        n = B // k
        out.append((jax.random.gumbel(k_partner, (n, O, O)),
                    jax.random.bernoulli(k_swap, 0.5, (n, O)),
                    jax.random.uniform(k_a1, (n, O)),
                    jax.random.uniform(k_a2, (n, O)),
                    jax.random.normal(rng_z, (n, O, latent))))
    return out


def jax_step_draws(step, k, latent):
    """(graph draws, z noise) per chunk, as the JAX step draws them at
    `step` (k chunks; 1 = unchunked)."""
    out = []
    for *graph, z in _jax_step_draws(step, k, latent):
        out.append((GraphDraws(*(t_(x) for x in graph)), t_(z)))
    return out


@pytest.fixture(scope="module")
def setup():
    """24 synthetic rooms, the size table in both packages, a JAX-initialised
    narrow model's variables, the first batch and its JAX graphs."""
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(24, seed=3), O)
    t, m, a = jsyn.default_size_table(64, seed=1)
    jsi = JSizeInfo(*(jnp.asarray(x) for x in (t, m, a)))
    tsi = SizeInfo(*(torch.as_tensor(x) for x in (t, m, a)))
    raw = jloop.RawBatch(*(arrays[k][:B] for k in tloop.RawBatch._fields))
    example = j_build_graphs(jax.random.PRNGKey(0),
                             *(jnp.asarray(x) for x in raw), jsi,
                             max_on_rels=O)
    cfg_j, _ = configs()
    jm = JVAE(cfg_j.model)
    variables = jax.jit(lambda key, b: jm.init(key, b, None, False))(
        jax.random.PRNGKey(0), example)
    return arrays, jsi, tsi, raw, variables, example


def port_state(cfg_t, variables):
    """A port TrainState on the CPU holding the JAX variables, fresh Adam."""
    return tloop.create_state(cfg_t, "cpu", {
        "model_state": jax.tree.map(np.asarray, variables),
        "optim_state": None, "counters": {"t": 0}})


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# losses, KL schedule, batch order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("free_bits", [0.0, 0.05])
@pytest.mark.parametrize("use_ae", [False, True])
def test_vae_losses_match_jax(free_bits, use_ae):
    rng = np.random.default_rng(0)
    D = 16
    mask = rng.random((B, O)) < 0.7
    boxes = rng.random((B, O, 6)).astype(np.float32)
    angles = rng.integers(0, 24, (B, O))
    # half the latent dimensions with a KL under the free-bits floor
    mu = (rng.standard_normal((B, O, D)) * np.r_[[0.02] * 8, [1.0] * 8]
          ).astype(np.float32)
    logvar = (rng.standard_normal((B, O, D)) * np.r_[[0.02] * 8, [0.5] * 8]
              ).astype(np.float32)
    pred = rng.random((B, O, 6)).astype(np.float32)
    logits = rng.standard_normal((B, O, 24)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))

    jb = types.SimpleNamespace(obj_mask=jnp.asarray(mask),
                               boxes=jnp.asarray(boxes),
                               angles=jnp.asarray(angles, jnp.int32))
    tb = types.SimpleNamespace(obj_mask=t_(mask), boxes=t_(boxes),
                               angles=t_(angles))
    _, want = jlosses.vae_losses(jb, *(jnp.asarray(x) for x in
                                       (mu, logvar, pred, logp)),
                                 np.float32(0.1), use_ae, free_bits)
    _, got = tlosses.vae_losses(tb, *(t_(x) for x in (mu, logvar, pred,
                                                      logp)),
                                float(np.float32(0.1)), use_ae, free_bits)
    assert set(got) == set(want)
    assert ("KLD_raw" in got) == (not use_ae)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    if free_bits and not use_ae:
        assert float(got["KLD_Gauss"]) > 0.1 * float(got["KLD_raw"])


@pytest.mark.parametrize("decay", [False, True])
def test_kl_weight_schedule_matches_jax(decay):
    cfg_j, cfg_t = configs(kl_linear_decay=decay, kl_loss_weight=0.1)
    for step in (1, 99_999, 100_000, 700_000):
        want = float(np.asarray(jloop.kl_weight_at(jnp.int32(step),
                                                   cfg_j.train)))
        assert tloop.kl_weight_at(step, cfg_t.train) == want, step


def test_epoch_stream_matches_jax(setup):
    """20 rooms in batches of 8: three batches, the last wrapping around."""
    arrays = {k: v[:20] for k, v in setup[0].items()}
    want = list(jloop.batch_indices(20, 8, np.random.default_rng(3)))
    got = list(tloop.batch_indices(20, 8, np.random.default_rng(3)))
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tloop.batches_from_arrays(arrays, 8,
                                              np.random.default_rng(3)),
                    jloop.batches_from_arrays(arrays, 8,
                                              np.random.default_rng(3))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    staged = tloop.stage_arrays(arrays, "cpu")
    for idx, raw in zip(got, jloop.batches_from_arrays(
            arrays, 8, np.random.default_rng(3))):
        for x, y in zip(tloop.gather_batch(staged, idx), raw):
            np.testing.assert_array_equal(x.numpy(), y)


# ---------------------------------------------------------------------------
# one train step against the JAX step
# ---------------------------------------------------------------------------
def _jax_grads(model, cfg_t, adam):
    """JAX's gradient of each parameter (JAX layout), read from its first
    Adam moment: from zero moments, mu = 0.1 g."""
    return {name: _leaf(adam.mu, jax_path(name, cfg_t.model)[1])
            / np.float32(0.1) for name, _ in model.named_parameters()}


@pytest.mark.parametrize("mode", ["train", "eval_mode", "microbatch"])
def test_train_step_matches_jax(setup, mode):
    _, jsi, tsi, raw, variables, _ = setup
    eval_mode = mode == "eval_mode"
    microbatch = 4 if mode == "microbatch" else 0
    k = B // microbatch if microbatch else 1
    cfg_j, cfg_t = configs(microbatch=microbatch, kl_free_bits=0.05)
    lr = cfg_t.train.learning_rate
    jmodel = JVAE(cfg_j.model)
    tx = optax.adam(lr)
    js = jloop.TrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.int32(0))
    step_j = jloop.make_train_step(jmodel, tx, cfg_j, jsi,
                                   eval_mode=eval_mode)
    new_j, losses_j = step_j(jax.tree.map(jnp.copy, js), raw,
                             jax.random.PRNGKey(KEY))

    state = port_state(cfg_t, variables)
    step_t = tloop.make_train_step(state, cfg_t, tsi, eval_mode=eval_mode)
    losses_t = step_t(tloop.RawBatch(*(t_(x) for x in raw)),
                      jax_step_draws(0, k, cfg_t.model.latent_dim))
    assert state.step == 1

    assert set(losses_t) == set(losses_j)
    for name in losses_j:
        np.testing.assert_allclose(float(losses_t[name]),
                                   float(losses_j[name]), rtol=1e-5,
                                   err_msg=name)

    adam_j = new_j.opt_state[0]
    g_j = _jax_grads(state.model, cfg_t, adam_j)
    # the scale of each gradient's error: max |g| of the tensor; with
    # chunks, each chunk's max |g_i| weighted as the step weights the
    # chunk (n_i / n): chunks' gradients can cancel in the sum. Chunk i's
    # gradient comes from the same JAX step run with every other chunk's
    # objects masked out: a chunk without objects has a zero gradient and
    # the weight max(0, 1) = 1 (loop.py:137-138), so that step's gradient
    # is n_i g_i / (n_i + 1), with chunk i's own keys.
    scale = {name: np.abs(g).max() for name, g in g_j.items()}
    if k > 1:
        n_total = raw.obj_mask.sum()
        scale = dict.fromkeys(g_j, 0.0)
        recombined = dict.fromkeys(g_j, 0.0)
        for i in range(k):
            mask = np.zeros_like(raw.obj_mask)
            rows = slice(i * microbatch, (i + 1) * microbatch)
            mask[rows] = raw.obj_mask[rows]
            new_i, losses_i = step_j(jax.tree.map(jnp.copy, js),
                                     raw._replace(obj_mask=mask),
                                     jax.random.PRNGKey(KEY))
            assert float(losses_i["skipped_nan"]) == 0.0
            n_i = mask.sum()
            for name, g in _jax_grads(state.model, cfg_t,
                                      new_i.opt_state[0]).items():
                scale[name] += (n_i + 1) / n_total * np.abs(g).max()
                recombined[name] = recombined[name] + (n_i + 1) * g
        # the chunks' gradients add up to the step's
        for name, g in g_j.items():
            np.testing.assert_allclose(recombined[name] / n_total, g,
                                       rtol=0, atol=1e-5 * scale[name],
                                       err_msg=name)

    # A Dense bias feeding a train-mode BatchNorm has zero gradient in
    # exact arithmetic (the norm subtracts the batch mean): both sides give
    # rounding noise there, under 1e-6 of the largest gradient, and are
    # held to that
    top = max(scale.values())
    noise = {name for name, s in scale.items() if s < 1e-6 * top}
    assert len(noise) < len(g_j) // 2
    for name, p in state.model.named_parameters():
        transpose = jax_path(name, cfg_t.model)[2]
        g_t = p.grad.numpy().T if transpose else p.grad.numpy()
        if name in noise:
            assert np.abs(g_t).max() < 1e-6 * top, name
        else:
            np.testing.assert_allclose(g_t, g_j[name], rtol=0,
                                       atol=1e-5 * scale[name], err_msg=name)

    ms = model_state_of(state.model, cfg_t.model)
    for path, want in jax.tree_util.tree_flatten_with_path(
            new_j.batch_stats)[0]:
        got = _leaf(ms["batch_stats"], [p.key for p in path])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    for name in g_j:
        path = jax_path(name, cfg_t.model)[1]
        got, want = _leaf(ms["params"], path), _leaf(new_j.params, path)
        big = np.abs(g_j[name]) > 1e-4
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-7,
                                   err_msg=name)
        assert np.abs(got - want)[~big].max(initial=0) <= 2 * lr, name

    # from zero moments: mu = 0.1 g, nu = 0.001 g^2
    adam_t = adam_state_of(state.model, state.optimizer, cfg_t.model)
    assert adam_t["count"] == int(adam_j.count) == 1
    for name in set(g_j) - noise:
        path = jax_path(name, cfg_t.model)[1]
        for key, unit in (("mu", 0.1 * scale[name]),
                          ("nu", 0.001 * scale[name] ** 2)):
            np.testing.assert_allclose(
                _leaf(adam_t[key], path), _leaf(getattr(adam_j, key), path),
                rtol=0, atol=1e-5 * unit, err_msg=f"{key} {name}")


# ---------------------------------------------------------------------------
# the NaN guard, microbatch validation, use_ae
# ---------------------------------------------------------------------------
def test_nan_step_leaves_every_state_tensor_unchanged(setup):
    arrays, _, tsi, _, variables, _ = setup
    _, cfg_t = configs()
    state = port_state(cfg_t, variables)
    step = tloop.make_train_step(state, cfg_t, tsi)
    staged = tloop.stage_arrays(arrays, "cpu")
    idx = np.arange(B)
    first = step(tloop.gather_batch(staged, idx))     # a real Adam state
    assert float(first["skipped_nan"]) == 0.0
    before = [t.clone() for t in state.state_tensors()]
    names = list(state.model.state_dict())

    raw = tloop.gather_batch(staged, idx)
    poisoned = raw._replace(boxes=torch.full_like(raw.boxes, float("nan")))
    losses = step(poisoned)
    assert float(losses["skipped_nan"]) == 1.0
    assert not np.isfinite(float(losses["total_loss"]))
    assert state.step == 2
    after = state.state_tensors()
    assert len(after) == len(before) > len(names)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    # and training goes on from there
    assert float(step(raw)["skipped_nan"]) == 0.0
    assert not torch.equal(state.state_tensors()[0], before[0])


def test_microbatch_must_divide_the_batch(setup):
    _, _, tsi, raw, variables, _ = setup
    _, cfg_t = configs(microbatch=3)
    state = port_state(cfg_t, variables)
    step = tloop.make_train_step(state, cfg_t, tsi)
    with pytest.raises(ValueError, match="divisible"):
        step(tloop.RawBatch(*(t_(x) for x in raw)))
    assert state.step == 0


def test_use_ae_takes_z_equal_mu_as_jax_does(setup):
    """use_ae: the JAX model with an rng given decodes z = mu; so does the
    port with a generator given, and vae_losses has no KL terms."""
    *_, variables, jb = setup
    cfg_j, cfg_t = configs(model=dict(use_ae=True))
    jm = JVAE(cfg_j.model)
    want, z_mu = jax.jit(lambda v, b: (
        jm.apply(v, b, jax.random.PRNGKey(2), False),
        jm.apply(v, b, None, False)))(variables, jb)
    model = Sg2ScVAE(cfg_t.model)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       variables)))
    tb = SceneBatch(*(t_(x) for x in jb))._replace(
        **{k: t_(getattr(jb, k)).long() for k in
           ("objs", "angles", "attrs", "triples", "room_ids")})
    with torch.no_grad():
        got = model.eval()(tb, generator=torch.Generator().manual_seed(0))
    m = np.asarray(jb.obj_mask)
    for a, b, c in zip(got, want, z_mu):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=2e-4, atol=2e-4)
