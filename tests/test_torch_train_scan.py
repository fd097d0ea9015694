"""The port's device-resident train loop (sln_tpu_torch.train.loop
make_train_scan) on the CPU, where it runs as its plain version, the eager
loop of the step: against the JAX package's make_train_scan on the same key
(the port fed JAX's per-step draws, as tests/test_torch_train.py feeds its
step), against the port's own eager steps bit for bit (plain and
microbatched: the microbatched step itself is held against JAX's by
tests/test_torch_train.py), across a non-finite step, at the KL weight's
staircase and inside a process group. The CUDA graph it captures on the
card is held against the eager steps by chip_smoke.py's train_scan phase.

Gates: the summed total_loss rtol 1e-5 against JAX; every parameter within
2 lr per step (Adam's update is about lr m / |m|: a moment near zero flips
the sign of its lr-sized step on rounding, at each step; tighter
elementwise gates do not hold over four steps, where a moment that its
gradients' signs shrink carries their error, 1e-5 of the tensor's largest
in tests/test_torch_train.py, into the update: 1.7e-5 measured on an
embedding row, 5.3e-4 at worst); BatchNorm running statistics within 5e-4
of their largest (they follow activations of parameters that agree only to
those sign flips: 1e-4 after the two steps of tests/test_torch_parallel.py,
up to 1.8e-4 measured here after four); Adam's moments mu and nu each
within 2e-2 relative norm over all parameters (4.6e-3 and 1.9e-3
measured; a window one step short is 0.57 and 0.30 off, and the test
checks that it misses the gate); against the eager loop every state
tensor and the total the same bits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.train import loop as jloop
from sln_tpu_torch.models.vae import jax_path
from sln_tpu_torch.parallel.mesh import make_mesh
from sln_tpu_torch.train import loop as tloop
from sln_tpu_torch.train.checkpoint import adam_state_of, model_state_of

from test_torch_train import (B, KEY, _leaf, configs, jax_step_draws,
                              port_state, setup, t_)  # noqa: F401

torch.set_num_threads(2)

N = 4
MOMENT_REL = 2e-2
MODES = {"plain": {}, "microbatch": dict(microbatch=4)}


def raw_of(setup):
    return tloop.RawBatch(*(t_(x) for x in setup[3]))


@pytest.fixture(scope="module")
def scans(setup):
    """N steps of the JAX package's make_train_scan on PRNGKey(KEY) and of
    the port's on JAX's per-step draws, from the same init: (JAX's final
    TrainState, its summed total_loss, the port's state, its total)."""
    _, jsi, tsi, raw, variables, _ = setup
    cfg_j, cfg_t = configs()
    tx = optax.adam(cfg_j.train.learning_rate)
    js = jloop.TrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.int32(0))
    scan = jloop.make_train_scan(JVAE(cfg_j.model), tx, cfg_j, jsi)
    state_j, total_j = scan(jax.tree.map(jnp.copy, js), raw,
                            jax.random.PRNGKey(KEY), N)
    state = port_state(cfg_t, variables)
    run = tloop.make_train_scan(state, cfg_t, tsi)
    total = run(raw_of(setup), N, [jax_step_draws(s, 1,
                                                  cfg_t.model.latent_dim)
                                   for s in range(N)])
    return state_j, float(total_j), state, total


def test_scan_matches_the_jax_scan(scans):
    state_j, total_j, state, total = scans
    _, cfg_t = configs()
    assert total.dim() == 0 and state.step == N
    np.testing.assert_allclose(float(total), total_j, rtol=1e-5)

    lr = cfg_t.train.learning_rate
    ms = model_state_of(state.model, cfg_t.model)
    for name, _ in state.model.named_parameters():
        path = jax_path(name, cfg_t.model)[1]
        got, want = _leaf(ms["params"], path), _leaf(state_j.params, path)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr * N,
                                   err_msg=name)
    for path, want in jax.tree_util.tree_flatten_with_path(
            state_j.batch_stats)[0]:
        want = np.asarray(want)
        np.testing.assert_allclose(
            _leaf(ms["batch_stats"], [p.key for p in path]), want, rtol=0,
            atol=5e-4 * np.abs(want).max(), err_msg=str(path))


def test_scan_adam_moments_match_the_jax_scan(scans, setup):
    """Adam's count and both moments after the window against JAX's
    opt_state, each moment over all parameters at MOMENT_REL relative
    norm. Every step's update enters them, where the parameters' 2 lr gate
    cannot see one: the same gate on the port's window one step short
    (its moments against JAX's after N steps) fails by far."""
    state_j, _, state, _ = scans
    _, cfg_t = configs()
    adam_j = state_j.opt_state[0]

    def rel_norms(model, optimizer):
        adam_t = adam_state_of(model, optimizer, cfg_t.model)
        out = {"count": adam_t["count"]}
        for key in ("mu", "nu"):
            paths = [jax_path(n, cfg_t.model)[1]
                     for n, _ in model.named_parameters()]
            got, want = (np.concatenate([np.ravel(_leaf(tree, p))
                                         for p in paths])
                         for tree in (adam_t[key], getattr(adam_j, key)))
            out[key] = np.linalg.norm(got - want) / np.linalg.norm(want)
        return out

    full = rel_norms(state.model, state.optimizer)
    assert full["count"] == int(adam_j.count) == N
    assert full["mu"] < MOMENT_REL and full["nu"] < MOMENT_REL, full
    short, _, _ = eager_steps(cfg_t, setup, [
        jax_step_draws(s, 1, cfg_t.model.latent_dim) for s in range(N - 1)],
        n=N - 1)
    short = rel_norms(short.model, short.optimizer)
    assert min(short["mu"], short["nu"]) > 10 * MOMENT_REL, short


def eager_steps(cfg_t, setup, draws=None, n=N):
    """n eager steps of make_train_step from the JAX init: (the state, the
    total_loss summed in step order from 0, each step's state tensors)."""
    state = port_state(cfg_t, setup[4])
    step = tloop.make_train_step(state, cfg_t, setup[2])
    total, after = torch.zeros(()), []
    for i in range(n):
        losses = step(raw_of(setup), None if draws is None else draws[i])
        total = total + losses["total_loss"]
        after.append([t.clone() for t in state.state_tensors()])
    return state, total, after


@pytest.mark.parametrize("mode", list(MODES))
def test_scan_gives_the_eager_loops_bits(setup, mode):
    """With the steps' own draws (step_seed), as the graph on the card is
    held against the eager loop."""
    _, cfg_t = configs(**MODES[mode])
    state = port_state(cfg_t, setup[4])
    total = tloop.make_train_scan(state, cfg_t, setup[2])(raw_of(setup), N)
    eager, total_e, _ = eager_steps(cfg_t, setup)
    assert torch.equal(total, total_e)
    assert state.step == eager.step == N
    for a, b in zip(state.state_tensors(), eager.state_tensors()):
        assert torch.equal(a, b)


def test_a_non_finite_step_inside_the_window_is_skipped(setup):
    """Step 2 of 4 draws NaN noise: the NaN guard leaves every state tensor
    as step 1 left it, the window goes on, and the summed loss is NaN (as
    the JAX scan's sum is)."""
    _, cfg_t = configs()
    draws = [jax_step_draws(s, 1, cfg_t.model.latent_dim) for s in range(N)]
    graph, noise = draws[1][0]
    draws[1] = [(graph, torch.full_like(noise, float("nan")))]
    state = port_state(cfg_t, setup[4])
    total = tloop.make_train_scan(state, cfg_t, setup[2])(raw_of(setup), N,
                                                          draws)
    eager, total_e, after = eager_steps(cfg_t, setup, draws)
    assert not np.isfinite(float(total)) and not np.isfinite(float(total_e))
    for a, b in zip(after[0], after[1]):
        assert torch.equal(a, b)
    assert not torch.equal(after[2][0], after[1][0])
    for a, b in zip(state.state_tensors(), eager.state_tensors()):
        assert torch.equal(a, b)
    assert state.step == N


def test_a_window_across_a_kl_weight_change_is_refused(setup):
    """The KL weight is captured with the step: under kl_linear_decay a
    window must not cross a multiple of 100,000 steps."""
    _, cfg_t = configs(kl_linear_decay=True)
    state = port_state(cfg_t, setup[4])
    run = tloop.make_train_scan(state, cfg_t, setup[2])
    state.step = 99_998        # steps 99,999 (1e-6) and 100,000 (1e-5)
    with pytest.raises(ValueError, match="KL weight changes"):
        run(raw_of(setup), 2)
    assert state.step == 99_998
    state.step = 99_999        # steps 100,000 and 100,001: both 1e-5
    assert np.isfinite(float(run(raw_of(setup), 2)))
    assert state.step == 100_001


def test_the_scan_refuses_a_distributed_mesh(setup, tmp_path, monkeypatch):
    """Inside a process group (make_mesh's under a launcher's environment,
    here a gloo world of one) the scan raises: it runs on one device, as
    the JAX scan."""
    _, cfg_t = configs()
    state = port_state(cfg_t, setup[4])
    for var in ("RANK", "LOCAL_RANK"):
        monkeypatch.setenv(var, "0")
    for var in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.setenv(var, "1")
    mesh = make_mesh(1, device="cpu",
                     init_method=f"file://{tmp_path / 'store'}")
    try:
        assert mesh.distributed
        with pytest.raises(ValueError, match="one device"):
            tloop.make_train_scan(state, cfg_t, setup[2])
    finally:
        mesh.close()
    with pytest.raises(ValueError, match="draws for"):
        tloop.make_train_scan(state, cfg_t, setup[2])(
            raw_of(setup), 2, [jax_step_draws(0, 1,
                                              cfg_t.model.latent_dim)])
