"""The port's bfloat16 compute modes against the JAX package's on the CPU:
the VAE's --compute_dtype bfloat16 (MLP and masked BatchNorm, the graph
convs, the whole Sg2ScVAE, one train step) and the shading generator's
--spade_dtype bfloat16 (SEBlock2, SPADE4, SPADEResnetBlock4, the
generator, make_spade_model's bfloat16 weights).

Both packages run with the same float32 weights (carried over by the
params_from_jax functions) on the same numpy-seeded inputs. bfloat16
rounds differently in each framework, so the gate is relative to the
rounding itself: rel(port_bf16, jax_bf16) <= 0.5 * rel(jax_bf16,
jax_fp32), rel the relative Frobenius norm over the valid rows, and the
JAX gap must not be zero. A cast in the wrong place (statistics in
bfloat16, a layer left in float32) moves the port by about the whole gap.

The JAX side is compiled with XLA's excess precision off (`jrun`). By
default XLA may drop a rounding to bfloat16 where a cast and its inverse
land in one fusion, which depends on how it fuses the whole program: the
generator's bfloat16 output then moves by as much as bfloat16 moves it
from float32 (measured, ngf 4 at 32 px). With the option off, JAX computes
every cast its modules write, which are the cast points the port mirrors.
"""

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
from sln_tpu.models import graph as jgraph, layers as jlayers
from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.spade import layers as jsl
from sln_tpu.spade.generator import SPADEGenerator4 as JGen
from sln_tpu.train import loop as jloop
from sln_tpu_torch import config as tcfg
from sln_tpu_torch.data.augment import GraphDraws, SizeInfo
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models import graph as tgraph, layers as tlayers
from sln_tpu_torch.models.vae import Sg2ScVAE, jax_path, params_from_jax
from sln_tpu_torch.spade import layers as tsl
from sln_tpu_torch.spade.generator import SPADEGenerator4 as TGen
from sln_tpu_torch.spade.port import params_from_jax as spade_from_jax
from sln_tpu_torch.train import loop as tloop
from sln_tpu_torch.workloads import gan_shade

torch.set_num_threads(2)

O, B = 8, 6
NARROW = dict(embedding_dim=16, gconv_num_layers=2)


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def gate(name, port, jax_bf16, jax_fp32):
    """rel(port, jax_bf16) <= 0.5 rel(jax_bf16, jax_fp32); lists are
    concatenated."""
    def cat(xs):
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        return np.concatenate([np.asarray(x, np.float64).ravel()
                               for x in xs])
    ours, gap = rel(cat(port), cat(jax_bf16)), rel(cat(jax_bf16),
                                                   cat(jax_fp32))
    print(f"{name}: rel(port_bf16, jax_bf16) {ours:.3e}, "
          f"rel(jax_bf16, jax_fp32) {gap:.3e}")
    assert gap > 0, f"{name}: bfloat16 changed nothing in JAX"
    assert ours <= 0.5 * gap, f"{name}: {ours:.3e} > 0.5 x {gap:.3e}"


def jrun(fn, *args):
    """fn(*args) jitted by JAX (or fn already jitted) and compiled with
    every rounding its casts write (xla_allow_excess_precision off)."""
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    return fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the VAE: MLP + masked BatchNorm, graph convs, Sg2ScVAE, one train step
# ---------------------------------------------------------------------------
def _stats(rng, tree):
    """Running statistics of a plausibly trained net."""
    def draw(path, x):
        if path[-1].key == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(x.shape),
                               jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("train", [True, False])
def test_mlp_batchnorm_bf16_matches_jax(train):
    rng = np.random.default_rng(0)
    N, dims = 64, (24, 48, 16)
    x = rng.standard_normal((N, dims[0])).astype(np.float32)
    mask = rng.random(N) < 0.75
    x[~mask] = 50.0          # padded rows must not reach the statistics
    jm = {dt: jlayers.MLP(dims, batch_norm="batch", dtype=dt)
          for dt in (jnp.float32, jnp.bfloat16)}
    v = jm[jnp.float32].init(jax.random.PRNGKey(0), x, mask, False)
    v = {"params": v["params"],
         "batch_stats": _stats(rng, v["batch_stats"])}
    outs = {}
    for dt, m in jm.items():
        y, upd = jrun(lambda v, x, mask, m=m: m.apply(
            v, x, mask, train, mutable=["batch_stats"]), v, x, mask)
        outs[dt] = (np.asarray(y.astype(jnp.float32))[mask],
                    jax.tree.leaves(upd["batch_stats"]))
    tm = tlayers.MLP(dims, "batch", dtype=torch.bfloat16)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v)))
    tm.train(train)
    with torch.no_grad():
        y = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert y.dtype == torch.bfloat16
    assert all(b.dtype == torch.float32 for b in tm.buffers()
               if b.is_floating_point())
    gate(f"MLP+BN {'train' if train else 'eval'}", f32(y)[mask],
         outs[jnp.bfloat16][0], outs[jnp.float32][0])
    if train:
        # the running statistics: float32 sums of the bfloat16 activations
        # (flax orders them mean, var per bn_i)
        got = [f32(getattr(tm[3 * i + 1], k)) for i in range(2)
               for k in ("running_mean", "running_var")]
        gate("MLP+BN running stats", got, outs[jnp.bfloat16][1],
             outs[jnp.float32][1])


def _graph_inputs(rng, D):
    objs = rng.standard_normal((B, O, D)).astype(np.float32)
    T = 3 * O
    preds = rng.standard_normal((B, T, D)).astype(np.float32)
    edges = rng.integers(0, O, (B, T, 2)).astype(np.int32)
    obj_mask = rng.random((B, O)) < 0.8
    triple_mask = rng.random((B, T)) < 0.7
    return objs, preds, edges, obj_mask, triple_mask


def test_graph_triple_conv_net_bf16_matches_jax():
    rng = np.random.default_rng(1)
    D, H = 16, 32
    objs, preds, edges, om, tm_ = _graph_inputs(rng, D)
    jm = {dt: jgraph.GraphTripleConvNet(D, H, num_layers=2,
                                        mlp_normalization="batch", dtype=dt)
          for dt in (jnp.float32, jnp.bfloat16)}
    v = jm[jnp.float32].init(jax.random.PRNGKey(0), objs, preds, edges, om,
                             tm_, False)
    outs = {}
    for dt, m in jm.items():
        (o, p), _ = jrun(lambda v, *a, m=m: m.apply(
            v, *a, True, mutable=["batch_stats"]), v, jnp.asarray(objs, dt),
            jnp.asarray(preds, dt), edges, om, tm_)
        outs[dt] = [np.asarray(o.astype(jnp.float32))[om],
                    np.asarray(p.astype(jnp.float32))[tm_]]
    net = tgraph.GraphTripleConvNet(D, H, 2, mlp_normalization="batch",
                                    dtype=torch.bfloat16)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v)))
    t = torch.from_numpy
    with torch.no_grad():
        o, p = net.train()(t(objs).bfloat16(), t(preds).bfloat16(),
                           t(edges).long(), t(om), t(tm_))
    assert o.dtype == p.dtype == torch.bfloat16
    gate("GraphTripleConvNet", [f32(o)[om], f32(p)[tm_]],
         outs[jnp.bfloat16], outs[jnp.float32])


def _rooms(n):
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(n, seed=3), O)
    table = jsyn.default_size_table(64, seed=1)
    return arrays, table


def _to_torch(jb) -> SceneBatch:
    return SceneBatch(*(torch.as_tensor(np.array(x)) for x in jb))._replace(
        **{k: torch.as_tensor(np.array(getattr(jb, k))).long()
           for k in ("objs", "angles", "attrs", "triples", "room_ids")})


@pytest.fixture(scope="module")
def vae_setup():
    arrays, table = _rooms(B)
    jb = j_build_graphs(jax.random.PRNGKey(0),
                        *(jnp.asarray(arrays[k]) for k in
                          ("objs", "boxes", "angles", "obj_mask",
                           "room_ids")),
                        JSizeInfo(*(jnp.asarray(x) for x in table)),
                        max_on_rels=O)
    jm = JVAE(jcfg.ModelConfig(**NARROW))
    v = jm.init(jax.random.PRNGKey(0), jb, None, False)
    v = {"params": v["params"],
         "batch_stats": _stats(np.random.default_rng(2), v["batch_stats"])}
    return arrays, table, jb, v


@pytest.mark.parametrize("part", ["encode", "decode"])
def test_vae_bf16_matches_jax(vae_setup, part):
    """Eval mode (running statistics) and train mode (batch statistics)
    of the encoder or the decoder; outputs float32 on both sides."""
    _, _, jb, v = vae_setup
    m = np.asarray(jb.obj_mask)
    z = np.random.default_rng(4).standard_normal(
        (B, O, jcfg.ModelConfig(**NARROW).latent_dim)).astype(np.float32)
    outs = {}
    for dt in ("float32", "bfloat16"):
        jm = JVAE(jcfg.ModelConfig(compute_dtype=dt, **NARROW))
        res = []
        for train in (False, True):
            args = (jb,) if part == "encode" else (jnp.asarray(z), jb)
            got, _ = jrun(lambda v, *a, jm=jm, train=train: jm.apply(
                v, *a, train, method=part, mutable=["batch_stats"]),
                v, *args)
            assert all(g.dtype == jnp.float32 for g in got)
            res += [np.asarray(g)[m] for g in got]
        outs[dt] = res
    model = Sg2ScVAE(tcfg.ModelConfig(compute_dtype="bfloat16", **NARROW))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v)))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tb = _to_torch(jb)
    res = []
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            got = (model.encode(tb) if part == "encode"
                   else model.decode(torch.from_numpy(z), tb))
        assert all(g.dtype == torch.float32 for g in got)
        res += [g.numpy()[m] for g in got]
    names = (["mu", "logvar"] if part == "encode"
             else ["boxes_pred", "angle_logprobs"])
    for i, name in enumerate(names * 2):
        mode = "eval" if i < len(names) else "train"
        gate(f"Sg2ScVAE {name} ({mode})", res[i], outs["bfloat16"][i],
             outs["float32"][i])


@pytest.mark.parametrize("microbatch", [0, 3])
def test_train_step_bf16_matches_jax(vae_setup, microbatch):
    """One bfloat16 train step, free bits 0.05, unchunked or in two
    microbatch chunks, the port handed JAX's draws: the losses, and the
    gradient of every parameter whose float32 gradient is not rounding
    noise (a Dense bias in front of a train-mode BatchNorm has zero
    gradient in exact arithmetic), each under the gate.

    One exception, checked otherwise: the bias of an MLP's last, plain
    Linear (box_mean.0.bias, ...) has as gradient the sum over the rows of
    the loss's cotangent, rounded to bfloat16. The JAX package sums the
    bfloat16 rows less exactly than PyTorch, which accumulates in float32,
    so there most of the JAX gap can be JAX's own rounding (measured on
    box_mean.0.bias: JAX 4 bfloat16 ulps from float32 in one element, the
    port within one). Such a bias passes the gate, or lies nearer the
    float32 gradient than JAX's bfloat16 one does: a wrong cast would move
    it away from both."""
    arrays, table, _, v = vae_setup
    raw = jloop.RawBatch(*(arrays[k][:B] for k in tloop.RawBatch._fields))
    jsi = JSizeInfo(*(jnp.asarray(x) for x in table))
    key = jax.random.PRNGKey(7)
    data = dict(max_objects=O, max_triples=3 * O, max_on_rels=O)
    train = dict(batch_size=B, kl_free_bits=0.05, microbatch=microbatch)

    def configs(dt):
        model = dict(NARROW, compute_dtype=dt)
        return (jcfg.default_config().replace(
                    model=jcfg.ModelConfig(**model),
                    data=jcfg.DataConfig(**data),
                    train=jcfg.TrainConfig(**train)),
                tcfg.default_config().replace(
                    model=tcfg.ModelConfig(**model),
                    data=tcfg.DataConfig(**data),
                    train=tcfg.TrainConfig(**train)))

    tx = optax.adam(1e-4)
    js = jloop.TrainState(v["params"], v["batch_stats"],
                          tx.init(v["params"]), jnp.int32(0))
    losses_j, grads_j = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg_j, cfg_t = configs(dt)
        step = jloop.make_train_step(JVAE(cfg_j.model), tx, cfg_j, jsi)
        new, losses = jrun(step, jax.tree.map(jnp.copy, js), raw, key)
        losses_j[dt] = {k: float(x) for k, x in losses.items()}
        model = Sg2ScVAE(cfg_t.model)
        # from zero moments, Adam's mu = 0.1 g
        grads_j[dt] = {
            name: np.asarray(_leaf(new.opt_state[0].mu,
                                   jax_path(name, cfg_t.model)[1])) / 0.1
            for name, _ in model.named_parameters()}

    # JAX's draws, split as sln_tpu/train/loop.py:146-147 (unchunked) and
    # :158-159 (per chunk) split them
    rng_step = jax.random.fold_in(key, 0)
    k = B // microbatch if microbatch else 1
    latent = cfg_t.model.latent_dim
    t_ = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    draws = []
    for chunk_key in ([rng_step] if k == 1 else
                      [jax.random.fold_in(rng_step, i) for i in range(k)]):
        rng_graph, rng_z = jax.random.split(chunk_key)
        k_partner, k_swap, k_a1, k_a2 = jax.random.split(rng_graph, 4)
        n = B // k
        draws.append((GraphDraws(
            t_(jax.random.gumbel(k_partner, (n, O, O))),
            t_(jax.random.bernoulli(k_swap, 0.5, (n, O))),
            t_(jax.random.uniform(k_a1, (n, O))),
            t_(jax.random.uniform(k_a2, (n, O)))),
            t_(jax.random.normal(rng_z, (n, O, latent)))))
    _, cfg_t = configs("bfloat16")
    state = tloop.create_state(cfg_t, "cpu", {
        "model_state": jax.tree.map(np.asarray, v), "optim_state": None,
        "counters": {"t": 0}})
    step_t = tloop.make_train_step(
        state, cfg_t, SizeInfo(*(torch.as_tensor(x) for x in table)))
    losses_t = step_t(tloop.RawBatch(*(t_(x) for x in raw)), draws)
    assert float(losses_t["skipped_nan"]) == 0.0
    names = sorted(set(losses_j["float32"]) - {"skipped_nan"})
    gate("train step losses", [float(losses_t[k]) for k in names],
         [losses_j["bfloat16"][k] for k in names],
         [losses_j["float32"][k] for k in names])

    scale = {k: np.abs(g).max() for k, g in grads_j["float32"].items()}
    top = max(scale.values())
    plain_biases = {
        f"{name}.{len(m) - 1}.bias" for name, m in state.model.named_modules()
        if isinstance(m, tlayers.MLP) and isinstance(m[-1], torch.nn.Linear)}
    checked, nearer_fp32 = 0, []
    for name, p in state.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        if scale[name] < 1e-6 * top:
            continue
        g = p.grad.numpy()
        g = g.T if jax_path(name, cfg_t.model)[2] else g
        jb, jf = grads_j["bfloat16"][name], grads_j["float32"][name]
        checked += 1
        if name in plain_biases and rel(g, jb) > 0.5 * rel(jb, jf):
            print(f"grad {name}: rel(port_bf16, jax_bf16) {rel(g, jb):.3e},"
                  f" rel(jax_bf16, jax_fp32) {rel(jb, jf):.3e}, "
                  f"rel(port_bf16, jax_fp32) {rel(g, jf):.3e}")
            assert rel(g, jf) < rel(jb, jf), name
            nearer_fp32.append(name)
            continue
        gate(f"grad {name}", g, jb, jf)
    assert checked > len(scale) // 2
    assert len(nearer_fp32) <= len(plain_biases) // 2


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# the shading generator
# ---------------------------------------------------------------------------
def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def seg_map(rng, n, S):
    """(n, S, S, 41): depth in [-1, 1] and one class mask set per pixel."""
    seg = np.zeros((n, S, S, 41), np.float32)
    seg[..., 0] = rng.uniform(-1, 1, (n, S, S))
    cls = rng.integers(1, 41, (n, S, S))
    idx = np.indices((n, S, S))
    seg[idx[0], idx[1], idx[2], cls] = 1.0
    return seg


def random_params(module, *args, seed=0):
    """Seeded normals: kernels scaled by 1/sqrt(fan in), biases by 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a), *args)["params"]

    def fill(x):
        if len(x.shape) == 1:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (rng.standard_normal(x.shape)
                / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
    return jax.tree.map(fill, shapes)


def _port(cls, params, *args, **kwargs):
    m = cls(*args, **kwargs)
    m.load_state_dict(spade_from_jax(params))
    return m.eval()


def test_seblock2_bf16_matches_jax():
    """The fc layers run in float32 on both sides; the gate is cast to the
    stream's bfloat16 before the multiply."""
    x = np.random.default_rng(5).standard_normal(
        (2, 6, 6, 16)).astype(np.float32)
    jm = jsl.SEBlock2(16)
    p = random_params(jm, x)
    outs = {dt: np.asarray(jrun(lambda p, x: jm.apply({"params": p}, x),
                                p, jnp.asarray(x, dt)).astype(jnp.float32))
            for dt in (jnp.float32, jnp.bfloat16)}
    tm = _port(tsl.SEBlock2, p, 16)
    with torch.no_grad():
        y = tm(nchw(x).bfloat16())
    assert y.dtype == torch.bfloat16
    assert all(q.dtype == torch.float32 for q in tm.parameters())
    gate("SEBlock2", nhwc(y), outs[jnp.bfloat16], outs[jnp.float32])


def test_spade4_bf16_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    seg = seg_map(rng, 2, 16)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = jsl.SPADE4(norm_nc=6, dtype=dt)
        p = random_params(jm, x, seg)
        g, b = jrun(lambda p, s, jm=jm: jm.apply({"params": p}, s, 8, 8,
                                                 method="mods"), p, seg)
        y = jrun(lambda p, x, s, jm=jm: jm.apply({"params": p}, x, s), p,
                 jnp.asarray(x, dt), seg)
        outs[dt] = [np.asarray(a.astype(jnp.float32)) for a in (g, b, y)]
    tm = _port(tsl.SPADE4, p, 6, dtype=torch.bfloat16)
    with torch.no_grad():
        g, b = tm.mods(nchw(seg), 8, 8)
        y = tm(nchw(x).bfloat16(), nchw(seg))
    assert g.dtype == b.dtype == y.dtype == torch.bfloat16
    gate("SPADE4", [nhwc(g), nhwc(b), nhwc(y)], outs[jnp.bfloat16],
         outs[jnp.float32])


def test_spade_resnet_block4_bf16_matches_jax():
    """fin != fout: the learned shortcut (norm_s and the 1x1 conv_s)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    seg = seg_map(rng, 2, 16)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = jsl.SPADEResnetBlock4(12, 6, dtype=dt)
        p = random_params(jm, x, seg)
        outs[dt] = np.asarray(jrun(
            lambda p, x, s, jm=jm: jm.apply({"params": p}, x, s), p,
            jnp.asarray(x, dt), seg).astype(jnp.float32))
    tm = _port(tsl.SPADEResnetBlock4, p, 12, 6, dtype=torch.bfloat16)
    assert tm.learned_shortcut
    with torch.no_grad():
        y = tm(nchw(x).bfloat16(), nchw(seg))
    assert y.dtype == torch.bfloat16
    gate("SPADEResnetBlock4 12->6", nhwc(y), outs[jnp.bfloat16],
         outs[jnp.float32])


GEN = dict(nz=8, ngf=4, crop_size=32)


@pytest.fixture(scope="module")
def generator():
    """The small generator's carried weights, 2 rooms and 3 z each, and
    the JAX package's float32 and bfloat16 images (B, 32, 32, 3)."""
    rng = np.random.default_rng(8)
    seg = seg_map(rng, 2, 32)
    z = rng.standard_normal((2, GEN["nz"])).astype(np.float32)
    imgs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = JGen(dtype=dt, **GEN)
        p = random_params(jm, seg, z, seed=9)
        imgs[dt] = np.asarray(jrun(lambda p, s, z, jm=jm: jm.apply(
            {"params": p}, s, z), p, seg, z))
    return p, seg, z, imgs


def test_generator4_bf16_matches_jax(generator):
    p, seg, z, imgs = generator
    assert imgs[jnp.bfloat16].dtype == np.float32
    tm = _port(TGen, p, dtype=torch.bfloat16, **GEN)
    with torch.no_grad():
        y = tm(nchw(seg), torch.from_numpy(z))
    assert y.dtype == torch.float32
    gate("SPADEGenerator4 ngf 4 crop 32", nhwc(y), imgs[jnp.bfloat16],
         imgs[jnp.float32])


def test_make_spade_model_bf16_weights(generator, tmp_path):
    """make_spade_model in bfloat16 stores every weight in bfloat16 but
    the SE layers', and shades with the same bits as float32-stored
    weights cast at each call; the float32 model is unchanged."""
    import pickle

    p, seg, z, _ = generator
    path = tmp_path / "small.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"g_params": jax.tree.map(np.asarray, p),
                     "config": {"ngf": GEN["ngf"], "crop": GEN["crop_size"],
                                "nz": GEN["nz"]}}, f)
    cfg = tcfg.default_config()
    sp = dict(ngf=GEN["ngf"], crop_size=GEN["crop_size"], nz=GEN["nz"])
    models = {dt: gan_shade.make_spade_model(
        cfg.replace(spade=dataclasses.replace(cfg.spade, compute_dtype=dt,
                                              **sp)), str(path), "cpu")
        for dt in ("float32", "bfloat16")}
    stored = {n: q.dtype for n, q in models["bfloat16"].named_parameters()}
    se = {n for n in stored if ".se." in n}
    assert se and all(stored[n] == torch.float32 for n in se)
    assert all(d == torch.bfloat16 for n, d in stored.items()
               if n not in se)
    assert all(q.dtype == torch.float32
               for q in models["float32"].parameters())
    cast_per_call = _port(TGen, p, dtype=torch.bfloat16, **GEN)
    with torch.no_grad():
        a = models["bfloat16"](nchw(seg), torch.from_numpy(z))
        b = cast_per_call(nchw(seg), torch.from_numpy(z))
        c = models["float32"](nchw(seg), torch.from_numpy(z))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
