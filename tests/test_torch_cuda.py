"""The CUDA soft-rasterizer kernels against their plain PyTorch versions,
on the card. Marked `cuda`: they skip without one. On the card's machine
(no JAX there, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sln_tpu_torch.render import rasterizer as tr
from sln_tpu_torch.render import rasterizer_cuda as tc

pytestmark = pytest.mark.cuda

S, C = 32, 5
CONSTS = (S, 0.7, 0.02, 100.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def scenes(device, n=150, B=2, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, S, (B, n, 1, 2))
    v2d = a + np.concatenate([np.zeros((B, n, 1, 2)),
                              rng.uniform(-12, 12, (B, n, 2, 2))], 2)
    z = rng.uniform(2, 12, (B, n, 3))
    valid = rng.random((B, n)) > 0.2
    cls = rng.integers(0, C, (B, n))
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa
    return (t(v2d, torch.float32), t(z, torch.float32), t(valid, torch.bool),
            t(cls, torch.long))


def test_kernels_match_plain_versions(card):
    v2d, z, valid, cls = scenes(card)
    valid[1] = False                    # scene 1: every tile's list empty
    packed = tc.prepare_faces(tr.face_geometry(v2d, z, valid, cls), C, S)
    assert int(packed[2][1].sum()) == 0
    f0, b0 = tc.FWD_LAUNCHES, tc.BWD_LAUNCHES
    d_k, c_k, r_k = tc.raster_fwd_cuda(*packed, *CONSTS)
    d_p, c_p, r_p = tc.raster_fwd_plain(*packed, *CONSTS)
    torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(c_k, c_p, rtol=1e-4, atol=1e-4)
    gen = torch.Generator(card).manual_seed(0)
    gd = torch.randn(d_p.shape, generator=gen, device=card)
    gc = torch.randn(c_p.shape, generator=gen, device=card)
    g_k = tc.raster_bwd_cuda(*packed, r_p, c_p, gd, gc, *CONSTS)
    g_p = tc.raster_bwd_plain(*packed, r_p, c_p, gd, gc, *CONSTS)
    scale = max(float(g_p.abs().max()), 1e-3)
    torch.testing.assert_close(g_k, g_p, rtol=2e-3, atol=2e-3 * scale)
    # each call counts its kernels: the forward's item and merge, the
    # backward's item, reduce and combine
    assert (tc.FWD_LAUNCHES - f0, tc.BWD_LAUNCHES - b0) == (2, 3)


def test_bwd_kernel_on_skewed_chunk_lists(card):
    """Work items as unequal as lists get: one tile with every chunk
    active, most tiles empty, B = 8 with one scene empty. Kernel and plain
    version skip the same chunks, so they compute the same function."""
    B = 8
    v2d, z, valid, cls = scenes(card, n=600, B=B, seed=2)
    fdata, onehot, _, clist = tc.prepare_faces(
        tr.face_geometry(v2d, z, valid, cls), C, S)
    _, T, K = clist.shape
    mask = torch.zeros(B, T, K, dtype=torch.bool, device=card)
    mask[0, 3] = True                   # every chunk of one tile
    for b in range(1, B):
        mask[b, b % T, b % K] = True    # one chunk of one tile
    mask[5] = False                     # one empty scene
    counts, clist = tc.chunk_lists(mask)
    packed = (fdata, onehot, counts, clist)
    _, c_p, r_p = tc.raster_fwd_plain(*packed, *CONSTS)
    gen = torch.Generator(card).manual_seed(3)
    gd = torch.randn(B, S * S, 1, generator=gen, device=card)
    gc = torch.randn(c_p.shape, generator=gen, device=card)
    g_k = tc.raster_bwd_cuda(*packed, r_p, c_p, gd, gc, *CONSTS)
    g_p = tc.raster_bwd_plain(*packed, r_p, c_p, gd, gc, *CONSTS)
    assert bool(torch.isfinite(g_k).all()) and bool((g_k[5] == 0).all())
    scale = max(float(g_p.abs().max()), 1e-3)
    torch.testing.assert_close(g_k, g_p, rtol=2e-3, atol=2e-3 * scale)


def test_bwd_kernel_gives_the_same_bits_twice(card):
    """The backward sums each face's per-tile partials in tile order (no
    atomics): two launches on the same inputs give the same bits, here
    and with an empty scene."""
    v2d, z, valid, cls = scenes(card, n=600, B=4, seed=5)
    valid[2] = False
    packed = tc.prepare_faces(tr.face_geometry(v2d, z, valid, cls), C, S)
    _, c_p, r_p = tc.raster_fwd_plain(*packed, *CONSTS)
    gen = torch.Generator(card).manual_seed(6)
    gd = torch.randn(4, S * S, 1, generator=gen, device=card)
    gc = torch.randn(c_p.shape, generator=gen, device=card)
    g1 = tc.raster_bwd_cuda(*packed, r_p, c_p, gd, gc, *CONSTS)
    g2 = tc.raster_bwd_cuda(*packed, r_p, c_p, gd, gc, *CONSTS)
    assert torch.equal(g1, g2)
    assert bool((g1[2] == 0).all())


def test_fwd_kernel_on_skewed_chunk_lists(card):
    """The forward's items and ordered merge on lists as unequal as they
    get: one tile with every chunk active, tiles with one chunk, most tiles
    empty, B = 8 with one scene empty. Two launches give the same bits."""
    B = 8
    v2d, z, valid, cls = scenes(card, n=600, B=B, seed=4)
    fdata, onehot, _, clist = tc.prepare_faces(
        tr.face_geometry(v2d, z, valid, cls), C, S)
    _, T, K = clist.shape
    mask = torch.zeros(B, T, K, dtype=torch.bool, device=card)
    mask[0, 3] = True                   # every chunk of one tile
    mask[0, 5, 1:3] = True              # two chunks, not from the first
    for b in range(1, B):
        mask[b, b % T, b % K] = True    # one chunk of one tile
    mask[5] = False                     # one empty scene
    counts, clist = tc.chunk_lists(mask)
    packed = (fdata, onehot, counts, clist)
    d_k, c_k, r_k = tc.raster_fwd_cuda(*packed, *CONSTS)
    d_p, c_p, r_p = tc.raster_fwd_plain(*packed, *CONSTS)
    torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(c_k, c_p, rtol=1e-4, atol=1e-4)
    covered = (1.0 - torch.exp(r_p[..., 3])) > 1e-6
    torch.testing.assert_close(r_k[covered], r_p[covered], rtol=1e-3,
                               atol=1e-3)
    assert bool((d_k[5] == CONSTS[-1]).all()) and bool((c_k[5] == 0).all())
    again = tc.raster_fwd_cuda(*packed, *CONSTS)
    for a, b in zip((d_k, c_k, r_k), again):
        assert torch.equal(a, b)


def test_card_path_matches_cpu_path_with_vertex_grads(card):
    grads = []
    for dev in (card, torch.device("cpu")):
        v2d, z, valid, cls = scenes(dev, seed=1)
        v2d.requires_grad_(True)
        z.requires_grad_(True)
        d, c = tc.soft_rasterize_cuda(
            tr.face_geometry(v2d, z, valid, cls), C, S, *CONSTS[1:])
        (d.mean() + (c * torch.arange(C, device=dev)).sum() * 1e-2
         ).backward()
        grads.append((d.detach().cpu(), c.detach().cpu(), v2d.grad.cpu(),
                      z.grad.cpu()))
    (dk, ck, gvk, gzk), (dp, cp, gvp, gzp) = grads
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(ck, cp, rtol=1e-4, atol=1e-4)
    for a, b in ((gvk, gvp), (gzk, gzp)):
        torch.testing.assert_close(a, b, rtol=2e-3,
                                   atol=2e-3 * float(b.abs().max()))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    v2d, z, valid, cls = scenes(card)
    fdata, onehot, counts, clist = tc.prepare_faces(
        tr.face_geometry(v2d, z, valid, cls), C, S)
    wide = torch.zeros(*onehot.shape[:2], tc.MAX_CLASSES + 1, device=card)
    with pytest.raises(ValueError, match="classes"):
        tc.raster_fwd_cuda(fdata, wide, counts, clist, *CONSTS)
    with pytest.raises(ValueError, match="contiguous"):
        tc.raster_fwd_cuda(fdata.transpose(1, 2).contiguous().transpose(
            1, 2), onehot, counts, clist, *CONSTS)
    with pytest.raises(TypeError, match="int32"):
        tc.raster_fwd_cuda(fdata, onehot, counts.long(), clist, *CONSTS)


def test_train_step_on_the_card_matches_the_cpu(card):
    """One full-width train step (embedding 64, 5 gconv layers, 32 object
    slots, batch 256, fp32, the committed recipe's free bits) on the card
    and on the CPU, from the same initial weights and the same random
    numbers: loss dicts within rtol 1e-4 (the card's GEMMs and reductions
    sum in another order)."""
    from sln_tpu_torch.config import TrainConfig, default_config
    from sln_tpu_torch.data import synthetic
    from sln_tpu_torch.data.augment import SizeInfo, draw_graph_randomness
    from sln_tpu_torch.train import loop
    from sln_tpu_torch.workloads import common

    cfg = default_config().replace(
        train=TrainConfig(batch_size=256, kl_free_bits=0.05))
    arrays, _ = common.load_arrays(256, cfg, "cpu", synthetic_seed=42)
    gen = torch.Generator().manual_seed(0)
    draws = [(draw_graph_randomness(256, 32, gen, "cpu"),
              torch.randn(256, 32, cfg.model.latent_dim, generator=gen))]
    losses = []
    for dev in (card, torch.device("cpu")):
        size_info = SizeInfo(*(torch.as_tensor(x, device=dev)
                               for x in synthetic.default_size_table()))
        state = loop.create_state(cfg, dev)
        step = loop.make_train_step(state, cfg, size_info)
        losses.append({k: float(v) for k, v in step(
            loop.stage_arrays(arrays, dev), draws).items()})
    on_card, on_cpu = losses
    assert on_card["skipped_nan"] == 0.0
    for k, want in on_cpu.items():
        np.testing.assert_allclose(on_card[k], want, rtol=1e-4, err_msg=k)


def test_two_ranks_sharing_the_card_match_the_single_step(card, tmp_path):
    """Two data-parallel ranks on one card (gloo, as make_mesh picks when
    the ranks outnumber the cards), 8 rows each, against the
    single-process step on the same card from the same seeded weights and
    the step's own random numbers, at the parallel CPU tests' narrow width
    (at the recipe's width the step's float32 floor is above these gates:
    chip_smoke's parallel phase): two steps' losses within rtol 1e-5,
    parameters within 2.5e-3 (Adam's lr-sized steps on near-zero
    gradients), both ranks' state the same bits."""
    from torch_dist_worker import launch

    from sln_tpu_torch.config import (ModelConfig, TrainConfig,
                                      default_config)
    from sln_tpu_torch.data import synthetic
    from sln_tpu_torch.data.augment import SizeInfo
    from sln_tpu_torch.train import loop
    from sln_tpu_torch.workloads import common

    cfg = default_config().replace(
        model=ModelConfig(embedding_dim=16, gconv_num_layers=2),
        train=TrainConfig(batch_size=16, kl_free_bits=0.05))
    arrays, _ = common.load_arrays(16, cfg, "cpu", synthetic_seed=42)
    table = synthetic.default_size_table()
    raw = {k: arrays[k] for k in loop.RawBatch._fields}
    ranks = launch(2, {"device": "cuda", "tasks": {"train": {
        "kind": "train", "cfg": cfg, "size_table": table, "raw": raw,
        "steps": 2}}}, tmp_path)(timeout=600)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    state = loop.create_state(cfg, card)
    step = loop.make_train_step(state, cfg, SizeInfo(
        *(torch.as_tensor(x, device=card) for x in table)))
    staged = loop.stage_arrays(raw, card)
    want = [{k: float(v) for k, v in step(staged).items()} for _ in range(2)]
    got = ranks[0]["train"]["mesh"]
    for s in range(2):
        for k, v in want[s].items():
            np.testing.assert_allclose(float(got["losses"][s][k]), v,
                                       rtol=1e-5, err_msg=f"step {s} {k}")
    for p, q in zip(state.model.parameters(), got["state"]):
        np.testing.assert_allclose(q.numpy(), p.detach().cpu().numpy(),
                                   rtol=0, atol=2.5e-3)
    for a, b in zip(got["state"], ranks[1]["train"]["mesh"]["state"]):
        assert torch.equal(a, b)


def test_spade_generator_on_the_card_matches_the_cpu(card):
    """The shading generator (ngf 16, 128 px, seeded random weights) on the
    card and on the CPU, from the same segmentation and z: fp32 convs (the
    generator turns TF32 off itself) within 1e-3 of the CPU on the tanh
    output, and the same bits twice on the card."""
    from sln_tpu_torch.spade.generator import SPADEGenerator4

    torch.manual_seed(0)
    model = SPADEGenerator4(41, 3, nz=32, ngf=16, crop_size=128).eval()
    rng = np.random.default_rng(0)
    seg = np.zeros((1, 41, 128, 128), np.float32)
    seg[:, 0] = rng.uniform(-1, 1, (128, 128))
    np.put_along_axis(seg[0, 1:], rng.integers(0, 40, (1, 128, 128)), 1.0,
                      0)
    z = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    seg = torch.from_numpy(seg)
    with torch.inference_mode():
        want = model(seg.expand(2, -1, -1, -1), z)
        m = model.to(card)
        mods = m.seg_mods(seg.to(card))
        got = m.decode(mods, z.to(card))
        again = m.decode(m.seg_mods(seg.to(card)), z.to(card))
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)


def _gan_state(device, ngf=16, ndf=16, nz=32, crop=128):
    """A GAN training state (seeded JAX-like init, built on the CPU, then
    moved) and one batch of two, on `device`."""
    from sln_tpu_torch.spade import port
    from sln_tpu_torch.spade.discriminator import MultiscaleDiscriminator
    from sln_tpu_torch.spade.generator import SPADEGenerator4
    from sln_tpu_torch.spade.losses import GanState

    G = port.init_like_jax(SPADEGenerator4(nz=nz, ngf=ngf, crop_size=crop),
                           0)
    D = port.init_like_jax(MultiscaleDiscriminator(44, ndf), 1)
    rng = np.random.default_rng(0)
    seg = np.zeros((2, 41, crop, crop), np.float32)
    seg[:, 0] = rng.uniform(-1, 1, (2, crop, crop))
    np.put_along_axis(seg[:, 1:], rng.integers(0, 40, (2, 1, crop, crop)),
                      1.0, 1)
    real = rng.uniform(-1, 1, (2, 3, crop, crop)).astype(np.float32)
    z = rng.standard_normal((2, nz)).astype(np.float32)
    batch = tuple(torch.from_numpy(x).to(device) for x in (seg, real, z))
    return GanState(G.to(device), D.to(device), 1e-4, 4e-4), batch


def test_spade_discriminator_on_the_card_matches_the_cpu(card):
    """The multiscale discriminator (ndf 16, 128 px) in training mode on
    the card and on the CPU from the same weights: every feature map and
    logit within 1e-4 (abs, of values of order 1), and the spectral
    vectors after the power-iteration step within 1e-5."""
    outs, bufs = [], []
    for dev in (card, torch.device("cpu")):
        state, (seg, real, _) = _gan_state(dev)
        D = state.discriminator
        with torch.no_grad():
            out = D(torch.cat([seg, real], 1), True)
        outs.append([f.cpu() for feats in out for f in feats])
        bufs.append([b.cpu() for b in D.buffers()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for a, b in zip(*bufs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_gan_step_on_the_card_matches_the_cpu(card):
    """One hinge + feature-matching + L1 step (ngf 16, ndf 16, 128 px,
    batch 2) on the card and on the CPU from the same state and batch: the
    losses within rtol 1e-4, and each network's gradients (left in .grad
    by the step, before Adam) within 1e-3 of the CPU's relative to each
    tensor's norm; not the discriminator's instance-normed conv biases,
    whose gradient is rounding alone."""
    from sln_tpu_torch.spade.discriminator import instance_normed_biases
    from sln_tpu_torch.spade.losses import make_gan_train_step

    runs = []
    for dev in (card, torch.device("cpu")):
        state, batch = _gan_state(dev)
        losses = make_gan_train_step(state, lambda_l1=50.0)(*batch)
        skip = {f"d.{n}" for n in instance_normed_biases(
            state.discriminator)}
        grads = {f"{net}.{n}": p.grad.cpu()
                 for net, m in (("d", state.discriminator),
                                ("g", state.generator))
                 for n, p in m.named_parameters() if f"{net}.{n}" not in skip}
        runs.append(({k: float(v) for k, v in losses.items()}, grads))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    for k, want in l_cpu.items():
        np.testing.assert_allclose(l_card[k], want, rtol=1e-4, err_msg=k)
    for k, b in g_cpu.items():
        rel = float((g_card[k] - b).norm() / b.norm().clamp(min=1e-12))
        assert rel <= 1e-3, (k, rel)


def test_gan_step_gives_the_same_bits_twice(card):
    """The same step from the same state twice: every loss, parameter,
    spectral vector and Adam moment the same bits (the reflection pads' and
    the bilinear resize's backward sum in a fixed order)."""
    from sln_tpu_torch.spade.losses import make_gan_train_step

    results = []
    for _ in range(2):
        state, batch = _gan_state(card)
        step = make_gan_train_step(state, lambda_l1=50.0)
        losses = [step(*batch) for _ in range(2)]
        results.append(([v for d in losses for v in d.values()],
                        state.state_tensors()))
    (l1, s1), (l2, s2) = results
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert len(s1) == len(s2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


REFINE_STEPS = 8
# rooms (rows of the world's batch) refined back to back: three of one key,
# one of another shape (two rooms a batch), then one of the first shape,
# whose graph the card no longer holds; and per room whether it captures
# or reuses the card's step graph
ROOMS = [slice(0, 1), slice(1, 2), slice(2, 3), slice(0, 2), slice(3, 4)]
CAPTURES = [1, 0, 0, 1, 1]
REUSES = [0, 1, 1, 0, 0]
COUNTED = ("refine.graph_replays", "refine.graph_captures",
           "refine.graph_reuses", "raster.fwd_launches",
           "raster.bwd_launches", "raster.dispatched_pairs")


def _same_bits(a, b) -> bool:
    """a and b hold the same bytes (a -0 is not a 0)."""
    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        raw(a), raw(b))


def _refine_world(card):
    """A small decoder, five val rooms on the card, a bank of its own (so
    the world's rooms have a step graph key of their own) and the
    configuration."""
    import dataclasses
    from types import SimpleNamespace

    from sln_tpu_torch.config import DataConfig, default_config
    from sln_tpu_torch.models.vae import Sg2ScVAE
    from sln_tpu_torch.render import assets, scene as scene_lib
    from sln_tpu_torch.tools.eval_refinement_quality import val_batch
    from sln_tpu_torch.workloads import refine

    cfg = default_config()
    cfg = cfg.replace(
        data=DataConfig(max_objects=16, max_triples=48, max_on_rels=16),
        model=dataclasses.replace(cfg.model, embedding_dim=16,
                                  gconv_num_layers=2),
        refine=dataclasses.replace(cfg.refine, render_size=64, lr_z=2e-2))
    torch.manual_seed(0)
    model = Sg2ScVAE(cfg.model).to(card).eval()
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    return SimpleNamespace(
        cfg=cfg, model=model, rooms=val_batch(cfg, 5, card),
        rcfg=refine.refine_render_config(cfg), bank_host=bank_host,
        bank=scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                   device=card))


def _room(w, rows, seed: int, model=None):
    """A Refiner of the world's rooms `rows` (on a copy of the world's
    model unless `model` is given), its noise for each step, the tensors
    the caller passes it and clones of them."""
    import copy

    from sln_tpu_torch.workloads import refine

    batch = w.rooms.select(rows)
    with torch.no_grad():
        z0, _ = w.model.encode(batch)
    ins = refine.prepare_refine_inputs(batch, w.bank_host, w.bank, w.rcfg)
    r = refine.make_refine_step(
        copy.deepcopy(w.model) if model is None else model, batch, ins[0],
        w.bank, *ins[1:], w.cfg, z0)
    assert r.graphed
    device = batch.objs.device
    noise = 0.25 * torch.randn(
        (REFINE_STEPS,) + tuple(batch.objs.shape), device=device,
        generator=torch.Generator(device).manual_seed(seed))
    given = [*batch, *ins, z0]
    return r, noise, given, [t.clone() for t in given]


def _state(r):
    """Clones of a Refiner's z, every parameter and every momentum
    buffer."""
    moms = [r.opt.state[p]["momentum_buffer"]
            for group in r.opt.param_groups for p in group["params"]
            if "momentum_buffer" in r.opt.state[p]]
    return {"z": r.z.detach().clone(),
            "params": [p.detach().clone() for p in r.model.parameters()],
            "moms": [m.clone() for m in moms]}


def _profiled(fn):
    """fn() under a profiler (the counters count only then): its result
    and the counters it moved."""
    from torch.profiler import ProfilerActivity, profile

    from sln_tpu_torch import trace

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = fn()
        torch.cuda.synchronize()
    counts = trace.counters()
    return out, {k: counts.get(k, 0) for k in COUNTED}


def _refine_rooms(card, graphed: bool):
    """ROOMS refined back to back, REFINE_STEPS steps each, from the same
    weights, z0 and noise: through Refiner.step (a room's step graph
    captured or reused) or through its eager step every time. Per room:
    the steps' losses, the state after, the counters, and whether the
    tensors the caller passed are as they were."""
    w = _refine_world(card)
    out = []
    for j, rows in enumerate(ROOMS):
        r, noise, given, before = _room(w, rows, j)
        losses, counts = _profiled(lambda: [
            r.step(noise[k]) if graphed else r._step(noise[k])
            for k in range(REFINE_STEPS)])
        out.append({"losses": losses, "counts": counts, **_state(r),
                    "inputs_kept": all(_same_bits(a, b)
                                       for a, b in zip(given, before))})
    return out


def _assert_same_bits(g, e):
    """The losses of each step and the state after: the same bits."""
    assert len(g["losses"]) == len(e["losses"])
    for lg, le in zip(g["losses"], e["losses"]):
        assert lg.keys() == le.keys()
        for k in lg:
            assert _same_bits(lg[k], le[k]), k
    assert _same_bits(g["z"], e["z"])
    assert len(g["params"]) == len(e["params"])
    assert all(_same_bits(a, b) for a, b in zip(g["params"], e["params"]))
    assert len(g["moms"]) == len(e["moms"]) > 1
    assert all(_same_bits(a, b) for a, b in zip(g["moms"], e["moms"]))


def test_graphed_refine_gives_the_eager_bits(card):
    """The refine step replayed as a CUDA graph over ROOMS: each step's
    losses, z, every decoder parameter and every momentum buffer the eager
    step's bits, for the room that captures the graph (eager step 0, the
    capture at step 1), for the rooms of its key that replay it from their
    step 0 (SGD's first update on a -0 momentum buffer), for a room of
    another shape and for a room of the first shape after it. The tensors
    the caller passed are never written; each step's losses are tensors of
    their own; the three rooms of one key capture once and reuse twice;
    the rasterizer's launches and dispatched pairs are counted as the
    eager steps count them."""
    graphed = _refine_rooms(card, True)
    eager = _refine_rooms(card, False)
    for j, (g, e) in enumerate(zip(graphed, eager)):
        _assert_same_bits(g, e)
        assert g["inputs_kept"] and e["inputs_kept"]
        assert len({d["total"].data_ptr() for d in g["losses"]}) == \
            REFINE_STEPS
        assert len({float(d["total"]) for d in g["losses"]}) == REFINE_STEPS
        assert g["counts"]["refine.graph_captures"] == CAPTURES[j]
        assert g["counts"]["refine.graph_reuses"] == REUSES[j]
        # a room that reuses the graph replays step 0 too
        assert g["counts"]["refine.graph_replays"] == \
            REFINE_STEPS - CAPTURES[j]
        assert e["counts"]["refine.graph_replays"] == 0
        assert g["counts"]["raster.fwd_launches"] == 2 * REFINE_STEPS
        assert g["counts"]["raster.bwd_launches"] == 3 * REFINE_STEPS
        assert g["counts"]["raster.dispatched_pairs"] > 0
        graph_only = ("refine.graph_replays", "refine.graph_captures",
                      "refine.graph_reuses")
        assert {k: v for k, v in g["counts"].items()
                if k not in graph_only} == \
            {k: v for k, v in e["counts"].items() if k not in graph_only}
    assert sum(g["counts"]["refine.graph_captures"]
               for g in graphed[:3]) == 1
    assert sum(g["counts"]["refine.graph_reuses"] for g in graphed[:3]) == 2


def _two_in_turn(card, graphed: bool, shared: bool):
    """Two live Refiners of one key stepped in turn (A's step k, then
    B's), on a model each or one model they share: both Refiners' losses,
    their states after, the counters and whether the caller's tensors are
    as they were."""
    import copy

    w = _refine_world(card)
    model = copy.deepcopy(w.model) if shared else None
    rooms = [_room(w, rows, j, model)
             for j, rows in enumerate((slice(0, 1), slice(1, 2)))]

    def steps():
        losses = ([], [])
        for k in range(REFINE_STEPS):
            for (r, noise, _, _), hist in zip(rooms, losses):
                hist.append(r.step(noise[k]) if graphed
                            else r._step(noise[k]))
        return losses

    losses, counts = _profiled(steps)
    return [{"losses": hist, **_state(r),
             "inputs_kept": all(_same_bits(a, b)
                                for a, b in zip(given, before))}
            for hist, (r, _, given, before) in zip(losses, rooms)], counts


@pytest.mark.parametrize("shared", [False, True])
def test_two_refiners_of_one_key_stepped_in_turn_give_the_eager_bits(
        card, shared):
    """Two live Refiners of one key stepped in turn take the step graph
    from each other every step: the first captures it at its step 1, the
    second reuses it from its step 1, and each binds again when it steps
    after the other. Each one's losses, z, parameters (its own model's, or
    the model they share, which both update) and momentum buffers are the
    eager steps' bits, taken in the same order; the caller's tensors are
    never written."""
    graphed, counts = _two_in_turn(card, True, shared)
    eager, _ = _two_in_turn(card, False, shared)
    for g, e in zip(graphed, eager):
        _assert_same_bits(g, e)
        assert g["inputs_kept"] and e["inputs_kept"]
    assert counts["refine.graph_captures"] == 1
    assert counts["refine.graph_reuses"] == 1
    assert counts["refine.graph_replays"] == 2 * (REFINE_STEPS - 1)
