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
