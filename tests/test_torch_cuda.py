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
    assert (tc.FWD_LAUNCHES - f0, tc.BWD_LAUNCHES - b0) == (1, 1)


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
