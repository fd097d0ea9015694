"""The redesigned forward's pieces that can be checked on the CPU: its
per-item partial online-softmax states and their ordered merge, written
plainly here (the kernel pair raster_fwd_item_kernel / raster_fwd_merge_kernel
in csrc/soft_raster.cu computes them on the card), against raster_fwd_plain on
skewed chunk lists; and the two-term TF32 split of the class product."""

import numpy as np
import pytest
import torch

from sln_tpu_torch.render import rasterizer as tr
from sln_tpu_torch.render import rasterizer_cuda as tc

torch.set_num_threads(2)

S, C = 16, 5                            # 2 tiles of 128 pixels
CONSTS = (S, 0.7, 0.02, 100.0)
FWD_TOL = {"depth": (1e-4, 1e-3), "classes": (1e-4, 1e-4)}


def skewed_lists(seed, B=3, n=300):
    """Packed random faces (3 chunks) with skewed chunk lists: scene 1 has
    none, tile 0 of scene 2 has every chunk, tile 1 of scene 0 only its
    second, the rest a random few."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, S, (B, n, 1, 2))
    v2d = a + np.concatenate([np.zeros((B, n, 1, 2)),
                              rng.uniform(-6, 6, (B, n, 2, 2))], 2)
    geom = tr.face_geometry(
        torch.as_tensor(v2d, dtype=torch.float32),
        torch.as_tensor(rng.uniform(2, 12, (B, n, 3)), dtype=torch.float32),
        torch.as_tensor(rng.random((B, n)) > 0.2),
        torch.as_tensor(rng.integers(0, C, (B, n))))
    fdata, onehot, _, clist = tc.prepare_faces(geom, C, S)
    _, T, K = clist.shape
    mask = torch.as_tensor(rng.random((B, T, K)) < 0.4)
    mask[1] = False
    mask[2, 0] = True
    mask[0, 1] = torch.tensor([False, True, False])
    counts, clist = tc.chunk_lists(mask)
    return fdata, onehot, counts, clist


def item_partials(fdata, onehot, counts, clist, sigma, gamma, step=8):
    """Every chunk slot's partial state over its PT pixels, as the item
    kernel leaves it: m, s, sum w*z, sum log(1 - cov) (B, T, K, PT, 1 each)
    and ac (B, T, K, PT, C). Faces are taken `step` at a time with one
    rescale per step, as the kernel's 8-face mma steps do. Inactive slots
    hold the empty state m = -1e30, s = az = alt = ac = 0."""
    B, _, Fp = fdata.shape
    T, K = clist.shape[1:]
    px, py = tc._tile_pixels(T, tc.PT, S, fdata.device)
    parts = []
    for j in range(K):
        active = (counts[:, :, 0] > j)[:, :, None, None]
        fd, oh, _ = tc._gather_chunk(fdata, onehot, clist, j)
        g = tc._chunk_geometry(fd, px, py, sigma, gamma)
        m = torch.full((B, T, tc.PT, 1), -1e30)
        s, az, alt = (torch.zeros(B, T, tc.PT, 1) for _ in range(3))
        ac = torch.zeros(B, T, tc.PT, C)
        for f in range(0, tc.FC, step):
            sl = slice(f, f + step)
            logit, zbuf = g["logit"][..., sl], g["zbuf"][..., sl]
            m_new = torch.maximum(m, logit.amax(-1, keepdim=True))
            sc = torch.exp(m - m_new)
            w = torch.exp(logit - m_new)
            s = s * sc + w.sum(-1, keepdim=True)
            az = az * sc + (w * zbuf).sum(-1, keepdim=True)
            ac = ac * sc + w @ oh[:, :, sl]
            alt = alt + g["lomc"][..., sl].sum(-1, keepdim=True)
            m = m_new
        part = torch.cat([m, s, az, alt, ac], -1)
        empty = torch.cat([torch.full_like(m, -1e30),
                           torch.zeros_like(part[..., 1:])], -1)
        parts.append(torch.where(active, part, empty))
    return torch.stack(parts, 2)                       # (B, T, K, PT, 4+C)


def ordered_merge(parts, counts, z_far):
    """A tile's partial states merged in clist order (j = 0, 1, ...) with
    the rescale to the larger max, as the merge kernel does; then depth,
    classes and the residuals as the forward writes them."""
    B, T, K, P, _ = parts.shape
    m = torch.full((B, T, P, 1), -1e30)
    s, az, alt = (torch.zeros(B, T, P, 1) for _ in range(3))
    ac = torch.zeros(B, T, P, parts.shape[-1] - 4)
    for j in range(K):
        active = (counts[:, :, 0] > j)[:, :, None, None]
        p = parts[:, :, j]
        mj = p[..., 0:1]
        mn = torch.maximum(m, mj)
        a, w = torch.exp(m - mn), torch.exp(mj - mn)
        s = torch.where(active, s * a + p[..., 1:2] * w, s)
        az = torch.where(active, az * a + p[..., 2:3] * w, az)
        alt = torch.where(active, alt + p[..., 3:4], alt)
        ac = torch.where(active, ac * a + p[..., 4:] * w, ac)
        m = torch.where(active, mn, m)
    denom = s.clamp(min=1e-30)
    alpha = 1.0 - torch.exp(alt)
    depth = alpha * az / denom + (1.0 - alpha) * z_far
    classes = ac * (alpha / denom)
    res = torch.cat([m, s, az, alt], -1)
    return (depth.reshape(B, T * P, 1), classes.reshape(B, T * P, -1),
            res.reshape(B, T * P, 4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_items_and_ordered_merge_match_plain_forward(seed):
    fdata, onehot, counts, clist = skewed_lists(seed)
    assert int(counts[1].sum()) == 0 and int(counts[2, 0]) == clist.shape[-1]
    assert int(counts[0, 1]) == 1        # a tile of one chunk
    _, sigma, gamma, z_far = CONSTS
    parts = item_partials(fdata, onehot, counts, clist, sigma, gamma)
    got = ordered_merge(parts, counts, z_far)
    want = tc.raster_fwd_plain(fdata, onehot, counts, clist, *CONSTS)
    for name, a, b in zip(("depth", "classes"), got, want):
        torch.testing.assert_close(a, b, rtol=FWD_TOL[name][0],
                                   atol=FWD_TOL[name][1])
    covered = (1.0 - torch.exp(want[2][..., 3])) > 1e-6
    assert bool(covered.any())
    torch.testing.assert_close(got[2][covered], want[2][covered],
                               rtol=1e-3, atol=1e-3)
    # the empty scene: background, and the residuals of no face at all
    assert bool((got[0][1] == z_far).all()) and bool((got[1][1] == 0).all())
    assert bool((got[2][1] == torch.tensor([-1e30, 0.0, 0.0, 0.0])).all())


def test_empty_partials_leave_a_merge_unchanged():
    """Merging an empty partial (m = -1e30, s = 0) into a state, in either
    order, gives that state's bits: a slot with no active chunk adds
    nothing."""
    fdata, onehot, counts, clist = skewed_lists(3)
    _, sigma, gamma, z_far = CONSTS
    parts = item_partials(fdata, onehot, counts, clist, sigma, gamma)
    one = torch.ones_like(counts)
    first = ordered_merge(parts[:, :, :1], one, z_far)
    empty = torch.cat([torch.full_like(parts[..., :1], -1e30),
                       torch.zeros_like(parts[..., 1:])], -1)[:, :, :1]
    for stacked in (torch.cat([parts[:, :, :1], empty], 2),
                    torch.cat([empty, parts[:, :, :1]], 2)):
        got = ordered_merge(stacked, 2 * one, z_far)
        for a, b in zip(got, first):
            assert torch.equal(a, b)


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (10 mantissa bits), round to nearest with ties away
    from zero, as cvt.rna.tf32.f32; returned as float32."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_two_term_tf32_split_of_the_class_product():
    """A check of the algebra, not of the kernel: the kernel issues
    W_hi @ onehot + W_lo @ onehot with W_hi = tf32(W) and
    W_lo = tf32(W - W_hi); this holds that split, in float64, against
    W @ onehot for weights as the softmax makes them (exp of logit - max,
    in (0, 1]). One TF32 term alone errs by up to 2^-11."""
    rng = np.random.default_rng(0)
    w = np.exp(-rng.exponential(8.0, (4096, 128))).astype(np.float32)
    w[:, 0] = 1.0                                  # the running max
    hi = rna_tf32(w)
    lo = rna_tf32(w - hi)
    cls = rng.integers(0, 32, 128)
    onehot = np.eye(32)[cls]
    want = w.astype(np.float64) @ onehot
    split = hi.astype(np.float64) @ onehot + lo.astype(np.float64) @ onehot
    single = hi.astype(np.float64) @ onehot
    nz = want > 0
    rel = np.abs(split - want)[nz] / want[nz]
    assert rel.max() < 1e-6
    assert (np.abs(single - want)[nz] / want[nz]).max() > 1e-5
    # per weight: hi + lo recovers w to 2^-22 relative (weights far below
    # any sum they join, under 2^-100, may lose more in subnormal lo terms)
    big = w > 2.0 ** -100
    err = np.abs(hi.astype(np.float64) + lo - w) / w
    assert err[big].max() <= 2.0 ** -22
