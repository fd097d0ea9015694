"""The redesigned backward's pieces that can be checked on the CPU: the
closed-form VJP (raster_bwd_plain, which skips the chunk slots j >=
counts[b, t] as the kernel's count-guarded blocks do) against autograd
through the plain forward on skewed chunk lists, and the shared-sigmoid
algebra of the kernel's per-pair weight against the forms it replaces."""

import numpy as np
import pytest
import torch

from sln_tpu_torch.render import rasterizer as tr
from sln_tpu_torch.render import rasterizer_cuda as tc

torch.set_num_threads(2)

S, C = 16, 5                            # 2 tiles of 128 pixels
CONSTS = (S, 0.7, 0.02, 100.0)


def skewed_case(seed, B=3, n=300):
    """Packed random faces (3 chunks) with skewed chunk lists: scene 1 has
    none, tile 0 of scene 2 has every chunk, the rest a random few."""
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
    counts, clist = tc.chunk_lists(mask)
    gen = torch.Generator().manual_seed(seed)
    gd = torch.randn(B, S * S, 1, generator=gen)
    gc = torch.randn(B, S * S, C, generator=gen)
    return (fdata, onehot, counts, clist), gd, gc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_form_bwd_matches_autograd_on_skewed_lists(seed):
    (fdata, onehot, counts, clist), gd, gc = skewed_case(seed)
    assert int(counts[1].sum()) == 0 and int(counts[2, 0]) == clist.shape[-1]
    fd = fdata.clone().requires_grad_(True)
    depth, classes, res = tc.raster_fwd_plain(fd, onehot, counts, clist,
                                              *CONSTS)
    ((depth * gd).sum() + (classes * gc).sum()).backward()
    got = tc.raster_bwd_plain(fdata, onehot, counts, clist, res.detach(),
                              classes.detach(), gd, gc, *CONSTS)
    scale = float(fd.grad.abs().max())
    assert scale > 0 and bool((got[1] == 0).all())
    torch.testing.assert_close(got, fd.grad, rtol=2e-3, atol=2e-3 * scale)


def test_bwd_of_empty_lists_is_zero():
    (fdata, onehot, counts, clist), gd, gc = skewed_case(3)
    counts = torch.zeros_like(counts)
    depth, classes, res = tc.raster_fwd_plain(fdata, onehot, counts, clist,
                                              *CONSTS)
    assert bool((depth == CONSTS[-1]).all()) and bool((classes == 0).all())
    got = tc.raster_bwd_plain(fdata, onehot, counts, clist, res, classes,
                              gd, gc, *CONSTS)
    assert bool((got == 0).all())


def shared_sigmoid(dd, zterm, m, inv_s):
    """The backward kernel's per-pair weight and coverage sigmoid, in its
    shared-sigmoid form (csrc/soft_raster.cu, raster_bwd_kernel): with
    e = exp(-|dd|) and r = 1 / (1 + e), sigmoid(dd) = r if dd >= 0 else
    e * r, and exp(logit - m) = exp(min(dd, 0) - zterm - m) * r since
    logit = min(dd, 0) - log1p(e) - zterm (zterm = zbuf / gamma)."""
    e = torch.exp(-dd.abs())
    r = 1.0 / (1.0 + e)
    sig = torch.where(dd >= 0, r, e * r)
    w = torch.exp(torch.clamp(dd, max=0.0) - zterm - m) * r * inv_s
    return w, sig


def test_shared_sigmoid_form_matches_the_old_one():
    """A check of the algebra, not of the kernel: shared_sigmoid above is a
    torch transcription of the kernel's formula, so a change to
    soft_raster.cu cannot fail this test (tests/test_torch_cuda.py and
    chip_smoke.py's kernels phase hold the kernel itself). Both float32
    forms against float64 on the same float32 inputs. The
    exponent of w sums terms as large as |dd| + zterm + |m|, so either form
    rounds it by a few float32 ulps of that size: the stated bound. Below
    float32's normal range (2**-126) either form may flush to zero."""
    dd = torch.linspace(-1e3, 1e3, 200001, dtype=torch.float32)
    dd = torch.cat([dd, torch.tensor([0.0, -0.0, 1e-30, -1e-30, 88.0,
                                      -88.0, -104.0])])
    zterm = torch.full_like(dd, 250.0)
    inv_s = torch.tensor(0.37)

    def old(m):
        logit = torch.clamp(dd, max=0.0) - torch.log1p(
            torch.exp(-dd.abs())) - zterm
        return torch.exp(logit - m) * inv_s, torch.sigmoid(dd)

    d64 = dd.double()
    logit64 = d64.clamp(max=0.0) - torch.log1p(torch.exp(-d64.abs())) \
        - zterm.double()
    sig64 = torch.sigmoid(d64)
    # m above the logit (the forward's running max is) and below it, as
    # far as exp(logit - m) stays finite in float32
    for delta in (0.0, 1e-3, 1.0, 30.0, 80.0, 1e3, 1e5, -1.0, -30.0,
                  -80.0):
        m = (logit64 + delta).float()
        w64 = torch.exp(logit64 - m.double()) * float(inv_s)
        tol = 4 * 2.0 ** -24 * (d64.abs() + 250.0 + m.double().abs()) \
            + 1e-6
        for w, sig in (shared_sigmoid(dd, zterm, m, inv_s), old(m)):
            assert torch.isfinite(w).all() and torch.isfinite(sig).all()
            assert bool(((w.double() - w64).abs()
                         <= tol * w64 + 2.0 ** -126).all()), delta
            assert bool(((sig.double() - sig64).abs()
                         <= 1e-6 * sig64 + 2.0 ** -126).all()), delta
    # the new exponent min(dd,0) - zterm - m = logit - m + log1p(e) is at
    # most log 2 when m >= logit: no overflow where the old form had none
    m = logit64.float()
    w, _ = shared_sigmoid(dd, zterm, m, torch.tensor(1.0))
    assert float(w.max()) <= 1.0 + 1e-3
