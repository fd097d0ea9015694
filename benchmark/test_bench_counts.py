"""The frozen counts: needed (pixel, face) pairs against a brute-force
count pixel by pixel, and the operation counts against hand sums."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark.counts import flops as F
from benchmark.counts import raster as RC
from benchmark.reference import render as R
from benchmark.traffic import scenes as S


def _scene_terms(seed: int, size: int):
    rooms = S.generate_rooms(2, S.host_seed(seed, 1))
    si = S.size_table("cpu", num_rooms=64)
    b = S.scene_batch(rooms, 32, si, S.device_generator("cpu", seed, 2),
                      "cpu")
    bank, shells = R.mesh_bank(1), R.room_shells(2)
    dims = (b.boxes * b.room_mask[..., None]).sum(1)[..., 3:]
    absb = b.boxes * torch.cat([dims, dims], -1)[:, None]
    midx = torch.as_tensor(R.retrieve(b.objs.numpy(), absb.numpy(), bank))
    tri, fcls, fvalid, dims = R.assemble(b.objs, b.boxes, b.angles.float(),
                                         b.obj_mask, midx, bank, shells)
    return R.face_terms(tri, fvalid, dims, R.Camera(image_size=size))


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_needed_pairs_against_brute_force(seed):
    size, sigma, gamma = 12, 0.5, 0.02
    terms = _scene_terms(seed, size)
    got = RC.needed_pairs(terms, size, sigma, gamma, block=17)
    nx, ny, c, il, iz, valid = terms
    want = []
    for b in range(nx.shape[0]):
        n = 0
        z_far = max(1.0 / float(iz[b, f].double().min())
                    for f in range(nx.shape[1]) if valid[b, f])
        for f in range(nx.shape[1]):
            if not bool(valid[b, f]):
                continue
            z_near = 1.0 / float(iz[b, f].double().max())
            dd = RC.CULL_LOGIT + max(z_far - z_near, 0.0) / gamma
            h = np.float32(0.5 * (math.sqrt(1.0 + 4.0 * sigma * dd) - 1.0))
            for y in range(size):
                for x in range(size):
                    px, py = np.float32(x + 0.5), np.float32(y + 0.5)
                    d = min((nx[b, f, k].numpy() * px + ny[b, f, k].numpy()
                             * py + c[b, f, k].numpy()) * il[b, f, k].numpy()
                            for k in range(3))
                    n += bool(d >= -h)
        want.append(n)
    assert got.tolist() == want
    assert 0 < want[0] < size * size * int(valid[0].sum())


def test_vae_flops_hand_sum():
    # B=1, O=2, T=3, e=4: D=8, H=16; one graph layer
    gconv = 2 * 3 * (24 * 16 + 16 * 40) + 2 * 2 * (16 * 16 + 16 * 8)
    enc = gconv + 2 * (2 * 2 * (8 * 16 + 16 * 8)) + 2 * (2 * 2 * 8 * 3) \
        + 2 * (2 * 2 * 8 * 1)
    dec = gconv + 2 * 2 * (9 * 16 + 16 * 6) + 2 * 2 * (8 * 16 + 16 * 24)
    f = F.vae_flops(1, 2, 3, e=4, layers=1)
    assert f == {"encoder": enc, "decoder": dec,
                 "box_embedding": 2 * 2 * 6 * 3}
    assert F.train_step_flops(1, 2, 3, 4, 1) == 3 * (enc + dec) + 2 * 72
    assert F.decoder_step_flops(1, 2, 3, 4, 1) == 3 * dec


def test_psp_flops_hand_sum():
    # 8 -> 4 -> 8 and the identity scale 8
    down = 2 * 4 * 8 * 8 + 2 * 4 * 8 * 4
    up = 2 * 8 * 4 * 4 + 2 * 8 * 4 * 8
    assert F.psp_flops(2, 3, 8, (4, 8)) == 2 * 2 * 3 * (down + up)


def test_spade_flops_at_the_published_width():
    """seg_mods and a 10-z decode at ngf 64, 256 px, as counted on the
    card's conv shapes (220.5 and 846.8 GFLOP), and conv_img by hand."""
    f = F.spade_room_flops()
    assert f["seg_mods"] == pytest.approx(220.5e9, rel=1e-3)
    assert f["decode_chunk"] == pytest.approx(846.8e9, rel=1e-3)
    assert f["room"] == f["seg_mods"] + 5 * f["decode_chunk"]
    small = F.spade_room_flops(ngf=1, nz=1, crop=32, num_z=1, z_chunk=1)
    conv_img = 2 * 3 * 32 * 32 * 1 * 25
    assert small["decode_chunk"] > conv_img


def test_roofline_bounds():
    peaks = {"fp32_flops": 67e12, "tf32_flops": 495e12, "hbm_bytes": 3.35e12}
    p = 1e9
    assert RC.fwd_seconds_bound(p, 100, 1000, peaks) == pytest.approx(
        p * 67 / 67e12 + p * 128 / 495e12)
    assert RC.bwd_seconds_bound(p, 100, 1000, peaks) == pytest.approx(
        p * 230 / 67e12)
    # no pairs: the bytes bound the call
    assert RC.fwd_seconds_bound(0, 100, 1000, peaks) == pytest.approx(
        4 * (100 * 17 + 1000 * 33) / 3.35e12)
    assert np.isfinite(RC.bwd_seconds_bound(0, 1, 1, peaks))
