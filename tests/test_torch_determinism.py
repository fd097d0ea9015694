"""The vertex gather of the port's scene assembly has a backward with a
fixed order (render/scene.py GatherCorners): a gather through the inverse
face index and a sum over each vertex's corners, in place of
torch.gather's scatter_add, which on the card adds with atomics in no
fixed order. On the CPU it must give torch.gather's gradient (within
1e-6). The backward kernel's fixed-order reduce has no CPU build; the
`cuda`-marked tests and chip_smoke.py hold it to the same bits twice."""

import numpy as np
import pytest
import torch

from sln_tpu_torch.config import default_config
from sln_tpu_torch.render import assets, scene as scene_lib

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    """Two scenes of the procedural bank, with every object renderable."""
    bank_host = assets.build_procedural_bank(1)
    bank = scene_lib.device_bank(bank_host, 1, device="cpu")
    rng = np.random.default_rng(0)
    B, O = 2, 6
    objs = torch.as_tensor(rng.integers(1, 20, (B, O)))
    objs[:, -1] = 0
    lo = rng.uniform(0, 0.6, (B, O, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.3, (B, O, 3))], -1)
    boxes[:, -1] = [0, 0, 0, 4.0, 2.8, 5.0]
    angles = torch.as_tensor(rng.uniform(0, 24, (B, O)), dtype=torch.float32)
    midx = torch.as_tensor(rng.integers(0, bank.verts.shape[0], (B, O)))
    return scene_lib.assemble_scene(
        objs, torch.as_tensor(boxes, dtype=torch.float32), angles,
        torch.ones(B, O, dtype=torch.bool), midx, bank)


def test_vertex_slots_invert_the_face_index():
    faces = np.array([[[0, 1, 2], [2, 1, 3], [3, 3, 0]],
                      [[4, 4, 4], [0, 1, 2], [1, 2, 3]]])
    width = scene_lib.max_valence(faces, 5)
    slots = scene_lib.vertex_slots(faces, 5, width)
    assert width == 3 and slots.shape == (2, 5, 3)
    for m in range(2):
        flat = faces[m].reshape(-1)
        for v in range(5):
            row = slots[m, v]
            listed = row[row >= 0]
            np.testing.assert_array_equal(listed, np.flatnonzero(flat == v))
            assert (row[len(listed):] == -1).all()


def test_scene_vertex_slots_list_every_corner_once(scene):
    B, Fn, _ = scene.faces.shape
    V = scene.verts.shape[1]
    n = Fn * 3
    slots = scene.vert_slots
    assert slots.shape[:2] == (B, V)
    corners = scene.faces.reshape(B, n)
    for b in range(B):
        real = slots[b][slots[b] < n]
        assert sorted(real.tolist()) == list(range(n))   # each corner once
        v_of = torch.arange(V)[:, None].expand_as(slots[b])
        ok = slots[b] < n
        assert torch.equal(corners[b][slots[b][ok]], v_of[ok])


def test_gather_corners_backward_matches_torch_gather(scene):
    B, Fn, _ = scene.faces.shape
    V = scene.verts.shape[1]
    corners = scene.faces.reshape(B, Fn * 3)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, V, 3, generator=gen, requires_grad=True)
    g = torch.randn(B, Fn * 3, 3, generator=gen)
    out = scene_lib.GatherCorners.apply(x, corners, scene.vert_slots)
    want = torch.gather(x, 1, corners[..., None].expand(B, Fn * 3, 3))
    assert torch.equal(out, want)
    (grad,) = torch.autograd.grad(out, x, g)
    (grad_want,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(grad, grad_want, rtol=0, atol=1e-6)


def test_scene_geometry_gradient_matches_torch_gather(scene, monkeypatch):
    """The whole projection and face setup: the vertex gradient through
    GatherCorners equals the one through torch.gather (the same function
    with torch.gather's own backward, patched in)."""
    rcfg = default_config().render
    room = torch.tensor([[4.0, 2.8, 5.0]] * scene.verts.shape[0])

    def vertex_grad():
        verts = scene.verts.detach().clone().requires_grad_(True)
        geom = scene_lib.scene_geometry(scene._replace(verts=verts), room,
                                        rcfg)
        terms = torch.cat([geom.edge_nx, geom.edge_ny, geom.edge_c * 1e-2,
                           geom.inv_z], -1)
        terms = torch.where(geom.valid[..., None], terms, 0.0)
        w = torch.randn(terms.shape,
                        generator=torch.Generator().manual_seed(2))
        (terms * w).sum().backward()
        return verts.grad

    ours = vertex_grad()
    monkeypatch.setattr(
        scene_lib.GatherCorners, "apply", staticmethod(
            lambda x, c, slots: torch.gather(
                x, 1, c[..., None].expand(*c.shape, x.shape[-1]))))
    want = vertex_grad()
    assert bool(ours.abs().max() > 0)
    torch.testing.assert_close(ours, want, rtol=1e-6, atol=1e-6)
