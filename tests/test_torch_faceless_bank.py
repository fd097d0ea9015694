"""A bank of faceless meshes (build_procedural_bank(0): each model's
face list is empty, so only the room shell is drawn), the bank the JAX
package's multi-device dry run renders: the port's device_bank takes it,
its render at 32 px matches the JAX package's on the CPU, and the port's
dry run builds the same bank."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sln_tpu import config as jcfg
from sln_tpu.data import synthetic as jsyn, tensorize as jtens
from sln_tpu.render import assets as jassets, scene as jscene
from sln_tpu_torch import dryrun
from sln_tpu_torch.config import CameraConfig, RenderConfig
from sln_tpu_torch.render import assets as tassets, scene as tscene

torch.set_num_threads(2)

SIZE = 32


def test_faceless_bank_has_an_empty_face_axis():
    host = tassets.build_procedural_bank(0)
    assert host.faces.shape == (len(host.verts), 0)
    assert tscene.max_valence(np.zeros((3, 0, 3), np.int64), 6) == 0
    assert tscene.vertex_slots(np.zeros((3, 0, 3), np.int64), 6,
                               2).tolist() == [[[-1, -1]] * 6] * 3
    bank = tscene.device_bank(host, 1, device="cpu")
    shells = tassets.procedural_shell_bank(1)
    width = tscene.max_valence(shells.faces, shells.verts.shape[1])
    assert bank.faces.shape == (len(host.verts), 0, 3)
    assert bank.face_valid.shape == (len(host.verts), 0)
    # the table width comes from the shells alone
    assert bank.vert_slots.shape == (len(host.verts), host.vm, width)
    assert (bank.vert_slots == -1).all()


@pytest.mark.parametrize("shell_subdiv", [1, 2])
def test_faceless_bank_render_matches_jax(shell_subdiv):
    """Two synthetic rooms, every object retrieved into the faceless bank:
    the port's plain rasterizer against the JAX package's pure-JAX one."""
    O = 8
    arrays = jtens.tensorize_rooms(jsyn.generate_rooms(2, seed=4), O)
    objs, boxes = arrays["objs"], arrays["boxes"]
    angles = arrays["angles"].astype(np.float32)
    mask = arrays["obj_mask"]
    room = (objs == 0) & mask
    dims = (boxes * room[..., None]).sum(1)[:, 3:]
    abs_boxes = boxes * np.concatenate([dims, dims], -1)[:, None]

    jhost = jassets.build_procedural_bank(0)
    jbank = jscene.device_bank(jhost, shell_subdiv)
    rcfg_j = dataclasses.replace(
        jcfg.default_config().render, backend="jax",
        camera=dataclasses.replace(jcfg.default_config().render.camera,
                                   image_size=SIZE))
    want = np.stack([np.asarray(jscene.render_layout(
        jnp.asarray(objs[b]), jnp.asarray(boxes[b]), jnp.asarray(angles[b]),
        jnp.asarray(mask[b]),
        jassets.retrieve_models(objs[b], jnp.asarray(abs_boxes[b]), jhost),
        jbank, rcfg_j)) for b in range(2)])

    thost = tassets.build_procedural_bank(0)
    tbank = tscene.device_bank(thost, shell_subdiv, device="cpu")
    midx = torch.as_tensor(tassets.retrieve_models(objs, abs_boxes, thost))
    got = tscene.render_layout(
        torch.as_tensor(objs).long(), torch.as_tensor(boxes),
        torch.as_tensor(angles), torch.as_tensor(mask), midx, tbank,
        RenderConfig(camera=CameraConfig(image_size=SIZE))).numpy()

    assert got.shape == want.shape == (2, 70, SIZE, SIZE)
    assert np.isfinite(got).all()
    # the room shell is drawn in both scenes
    assert ((got[:, 0] > 0).mean((1, 2)) > 0.2).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dryrun_refine_builds_the_jax_dry_runs_bank():
    """The dry run's refine renders build_procedural_bank(0) with a
    subdiv-1 shell, as the JAX dry run does (device_bank(bank_host, 1))."""
    cfg, batch, bank, inputs = dryrun.refine_setup("cpu", 2)
    jbank = jscene.device_bank(jassets.build_procedural_bank(0), 1)
    np.testing.assert_array_equal(bank.verts.numpy(), np.asarray(jbank.verts))
    assert bank.faces.shape[:2] == np.asarray(jbank.faces).shape[:2]
    assert bank.faces.numel() == 0
    for k in ("shell_verts", "shell_faces", "shell_part", "shell_fvalid"):
        np.testing.assert_array_equal(getattr(bank, k).numpy(),
                                      np.asarray(getattr(jbank, k)),
                                      err_msg=k)
    midx, target, size_t, room_row = inputs
    assert target.shape[-1] == SIZE and torch.isfinite(target).all()
