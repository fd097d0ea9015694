"""The port's asset pipeline (sln_tpu_torch/data/objio.py and
sln_tpu_torch/tools/build_asset_bank.py over the port's native edge
splitter) against the JAX package's (sln_tpu/data/objio.py,
tools/build_asset_bank.py) on the SUNCG-style multi-part .obj corpus that
tests/test_asset_bank.py writes: .obj parsing, the bank and its shells,
the .npz in both packages' loaders, retrieval, and one refinement step
driven by the built bank."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_asset_bank import FIXTURE_MODELS, _emit_box, _write_furniture_obj
from test_torch_native import split_contracted

from sln_tpu.data import objio as jobjio
from sln_tpu_torch import native
from sln_tpu_torch.data import objio
from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME
from sln_tpu_torch.render import assets
from sln_tpu_torch.render import scene as scene_lib
from sln_tpu_torch.render.blender import scene_spec
from sln_tpu_torch.tools import build_asset_bank as tbank
from tools import build_asset_bank as jbank

torch.set_num_threads(2)

MAX_LEN, MAX_FACES = 0.35, 512
BANK_KEYS = ("verts", "faces", "face_valid", "bbox_min", "bbox_max",
             "model_class", "vm", "fm", "ids", "shell_verts", "shell_faces",
             "shell_part", "shell_face_valid", "shell_ratio")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """<obj_dir>/<mid>/<mid>.obj + suncg_data_many.json + one room's
    wall/floor/ceiling shells + wall_data_wfc.json, as
    tests/test_asset_bank.py lays them out; plus one .obj with negative
    indices, v//vn tokens, polygons and groups."""
    tmp = tmp_path_factory.mktemp("port_assets")
    obj_dir = tmp / "object"
    metadata = {}
    for cls, models in FIXTURE_MODELS.items():
        metadata[cls] = []
        for mid, parts in models:
            os.makedirs(obj_dir / mid)
            _write_furniture_obj(obj_dir / mid / f"{mid}.obj", parts)
            lo = np.min([p[1] for p in parts], axis=0)
            hi = np.max([p[2] for p in parts], axis=0)
            metadata[cls].append({"id": mid, "bbox_min": lo.tolist(),
                                  "bbox_max": hi.tolist()})
    metadata["chair"].append({"id": "chair_missing", "bbox_min": [0, 0, 0],
                              "bbox_max": [1, 1, 1]})
    metadata["no_such_class"] = [{"id": "bed_101", "bbox_min": [0, 0, 0],
                                  "bbox_max": [1, 1, 1]}]
    with open(tmp / "suncg_data_many.json", "w") as f:
        json.dump(metadata, f)
    X, Y, Z = dims = (4.0, 2.6, 5.0)
    house = tmp / "room" / "house0"
    os.makedirs(house)
    for suffix, lo, hi in (("w", (0, 0, 0), dims),
                           ("f", (0, -0.08, 0), (X, 0, Z)),
                           ("c", (0, Y, 0), (X, Y + 0.08, Z))):
        with open(house / f"fr_0rm_0{suffix}.obj", "w") as f:
            _emit_box(f, lo, hi, 0, suffix)
    with open(tmp / "wall_data_wfc.json", "w") as f:
        json.dump([{"house_id": "house0", "model_id": "fr_0rm_0",
                    "wall_bbox_min": [0, 0, 0], "wall_bbox_max": list(dims)},
                   {"house_id": "house0", "model_id": "missing",
                    "wall_bbox_min": [0, 0, 0],
                    "wall_bbox_max": [1, 1, 1]}], f)
    odd = tmp / "odd.obj"
    odd.write_text(
        "# negative indices, v//vn, a pentagon, groups\nmtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\nvn 0 0 1\n"
        "g front\nusemtl a\nf -5//1 -4//1 -3//1 -2//1 -1//1\n"
        "v 0 0 1\nv 1 0 1\nv 1 1 1\n"
        "o back\nf 6/1 7/1 8/1\nf -3 -2 -1\ng empty\n"
        "vt 0.5 0.5\ns off\nf 1 2 3\n")
    return {"obj_dir": str(obj_dir),
            "metadata": str(tmp / "suncg_data_many.json"),
            "room_dir": str(tmp / "room"),
            "wall_metadata": str(tmp / "wall_data_wfc.json"),
            "odd": str(odd), "tmp": tmp}


def _build(module, corpus, out):
    module.build_bank(corpus["obj_dir"], corpus["metadata"], out,
                      max_len=MAX_LEN, max_faces=MAX_FACES,
                      room_dir=corpus["room_dir"],
                      wall_metadata=corpus["wall_metadata"])
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def banks(corpus):
    """(the port's bank, the JAX package's bank), built by their CLIs'
    build_bank; the port's also through its main."""
    port = str(corpus["tmp"] / "port.npz")
    tbank.main(["--obj_dir", corpus["obj_dir"], "--metadata",
                corpus["metadata"], "--out", port, "--max_len", str(MAX_LEN),
                "--max_faces", str(MAX_FACES), "--room_dir",
                corpus["room_dir"], "--wall_metadata",
                corpus["wall_metadata"]])
    with np.load(port) as z:
        t = {k: z[k] for k in z.files}
    j = _build(jbank, corpus, str(corpus["tmp"] / "jax.npz"))
    return t, j, port


@pytest.mark.parametrize("name", ["bed_101/bed_101.obj",
                                  "table_33/table_33.obj", "odd"])
def test_obj_io_matches_jax(corpus, name):
    path = corpus["odd"] if name == "odd" else os.path.join(
        corpus["obj_dir"], name)
    v, f = objio.load_obj(path)
    vj, fj = jobjio.load_obj(path)
    assert v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    groups, jgroups = objio.load_obj_groups(path), jobjio.load_obj_groups(
        path)
    assert len(groups) == len(jgroups) > 0
    for (gv, gf), (jv, jf) in zip(groups, jgroups):
        np.testing.assert_array_equal(gv, jv)
        np.testing.assert_array_equal(gf, jf)
    if name == "odd":
        assert f.shape == (6, 3) and f.min() >= 0 and f.max() < 8
        assert [len(g[1]) for g in groups] == [3, 2, 1]
    elif name.startswith("bed"):
        assert v.shape == (56, 3) and f.shape == (84, 3)
        assert len(groups) == 7


def test_bank_matches_jax_but_for_the_splitter_ties(banks):
    """Same keys, shapes and dtypes; every array but the mesh vertices bit
    for bit. The vertices differ only where the JAX library's FMA
    contraction breaks an edge-length tie the other way
    (tests/test_torch_native.py): per model the same face count, the area
    to rtol 1e-5 and every edge <= max_len + 1e-5."""
    t, j, _ = banks
    assert sorted(t) == sorted(j) == sorted(BANK_KEYS)
    for k in BANK_KEYS:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        if k != "verts":
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for m in range(len(t["model_class"])):
        areas = []
        for b in (t, j):
            tri = b["verts"][m][b["faces"][m][b["face_valid"][m]]]
            areas.append(np.linalg.norm(np.cross(
                tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1).sum())
            edges = np.linalg.norm(tri - np.roll(tri, 1, axis=1), axis=2)
            assert edges.max() <= MAX_LEN + 1e-5
        np.testing.assert_allclose(areas[0], areas[1], rtol=1e-5)


def test_bank_is_jax_bank_bit_for_bit_with_either_splitter(corpus, banks,
                                                           monkeypatch):
    """The pipeline around the splitter is the JAX package's: the JAX tool
    run on the port's splitter gives the port's bank bit for bit, and the
    port's tool on the FMA-contracted splitter gives the JAX bank."""
    t, j, _ = banks
    monkeypatch.setattr(jbank.native, "split_long_edges",
                        native.split_long_edges)
    j_on_port = _build(jbank, corpus, str(corpus["tmp"] / "j_port.npz"))
    monkeypatch.undo()

    def fma_split(verts, faces, max_len):
        v = split_contracted(verts, faces, max_len)
        return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)

    monkeypatch.setattr(tbank.native, "split_long_edges", fma_split)
    t_on_fma = _build(tbank, corpus, str(corpus["tmp"] / "t_fma.npz"))
    for k in BANK_KEYS:
        np.testing.assert_array_equal(j_on_port[k], t[k], err_msg=k)
        np.testing.assert_array_equal(t_on_fma[k], j[k], err_msg=k)


def test_bank_structure_and_both_loaders(banks):
    """The port's .npz loads in both packages' load_bank_npz and in
    scene_spec.load_bank; one model per class, the edge bound, the cap,
    bbox metadata, and the procedural shell at 0 beside the room's."""
    _, _, path = banks
    bank, shells = tbank.load_bank_npz(path)
    jb, jshells = jbank.load_bank_npz(path)
    sb, sshells = scene_spec.load_bank(path)
    for other, oshells in ((jb, jshells), (sb, sshells)):
        for a, b in zip(bank, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(shells, oshells):
            np.testing.assert_array_equal(a, b)
    assert sorted(OBJECT_IDX_TO_NAME[c] for c in bank.model_class) == \
        ["bed", "chair", "sofa", "table"]
    for m in range(4):
        tri = bank.verts[m][bank.faces[m][bank.face_valid[m]]]
        assert np.linalg.norm(tri - np.roll(tri, 1, axis=1),
                              axis=2).max() <= MAX_LEN + 1e-5
        assert bank.face_valid[m].sum() <= MAX_FACES
    bed = list(bank.model_class).index(OBJECT_IDX_TO_NAME.index("bed"))
    np.testing.assert_allclose(bank.bbox_max[bed], [2.0, 1.1, 1.6],
                               atol=1e-6)
    assert shells.verts.shape[0] == 2
    np.testing.assert_allclose(shells.ratio[1], [2.6 / 4.0, 5.0 / 4.0],
                               rtol=1e-6)
    assert assets.retrieve_shell_np([4.0, 2.6, 5.0], shells) == 1


def test_retrieval_picks_matching_class(banks):
    _, _, path = banks
    bank, _ = tbank.load_bank_npz(path)
    bed = OBJECT_IDX_TO_NAME.index("bed")
    chair = OBJECT_IDX_TO_NAME.index("chair")
    midx = assets.retrieve_models(
        np.array([bed, chair]), np.array([[0, 0, 0, 2.0, 1.0, 1.6],
                                          [0, 0, 0, 0.5, 1.0, 0.5]],
                                         np.float32), bank)
    assert bank.model_class[midx[0]] == bed
    assert bank.model_class[midx[1]] == chair


def test_refinement_step_on_the_built_bank(banks):
    """One refinement iteration (render, gradients, optimizer) on the CPU
    driven by the corpus-built bank, its retrieved shell included: a
    visible finite target, a finite loss, z moved."""
    from sln_tpu_torch.config import DataConfig, ModelConfig, default_config
    from sln_tpu_torch.data.augment import build_graphs
    from sln_tpu_torch.models.vae import Sg2ScVAE
    from sln_tpu_torch.workloads import common, refine

    _, _, path = banks
    bank_host, shells = tbank.load_bank_npz(path)
    cfg = default_config().replace(
        model=ModelConfig(embedding_dim=16, gconv_num_layers=2),
        data=DataConfig(max_objects=12, max_triples=36, max_on_rels=12))
    cfg = cfg.replace(refine=dataclasses.replace(
        cfg.refine, render_size=32, num_iters=2,
        pyramid_sizes=(16, 24, 32)))
    arrays, size_info = common.load_arrays(8, cfg, "cpu", synthetic_seed=23)

    def t(k):
        return torch.as_tensor(arrays[k][:1])

    batch = build_graphs(t("objs"), t("boxes"), t("angles"), t("obj_mask"),
                         t("room_ids"), size_info, max_on_rels=12,
                         generator=torch.Generator().manual_seed(0))
    torch.manual_seed(0)
    model = Sg2ScVAE(cfg.model).eval()
    bank = scene_lib.device_bank(bank_host, shells=shells, device="cpu")
    rcfg = refine.refine_render_config(cfg)
    midx, target, size_t, room_row = refine.prepare_refine_inputs(
        batch, bank_host, bank, rcfg)
    assert torch.isfinite(target).all() and float(target[0, 0].max()) > 0
    z0 = torch.zeros(1, 12, cfg.model.latent_dim)
    refiner = refine.make_refine_step(model, batch, midx, bank, target,
                                      size_t, room_row, cfg, z0)
    aux = refiner.step()
    assert torch.isfinite(aux["total"])
    assert torch.isfinite(refiner.z).all()
    assert float((refiner.z.detach() - z0).abs().max()) > 0
