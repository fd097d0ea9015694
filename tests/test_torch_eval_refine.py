"""The refine loop's layout metrics (sln_tpu_torch/workloads/refine.py
masked_layout_iou, decoded_layout_iou) against the JAX package's at the
same weights, batch and z (the JAX tool's own probe inputs, the committed
checkpoint); the refinement-quality probe
(sln_tpu_torch/tools/eval_refinement_quality.py) on the CPU against the JAX
tool's record keys and its iou_at_z_gt; the committed JAX probe draws
(artifacts/refine_probe_inputs.npz); and the sweep's rows and its refusal
to write the JAX package's record."""

import dataclasses
import json
import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax_probe_inputs

from sln_tpu.models.vae import Sg2ScVAE as JVAE
from sln_tpu.workloads import refine as jref
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.tools import eval_refinement_quality as probe_tool
from sln_tpu_torch.tools import sweep_refinement
from sln_tpu_torch.workloads import common
from sln_tpu_torch.workloads import refine as tref

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_SWEEP = REPO / "artifacts" / "refine_sweep.json"
SWEEP_KEYS = ("num_iters", "lr_z", "iou_delta", "loss_cut_pct")
TOL = 1e-5
_jax_masked_iou = jax.jit(jref.masked_layout_iou)
_jax_decoded_iou = jax.jit(jref.decoded_layout_iou, static_argnums=0)


@pytest.fixture(scope="module")
def setup():
    """The JAX tool's probe inputs (8 synthetic val rooms, its graph, z0
    and noise draws, the committed checkpoint) in both packages."""
    cfg, jmodel, variables, jb, z0, noise = jax_probe_inputs.probe_setup()
    tb = SceneBatch(*(torch.as_tensor(np.array(x)) for x in jb))
    tb = tb._replace(**{k: getattr(tb, k).long() for k in
                        ("objs", "angles", "attrs", "triples", "room_ids")})
    args = probe_tool.parse_args(["--output_dir", str(REPO / "artifacts"),
                                  "--checkpoint_name", "bench"])
    cfg_t = probe_tool.probe_config(args)
    return dict(jmodel=jmodel, params=variables["params"],
                stats=variables["batch_stats"], jb=jb, z0=np.array(z0),
                noise=noise, tb=tb, cfg_t=cfg_t,
                tmodel=common.restore_model(cfg_t, "cpu"))


def _jax_mu(s):
    encode = jax.jit(lambda v, b: s["jmodel"].apply(v, b, False,
                                                    method=JVAE.encode))
    return encode({"params": s["params"], "batch_stats": s["stats"]},
                  s["jb"])[0]


def test_masked_layout_iou_matches_jax(setup):
    """Random predicted layouts (and the GT itself) against the batch."""
    s = setup
    rng = np.random.default_rng(4)
    B, O = s["tb"].objs.shape
    gt = s["tb"].boxes.numpy()
    for trial in range(3):
        boxes = (gt + (0.05 * trial) * rng.standard_normal(gt.shape)
                 ).astype(np.float32)
        angles = (s["tb"].angles.numpy() + trial * rng.integers(
            0, 24, (B, O))).astype(np.float32) % 24
        got = float(tref.masked_layout_iou(torch.as_tensor(boxes),
                                           torch.as_tensor(angles),
                                           s["tb"]))
        want = float(_jax_masked_iou(jnp.asarray(boxes),
                                     jnp.asarray(angles), s["jb"]))
        assert abs(got - want) <= TOL, (trial, got, want)
        if trial == 0:
            assert abs(got - 1.0) < 1e-3        # the GT against itself


def test_decoded_layout_iou_matches_jax(setup):
    """The decoded layout (argmax angle bins) at the posterior mean and at
    the JAX tool's z0, the committed weights in both packages."""
    s = setup
    for z in (np.array(_jax_mu(s)), s["z0"]):
        want = float(_jax_decoded_iou(s["jmodel"], s["stats"], s["jb"],
                                      jnp.asarray(z), s["params"]))
        got = float(tref.decoded_layout_iou(s["tmodel"], s["tb"],
                                            torch.as_tensor(z)))
        assert 0.0 < want < 1.0
        assert abs(got - want) <= TOL, (got, want)


def test_probe_iou_at_z_gt_matches_jax(setup):
    """The probe on the JAX tool's batch and weights (32 px, 2
    iterations): iou_at_z_gt within 1e-5 of the JAX package's
    decoded_layout_iou at its encoder's mean; every value finite; the
    model it was given left as it was."""
    s = setup
    want = float(_jax_decoded_iou(s["jmodel"], s["stats"], s["jb"],
                                  _jax_mu(s), s["params"]))
    before = {k: v.clone() for k, v in s["tmodel"].state_dict().items()}
    cfg = s["cfg_t"].replace(refine=dataclasses.replace(
        s["cfg_t"].refine, num_iters=2, render_size=32))
    rec, losses = probe_tool.probe(s["tmodel"], s["tb"], cfg, 1.0, 13)
    assert losses.shape == (2,) and losses[0] == rec["loss_first"]
    assert abs(rec["iou_at_z_gt"] - want) <= TOL
    assert all(math.isfinite(v) for v in rec.values())
    assert rec["iters"] == 2 and rec["loss_first"] != rec["loss_last"]
    for k, v in s["tmodel"].state_dict().items():
        assert torch.equal(v, before[k]), k


def test_probe_cli_on_cpu_prints_the_jax_tools_keys(capsys):
    """`python -m sln_tpu_torch.tools.eval_refinement_quality --device cpu`
    on the committed checkpoint, 2 rooms, 2 iterations, 32 px: one JSON
    line with the keys of the JAX tool's record (artifacts/
    refine_sweep.json's rows less the sweep's own keys), all finite."""
    rec, _ = probe_tool.main(["--output_dir", str(REPO / "artifacts"),
                           "--checkpoint_name", "bench", "--rooms", "2",
                           "--num_iters", "2", "--render_size", "32",
                           "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    printed = json.loads(line)
    jax_row = json.loads(JAX_SWEEP.read_text())[0]
    jax_keys = [k for k in jax_row if k not in SWEEP_KEYS]
    assert list(printed) == jax_keys
    assert list(rec) == jax_keys
    assert all(math.isfinite(v) for v in printed.values())
    assert printed["rooms"] == 2 and printed["iters"] == 2
    assert printed == probe_tool.rounded(rec)
    assert 0.0 < printed["iou_at_z_gt"] < 1.0


def test_sweep_rows_and_output(tmp_path, monkeypatch):
    """The sweep's grid is the JAX sweep's (its recorded rows' settings);
    each row adds iou_delta and loss_cut_pct, as there, and goes to --out;
    --out naming the JAX package's record raises before any probe runs."""
    jax_rows = json.loads(JAX_SWEEP.read_text())
    assert [{k: r[k] for k in ("sigma", "num_iters", "lr_z") if k in r}
            for r in jax_rows] == sweep_refinement.GRID
    with pytest.raises(ValueError, match="JAX package"):
        sweep_refinement.main(["--out", str(JAX_SWEEP), "--rows", "0"])

    seen = []

    def fake_probe(argv):
        args = probe_tool.parse_args(argv)
        seen.append(args)
        return {"rooms": args.rooms, "sigma": args.sigma,
                "iters": args.num_iters, "iou_perturbed": 0.12341,
                "iou_refined": 0.12432, "loss_first": 4.67891,
                "loss_last": 4.56443}, np.zeros(args.num_iters)

    monkeypatch.setattr(probe_tool, "main", fake_probe)
    out = tmp_path / "sweep.json"
    rows = sweep_refinement.main(["--rows", "0,6", "--out", str(out),
                                  "--device", "cpu", "--rooms", "2"])
    assert [a.sigma for a in seen] == [1.0, 0.5]
    assert [a.lr_z for a in seen] == [0.0, 2e-2]
    assert all(a.device == "cpu" and a.checkpoint_name == "bench"
               for a in seen)
    assert json.loads(out.read_text()) == rows
    assert rows[0]["iou_delta"] == 0.0009 and rows[0]["num_iters"] == 60
    assert rows[0]["loss_cut_pct"] == jax_rows[0]["loss_cut_pct"] == 2.45


def test_committed_jax_probe_inputs_and_the_port_on_them(setup):
    """artifacts/refine_probe_inputs.npz holds the JAX package's own probe
    draws (tests/jax_probe_inputs.py regenerates them bit for bit); on
    them the port's numbers that no draw moves (layout IoU and box L1 at z0
    and at z_gt, the z distance) equal the JAX package's recorded ones
    within 1e-5, on the committed checkpoint at full width."""
    s = setup
    with np.load(REPO / "artifacts" / "refine_probe_inputs.npz") as z:
        got = {k: z[k] for k in z.files}
    want = {f"batch_{k}": np.asarray(v)
            for k, v in zip(s["jb"]._fields, s["jb"])}
    want.update(z0=s["z0"], noise=s["noise"])
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["jax_cpu_totals"].shape == (jax_probe_inputs.ITERS,)

    model, batch = s["tmodel"], s["tb"]
    z0 = torch.as_tensor(got["z0"])
    with torch.no_grad():
        mu = model.encode(batch)[0]
    port = {"iou_perturbed": float(tref.decoded_layout_iou(model, batch, z0)),
            "iou_at_z_gt": float(tref.decoded_layout_iou(model, batch, mu)),
            "box_l1_perturbed": probe_tool.box_l1(model, batch, z0),
            "box_l1_at_z_gt": probe_tool.box_l1(model, batch, mu),
            "z_l1_before": float((z0 - mu).abs().mean())}
    for k, v in port.items():
        assert abs(v - float(got[f"jax_cpu_{k}"])) <= TOL, k
