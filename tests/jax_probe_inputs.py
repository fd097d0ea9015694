"""The JAX package's inputs to its refinement probe, for the port to run on.

    JAX_PLATFORMS=cpu python tests/jax_probe_inputs.py

writes artifacts/refine_probe_inputs.npz: the SceneBatch that
tools/eval_refinement_quality.py builds (8 synthetic val rooms of seed 11,
graphs drawn with PRNGKey(0)), its z0 (the encoder's mean plus one
standard normal draw of PRNGKey(13), sigma 1) and the 60 iterations' angle
noise (PRNGKey(14) split 60 ways, times angle_noise_scale), all from the
committed artifacts/latest_bench_with_model.ckpt; and what the JAX package
computes from them on the CPU (96 px, lr_z 2e-4): `jax_cpu_totals`, its 60
per-iteration losses, and `jax_cpu_<key>` for each number its tool prints
(the record its TPU run left in artifacts/refine_sweep.json row 0).
chip_smoke.py runs the port's probe on these draws on the card;
tests/test_torch_eval_refine.py holds the file to the JAX package's draws
bit for bit (the losses, minutes of CPU, it does not recompute). Not
collected by pytest.
"""

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "artifacts", "refine_probe_inputs.npz")
ROOMS, ITERS, SIGMA, SEED = 8, 60, 1.0, 13


def probe_setup():
    """(cfg, model, variables, batch, z0, noise (ITERS, B, O)) as the JAX
    tool builds them."""
    import jax
    import jax.numpy as jnp

    from sln_tpu.config import DataConfig, TrainConfig, default_config
    from sln_tpu.data.augment import build_graphs
    from sln_tpu.models.vae import Sg2ScVAE
    from sln_tpu.workloads import common

    cfg = default_config().replace(
        data=DataConfig(max_objects=16, max_triples=48, max_on_rels=16),
        train=TrainConfig(output_dir=os.path.join(REPO, "artifacts"),
                          checkpoint_name="bench"))
    cfg = cfg.replace(refine=dataclasses.replace(cfg.refine, render_size=96,
                                                 num_iters=ITERS))
    va, size_info = common.load_arrays(8, cfg, synthetic_seed=11)
    batch = build_graphs(jax.random.PRNGKey(0), *(
        jnp.asarray(va[k][:ROOMS]) for k in ("objs", "boxes", "angles",
                                             "obj_mask", "room_ids")),
        size_info, max_on_rels=16)
    model, variables = common.restore_model(cfg, example_batch=batch)
    mu, _ = model.apply(variables, batch, False, method=Sg2ScVAE.encode)
    z0 = mu + SIGMA * jax.random.normal(jax.random.PRNGKey(SEED), mu.shape)
    keys = jax.random.split(jax.random.PRNGKey(SEED + 1), ITERS)
    noise = np.stack([np.asarray(jax.random.normal(k, batch.objs.shape)
                                 * cfg.refine.angle_noise_scale)
                      for k in keys])
    return cfg, model, variables, batch, z0, noise


def main():
    import jax
    import jax.numpy as jnp

    from sln_tpu.models.vae import Sg2ScVAE
    from sln_tpu.render import assets, scene as scene_lib
    from sln_tpu.workloads import refine

    cfg, model, variables, batch, z0, noise = probe_setup()
    rcfg = dataclasses.replace(cfg.render, camera=dataclasses.replace(
        cfg.render.camera, image_size=cfg.refine.render_size))
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv)
    midx, target, size_t, room_row = refine.prepare_refine_inputs(
        batch, bank_host, bank, rcfg)
    tx, _, _, run_scan = refine.make_refine_step(
        model, variables["batch_stats"], batch, midx, bank, target, size_t,
        room_row, cfg)
    params = variables["params"]
    state = refine.RefineState(z0, params, tx.init((z0, params)),
                               jnp.zeros((), jnp.int32))
    state, aux = run_scan(state, jax.random.split(
        jax.random.PRNGKey(SEED + 1), ITERS))
    stats = variables["batch_stats"]
    mu, _ = model.apply(variables, batch, False, method=Sg2ScVAE.encode)

    def box_l1(z, p):
        boxes, _ = model.apply({"params": p, "batch_stats": stats}, z, batch,
                               False, method=Sg2ScVAE.decode)
        m = batch.obj_mask[..., None].astype(jnp.float32)
        return float((jnp.abs(boxes - batch.boxes) * m).sum()
                     / jnp.maximum(m.sum() * 6.0, 1.0))

    def iou(z, p):
        return float(refine.decoded_layout_iou(model, stats, batch, z, p))

    record = {
        "box_l1_perturbed": box_l1(z0, params),
        "box_l1_refined": box_l1(state.z, state.params),
        "box_l1_at_z_gt": box_l1(mu, params),
        "iou_perturbed": iou(z0, params),
        "iou_refined": iou(state.z, state.params),
        "iou_at_z_gt": iou(mu, params),
        "z_l1_before": float(jnp.abs(z0 - mu).mean()),
        "z_l1_after": float(jnp.abs(state.z - mu).mean()),
        "loss_first": float(aux["total"][0]),
        "loss_last": float(aux["total"][-1])}
    arrays = {f"batch_{k}": np.asarray(getattr(batch, k))
              for k in batch._fields}
    arrays.update(z0=np.asarray(z0), noise=noise,
                  jax_cpu_totals=np.asarray(aux["total"]),
                  **{f"jax_cpu_{k}": np.float64(v)
                     for k, v in record.items()})
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {record}")


if __name__ == "__main__":
    # as the tests run it: no persistent compilation cache
    os.environ.setdefault("SLN_TPU_COMPILATION_CACHE", "0")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
