"""Refinement-quality probe on a trained checkpoint (the port's counterpart
of the JAX package's tools/eval_refinement_quality.py: the same flags,
protocol and JSON keys).

    python -m sln_tpu_torch.tools.eval_refinement_quality \\
        --output_dir artifacts --checkpoint_name bench [--rooms 8] \\
        [--sigma 1.0] [--num_iters 60] [--lr_z 0] [--render_size 96] \\
        [--seed 13] [--device cuda|cpu]

For B synthetic val rooms (seed 11, graphs drawn with a generator seeded
0): encode the GT layout to z_gt = mu, perturb z0 = z_gt + sigma * eps (eps
from a torch.Generator seeded with --seed), and run the render-and-refine
loop (workloads/refine.py Refiner, both CUDA rasterizer kernels on the
card; its angle noise from a generator seeded with --seed + 1) against the
GT render. Prints one JSON line: box-L1, rotated-cuboid layout IoU and z
distance before the loop, after it and at z_gt, the fraction of the box-L1
gap recovered, and the first and last render loss. The loop's objective is
the render loss, not the boxes (reference test_render_refine.py), so the
IoU says whether refining the render also helps the layout.

It runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sln_tpu_torch import resolve_device
from sln_tpu_torch.config import Config, DataConfig, TrainConfig, \
    default_config
from sln_tpu_torch.data.augment import build_graphs
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE
from sln_tpu_torch.render import assets, scene as scene_lib
from sln_tpu_torch.workloads import common, refine

VAL_SEED = 11       # the synthetic val rooms (the JAX tool's seed)
GRAPH_SEED = 0      # the graph draws
# the printed record's keys and the digits the JAX tool rounds them to
DIGITS = {"box_l1_perturbed": 5, "box_l1_refined": 5, "box_l1_at_z_gt": 5,
          "iou_perturbed": 4, "iou_refined": 4, "iou_at_z_gt": 4,
          "recovered_fraction": 4, "z_l1_before": 5, "z_l1_after": 5,
          "loss_first": 4, "loss_last": 4}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", default="./checkpoints")
    p.add_argument("--checkpoint_name", default="latest_checkpoint")
    p.add_argument("--rooms", type=int, default=4)
    p.add_argument("--sigma", type=float, default=1.0,
                   help="z perturbation scale")
    p.add_argument("--num_iters", type=int, default=60)
    p.add_argument("--lr_z", type=float, default=0.0,
                   help="override RefineConfig.lr_z (0 = reference 2e-4)")
    p.add_argument("--render_size", type=int, default=96)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def probe_config(args: argparse.Namespace) -> Config:
    cfg = default_config().replace(
        data=DataConfig(max_objects=16, max_triples=48, max_on_rels=16),
        train=TrainConfig(output_dir=args.output_dir,
                          checkpoint_name=args.checkpoint_name))
    over = dict(render_size=args.render_size, num_iters=args.num_iters)
    if args.lr_z > 0:
        over["lr_z"] = args.lr_z
    return cfg.replace(refine=dataclasses.replace(cfg.refine, **over))


def val_batch(cfg: Config, rooms: int, device) -> SceneBatch:
    arrays, size_info = common.load_arrays(max(rooms, 8), cfg, device,
                                           synthetic_seed=VAL_SEED)

    def t(k):
        return torch.as_tensor(arrays[k][:rooms], device=device)

    return build_graphs(t("objs"), t("boxes"), t("angles"), t("obj_mask"),
                        t("room_ids"), size_info,
                        max_on_rels=cfg.data.max_on_rels,
                        generator=torch.Generator(device).manual_seed(
                            GRAPH_SEED))


@torch.no_grad()
def box_l1(model: Sg2ScVAE, batch: SceneBatch, z: torch.Tensor) -> float:
    """Mean |decoded box - GT box| over the real slots' 6 coordinates."""
    boxes_pred, _ = model.decode(z, batch)
    m = batch.obj_mask[..., None].float()
    return float((boxes_pred - batch.boxes).abs().mul(m).sum()
                 / (m.sum() * 6.0).clamp(min=1.0))


def probe(model: Sg2ScVAE, batch: SceneBatch, cfg: Config, sigma: float,
          seed: int, z0: Optional[torch.Tensor] = None,
          noises: Optional[torch.Tensor] = None
          ) -> Tuple[Dict[str, float], np.ndarray]:
    """The experiment on one batch; `model` (eval mode) is left as it is,
    the loop refines a copy. z0 (default: z_gt + sigma * eps, eps drawn
    with `seed`) and the per-iteration angle noise (num_iters, B, O)
    (default: drawn with seed + 1) can be given, e.g. the JAX package's
    draws. Returns the record with unrounded values and the per-iteration
    total losses."""
    device = batch.objs.device
    rcfg = refine.refine_render_config(cfg)
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device=device)
    with torch.no_grad():
        z_gt, _ = model.encode(batch)               # the posterior mean
    if z0 is None:
        gen = torch.Generator(device).manual_seed(seed)
        z0 = z_gt + sigma * torch.randn(z_gt.shape, device=device,
                                        generator=gen)
    midx, target, size_t, room_row = refine.prepare_refine_inputs(
        batch, bank_host, bank, rcfg)
    refiner = refine.make_refine_step(
        copy.deepcopy(model), batch, midx, bank, target, size_t, room_row,
        cfg, z0, torch.Generator(device).manual_seed(seed + 1))

    l1_before = box_l1(model, batch, z0)
    iou_before = float(refine.decoded_layout_iou(model, batch, z0))
    if noises is None:
        hist = refiner.run(cfg.refine.num_iters)["total"]
    else:
        hist = torch.stack([refiner.step(n)["total"] for n in noises])
    hist = hist.cpu().numpy()
    z = refiner.z.detach()
    l1_after = box_l1(refiner.model, batch, z)
    iou_after = float(refine.decoded_layout_iou(refiner.model, batch, z))
    l1_gtz = box_l1(model, batch, z_gt)
    iou_gtz = float(refine.decoded_layout_iou(model, batch, z_gt))
    return {
        "rooms": batch.objs.shape[0], "sigma": sigma,
        "iters": len(hist),
        "box_l1_perturbed": l1_before, "box_l1_refined": l1_after,
        "box_l1_at_z_gt": l1_gtz,
        "iou_perturbed": iou_before, "iou_refined": iou_after,
        "iou_at_z_gt": iou_gtz,
        "recovered_fraction": (l1_before - l1_after)
        / max(l1_before - l1_gtz, 1e-9),
        "z_l1_before": float((z0 - z_gt).abs().mean()),
        "z_l1_after": float((z - z_gt).abs().mean()),
        "loss_first": float(hist[0]), "loss_last": float(hist[-1])}, hist


def rounded(record: Dict[str, float]) -> Dict[str, float]:
    """The record as the JAX tool prints it."""
    return {k: round(v, DIGITS[k]) if k in DIGITS else v
            for k, v in record.items()}


def main(argv=None) -> Tuple[Dict[str, float], np.ndarray]:
    """Run the probe, print its JSON line (rounded as the JAX tool rounds
    it) and return the unrounded record and the per-iteration losses."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = probe_config(args)
    batch = val_batch(cfg, args.rooms, device)
    model = common.restore_model(cfg, device)
    record, losses = probe(model, batch, cfg, args.sigma, args.seed)
    print(json.dumps(rounded(record)), flush=True)
    return record, losses


if __name__ == "__main__":
    main()
