"""batch_gen workload: posterior cache + 4 sampled layouts per val room
(counterpart of sln_tpu/workloads/batch_gen.py; reference
testing/test_VAE.py:9-119, `test.py --batch_gen`).

Writes `<test_dir>/mean_cov.pkl` and `<test_dir>/data/data_extracted.json`
with per-room 'gt' and '0'..'3' predicted layouts, the JAX package's
keys.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import (GraphDraws, SizeInfo,
                                        draw_graph_randomness)
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE
from sln_tpu_torch.workloads import posterior
from sln_tpu_torch.workloads.acc_l1_std import decode_samples

NSAMPLE = 4             # reference test_VAE.py:71
BATCH_GEN_SEED = 7      # the JAX package's PRNGKey(7)


class GenDraws(NamedTuple):
    """The random numbers of one batch_gen batch."""
    graph: GraphDraws
    eps: torch.Tensor           # (NSAMPLE, B, O, d) standard normal


def room_records(batch: SceneBatch, boxes: np.ndarray, angles: np.ndarray,
                 take: int) -> Dict[int, dict]:
    """The first `take` scenes of a batch as data_extracted.json entries:
    room id -> {'gt': objs, angles, boxes, triples; '0'..: angles, boxes}
    of the sampled layouts boxes (S, B, O, 6), angles (S, B, O)."""
    objs = batch.objs.cpu().numpy()
    mask = batch.obj_mask.cpu().numpy()
    tmask = batch.triple_mask.cpu().numpy()
    triples = batch.triples.cpu().numpy()
    gt_boxes = batch.boxes.cpu().numpy()
    gt_angles = batch.angles.cpu().numpy()
    room_ids = batch.room_ids.cpu().numpy()
    data = {}
    for b in range(take):
        nv = int(mask[b].sum())
        room = {"gt": {"objs": objs[b, :nv].tolist(),
                       "angles": gt_angles[b, :nv].tolist(),
                       "boxes": gt_boxes[b, :nv].tolist(),
                       "triples": triples[b][tmask[b]].tolist()}}
        for k in range(boxes.shape[0]):
            room[str(k)] = {"angles": angles[k, b, :nv].tolist(),
                            "boxes": boxes[k, b, :nv].tolist()}
        data[int(room_ids[b])] = room
    return data


def run_batch_gen(model: Sg2ScVAE, train_arrays: Dict[str, np.ndarray],
                  val_arrays: Dict[str, np.ndarray], size_info: SizeInfo,
                  cfg: Config, test_dir: str, batch_size: int = 256,
                  device="cuda",
                  draw_fn: Optional[Callable[[int, int, int], GenDraws]] = None
                  ) -> str:
    """Sample NSAMPLE layouts of every val room from the (cached)
    posterior and write data_extracted.json; returns its path."""
    test_data_dir = os.path.join(test_dir, "data")
    os.makedirs(test_data_dir, exist_ok=True)
    mean, cov = posterior.get_or_compute_mean_cov(
        model, train_arrays, size_info, cfg, test_dir, device)
    d = model.cfg.latent_dim
    if draw_fn is None:
        gen = torch.Generator(device).manual_seed(BATCH_GEN_SEED)

        def draw_fn(start, B, O):
            return GenDraws(draw_graph_randomness(B, O, gen, device),
                            posterior.draw_eps((NSAMPLE, B, O), d, gen,
                                               device))

    data = {}
    n, O = val_arrays["objs"].shape
    model.eval()
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            idx, take = posterior.padded_rows(n, start, batch_size)
            draws = draw_fn(start, batch_size, O)
            batch = posterior.scene_batch(val_arrays, idx, size_info, cfg,
                                          draws.graph, device)
            boxes, angle_lp = decode_samples(
                model, batch, posterior.sample_z(mean, cov, draws.eps))
            data.update(room_records(batch, boxes.cpu().numpy(),
                                     angle_lp.argmax(-1).cpu().numpy(),
                                     take))

    out_path = os.path.join(test_data_dir, "data_extracted.json")
    with open(out_path, "w") as f:
        json.dump(data, f)
    return out_path
