"""Heatmap workload: mass-sample layouts for a word-level scene graph
(counterpart of sln_tpu/workloads/heatmap.py; reference
testing/test_heatmap.py:10-102).

The reference runs 20,000 sequential decoder calls on one 6-node graph;
here the trials are a batch axis: one decode of thousands of identical
graphs with independent z ~ N(mean, cov) per call.

Artifacts keep the JAX package's layout: `<idx>_heat.pkl` holding
[objs, attributes, boxes (num_iter, n, 6) ndarray, []] and plasma heatmap
PNGs.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME, PRED_IDX_TO_NAME
from sln_tpu_torch.models.vae import Sg2ScVAE
from sln_tpu_torch.parallel.mesh import (Mesh, global_from_host_shards,
                                         shard_batch)
from sln_tpu_torch.workloads.posterior import cholesky_factor

HEATMAP_SEED = 0        # the JAX package's PRNGKey(0)
DEFAULT_OBJECTS = ["bed", "desk", "cabinet", "chair", "lamp"]
DEFAULT_RELATIONS = [("bed", "behind", "desk"),
                     ("cabinet", "left of", "bed"),
                     ("chair", "left of", "desk"),
                     ("lamp", "on", "desk")]


def sg_from_words(objs_in_scene: Sequence[str],
                  rels_in_scene: Sequence[Tuple[str, str, str]]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Word-level scene graph -> (objs, triples, attributes) arrays, with
    the 'name:index' syntax for duplicate classes and the appended
    __room__ node + __in_room__ edges (testing/test_utils.py:43-90)."""
    objs = [OBJECT_IDX_TO_NAME.index(name.split(":")[0])
            for name in objs_in_scene]
    names = list(objs_in_scene)
    triples = [[names.index(s), PRED_IDX_TO_NAME.index(rel), names.index(o)]
               for s, rel, o in rels_in_scene]
    n = len(names)
    triples += [[i, 0, n] for i in range(n)]
    objs.append(0)  # __room__
    return (np.array(objs, np.int64), np.array(triples, np.int64),
            np.zeros(len(objs), np.int64))


def heatmap_scene_batch(batch_size: int, max_objects: int, max_triples: int,
                        objects: Sequence[str] = tuple(DEFAULT_OBJECTS),
                        relations=tuple(DEFAULT_RELATIONS),
                        device="cuda") -> SceneBatch:
    """The word scene graph tiled into a padded batch of identical
    scenes on `device`."""
    objs, triples, attrs = sg_from_words(list(objects), list(relations))
    n, t = len(objs), len(triples)
    if n > max_objects or t > max_triples:
        raise ValueError(f"{n} objects / {t} triples exceed the batch's "
                         f"{max_objects} / {max_triples}")
    B = batch_size
    objs_p = np.zeros((B, max_objects), np.int64)
    attrs_p = np.zeros((B, max_objects), np.int64)
    mask_p = np.zeros((B, max_objects), bool)
    triples_p = np.zeros((B, max_triples, 3), np.int64)
    tmask_p = np.zeros((B, max_triples), bool)
    objs_p[:, :n] = objs
    attrs_p[:, :n] = attrs
    mask_p[:, :n] = True
    triples_p[:, :t] = triples
    tmask_p[:, :t] = True

    def t_(x):
        return torch.as_tensor(x, device=device)

    return SceneBatch(
        objs=t_(objs_p), boxes=torch.zeros(B, max_objects, 6, device=device),
        angles=torch.zeros(B, max_objects, dtype=torch.long, device=device),
        attrs=t_(attrs_p), obj_mask=t_(mask_p), triples=t_(triples_p),
        triple_mask=t_(tmask_p),
        room_ids=torch.arange(B, device=device))


def make_sampler(model: Sg2ScVAE, batch: SceneBatch, mean: np.ndarray,
                 cov: np.ndarray, mesh: Optional[Mesh] = None
                 ) -> Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """eps (B, O, d) standard normal -> (boxes (B, O, 6), angles (B, O))
    decoded from z = mean + eps @ L^T, L the host-side float64 Cholesky
    factor of cov + 1e-8 I (on-device sampling + one batched decode in
    place of the reference's per-trial host sampling and decoder call,
    test_heatmap.py:56-62).

    mesh: multi-card serving over a process group (the JAX package's
    heatmap.py:106-128). The caller draws the global eps on every rank;
    each rank decodes its rows of the batch (the decoder runs in eval
    mode, so rows are independent) and the outputs are all-gathered, so
    every rank returns the global batch's layouts."""
    sharded = mesh is not None and mesh.distributed
    rows = mesh.rows(batch.objs.shape[0]) if sharded else slice(None)
    if sharded:
        batch = shard_batch(batch, mesh)
    device = batch.objs.device
    chol = torch.as_tensor(cholesky_factor(cov, 1e-8), device=device)
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=device)
    model.eval()

    @torch.inference_mode()
    def sample(eps: torch.Tensor):
        z = mean_t + torch.einsum("bol,kl->bok", eps[rows], chol)
        boxes, angle_lp = model.decode(z, batch)
        angles = angle_lp.argmax(-1)
        if sharded:
            boxes, angles = global_from_host_shards((boxes, angles), mesh)
        return boxes, angles

    return sample


def produce_heatmap(model: Sg2ScVAE, mean, cov, test_dir: str,
                    objects=tuple(DEFAULT_OBJECTS),
                    relations=tuple(DEFAULT_RELATIONS),
                    num_iter: int = 20000, batch_size: int = 4096,
                    room_idx: int = 0, max_objects: int = 8,
                    max_triples: int = 24, device="cuda") -> str:
    """Sample `num_iter` layouts, `batch_size` at a time (fewer when fewer
    are asked for), and write `<idx>_heat.pkl` (the JAX package's format;
    reference test_heatmap.py:63-64)."""
    heat_dir = os.path.join(test_dir, "data", "heat")
    os.makedirs(heat_dir, exist_ok=True)
    batch_size = min(batch_size, num_iter)
    batch = heatmap_scene_batch(batch_size, max_objects, max_triples,
                                objects, relations, device)
    sample = make_sampler(model, batch, mean, cov)
    n_valid = int(batch.obj_mask[0].sum())
    gen = torch.Generator(device).manual_seed(HEATMAP_SEED)
    shape = (batch_size, max_objects, len(mean))

    all_boxes: List[np.ndarray] = []
    done = 0
    while done < num_iter:
        boxes, _ = sample(torch.randn(shape, generator=gen, device=device))
        take = min(batch_size, num_iter - done)
        all_boxes.append(boxes[:take, :n_valid].cpu().numpy())
        done += take
    boxes_np = np.concatenate(all_boxes, axis=0)      # (num_iter, n, 6)

    objs_arr, _, attrs_arr = sg_from_words(list(objects), list(relations))
    path = os.path.join(heat_dir, str(room_idx).zfill(4) + "_heat.pkl")
    with open(path, "wb") as f:
        pickle.dump([objs_arr, attrs_arr, boxes_np, []], f)
    return path


def plot_heatmap(heat_pkl_path: str, save_dir: str,
                 clip_coor: bool = True) -> List[str]:
    """100x100 occupancy histograms of box centres -> plasma PNGs, one per
    object (testing/test_heatmap.py:66-102; each trial's boxes scaled by
    that trial's predicted room box)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(heat_pkl_path, "rb") as f:
        heat = pickle.load(f)
    idx = os.path.basename(heat_pkl_path).split("_")[0]
    boxes = np.asarray(heat[2])                      # (trials, n, 6)
    size = 100
    os.makedirs(save_dir, exist_ok=True)

    room = boxes[:, -1]                               # (trials, 6)
    dims = room[:, 3:] - room[:, :3]
    scale = np.concatenate([dims, dims], axis=-1)[:, None, :]
    scaled = boxes * scale
    centers = (scaled[..., :3] + scaled[..., 3:]) * 0.5   # (trials, n, 3)

    out_paths = []
    for obj_type in range(boxes.shape[1] - 1):
        ct = centers[:, obj_type]
        if clip_coor:
            ct = np.clip(ct, 0.0, 1.0)
            keep = np.ones(len(ct), bool)
        else:
            keep = np.all((ct > 0) & (ct < 1), axis=-1)
        rd = np.floor(ct[keep] * (size - 1)).astype(int)
        container = np.zeros((size, size))
        np.add.at(container, (rd[:, 2], rd[:, 0]), 1.0)
        container = container / max(container.sum(), 1.0)
        plt.imshow(container, cmap="plasma")
        plt.tight_layout()
        plt.gca().axes.get_yaxis().set_visible(False)
        plt.gca().axes.get_xaxis().set_visible(False)
        path = os.path.join(save_dir, f"{idx}_{str(obj_type).zfill(2)}.png")
        plt.savefig(path)
        plt.close()
        out_paths.append(path)
    return out_paths
