"""Quantitative eval: L1 / scene-graph accuracy / sample-diversity std
(counterpart of sln_tpu/workloads/acc_l1_std.py; reference
testing/test_acc_mean_std.py, `test.py --measure_acc_l1_std`).

The predicate of every GT triple is re-derived from the (predicted,
random or perturbed) boxes with one relation_matrix per batch, as the
reference's per-triple oracle (testing/test_utils.py:135-152) does.
Baselines: random-box scenes (same sizes, uniform centres,
test_utils.py:93-116) and Gaussian-perturbed GT boxes
(test_acc_mean_std.py:113-114).

Each per-batch function takes its random numbers as tensors (`EvalDraws`,
`StdDraws`); the loops draw them from torch.Generators seeded `seed` and
`seed + 1`, the JAX package's integers.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import (GraphDraws, SizeInfo, denormalize,
                                        draw_graph_randomness)
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.data.vocab import ROOM_IDX
from sln_tpu_torch.models.vae import Sg2ScVAE
from sln_tpu_torch.ops.relations import P_IN_ROOM, relation_matrix
from sln_tpu_torch.workloads import posterior


class EvalDraws(NamedTuple):
    """The random numbers of one run_acc_l1 batch."""
    graph: GraphDraws
    eps: torch.Tensor           # (B, O, d) standard normal: z noise
    center: torch.Tensor        # (B, O, 3) uniform [0, 1): random centres
    angle: torch.Tensor         # (B, O) int in [0, 24): random angles
    offset: torch.Tensor        # (B, O, 3) standard normal: perturbation


class StdDraws(NamedTuple):
    """The random numbers of one run_std batch."""
    graph: GraphDraws
    eps: torch.Tensor           # (nsample, B, O, d) standard normal


def scene_graph_acc_batch(objs, obj_mask, triples, triple_mask, boxes
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num correct, num triples) for a padded batch.

    Boxes are denormalized with each scene's own (predicted or perturbed)
    room box, the geometric oracle re-derives each triple's predicate,
    and a triple whose object is the __room__ node matches iff its GT
    predicate is __in_room__ (the oracle short-circuits on the room)."""
    room_mask = (objs == ROOM_IDX) & obj_mask
    relmat = relation_matrix(denormalize(boxes, room_mask))     # (B, O, O)
    s, p, o = (triples[..., k].long() for k in range(3))
    O = objs.shape[1]
    derived = torch.gather(relmat.reshape(relmat.shape[0], O * O), 1,
                           s * O + o)
    o_is_room = torch.gather(room_mask, 1, o)
    derived = torch.where(o_is_room, P_IN_ROOM, derived)
    good = ((derived == p) & triple_mask).sum()
    return good, triple_mask.sum()


def random_scene(objs, boxes, center, angle
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-box baseline: sizes kept, centres `center` (B, O, 3),
    angles `angle` (B, O); the room rows unchanged."""
    size = boxes[..., 3:] - boxes[..., :3]
    rand = torch.cat([center - size / 2, center + size / 2], -1)
    room = (objs == ROOM_IDX)
    return torch.where(room[..., None], boxes, rand), angle


def perturbed_scene(boxes, offset) -> torch.Tensor:
    """GT + 0.1 * offset (standard normal, (B, O, 3)) on both corners of
    every row (test_acc_mean_std.py:113)."""
    off = 0.1 * offset
    return boxes + torch.cat([off, off], -1)


def masked_l1(pred, target, mask) -> torch.Tensor:
    m = mask.to(torch.float32)[..., None]
    n = (m.sum() * pred.shape[-1]).clamp(min=1.0)
    return ((pred - target).abs() * m).sum() / n


def draw_eval(B: int, O: int, d: int, generator: torch.Generator, device
              ) -> EvalDraws:
    return EvalDraws(
        graph=draw_graph_randomness(B, O, generator, device),
        eps=posterior.draw_eps((B, O), d, generator, device),
        center=torch.rand(B, O, 3, generator=generator, device=device),
        angle=torch.randint(0, 24, (B, O), generator=generator,
                            device=device),
        offset=torch.randn(B, O, 3, generator=generator, device=device))


def eval_acc_l1_batch(model: Sg2ScVAE, batch: SceneBatch, mean, cov,
                      draws: EvalDraws) -> Dict[str, torch.Tensor]:
    """l1_<name>, good_<name> and total_<name> for name in pred (decoded
    from z ~ N(mean, cov)), rand and pert; `batch` was built with
    draws.graph."""
    z = posterior.sample_z(mean, cov, draws.eps)
    boxes_pred, _ = model.decode(z, batch)
    boxes_rand, _ = random_scene(batch.objs, batch.boxes, draws.center,
                                 draws.angle)
    boxes_pert = perturbed_scene(batch.boxes, draws.offset)
    out = {}
    for name, bx in (("pred", boxes_pred), ("rand", boxes_rand),
                     ("pert", boxes_pert)):
        out[f"l1_{name}"] = masked_l1(bx, batch.boxes, batch.obj_mask)
        good, total = scene_graph_acc_batch(
            batch.objs, batch.obj_mask, batch.triples, batch.triple_mask,
            bx)
        out[f"good_{name}"], out[f"total_{name}"] = good, total
    return out


def _eval_batches(val_arrays, batch_size):
    """(start, row indices, object mask) of each batch; a short last batch
    is wrapped with row 0 and its padding rows masked out."""
    n = val_arrays["objs"].shape[0]
    for start in range(0, n, batch_size):
        idx, take = posterior.padded_rows(n, start, batch_size)
        mask = val_arrays["obj_mask"][idx].copy()
        mask[take:] = False
        yield start, idx, mask


def run_acc_l1(model: Sg2ScVAE, val_arrays: Dict[str, np.ndarray],
               size_info: SizeInfo, cfg: Config, mean: np.ndarray,
               cov: np.ndarray, batch_size: int = 256, seed: int = 0,
               device="cuda",
               draw_fn: Optional[Callable[[int, int, int], EvalDraws]] = None
               ) -> Dict[str, float]:
    """Reference get_acc_l1 (test_acc_mean_std.py:71-125)."""
    d = model.cfg.latent_dim
    if draw_fn is None:
        gen = torch.Generator(device).manual_seed(seed)

        def draw_fn(start, B, O):
            return draw_eval(B, O, d, gen, device)

    l1s = {"pred": [], "rand": [], "pert": []}
    goods = {"pred": 0, "rand": 0, "pert": 0}
    totals = 0
    O = val_arrays["objs"].shape[1]
    model.eval()
    with torch.inference_mode():
        for start, idx, mask in _eval_batches(val_arrays, batch_size):
            draws = draw_fn(start, batch_size, O)
            batch = posterior.scene_batch(val_arrays, idx, size_info, cfg,
                                          draws.graph, device, mask)
            out = eval_acc_l1_batch(model, batch, mean, cov, draws)
            out = {k: v.item() for k, v in out.items()}
            for name in ("pred", "rand", "pert"):
                l1s[name].append(out[f"l1_{name}"])
                goods[name] += int(out[f"good_{name}"])
            totals += int(out["total_pred"])

    result = {}
    for name in ("pred", "rand", "pert"):
        result[f"l1_{name}"] = float(np.mean(l1s[name]))
        result[f"acc_{name}"] = goods[name] / max(totals, 1)
    result["total_triples"] = totals
    return result


def decode_samples(model: Sg2ScVAE, batch: SceneBatch, z: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (S, B, O, d) -> boxes (S, B, O, box_dim), angle logprobs
    (S, B, O, 24), decoded as ONE batch of S * B scenes (exact: BatchNorm
    is in eval mode, so scenes do not interact)."""
    S = z.shape[0]
    rep = SceneBatch(*(x.repeat((S,) + (1,) * (x.dim() - 1))
                       for x in batch))
    boxes, angle_lp = model.decode(z.reshape((-1,) + z.shape[2:]), rep)
    return (boxes.reshape(z.shape[:3] + boxes.shape[2:]),
            angle_lp.reshape(z.shape[:3] + angle_lp.shape[2:]))


def masked_std(samples: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """samples (S, B, O[, k]) -> the population std over S (jnp.std),
    averaged over the valid objects (and the k components)."""
    sd = samples.std(dim=0, correction=0)
    m = mask.to(torch.float32)
    mn = m.sum().clamp(min=1.0)
    if sd.dim() == 3:
        return (sd * m[..., None]).sum() / (mn * sd.shape[-1])
    return (sd * m).sum() / mn


def std_batch(model: Sg2ScVAE, batch: SceneBatch, mean, cov,
              eps: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(angle std, position std, size std) of the decodes of
    z = sample_z(mean, cov, eps), eps (S, B, O, d)."""
    boxes_s, angle_lp = decode_samples(model, batch,
                                       posterior.sample_z(mean, cov, eps))
    angles_s = angle_lp.argmax(-1).float()
    pos = (boxes_s[..., :3] + boxes_s[..., 3:]) / 2.0
    size = (boxes_s[..., :3] - boxes_s[..., 3:]).abs()
    m = batch.obj_mask
    return masked_std(angles_s, m), masked_std(pos, m), masked_std(size, m)


def run_std(model: Sg2ScVAE, val_arrays: Dict[str, np.ndarray],
            size_info: SizeInfo, cfg: Config, mean: np.ndarray,
            cov: np.ndarray, nsample: int = 10, batch_size: int = 256,
            seed: int = 0, device="cuda",
            draw_fn: Optional[Callable[[int, int, int], StdDraws]] = None
            ) -> Dict[str, float]:
    """Reference get_std (test_acc_mean_std.py:10-69): per-object std of
    angle / position / size over `nsample` decodes, averaged."""
    d = model.cfg.latent_dim
    if draw_fn is None:
        gen = torch.Generator(device).manual_seed(seed + 1)

        def draw_fn(start, B, O):
            return StdDraws(draw_graph_randomness(B, O, gen, device),
                            posterior.draw_eps((nsample, B, O), d, gen,
                                               device))

    stds = {"angle": [], "pos": [], "size": []}
    O = val_arrays["objs"].shape[1]
    model.eval()
    with torch.inference_mode():
        for start, idx, mask in _eval_batches(val_arrays, batch_size):
            draws = draw_fn(start, batch_size, O)
            batch = posterior.scene_batch(val_arrays, idx, size_info, cfg,
                                          draws.graph, device, mask)
            a, p, s = std_batch(model, batch, mean, cov, draws.eps)
            stds["angle"].append(a.item())
            stds["pos"].append(p.item())
            stds["size"].append(s.item())
    return {f"std_{k}": float(np.mean(v)) for k, v in stds.items()}
