"""Render-and-refine: per-room latent optimization against rendered targets
(counterpart of sln_tpu/workloads/refine.py; reference
testing/test_render_refine.py).

    decode(z) -> softargmax angles (+noise) -> assemble scene -> soft
    rasterize -> PSP-pyramid depth L1 + multi-scale semantic CE + size
    drift MSE -> SGD(nesterov) on [z, model params at lr/10]

Gradient shaping matches the reference hooks: `fix_grad` (box gradients
averaged into translation-only, :220-225) and `quad_grad` (4x angle
gradients, :227-230). Mesh retrieval and object sizes are frozen at
iteration 0 (diff_render.py:55-60, 84-89).

Differences from the JAX package, by design: the model parameters are
updated in place (finetune_rooms refines a copy per room, so the caller's
model is untouched); randomness (graph draws, z0, angle noise) comes from
explicit torch.Generators, whose streams differ from JAX's threefry; the
per-room artifacts are the pkl files only (no GIF/PNG renders).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import SizeInfo, build_graphs
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.models.vae import Sg2ScVAE, reparameterize
from sln_tpu_torch.render import assets, scene as scene_lib


# ---------------------------------------------------------------------------
# gradient-shaping hooks (reference :220-230)
# ---------------------------------------------------------------------------
class FixGrad(torch.autograd.Function):
    """Identity; the box gradient's min and max halves are averaged, so
    a box only translates (reference :220-225)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        avg = g[..., :3] / 2.0 + g[..., 3:] / 2.0
        return torch.cat([avg, avg], -1)


class QuadGrad(torch.autograd.Function):
    """Identity with a 4x gradient (reference :227-230)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 4.0 * g


def fix_grad(x: torch.Tensor) -> torch.Tensor:
    return FixGrad.apply(x)


def quad_grad(x: torch.Tensor) -> torch.Tensor:
    return QuadGrad.apply(x)


def softargmax(logprobs: torch.Tensor, beta: float = 2.0) -> torch.Tensor:
    """Differentiable angle index (reference softargmax :20-25):
    sum(softmax(x * beta) * (1..N)) - 1 over the last axis."""
    idx = torch.arange(1, logprobs.shape[-1] + 1, dtype=logprobs.dtype,
                       device=logprobs.device)
    return (F.softmax(logprobs * beta, -1) * idx).sum(-1) - 1.0


def angle_noise(shape, scale: float, generator: torch.Generator,
                device) -> torch.Tensor:
    """The reference's angle jitter (:293): N(0, 1) * scale."""
    return torch.randn(shape, generator=generator, device=device) * scale


# ---------------------------------------------------------------------------
# PSP pyramid losses (reference PSP_pool_new :192-217 and :334-356)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def resize_matrix(src: int, dst: int) -> np.ndarray:
    """1-D bilinear resize as a (dst, src) matrix. Resizing is separable
    and linear, so two matmuls replace the gather-based resize. Built the
    way jax.image.resize builds it: when downsampling, the triangle kernel
    is widened by src/dst (antialiasing), which plain bilinear
    interpolation does not do."""
    eye = torch.eye(src, dtype=torch.float32)[None, None]
    m = F.interpolate(eye, size=(dst, src), mode="bilinear",
                      align_corners=False, antialias=True)
    return m[0, 0].numpy().astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_t(src: int, dst: int, device: torch.device) -> torch.Tensor:
    """resize_matrix on `device`, copied there once."""
    return torch.as_tensor(resize_matrix(src, dst), device=device)


def psp_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size) bilinear (matmul formulation)."""
    H, W = x.shape[-2:]
    if H == size and W == size:
        return x
    mh = _resize_t(H, size, x.device)
    mw = _resize_t(W, size, x.device)
    return mh @ x @ mw.T


def psp_pyramid(x: torch.Tensor, sizes=(32, 48, 64, 96)):
    """List of (B, C, max, max): downsample to s then back up to max."""
    mx = sizes[-1]
    return [psp_resize(psp_resize(x, s), mx) for s in sizes]


def target_pyramids(target_img: torch.Tensor, sizes=(32, 48, 64, 96)):
    """Loss-side terms that depend only on the fixed (B, 70, S, S) target:
    (depth pyramid (B, 29*len(sizes), m, m), [per-scale argmax labels
    (B, m, m)], [per-scale ignore masks (B, m, m)])."""
    depth_tg = torch.cat(psp_pyramid(target_img[:, 41:], sizes), 1)
    labels_tg = psp_pyramid(target_img[:, 1:41], sizes)
    tgts = [lt.argmax(1) for lt in labels_tg]
    ignores = [lt.sum(1) < 0.5 for lt in labels_tg]             # :344
    return depth_tg, tgts, ignores


def refine_losses_pre(iter_img: torch.Tensor, depth_tg, tgts, ignores,
                      sizes=(32, 48, 64, 96)
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scene (depth (B,), semantic (B,)) losses of a (B, 70, S, S)
    render against precomputed target pyramids."""
    # fill null regions of the last depth channel (reference :332)
    null = iter_img[:, 41:].detach().sum(1) < 0.5
    last = torch.where(null, 1.0, iter_img[:, -1])
    iter_img = torch.cat([iter_img[:, :-1], last[:, None]], 1)

    depth_in = torch.cat(psp_pyramid(iter_img[:, 41:], sizes), 1)
    depth_loss = (depth_in - depth_tg).abs().mean((1, 2, 3)) * 0.5  # :350

    sem_loss = 0.0
    for li, tgt, ignore in zip(psp_pyramid(iter_img[:, 1:41], sizes),
                               tgts, ignores):
        logp = F.log_softmax(li, 1)
        picked = torch.gather(logp, 1, tgt[:, None])[:, 0]
        keep = (~ignore).float()
        n = keep.sum((1, 2)).clamp(min=1.0)
        sem_loss = sem_loss + (-(picked * keep).sum((1, 2)) / n) / 800.0
    return depth_loss, sem_loss


def refine_losses(iter_img, target_img, sizes=(32, 48, 64, 96)):
    """iter/target: (B, 70, S, S) render stacks -> per-scene (depth,
    semantic) losses."""
    return refine_losses_pre(iter_img, *target_pyramids(target_img, sizes),
                             sizes)


# ---------------------------------------------------------------------------
# the refinement step
# ---------------------------------------------------------------------------
def refine_render_config(cfg: Config):
    return dataclasses.replace(cfg.render, camera=dataclasses.replace(
        cfg.render.camera, image_size=cfg.refine.render_size))


def refine_optimizer(z: torch.Tensor, params, cfg: Config
                     ) -> torch.optim.SGD:
    """SGD with Nesterov momentum on two groups: z at lr_z, the model at
    lr * lr_model_scale. torch's update (buf = m*buf + g; step
    g + m*buf) is optax.sgd(nesterov=True)'s (trace t = g + m*t; update
    g + m*t) under the JAX package's multi_transform."""
    ref = cfg.refine
    return torch.optim.SGD(
        [{"params": [z], "lr": ref.lr_z},
         {"params": list(params),
          "lr": cfg.train.learning_rate * ref.lr_model_scale}],
        lr=ref.lr_z, momentum=ref.momentum, nesterov=ref.nesterov)


class Refiner:
    """Refine B scenes together (B=1 reproduces the reference loop).

    batch: (B, ...) SceneBatch; model_idx: (B, O); target_img:
    (B, 70, S, S); size_targets: (B, O, 3); room_row_gt: (B, 1, 6);
    z0: (B, O, latent). Each scene renders independently; the optimizer
    moves on the mean of per-scene totals.

    B>1 shares ONE set of model parameters across the rooms and steps them
    on the mean of per-room gradients (each room's z row still gets its own
    gradient), as the JAX package's batched serving configuration does; the
    reference fine-tunes the parameters per room, which B=1 reproduces.

    `model` is updated in place: pass a copy to keep the original.
    """

    def __init__(self, model: Sg2ScVAE, batch: SceneBatch, model_idx,
                 bank: scene_lib.DeviceBank, target_img, size_targets,
                 room_row_gt, cfg: Config, z0: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        ref = self.ref = cfg.refine
        self.model = model.eval()
        self.batch, self.model_idx, self.bank = batch, model_idx, bank
        self.size_targets, self.room_row_gt = size_targets, room_row_gt
        self.rcfg = refine_render_config(cfg)
        device = z0.device
        if generator is None:
            generator = torch.Generator(device).manual_seed(ref.seed + 1)
        self.generator = generator
        self.room_mask = batch.room_mask
        self.renderable = (bank.obj_renderable[batch.objs] & batch.obj_mask
                           & ~self.room_mask)
        self.angles_gt = batch.angles.float()
        with torch.no_grad():
            self.tg_pyr = target_pyramids(target_img, ref.pyramid_sizes)
        self.z = z0.detach().clone().requires_grad_(True)
        self.opt = refine_optimizer(self.z, model.parameters(), cfg)
        self.k = 0              # steps taken
        self.noises: List[torch.Tensor] = []

    def draw_noise(self) -> torch.Tensor:
        return angle_noise(self.batch.objs.shape, self.ref.angle_noise_scale,
                           self.generator, self.z.device)

    def noise(self, k: int) -> torch.Tensor:
        """Step k's angle noise. The generator is drawn in step order
        only, once per step, so reading a step's noise ahead of the step
        (a snapshot) moves no step's noise (the JAX package splits its
        keys once and reuses keys[k])."""
        while len(self.noises) <= k:
            self.noises.append(self.draw_noise())
        return self.noises[k]

    def forward(self, noise: torch.Tensor):
        """(total, aux dict, imgs (B, 70, S, S), boxes_pred, angles)."""
        ref, batch = self.ref, self.batch
        boxes_pred, angle_lp = self.model.decode(self.z, batch)
        boxes_pred = fix_grad(boxes_pred)                  # hook :288
        # clamp the room row to GT (:291), which also kills its gradient
        boxes_pred = torch.where(self.room_mask[..., None],
                                 self.room_row_gt, boxes_pred)
        ang = softargmax(angle_lp, ref.softargmax_beta) + noise
        ang = quad_grad(ang)                               # hook :297
        ang = torch.where(self.room_mask, self.angles_gt, ang)   # :298

        imgs = scene_lib.render_layout(batch.objs, boxes_pred, ang,
                                       batch.obj_mask, self.model_idx,
                                       self.bank, self.rcfg)
        depth_loss, sem_loss = refine_losses_pre(imgs, *self.tg_pyr,
                                                 ref.pyramid_sizes)
        depth_loss, sem_loss = depth_loss.mean(), sem_loss.mean()

        # size drift (diff_render.py:96-98, 163-164), mean over scenes
        room_dims = self.room_row_gt[:, 0, 3:]
        abs_size = ((boxes_pred[..., 3:] - boxes_pred[..., :3])
                    * room_dims[:, None, :])
        size_loss = ((abs_size - self.size_targets).square()
                     * self.renderable[..., None]).sum((1, 2)) / 3.0
        wall_sq = (boxes_pred - self.room_row_gt).square()
        wall_drift = ((wall_sq * self.room_mask[..., None]).sum((1, 2))
                      / (self.room_mask.sum(1) * 6.0))
        size_total = (size_loss + wall_drift).mean()

        # reference weighting (test_render_refine.py:349-354)
        total = (depth_loss * 2.0 * ref.depth_loss_weight
                 + sem_loss * 800.0 * ref.semantic_loss_weight
                 + size_total * ref.size_loss_weight)
        aux = {"depth_loss": depth_loss, "semantic_loss": sem_loss,
               "size_loss": size_total, "total": total}
        return total, aux, imgs, boxes_pred, ang

    def step(self, noise: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimization step, with step k's noise unless one is given;
        returns the step's detached losses."""
        if noise is None:
            noise = self.noise(self.k)
        self.k += 1
        self.opt.zero_grad(set_to_none=True)
        total, aux, *_ = self.forward(noise)
        total.backward()
        self.opt.step()
        return {k: v.detach() for k, v in aux.items()}

    def run(self, num_iters: int) -> Dict[str, torch.Tensor]:
        """num_iters steps; per-iteration losses stacked on the device
        (no host sync inside the loop)."""
        hist = [self.step() for _ in range(num_iters)]
        return {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    @torch.no_grad()
    def snapshot(self, k: int = 0):
        """Full render + layout for artifact dumps (not in the loop), with
        step k's noise."""
        _, aux, imgs, boxes_pred, ang = self.forward(self.noise(k))
        return aux, imgs, boxes_pred, ang


def make_refine_step(model, batch, model_idx, bank, target_img,
                     size_targets, room_row_gt, cfg: Config, z0,
                     generator=None) -> Refiner:
    """The refinement loop's state and step for B scenes (see Refiner)."""
    return Refiner(model, batch, model_idx, bank, target_img, size_targets,
                   room_row_gt, cfg, z0, generator)


@torch.no_grad()
def prepare_refine_inputs(batch: SceneBatch, bank_host: assets.MeshBank,
                          bank: scene_lib.DeviceBank, rcfg):
    """Batched SceneBatch -> (model_idx, target_img, size_targets,
    room_row_gt): absolute boxes, per-room mesh retrieval (on the host),
    the GT target render, and frozen size targets."""
    room_row = (batch.boxes * batch.room_mask[..., None]).sum(
        1, keepdim=True)                                      # (B, 1, 6)
    dims = room_row[:, 0, 3:]
    abs0 = batch.boxes * torch.cat([dims, dims], -1)[:, None, :]
    midx = torch.as_tensor(
        assets.retrieve_models(batch.objs.cpu().numpy(),
                               abs0.cpu().numpy(), bank_host),
        device=batch.objs.device)
    target = scene_lib.render_layout(batch.objs, batch.boxes,
                                     batch.angles.float(), batch.obj_mask,
                                     midx, bank, rcfg)
    size_t = abs0[..., 3:] - abs0[..., :3]
    return midx, target, size_t, room_row


# ---------------------------------------------------------------------------
# full workload
# ---------------------------------------------------------------------------
def single_scene_batch(val_arrays, size_info: SizeInfo, cfg: Config,
                       room_id, device) -> SceneBatch:
    ids = val_arrays["room_ids"]
    matches = np.where(ids == int(room_id))[0]
    if len(matches) == 0:
        print("Get by room id failed! Defaulting to 0.")
        idx = 0
    else:
        idx = int(matches[0])
    sel = np.array([idx])

    def t(name):
        return torch.as_tensor(val_arrays[name][sel], device=device)

    return build_graphs(t("objs"), t("boxes"), t("angles"), t("obj_mask"),
                        t("room_ids"), size_info,
                        max_on_rels=cfg.data.max_on_rels,
                        use_attr_30=cfg.data.use_attr_30,
                        generator=torch.Generator(device).manual_seed(0))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def finetune_rooms(model: Sg2ScVAE, val_arrays, size_info: SizeInfo,
                   cfg: Config, room_ids, save_dirs,
                   num_iters: Optional[int] = None,
                   device="cuda") -> Dict[str, List[dict]]:
    """Reference finetune_VAE (:243-377), one room at a time. Writes
    z_value.pkl, bbox_rot_<k>.pkl (k = 0 and the last iteration) and
    bbox_rot_gt.pkl into each room's save dir. Returns the per-room loss
    history."""
    ref = cfg.refine
    num_iters = num_iters or ref.num_iters
    rcfg = refine_render_config(cfg)
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device=device)
    history = {}

    for room_id, save_dir in zip(room_ids, save_dirs):
        os.makedirs(save_dir, exist_ok=True)
        room_model = copy.deepcopy(model).eval()
        batch = single_scene_batch(val_arrays, size_info, cfg, room_id,
                                   device)
        with torch.no_grad():
            # z0 from the GT posterior, fixed seed (reference :273-284)
            mu, logvar = room_model.encode(batch)
            z0 = reparameterize(
                mu, logvar, torch.Generator(device).manual_seed(ref.seed))
            with open(os.path.join(save_dir, "z_value.pkl"), "wb") as f:
                pickle.dump(_np(z0), f)

            room_row_gt = (batch.boxes * batch.room_mask[..., None]).sum(
                1, keepdim=True)                              # (1, 1, 6)
            dims = room_row_gt[:, 0, 3:]
            scale6 = torch.cat([dims, dims], -1)[:, None, :]
            # target render from GT (reference :317-321)
            gt_angles = batch.angles.float()
            model_idx_gt = torch.as_tensor(assets.retrieve_models(
                _np(batch.objs), _np(batch.boxes * scale6), bank_host),
                device=device)
            target_img = scene_lib.render_layout(
                batch.objs, batch.boxes, gt_angles, batch.obj_mask,
                model_idx_gt, bank, rcfg)                     # (1, 70, S, S)

            # iteration-0 retrieval + size cache from the PREDICTED layout
            boxes0, _ = room_model.decode(z0, batch)
            boxes0 = torch.where(batch.room_mask[..., None], room_row_gt,
                                 boxes0)
            abs0 = boxes0 * scale6
            model_idx = torch.as_tensor(assets.retrieve_models(
                _np(batch.objs), _np(abs0), bank_host), device=device)
            size_targets = abs0[..., 3:] - abs0[..., :3]

        refiner = make_refine_step(room_model, batch, model_idx, bank,
                                   target_img, size_targets, room_row_gt,
                                   cfg, z0)

        def dump(k):
            _, _, boxes_pred, ang = refiner.snapshot(min(k, num_iters - 1))
            with open(os.path.join(save_dir, f"bbox_rot_{k}.pkl"),
                      "wb") as f:
                pickle.dump([room_id, _np(boxes_pred[0]), _np(ang[0]),
                             _np(size_targets[0]), _np(model_idx[0])], f)

        dump(0)
        stacked = refiner.run(num_iters)
        stacked = {k: _np(v) for k, v in stacked.items()}
        losses = [{k: float(v[i]) for k, v in stacked.items()}
                  for i in range(num_iters)]
        dump(num_iters - 1)
        with open(os.path.join(save_dir, "bbox_rot_gt.pkl"), "wb") as f:
            pickle.dump([room_id, _np(batch.boxes[0]), _np(gt_angles[0])],
                        f)
        history[room_id] = losses
        print(f"room {room_id}: loss {losses[0]['total']:.4f} -> "
              f"{losses[-1]['total']:.4f}")
    return history
