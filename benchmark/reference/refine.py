"""Plain PyTorch render-and-refine step (3D-SLN
testing/test_render_refine.py), the reference the benchmark holds the
measured package's refine loop against.

decode(z) -> softargmax angles + noise -> render -> PSP-pyramid depth L1,
multi-scale semantic cross-entropy and size drift -> SGD with Nesterov
momentum on [z at lr_z, the decoder at lr / 10], with the reference's
gradient hooks (box gradients averaged into a translation, 4x angle
gradients). Imports nothing of the measured package.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import render as R


class _FixGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        avg = (g[..., :3] + g[..., 3:]) / 2.0
        return torch.cat([avg, avg], -1)


class _QuadGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 4.0 * g


def resize_matrix(src: int, dst: int, device) -> torch.Tensor:
    """(dst, src) bilinear resize, antialiased when shrinking."""
    eye = torch.eye(src, device=device)[None, None]
    return F.interpolate(eye, size=(dst, src), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    H, W = x.shape[-2:]
    if (H, W) == (size, size):
        return x
    return (resize_matrix(H, size, x.device) @ x
            @ resize_matrix(W, size, x.device).T)


def pyramid(x, sizes):
    return [resize(resize(x, s), sizes[-1]) for s in sizes]


def losses(img, target, sizes):
    """Per-scene (depth, semantic) losses of (B, 70, S, S) renders."""
    null = img[:, 41:].detach().sum(1) < 0.5
    img = torch.cat([img[:, :-1], torch.where(null, 1.0, img[:, -1])[:, None]],
                    1)
    depth = (torch.cat(pyramid(img[:, 41:], sizes), 1)
             - torch.cat(pyramid(target[:, 41:], sizes), 1)
             ).abs().mean((1, 2, 3)) * 0.5
    sem = 0.0
    for li, lt in zip(pyramid(img[:, 1:41], sizes),
                      pyramid(target[:, 1:41], sizes)):
        keep = (lt.sum(1) >= 0.5).to(lt.dtype)
        picked = F.log_softmax(li, 1).gather(1, lt.argmax(1)[:, None])[:, 0]
        sem = sem + (-(picked * keep).sum((1, 2))
                     / keep.sum((1, 2)).clamp(min=1.0)) / 800.0
    return depth, sem


class RefineReference:
    """B scenes refined together from the same inputs the program gets:
    the decoder (eval mode), the scene batch, the encoder's z0 noise,
    each step's angle noise, the bank and the refine settings (`rc`, the
    cell's traffic)."""

    def __init__(self, model, scenes, eps, bank, shells, cam: R.Camera,
                 rc: dict, lr: float):
        self.model, self.b, self.bank, self.shells = model.eval(), scenes, \
            bank, shells
        self.cam, self.rc = cam, rc
        b = scenes
        self.room = b.room_mask
        self.room_row = (b.boxes * self.room[..., None]).sum(1, keepdim=True)
        dims = self.room_row[:, 0, 3:]
        scale6 = torch.cat([dims, dims], -1)[:, None]
        objs = b.objs.cpu().numpy()
        with torch.no_grad():
            mu, logvar = model.encode(b)
            self.z0 = mu + eps * torch.exp(0.5 * logvar)
            midx_gt = torch.as_tensor(R.retrieve(
                objs, (b.boxes * scale6).cpu().numpy(), bank),
                device=b.objs.device)
            self.target = R.render(b.objs, b.boxes, b.angles.to(torch.get_default_dtype()),
                                   b.obj_mask, midx_gt, bank, shells, cam)
            boxes0, _ = model.decode(self.z0, b)
            boxes0 = torch.where(self.room[..., None], self.room_row, boxes0)
            abs0 = boxes0 * scale6
            self.midx = torch.as_tensor(R.retrieve(objs, abs0.cpu().numpy(),
                                                   bank), device=b.objs.device)
            self.size_t = abs0[..., 3:] - abs0[..., :3]
        self.renderable = (torch.as_tensor(R.OBJ_RENDERABLE,
                                           device=b.objs.device)[b.objs]
                           & b.obj_mask & ~self.room)
        self.z = self.z0.clone().requires_grad_(True)
        self.params = [p for p in model.parameters()]
        self.opt = torch.optim.SGD(
            [{"params": [self.z], "lr": rc["lr_z"]},
             {"params": self.params, "lr": lr * rc["lr_model_scale"]}],
            lr=rc["lr_z"], momentum=rc["momentum"], nesterov=True)

    def loss(self, noise):
        b, rc = self.b, self.rc
        boxes, ang_lp = self.model.decode(self.z, b)
        boxes = _FixGrad.apply(boxes)
        boxes = torch.where(self.room[..., None], self.room_row, boxes)
        idx = torch.arange(1, ang_lp.shape[-1] + 1, dtype=ang_lp.dtype,
                           device=ang_lp.device)
        ang = (F.softmax(ang_lp * rc["softargmax_beta"], -1) * idx).sum(-1) \
            - 1.0 + noise
        ang = _QuadGrad.apply(ang)
        ang = torch.where(self.room, b.angles.to(torch.get_default_dtype()), ang)
        img = R.render(b.objs, boxes, ang, b.obj_mask, self.midx, self.bank,
                       self.shells, self.cam)
        depth, sem = losses(img, self.target, tuple(rc["pyramid_sizes"]))
        dims = self.room_row[:, 0, 3:]
        size = ((((boxes[..., 3:] - boxes[..., :3]) * dims[:, None])
                 - self.size_t).square() * self.renderable[..., None]
                ).sum((1, 2)) / 3.0
        wall = (((boxes - self.room_row).square() * self.room[..., None])
                .sum((1, 2)) / (self.room.sum(1) * 6.0))
        return (depth.mean() * 2.0 * rc["depth_loss_weight"]
                + sem.mean() * 800.0 * rc["semantic_loss_weight"]
                + (size + wall).mean() * rc["size_loss_weight"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = {"z": self.z}
        out.update(dict(self.model.named_parameters()))
        return out

    def steps(self, noises, n: int = 3):
        """n steps; returns (losses, first gradients {leaf: grad}, the
        leaves after n steps, the leaves after the first)."""
        hist: List[float] = []
        grads = after1 = None
        for k in range(n):
            self.opt.zero_grad(set_to_none=True)
            total = self.loss(noises[k])
            total.backward()
            if k == 0:
                grads = {name: (None if p.grad is None
                                else p.grad.detach().clone())
                         for name, p in self.leaves().items()}
            self.opt.step()
            if k == 0:
                after1 = {name: p.detach().clone()
                          for name, p in self.leaves().items()}
            hist.append(float(total.detach()))
        return hist, grads, {k: v.detach().clone()
                             for k, v in self.leaves().items()}, after1
