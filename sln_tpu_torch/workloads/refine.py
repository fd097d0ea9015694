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
explicit torch.Generators, whose streams differ from JAX's threefry.

Each room's artifacts are the JAX package's: the pkl files, and the depth
PNG + GIF of the target, of iteration 0 and of the last iteration (with
`save_semantic`, one GIF per NYU-40 class with mass), written with
render/image_io.py, outside the loop.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import pickle
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sln_tpu_torch import trace
from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import SizeInfo, build_graphs
from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.data.vocab import NYU40_CLASSES
from sln_tpu_torch.models.layers import fp32_accumulation
from sln_tpu_torch.models.vae import Sg2ScVAE, reparameterize
from sln_tpu_torch.ops.iou import layout_iou
from sln_tpu_torch.parallel.mesh import (Mesh, all_reduce_flat, replicate,
                                         shard_batch)
from sln_tpu_torch.render import assets, scene as scene_lib
from sln_tpu_torch.render.image_io import write_gif, write_png_gray


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

    mesh: multi-card serving over a process group (the JAX package's
    shard_refine_inputs). Every per-room input is this rank's rooms (by
    its data index: shard_refine_inputs), the sums below run over its data
    group (the ranks of a model group, on a mesh with a model axis, serve
    the same rooms alike), and each rank renders its rooms through both
    kernels. Each room's z keeps its own gradient; each rank's loss is its
    rooms' share of the mean over the global batch (the local mean times
    B_local / B), and the decoder's gradients are summed over the ranks, so
    the shared parameters take the global batch's step, the same on every
    rank. The angle noise is drawn for the global batch and sliced; a
    noise passed to `step` is the global batch's too. The returned losses
    are the global batch's.

    On the card and off a mesh (`replays`), the step is one CUDA graph
    (`StepGraph`) that the host launches instead of the step's ~1,400
    kernels, with the eager step's bits. A card keeps the graph of the
    newest key (`graph_key`: shapes, bank, configurations); a Refiner of
    that key replays it from its own step 0, and only the first Refiner of
    a key runs step 0 eagerly and captures the graph at step 1. The graph
    reads and writes tensors of its own (its slots), and one Refiner at a
    time owns them: binding copies the Refiner's inputs, z, parameters,
    buffers and momentum buffers into the slots, and from then on its z,
    its model's parameters and buffers (`.data`), their `.grad` and its
    momentum buffers ARE the slots, so the model is still updated in
    place. When another Refiner binds, the last owner's tensors get
    private copies of their values; a Refiner that steps again after that
    binds again. The caller's inputs are never written. Hold clones, not
    views, of a Refiner's z or parameters across other Refiners' steps.
    The CPU, a mesh (whose step all-reduces inside) and `snapshot` run
    eagerly.
    """

    def __init__(self, model: Sg2ScVAE, batch: SceneBatch, model_idx,
                 bank: scene_lib.DeviceBank, target_img, size_targets,
                 room_row_gt, cfg: Config, z0: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        ref = self.ref = cfg.refine
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        world = self.mesh.data_size if self.mesh else 1
        self.global_rows = world * batch.objs.shape[0]
        self.rows = (self.mesh.rows(self.global_rows) if self.mesh
                     else slice(None))
        self.share = 1.0 / world          # B_local / B
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
        self.graphed = self.replays(device, self.mesh)
        self._graph: Optional[StepGraph] = None

    @staticmethod
    def replays(device, mesh: Optional[Mesh]) -> bool:
        """Whether a Refiner on `device` under `mesh` replays its step as a
        CUDA graph: on the card, with no process group."""
        return (torch.device(device).type == "cuda"
                and not (mesh is not None and mesh.distributed))

    def graph_key(self) -> tuple:
        """What a captured step depends on besides the values it reads:
        the device; the shapes and dtypes of the per-room inputs (B,
        objects, triples, render and pyramid sizes), of z and of the
        model's parameters and buffers; the model's configuration; the
        bank, by identity (the graph reads its tensors where they lie);
        the configurations the step reads and the optimizer's
        hyperparameters (the graph bakes their scalars in); the matmul
        precision. Refiners of one key replay one graph."""
        def shapes(ts):
            return tuple((tuple(t.shape), t.dtype, t.device) for t in ts)

        hyper = tuple(tuple(sorted((k, v) for k, v in g.items()
                                   if k != "params"))
                      for g in self.opt.param_groups)
        return (self.z.device, shapes(self._inputs()),
                shapes(self._leaves()), self.model.cfg, id(self.bank),
                self.ref, self.rcfg, hyper,
                torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32)

    def _inputs(self) -> List[torch.Tensor]:
        """The per-room tensors the step reads, in a fixed order."""
        depth, tgts, ignores = self.tg_pyr
        return [*self.batch, self.model_idx, self.room_mask,
                self.renderable, self.angles_gt, self.room_row_gt,
                self.size_targets, depth, *tgts, *ignores]

    def _reading(self, inputs: List[torch.Tensor]) -> "Refiner":
        """A shallow copy of this Refiner whose step reads `inputs` (in
        `_inputs`' order) in place of its own."""
        r, it = copy.copy(self), iter(inputs)

        def take(n):
            return [next(it) for _ in range(n)]

        r.batch = SceneBatch(*take(len(self.batch)))
        (r.model_idx, r.room_mask, r.renderable, r.angles_gt,
         r.room_row_gt, r.size_targets, depth) = take(7)
        n = len(self.tg_pyr[1])
        r.tg_pyr = (depth, take(n), take(n))
        return r

    def _leaves(self) -> List[torch.Tensor]:
        """z, then the model's parameters and buffers: the state the step
        updates (the buffers it only reads)."""
        return [self.z, *self.model.parameters(), *self.model.buffers()]

    def draw_noise(self) -> torch.Tensor:
        """The next step's noise for this rank's rooms, drawn for the
        global batch."""
        shape = (self.global_rows, self.batch.objs.shape[1])
        return angle_noise(shape, self.ref.angle_noise_scale,
                           self.generator, self.z.device)[self.rows]

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
        with trace.span("sln.refine.decode"):
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
        with trace.span("sln.refine.losses"):
            total, aux = self._losses(imgs, boxes_pred)
        return total, aux, imgs, boxes_pred, ang

    def _losses(self, imgs, boxes_pred):
        """(total, aux dict) of a render and its boxes."""
        ref = self.ref
        depth_loss, sem_loss = refine_losses_pre(imgs, *self.tg_pyr,
                                                 ref.pyramid_sizes)
        depth_loss, sem_loss = depth_loss.mean(), sem_loss.mean()
        if self.mesh:
            depth_loss, sem_loss = (depth_loss * self.share,
                                    sem_loss * self.share)

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
        if self.mesh:
            size_total = size_total * self.share

        # reference weighting (test_render_refine.py:349-354)
        total = (depth_loss * 2.0 * ref.depth_loss_weight
                 + sem_loss * 800.0 * ref.semantic_loss_weight
                 + size_total * ref.size_loss_weight)
        aux = {"depth_loss": depth_loss, "semantic_loss": sem_loss,
               "size_loss": size_total, "total": total}
        return total, aux

    def _global_aux(self, aux: Dict[str, torch.Tensor], grads=()):
        """The losses detached, summed over the ranks under a mesh with
        `grads` (summed in place) in the same collective."""
        aux = {k: v.detach() for k, v in aux.items()}
        if self.mesh:
            *grads_sum, stacked = all_reduce_flat(
                [*grads, torch.stack(list(aux.values()))], self.mesh)
            for g, s in zip(grads, grads_sum):
                g.copy_(s)
            aux = dict(zip(aux, stacked.unbind()))
        return aux

    def step(self, noise: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimization step, with step k's noise unless one is given;
        returns the step's detached losses (tensors of its own)."""
        with trace.span("sln.refine.step"):
            noise = (self.noise(self.k) if noise is None
                     else noise[self.rows])
            self.k += 1
            if self.graphed and self._graph is None:
                self._graph = self._cached_graph()
                if self._graph is None and self.k > 1:
                    with trace.span("sln.refine.capture"):
                        self._graph = self._capture(noise)
            if self._graph is None:
                return self._step(noise)
            return self._replay(noise)

    def _step(self, noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step, run eagerly."""
        self.opt.zero_grad(set_to_none=True)
        with fp32_accumulation():
            total, aux, *_ = self.forward(noise)
            with trace.span("sln.refine.backward"):
                total.backward()
        with trace.span("sln.refine.update"):
            aux = self._global_aux(aux, [
                p.grad for p in self.model.parameters()
                if p.grad is not None])
            self.opt.step()
        return aux

    def _cached_graph(self) -> Optional[StepGraph]:
        """The card's step graph if its key is this Refiner's (a graph
        another Refiner captured: counted as a reuse)."""
        graph = _step_graphs.get(self.z.device)
        if graph is None or graph.key != self.graph_key():
            return None
        if trace.recording():
            trace.count("refine.graph_reuses")
        return graph

    def _capture(self, noise: torch.Tensor) -> StepGraph:
        """Capture `_step` into a CUDA graph (nothing runs), owned by this
        Refiner and cached for its card: the per-room inputs and the noise
        read from slots of the graph's own (copies); the grads set to None
        first, so the captured backward makes them and each replay
        overwrites them; the losses stacked into a static output. z, the
        parameters, buffers and SGD's momentum buffers (from step 0) are
        this Refiner's. Every graph on a card is captured into one memory
        pool, so a room's graph reuses what the last one let go; an older
        graph may still replay, since no tensor of the pool that a graph
        does not hold carries a value from one replay to the next."""
        device = self.z.device
        inputs = [t.clone() for t in self._inputs()]
        noise_slot = noise.clone()
        reader = self._reading(inputs)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)      # as torch.cuda.graph does
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        last = _step_graphs.get(device)
        with torch.cuda.stream(side), trace.tally() as tally:
            graph.capture_begin(pool=torch.cuda.graph_pool_handle()
                                if last is None else last.graph.pool())
            try:
                aux = reader._step(noise_slot)
                out = torch.stack(list(aux.values()))
            finally:
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        if trace.recording():
            trace.count("refine.graph_captures")
        leaves = self._leaves()
        step_graph = StepGraph(
            self.graph_key(), self.bank, graph, tally, inputs, noise_slot,
            out, list(aux), leaves,
            [self.opt.state[p].get("momentum_buffer")
             for p in _opt_params(self.opt)])
        step_graph.own(self)
        _step_graphs[device] = step_graph
        return step_graph

    def _bind(self, graph: StepGraph) -> None:
        """Make this Refiner the owner of `graph`: the last owner's state
        handed back to it, this Refiner's inputs and state copied into the
        slots, and its z, parameters, buffers, their grads and its
        momentum buffers made the slots. A momentum buffer SGD has not made
        yet becomes -0: SGD's buffer update on it, -0 * m + g, is g bit
        for bit (a -0 too), which is what its first step's clone of g
        is."""
        with trace.span("sln.refine.bind"):
            graph.release()
            leaves = self._leaves()
            torch._foreach_copy_(graph.inputs, self._inputs())
            torch._foreach_copy_(graph.leaves, [t.detach() for t in leaves])
            for t, slot, grad in zip(leaves, graph.leaves, graph.grads):
                t.data = slot
                if grad is not None:
                    t.grad = grad
            fresh = []
            for p, slot in zip(_opt_params(self.opt), graph.moms):
                if slot is None:
                    continue
                state = self.opt.state[p]
                if "momentum_buffer" in state:
                    slot.copy_(state["momentum_buffer"])
                else:
                    fresh.append(slot)
                state["momentum_buffer"] = slot
            if fresh:
                torch._foreach_zero_(fresh)
                torch._foreach_neg_(fresh)
            graph.own(self)

    def _replay(self, noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step as a replay of its graph, bound to this Refiner
        first if another owns it."""
        graph = self._graph
        if not graph.owned_by(self):
            self._bind(graph)
        with trace.span("sln.refine.replay"):
            graph.noise.copy_(noise)
            graph.graph.replay()
            graph.tally.replay()
            if trace.recording():
                trace.count("refine.graph_replays")
            aux = graph.out.clone()
        return dict(zip(graph.aux_keys, aux.unbind()))

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
        return self._global_aux(aux), imgs, boxes_pred, ang


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


class StepGraph:
    """A refine step captured as a CUDA graph, and the tensors it reads and
    writes where they lie (its slots): `inputs`, the per-room inputs in
    `Refiner._inputs`' order, and `noise`, copied in before a replay;
    `leaves`, z and the model's parameters and buffers; `grads`, their
    gradients as the graph's backward makes them (None for a buffer, or a
    parameter the step leaves alone); `moms`, SGD's momentum buffers of
    the optimizer's parameters (None where there is none). `out` holds the
    stacked losses named `aux_keys`; `key` is the capturing Refiner's
    `graph_key`, whose bank the graph holds (so its identity stays
    unique). `owner` is a weak reference to the Refiner whose state the
    slots are, `held` weak references to its leaves and optimizer: a
    model or z the caller keeps still gets its values back when the
    Refiner is gone."""

    def __init__(self, key, bank, graph, tally, inputs, noise, out,
                 aux_keys, leaves, moms):
        self.key, self.bank, self.graph, self.tally = key, bank, graph, tally
        self.inputs, self.noise, self.out = inputs, noise, out
        self.aux_keys = aux_keys
        self.leaves = [t.detach() for t in leaves]
        self.grads = [t.grad for t in leaves]
        self.moms = moms
        self.owner = self.held = None

    def owned_by(self, refiner: Refiner) -> bool:
        return self.owner is not None and self.owner() is refiner

    def own(self, refiner: Refiner) -> None:
        self.owner = weakref.ref(refiner)
        self.held = ([weakref.ref(t) for t in refiner._leaves()],
                     weakref.ref(refiner.opt))

    def release(self) -> None:
        """Hand the owner's leaves, grads and momentum buffers that are
        still alive private copies of their values, so the next owner's
        replays leave them alone."""
        if self.held is None:
            return
        leaves, opt = self.held
        for ref in leaves:
            t = ref()
            if t is not None:
                t.data = t.detach().clone()
                if t.grad is not None:
                    t.grad = t.grad.clone()
        opt = opt()
        if opt is not None:
            for p in _opt_params(opt):
                state = opt.state.get(p, {})
                if "momentum_buffer" in state:
                    state["momentum_buffer"] = state["momentum_buffer"].clone()
        self.owner = self.held = None


# each card's step graph of the newest key: the next Refiner of that key
# replays it, and its memory pool serves the next capture (a pool that no
# graph holds is let go). One a card keeps memory flat; Refiners of keys
# that alternate capture a graph each, as each holds its own.
_step_graphs: Dict[torch.device, StepGraph] = {}


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream every refine graph on `device` is captured on: cuBLAS
    keeps a workspace for each stream it runs on, for good, so a stream of
    its own for each room's capture would add one a room."""
    return torch.cuda.Stream(device)


def make_refine_step(model, batch, model_idx, bank, target_img,
                     size_targets, room_row_gt, cfg: Config, z0,
                     generator=None, mesh: Optional[Mesh] = None) -> Refiner:
    """The refinement loop's state and step for B scenes (see Refiner)."""
    return Refiner(model, batch, model_idx, bank, target_img, size_targets,
                   room_row_gt, cfg, z0, generator, mesh)


def shard_refine_inputs(mesh: Mesh, batch: SceneBatch, model_idx,
                        target_img, size_targets, room_row_gt, z0,
                        model: Sg2ScVAE):
    """This rank's rooms of every per-room input, and the model with rank
    0's parameters (counterpart of the JAX package's refine.py:287-308):
    (batch, model_idx, target_img, size_targets, room_row_gt, z0, model).
    Rooms are independent along axis 0; the Refiner built on them under
    the same mesh sums the decoder's gradients over the ranks."""
    sharded = shard_batch((batch, model_idx, target_img, size_targets,
                           room_row_gt, z0), mesh)
    return (*sharded, replicate(model, mesh))


def masked_layout_iou(boxes_pred: torch.Tensor, angles_pred: torch.Tensor,
                      batch: SceneBatch) -> torch.Tensor:
    """Mean rotated-cuboid IoU of a predicted layout (boxes (B, O, 6),
    angle bins (B, O)) against the batch's GT, over the real non-room
    objects: the reference's layout currency (testing/test_utils.py:33-40
    get_iou_cuboid, xz polygon intersection x y overlap per object)."""
    room_row = (batch.boxes * batch.room_mask[..., None]).sum(1)   # (B, 6)
    ious = layout_iou(boxes_pred, angles_pred, batch.boxes,
                      batch.angles.float(), room_row[:, 3:])       # (B, O)
    m = (batch.obj_mask & ~batch.room_mask).float()
    return (ious * m).sum() / m.sum().clamp(min=1.0)


@torch.no_grad()
def decoded_layout_iou(model: Sg2ScVAE, batch: SceneBatch,
                       z: torch.Tensor) -> torch.Tensor:
    """masked_layout_iou of the layout `model` decodes from z, each angle
    its argmax bin, as the reference's artifact dumps take it
    (test_render_refine.py:369-377)."""
    boxes_pred, angle_lp = model.decode(z, batch)
    return masked_layout_iou(boxes_pred, angle_lp.argmax(-1).float(), batch)


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


def save_channel_images(img: np.ndarray, folder: str, prefix: str,
                        save_semantic: bool = False) -> None:
    """Depth PNG + GIF (+ optional per-class mask GIFs) of a (70, S, S)
    render stack — the reference save_images artifact set
    (test_render_refine.py:144-163 writes `<prefix>_depth.gif` and
    `<prefix>_<class>.gif` single-frame GIFs); the same files as the JAX
    package's, written without matplotlib or imageio."""
    os.makedirs(folder, exist_ok=True)
    depth = img[0].copy()
    depth = depth - depth.min()
    finite_max = depth[depth < 10.0].max() if (depth < 10.0).any() else 1.0
    depth = np.clip(depth, 0, finite_max) / max(finite_max, 1e-6)
    write_png_gray(os.path.join(folder, f"{prefix}_depth.png"), depth)
    write_gif(os.path.join(folder, f"{prefix}_depth.gif"),
              (depth * 255.0).astype(np.uint8))
    if save_semantic:
        for i, cls in enumerate(NYU40_CLASSES):
            mask = np.clip(img[1 + i], 0.0, 1.0)
            if mask.max() <= 0:
                continue  # skip empty classes (file-count sanity)
            write_gif(os.path.join(
                folder, f"{prefix}_{cls.replace(' ', '_')}.gif"),
                (mask * 255.0).astype(np.uint8))


def finetune_rooms(model: Sg2ScVAE, val_arrays, size_info: SizeInfo,
                   cfg: Config, room_ids, save_dirs,
                   num_iters: Optional[int] = None,
                   save_semantic: bool = False,
                   device="cuda") -> Dict[str, List[dict]]:
    """Reference finetune_VAE (:243-377), one room at a time. Writes
    z_value.pkl, bbox_rot_<k>.pkl (k = 0 and the last iteration),
    bbox_rot_gt.pkl and the depth images of the target and of both k
    (save_channel_images; with `save_semantic`, the class GIFs of both k)
    into each room's save dir. Returns the per-room loss history."""
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
            save_channel_images(_np(target_img[0]), save_dir, "target")

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
            _, imgs, boxes_pred, ang = refiner.snapshot(min(k,
                                                            num_iters - 1))
            save_channel_images(_np(imgs[0]), save_dir, str(k).zfill(3),
                                save_semantic=save_semantic)
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
