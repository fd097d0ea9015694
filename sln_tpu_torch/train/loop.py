"""The training step and its data stream (counterpart of
sln_tpu/train/loop.py; reference train.py:56-114).

One step builds the stochastic scene graphs on the device, runs the VAE
forward with the reparameterisation, assembles the masked losses with the
KL schedule, backpropagates and takes one Adam step, with a NaN guard
that leaves every piece of state as it was when the loss is not finite.

Randomness is a function of (seed, step[, chunk]): each step (each
microbatch chunk) reseeds one torch.Generator from those integers, as the
JAX step folds the step into its key, so a resumed run draws what an
uninterrupted one would. The streams differ from JAX's threefry ones; the
step takes explicit draws instead, and the tests hand it JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional
from typing import Sequence, Tuple

import numpy as np
import torch

from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import (GraphDraws, SizeInfo, build_graphs,
                                        draw_graph_randomness)
from sln_tpu_torch.models.layers import fp32_accumulation, set_mesh
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.parallel.mesh import (Mesh, all_reduce_flat,
                                         all_reduce_sum)
from sln_tpu_torch.train import checkpoint as ckpt_lib
from sln_tpu_torch.train.losses import vae_losses

# one chunk's random numbers: the graph draws and the z noise (B, O, D)
ChunkDraws = Tuple[GraphDraws, torch.Tensor]


class RawBatch(NamedTuple):
    """Tensorized scenes before the graph augmentation."""
    objs: torch.Tensor          # (B, O) int
    boxes: torch.Tensor         # (B, O, 6) float32
    angles: torch.Tensor        # (B, O) int
    obj_mask: torch.Tensor      # (B, O) bool
    room_ids: torch.Tensor      # (B,) int


class Rollback:
    """A saved copy of a fixed set of tensors, put back where a flag on the
    device says so: the NaN guard without a wait for the device.

    The tensors are grouped by dtype; each group keeps two flat buffers
    and views of them shaped as its tensors, so a save is one foreach copy
    and a rollback is a foreach copy, one `where` and a foreach copy back,
    whatever the number of tensors."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.groups = []
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            ts = [t for t in tensors if t.dtype == dtype]
            n = sum(t.numel() for t in ts)
            saved = ts[0].new_empty(n)
            cur = ts[0].new_empty(n)
            sizes = [t.numel() for t in ts]
            views = [[v.view(t.shape) for v, t in zip(buf.split(sizes), ts)]
                     for buf in (saved, cur)]
            self.groups.append((ts, saved, cur, *views))

    @torch.no_grad()
    def save(self) -> None:
        for ts, _, _, saved_views, _ in self.groups:
            torch._foreach_copy_(saved_views, ts)

    @torch.no_grad()
    def restore_unless(self, keep: torch.Tensor) -> None:
        """Every tensor back to its saved value unless `keep` (a 0-dim
        bool tensor on the device) is true."""
        for ts, saved, cur, _, cur_views in self.groups:
            torch._foreach_copy_(cur_views, ts)
            torch.where(keep, cur, saved, out=cur)
            torch._foreach_copy_(ts, cur_views)


@dataclass
class TrainState:
    model: Sg2ScVAE
    optimizer: torch.optim.Adam
    step: int = 0           # steps taken; kl_weight_at reads step + 1
    generator: Optional[torch.Generator] = None
    rollback: Optional[Rollback] = field(default=None, repr=False)

    def state_tensors(self) -> List[torch.Tensor]:
        """What one step may change: parameters, BatchNorm buffers and the
        Adam state (its per-parameter counts included)."""
        opt = [t for p in self.model.parameters()
               for t in self.optimizer.state[p].values()]
        return [*self.model.parameters(), *self.model.buffers(), *opt]


def kl_weight_at(step: int, cfg) -> float:
    """Constant or staircase-decay KL weight (reference train.py:73-76),
    rounded to float32 as the JAX step computes it."""
    if cfg.kl_linear_decay:
        return float(np.float32(10.0) ** np.float32(step // 100_000 - 6))
    return float(np.float32(cfg.kl_loss_weight))


def step_seed(seed: int, step: int, chunk: Optional[int] = None) -> int:
    """The generator seed of one step (of one microbatch chunk)."""
    entropy = [seed, step] if chunk is None else [seed, step, chunk]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


def create_state(cfg: Config, device, restored: Optional[Dict] = None
                 ) -> TrainState:
    """The model initialised from cfg.train.seed (or from a checkpoint's
    model_state), and Adam with optax.adam's defaults (betas 0.9 / 0.999,
    eps 1e-8; the same update) with zero moments (or the checkpoint's);
    the step counter starts at the checkpoint's t."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = Sg2ScVAE(cfg.model)
    if restored is not None:
        model.load_state_dict(params_from_jax(restored["model_state"]))
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(),
                                 lr=cfg.train.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8, fused=True)
    ckpt_lib.load_adam_state(
        model, optimizer, None if restored is None
        else restored["optim_state"], cfg.model)
    state = TrainState(model, optimizer,
                       0 if restored is None else restored["counters"]["t"],
                       torch.Generator(device))
    state.rollback = Rollback(state.state_tensors())
    return state


def make_train_step(state: TrainState, cfg: Config, size_info: SizeInfo,
                    eval_mode: bool = False, mesh: Optional[Mesh] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The step: step_fn(raw, draws=None) -> loss dict of 0-dim tensors on
    the device (no value is read back to the host).

    eval_mode=True keeps optimizing but runs BatchNorm on its running
    statistics (the reference's --eval_mode_after, train.py:63-65); the
    noise is still drawn. `draws`, one (GraphDraws, noise) per chunk,
    replaces the generator's random numbers.

    cfg.train.microbatch > 0 splits the batch into chunks of that size:
    each chunk's gradient and losses are weighted by its valid-object
    count and divided by the total, BatchNorm's running statistics thread
    through the chunks in order, and one Adam step follows (the JAX
    package's loop.py:150-188). A batch it does not divide raises;
    microbatch 0 or >= the batch is the unchunked step.

    A step whose total loss is not finite leaves the parameters, the Adam
    state and the BatchNorm buffers as they were, still counts as a step,
    and reports skipped_nan = 1.

    Under a `mesh` with a process group, `raw` is this rank's rows of the
    global batch (shard_rows: its share of each global chunk) and the step
    computes the global batch's step: each chunk's draws are the global
    chunk's (from the same seed; this rank keeps its rows; `draws` too are
    the global chunks'), BatchNorm's statistics and every loss normalizer
    are global, each rank backpropagates total / world_size, and the
    gradients are summed over the ranks before Adam, so every replica takes
    the same update and decides the NaN guard on the same global loss."""
    tc, dc = cfg.train, cfg.data
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())
    sharded = mesh is not None and mesh.distributed
    world = mesh.world_size if sharded else 1
    set_mesh(model, mesh if sharded else None)

    def global_draws(n: int, O: int, device, seed: int) -> ChunkDraws:
        """A global chunk of n rows' draws from the step's generator: the
        graph randomness, then the z noise, as the model would draw it."""
        gen = state.generator
        gen.manual_seed(seed)
        graph_draws = draw_graph_randomness(n, O, gen, device)
        noise = None
        if not cfg.model.use_ae:
            noise = torch.randn((n, O, cfg.model.latent_dim), generator=gen,
                                device=device)
        return graph_draws, noise

    def chunk_grads(chunk: RawBatch, kl_w: float, draws: ChunkDraws,
                    rows: slice, weigh: bool):
        device = chunk.boxes.device
        graph_draws, noise = draws
        graph_draws = GraphDraws(*(d[rows].to(device) for d in graph_draws))
        if noise is not None:
            noise = noise[rows].to(device)
        batch = build_graphs(*chunk, size_info, max_on_rels=dc.max_on_rels,
                             use_attr_30=dc.use_attr_30, draws=graph_draws)
        with fp32_accumulation():
            mu, logvar, boxes_pred, angle_lp = model(batch, noise=noise)
            total, losses = vae_losses(batch, mu, logvar, boxes_pred,
                                       angle_lp, kl_w, cfg.model.use_ae,
                                       tc.kl_free_bits, mesh)
            grads = torch.autograd.grad(total / world if sharded else total,
                                        params, allow_unused=True,
                                        materialize_grads=True)
        n_valid = None
        if weigh:
            n_valid = batch.obj_mask.to(torch.float32).sum()
            if sharded:
                n_valid = all_reduce_sum(n_valid, mesh)
            n_valid = n_valid.clamp(min=1.0)
        return list(grads), total, losses, n_valid

    def step_fn(raw: RawBatch, draws: Optional[Sequence[ChunkDraws]] = None
                ) -> Dict[str, torch.Tensor]:
        B = raw.objs.shape[0] * world
        mb = tc.microbatch if 0 < tc.microbatch < B else B
        if B % mb:
            raise ValueError(f"batch size {B} is not divisible by "
                             f"train.microbatch {mb}")
        if mb % world:
            raise ValueError(f"train.microbatch {mb} does not split over "
                             f"{world} ranks")
        k, mbl = B // mb, mb // world
        rows = mesh.rows(mb) if sharded else slice(0, mb)
        if draws is not None and len(draws) != k:
            raise ValueError(f"{len(draws)} draws for {k} chunks")
        kl_w = kl_weight_at(state.step + 1, tc)
        model.train(not eval_mode)
        state.rollback.save()

        def draws_of(i):
            if draws is not None:
                return draws[i]
            return global_draws(mb, raw.objs.shape[1], raw.objs.device,
                                step_seed(tc.seed, state.step) if k == 1
                                else step_seed(tc.seed, state.step, i))

        if k == 1:
            grads, total, losses, _ = chunk_grads(raw, kl_w, draws_of(0),
                                                  rows, False)
            if sharded:
                grads = all_reduce_flat(grads, mesh)
        else:
            for i in range(k):
                chunk = RawBatch(*(a[i * mbl:(i + 1) * mbl] for a in raw))
                g, t, ls, n = chunk_grads(chunk, kl_w, draws_of(i), rows,
                                          True)
                g = torch._foreach_mul(g, n)
                ls = {name: n * v for name, v in ls.items()}
                if i == 0:
                    grads, total, losses, n_total = g, n * t, ls, n
                else:
                    torch._foreach_add_(grads, g)
                    total = total + n * t
                    losses = {name: losses[name] + v
                              for name, v in ls.items()}
                    n_total = n_total + n
            if sharded:
                grads = all_reduce_flat(grads, mesh)
            torch._foreach_div_(grads, n_total)
            total = total / n_total
            losses = {name: v / n_total for name, v in losses.items()}

        for p, g in zip(params, grads):
            p.grad = g
        finite = torch.isfinite(total)
        optimizer.step()
        state.rollback.restore_unless(finite)
        state.step += 1
        losses = {name: v.detach() for name, v in losses.items()}
        losses["skipped_nan"] = (~finite).to(torch.float32)
        return losses

    return step_fn


def batch_indices(n: int, batch_size: int, rng: np.random.Generator
                  ) -> Iterator[np.ndarray]:
    """Shuffled fixed-size epoch index stream: (B,) int32 per batch; the
    final partial batch wraps around to the start of the permutation.
    The same permutation as the JAX package's for the same rng."""
    order = rng.permutation(n)
    if n % batch_size:
        order = np.concatenate(
            [order, order[: batch_size - n % batch_size]])
    for start in range(0, len(order), batch_size):
        yield order[start: start + batch_size].astype(np.int32)


def shard_rows(global_batch: int, microbatch: int, rank: int, world: int
               ) -> np.ndarray:
    """The rows of a global batch that rank `rank` of `world` takes, in the
    order its step reads them: its share of each global microbatch chunk,
    rows [i mb + r mb/N, i mb + (r+1) mb/N) of chunk i (one chunk of the
    whole batch when microbatch is 0 or >= the batch)."""
    mb = microbatch if 0 < microbatch < global_batch else global_batch
    if global_batch % mb or mb % world:
        raise ValueError(f"global batch {global_batch} in chunks of {mb} "
                         f"does not split over {world} ranks")
    per = mb // world
    return np.concatenate([np.arange(i * mb + rank * per,
                                     i * mb + (rank + 1) * per)
                           for i in range(global_batch // mb)])


def host_sharded_batches(arrays: Dict[str, np.ndarray],
                         global_batch_size: int, rng: np.random.Generator,
                         process_index: int, process_count: int,
                         microbatch: int = 0) -> Iterator[RawBatch]:
    """This rank's rows (shard_rows) of each batch of the global epoch
    stream (counterpart of the JAX package's loop.py:305). Every rank
    seeds the same rng, so draws the same global permutation, and keeps
    its own rows: without microbatching the ranks' batches concatenate in
    rank order to batches_from_arrays' stream. The trainer gathers the
    same rows on the device instead (batch_indices, then gather_batch)."""
    rows = shard_rows(global_batch_size, microbatch, process_index,
                      process_count)
    for idx in batch_indices(arrays["objs"].shape[0], global_batch_size,
                             rng):
        yield RawBatch(*(arrays[k][idx[rows]] for k in RawBatch._fields))


def stage_arrays(arrays: Dict[str, np.ndarray], device) -> RawBatch:
    """The whole tensorized dataset on the device, once; each step then
    gathers its batch there (gather_batch), so only the (B,) indices
    cross to the device per step."""
    return RawBatch(*(torch.as_tensor(arrays[k], device=device)
                      for k in RawBatch._fields))


def gather_batch(staged: RawBatch, idx: np.ndarray) -> RawBatch:
    """Rows `idx` of the staged dataset, gathered on its device."""
    i = torch.as_tensor(idx, dtype=torch.long).to(staged.objs.device,
                                                  non_blocking=True)
    return RawBatch(*(a[i] for a in staged))


def batches_from_arrays(arrays: Dict[str, np.ndarray], batch_size: int,
                        rng: np.random.Generator) -> Iterator[RawBatch]:
    """Shuffled fixed-size epoch iterator over tensorized scenes, gathered
    on the host (numpy arrays; batch_indices' permutation). The trainer
    stages on the device instead; this is the counterpart of the JAX
    package's host iterator, which the tests hold it against."""
    n = arrays["objs"].shape[0]
    for idx in batch_indices(n, batch_size, rng):
        yield RawBatch(*(arrays[k][idx] for k in RawBatch._fields))
