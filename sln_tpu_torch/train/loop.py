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

make_train_scan takes many steps with the host out of the loop: one CUDA
graph of the step, replayed. Under a mesh the step runs data-parallel over
the mesh's data group and, once shard_state has split the state over its
model axis, tensor-parallel over the model group.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional
from typing import Sequence, Tuple

import numpy as np
import torch

from sln_tpu_torch import trace
from sln_tpu_torch.config import Config
from sln_tpu_torch.data.augment import (GraphDraws, SizeInfo, build_graphs,
                                        draw_graph_randomness)
from sln_tpu_torch.models.layers import MLP, fp32_accumulation, set_mesh
from sln_tpu_torch.models.vae import Sg2ScVAE, params_from_jax
from sln_tpu_torch.parallel.mesh import (Mesh, all_reduce_flat,
                                         all_reduce_sum)
from sln_tpu_torch.parallel.sharding import (local_shard, partition_specs,
                                             shard_params)
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


def chunk_rows(batch: int, microbatch: int) -> int:
    """The rows of one microbatch chunk of a global batch (the whole batch
    when microbatch is 0 or >= it); a batch it does not divide raises."""
    mb = microbatch if 0 < microbatch < batch else batch
    if batch % mb:
        raise ValueError(f"batch size {batch} is not divisible by "
                         f"train.microbatch {mb}")
    return mb


def step_draws(generator: torch.Generator, cfg: Config, step: int,
               batch: int, O: int, device) -> List[ChunkDraws]:
    """The random numbers of train step `step` on a global batch of
    `batch` rows: one (GraphDraws, z noise) per microbatch chunk, each
    from `generator` seeded with the step's (the chunk's) step_seed, the
    graph randomness first, then the noise, as the model would draw it
    (None under use_ae)."""
    mb = chunk_rows(batch, cfg.train.microbatch)
    k = batch // mb
    out = []
    for i in range(k):
        generator.manual_seed(step_seed(cfg.train.seed, step) if k == 1
                              else step_seed(cfg.train.seed, step, i))
        graph = draw_graph_randomness(mb, O, generator, device)
        noise = None
        if not cfg.model.use_ae:
            noise = torch.randn((mb, O, cfg.model.latent_dim),
                                generator=generator, device=device)
        out.append((graph, noise))
    return out


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


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Tensor parallelism for a TrainState (built whole by create_state):
    shard_params on the model, Adam's moments split by the same specs,
    and the NaN guard's Rollback rebuilt on the shards. Returns it."""
    specs = partition_specs(state.model)
    named = list(state.model.named_parameters())
    shard_params(state.model, mesh)
    if mesh.num_model > 1:
        for name, p in named:
            moments = state.optimizer.state[p]
            for key in ("exp_avg", "exp_avg_sq"):
                moments[key] = local_shard(moments[key], specs[name], mesh)
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
    global batch (shard_rows by its data index: its share of each global
    chunk) and the step computes the global batch's step: each chunk's
    draws are the global chunk's (from the same seed; this rank keeps its
    rows; `draws` too are the global chunks'), BatchNorm's statistics and
    every loss normalizer are global, each rank backpropagates total /
    data_size, and the gradients are summed over the data group before
    Adam, so every replica takes the same update and decides the NaN guard
    on the same global loss. Under a mesh with a model axis the state must
    be sharded over it (shard_state): the MLPs run tensor-parallel, the
    ranks of a model group compute everything else alike, so a replicated
    parameter gets the same gradient on each of them."""
    tc, dc = cfg.train, cfg.data
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())
    sharded = mesh is not None and mesh.distributed
    world = mesh.data_size if sharded else 1
    tp = mesh is not None and mesh.num_model > 1
    if any((m.model_mesh is not None) != tp
           for m in model.modules() if isinstance(m, MLP)):
        raise ValueError("a mesh with more than one model rank needs the "
                         "model sharded over it (shard_state), and only such "
                         "a mesh takes a sharded model")
    set_mesh(model, mesh if sharded else None)

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
        mb = chunk_rows(B, tc.microbatch)
        if mb % world:
            raise ValueError(f"train.microbatch {mb} does not split over "
                             f"{world} ranks")
        k, mbl = B // mb, mb // world
        rows = mesh.rows(mb) if sharded else slice(0, mb)
        if draws is not None and len(draws) != k:
            raise ValueError(f"{len(draws)} draws for {k} chunks")
        kl_w = kl_weight_at(state.step + 1, tc)
        if draws is None:
            draws = step_draws(state.generator, cfg, state.step, B,
                               raw.objs.shape[1], raw.objs.device)
        model.train(not eval_mode)
        state.rollback.save()

        if k == 1:
            grads, total, losses, _ = chunk_grads(raw, kl_w, draws[0],
                                                  rows, False)
            if sharded:
                grads = all_reduce_flat(grads, mesh)
        else:
            for i in range(k):
                chunk = RawBatch(*(a[i * mbl:(i + 1) * mbl] for a in raw))
                g, t, ls, n = chunk_grads(chunk, kl_w, draws[i], rows,
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


def _draw_tensors(draws: Sequence[ChunkDraws]) -> List[torch.Tensor]:
    """One step's draws as a flat list of tensors (no noise under
    use_ae)."""
    return [t for graph, noise in draws for t in (*graph, noise)
            if t is not None]


@contextlib.contextmanager
def _capturable(optimizer: torch.optim.Optimizer):
    """Adam's capture check wants capturable=True while a step is
    captured. The fused update the state holds ignores the flag (its step
    count is on the device either way), so the step's bits do not change;
    the flag is put back after."""
    groups = optimizer.param_groups
    if not all(g.get("fused") for g in groups):
        raise ValueError("the train scan's graph needs the fused Adam "
                         "create_state builds")
    saved = [g["capturable"] for g in groups]
    for g in groups:
        g["capturable"] = True
    try:
        yield
    finally:
        for g, flag in zip(groups, saved):
            g["capturable"] = flag


class _GraphedStep:
    """One train step captured into a CUDA graph, with its static inputs
    (the raw batch and one step's draws), its static output (the running
    sum of total_loss) and the KL weight it was captured with."""

    WARMUP = 2

    def __init__(self, state: TrainState, step_fn, raw: RawBatch,
                 draws: Sequence[ChunkDraws], kl_w: float):
        self.kl_w = kl_w
        self.raw = RawBatch(*(a.clone() for a in raw))
        self.draws = [(GraphDraws(*(d.clone() for d in graph)),
                       None if noise is None else noise.clone())
                      for graph, noise in draws]
        self.draw_slots = _draw_tensors(self.draws)
        self.total = torch.zeros((), device=raw.objs.device)
        # warm-up and capture run the step's host code, and the warm-up
        # its device work too: both are undone, so the graph starts from
        # the state the scan was called with
        tensors = state.state_tensors()
        saved = [t.detach().clone() for t in tensors]
        step0 = state.step
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                step_fn(self.raw, self.draws)
        torch.cuda.current_stream().wait_stream(side)
        state.step = step0
        self.graph = torch.cuda.CUDAGraph()
        with _capturable(state.optimizer), torch.cuda.graph(self.graph):
            losses = step_fn(self.raw, self.draws)
            self.total.add_(losses["total_loss"])
        state.step = step0
        with torch.no_grad():
            torch._foreach_copy_(tensors, saved)

    def fits(self, raw: RawBatch, draws: Sequence[ChunkDraws],
             kl_w: float) -> bool:
        return (kl_w == self.kl_w
                and all(a.shape == b.shape and a.dtype == b.dtype
                        for a, b in zip(raw, self.raw))
                and [t.shape for t in _draw_tensors(draws)]
                == [t.shape for t in self.draw_slots])

    def run(self, raw: RawBatch, draws: Sequence[Sequence[ChunkDraws]]
            ) -> torch.Tensor:
        """Replay the step once per entry of `draws` (each copied into the
        static slots first, one device-to-device copy); the host reads
        nothing back in between. Returns the sum of total_loss."""
        with torch.no_grad():
            with trace.span("sln.train.stage"):
                torch._foreach_copy_(list(self.raw), list(raw))
                self.total.zero_()
            for step in draws:
                with trace.span("sln.train.stage"):
                    torch._foreach_copy_(self.draw_slots,
                                         _draw_tensors(step))
                with trace.span("sln.train.replay"):
                    self.graph.replay()
        return self.total.clone()


def make_train_scan(state: TrainState, cfg: Config, size_info: SizeInfo,
                    eval_mode: bool = False) -> Callable[..., torch.Tensor]:
    """Many train steps with the host out of the loop (the JAX package's
    make_train_scan, loop.py:225-260): run(raw, n, draws=None) takes n of
    make_train_step's steps on the same raw batch, advances the state
    (state.step included) by n, and returns the sum of their total_loss
    as a 0-dim tensor on the device, summed in step order.

    draws, one entry per step (each make_train_step's per-chunk list),
    replaces the steps' own random numbers, which are otherwise drawn
    from step_seed before the loop, the eager steps' numbers. The KL weight
    is a host float captured with the step: a window whose steps do not
    all share kl_weight_at's value raises (under kl_linear_decay the
    weight changes every 100,000 steps); a later call at another weight
    captures anew.

    On the card the step is captured into a torch.cuda.CUDAGraph after a
    warm-up on a side stream (undone, so the state is the caller's), then
    replayed n times; each step's draws go into the graph's static slots
    by one device-to-device copy. A failed capture or replay raises. The
    gradients live in the graph's pool: nothing outside a replay may read
    them. On the CPU the plain version runs: the eager loop of the step.
    The scan runs on one device, as the JAX scan: it raises inside an
    initialized process group (a model sharded over a model axis is
    refused by make_train_step)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise ValueError("make_train_scan runs on one device (the JAX scan "
                         "is single-device): not inside a process group")
    step_fn = make_train_step(state, cfg, size_info, eval_mode)
    captured: List[_GraphedStep] = []

    def run(raw: RawBatch, n: int,
            draws: Optional[Sequence[Sequence[ChunkDraws]]] = None
            ) -> torch.Tensor:
        if n < 1:
            raise ValueError(f"a scan of {n} steps")
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} steps' draws for {n} steps")
        kl_w = kl_weight_at(state.step + 1, cfg.train)
        if kl_weight_at(state.step + n, cfg.train) != kl_w:
            raise ValueError(
                f"the KL weight changes inside steps {state.step + 1}.."
                f"{state.step + n}: a scan captures one weight, so end the "
                "window where kl_weight_at changes")
        device = raw.objs.device
        if device.type != "cuda":
            total = torch.zeros((), device=device)
            for i in range(n):
                losses = step_fn(raw, None if draws is None else draws[i])
                total = total + losses["total_loss"]
            return total
        if draws is None:
            B, O = raw.objs.shape
            draws = [step_draws(state.generator, cfg, state.step + i, B, O,
                                device) for i in range(n)]
        if not captured or not captured[0].fits(raw, draws[0], kl_w):
            with trace.span("sln.train.capture"):
                captured[:] = [_GraphedStep(state, step_fn, raw, draws[0],
                                            kl_w)]
        total = captured[0].run(raw, draws)
        state.step += n
        return total

    return run


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
    mb = chunk_rows(global_batch, microbatch)
    if mb % world:
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
