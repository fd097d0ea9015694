"""VAE training replayed as one CUDA graph of the step
(`train.loop.make_train_scan`): the committed recipe's job (synthetic
rooms, batch, free bits, learning rate) from the configuration's weights
and a fresh Adam state, a new batch and new draws every step.

Set-up builds the train state, captures the graph and takes the first
three steps through the window's own call; the window goes on with that
same state. The reference follows the first three steps after the window.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import flops as F
from benchmark.reference import compare
from benchmark.reference import vae as vae_ref
from benchmark.reference.checkpoint import load_vae_state_dict
from benchmark.traffic import scenes as S

CHECKED_STEPS = 3
# a later step's loss swings with its batch (an outlier row's KL): the
# losses are logged, the gradient and the change compared (PERF.md)
COMPARED = ("grad1_gap", "delta_gap")
RAW = ("objs", "boxes", "angles", "obj_mask", "room_ids")


class State:
    pass


def initial_weights(ctx) -> dict:
    """The configuration's weights on the device: its checkpoint, or,
    where it names none ("seeded"), a fresh init from the seed."""
    if ctx.config["weights"] != "seeded":
        sd = load_vae_state_dict(str(ctx.repo / ctx.config["weights"]))
        return {k: v.to(ctx.device) for k, v in sd.items()}
    return seeded_weights(ctx)


def seeded_weights(ctx) -> dict:
    """A fresh init from the seed, made on the device in one draw: Linear
    weights N(0, 2 / fan_in) (Kaiming), embeddings N(0, 1), biases 0,
    BatchNorm scale 1 and shift 0, running statistics 0 and 1."""
    m = ctx.config["model"]
    with torch.device("meta"):
        ref = vae_ref.Sg2ScVAE(m["embedding_dim"], m["gconv_num_layers"])
    params = dict(ref.named_parameters())
    bufs = dict(ref.named_buffers())
    drawn = [k for k, v in params.items() if v.dim() == 2]
    total = sum(params[k].numel() for k in drawn)
    flat = torch.randn(total, device=ctx.device,
                       generator=S.device_generator(ctx.device, ctx.seed, 10))
    sd, at = {}, 0
    for k, v in params.items():
        if v.dim() == 2:
            w = flat[at:at + v.numel()].view(v.shape)
            at += v.numel()
            owner = k.rsplit(".", 1)[0]
            linear = isinstance(ref.get_submodule(owner), torch.nn.Linear)
            sd[k] = w * (2.0 / v.shape[1]) ** 0.5 if linear else w
        elif k.endswith("weight"):
            sd[k] = torch.ones(v.shape, device=ctx.device)
        else:
            sd[k] = torch.zeros(v.shape, device=ctx.device)
    for k, v in bufs.items():
        sd[k] = (torch.ones(v.shape, device=ctx.device)
                 if k.endswith("running_var")
                 else torch.zeros(v.shape, dtype=v.dtype, device=ctx.device))
    return sd


def _program_config(ctx):
    from sln_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      TrainConfig)
    t, c = ctx.traffic, ctx.config
    return Config(model=ModelConfig(**c["model"]),
                  data=DataConfig(max_objects=c["data"]["max_objects"],
                                  max_triples=c["data"]["max_triples"],
                                  max_on_rels=c["data"]["max_on_rels"]),
                  train=TrainConfig(batch_size=t["batch_size"],
                                    learning_rate=t["learning_rate"],
                                    kl_loss_weight=t["kl_loss_weight"],
                                    kl_free_bits=t["kl_free_bits"]))


class RawBatch(NamedTuple):
    """Rooms before the graph augmentation, field for field the program's
    train.loop.RawBatch."""
    objs: torch.Tensor
    boxes: torch.Tensor
    angles: torch.Tensor
    obj_mask: torch.Tensor
    room_ids: torch.Tensor


def _batch(st, k: int):
    """Step k's rows of the staged rooms (a new permutation each epoch)
    and its draws, both made on the device from the seed."""
    B = st.batch_size
    per_epoch = st.n_rooms // B
    epoch, i = divmod(k, per_epoch)
    while len(st.perms) <= epoch:
        st.perms.append(torch.as_tensor(
            st.rng.permutation(st.n_rooms), device=st.device))
    idx = st.perms[epoch][i * B:(i + 1) * B]
    raw = RawBatch(*(st.staged[n][idx] for n in RAW))
    O = raw.objs.shape[1]
    graph = S.draw_graph_randomness(B, O, st.gen, st.device)
    noise = torch.randn((B, O, st.latent), generator=st.gen,
                        device=st.device)
    return raw, (graph, noise)


def make_inputs(ctx) -> State:
    """What the benchmark hands both sides: the rooms, staged on the
    device, the size table, the batches' order and draws, the first
    steps' batches, and the init."""
    st = State()
    t, dev = ctx.traffic, ctx.device
    st.device = dev
    st.batch_size, st.n_rooms = t["batch_size"], t["rooms"]
    st.latent = ctx.config["model"]["embedding_dim"]
    rooms = S.generate_rooms(st.n_rooms, S.host_seed(ctx.seed, 1),
                             t["room_params"])
    arrays = S.tensorize(rooms, ctx.config["data"]["max_objects"])
    ctx.mark("rooms")
    st.staged = {n: torch.as_tensor(arrays[n], device=dev) for n in RAW}
    st.size_info = S.size_table(dev)
    st.rng = np.random.default_rng(S.host_seed(ctx.seed, 2))
    st.perms = []
    st.gen = S.device_generator(dev, ctx.seed, 3)
    st.sd = initial_weights(ctx)
    st.first = [_batch(st, k) for k in range(CHECKED_STEPS)]
    return st


def setup(ctx):
    from sln_tpu_torch.train.loop import create_state, make_train_scan

    ctx.mark("imports")
    st = make_inputs(ctx)
    ctx.mark("inputs")
    cfg = _program_config(ctx)
    state = create_state(cfg, ctx.device)
    ctx.mark("state")
    state.model.load_state_dict(st.sd)
    st.state = state
    st.run = make_train_scan(state, cfg, st.size_info)
    ctx.mark("program")
    params = dict(state.model.named_parameters())
    st.before = {k: v.detach().clone() for k, v in params.items()}
    st.first_losses = []
    for k, (raw, draws) in enumerate(st.first):
        st.first_losses.append(st.run(raw, 1, [[draws]]))
        if k == 0:
            opt = state.optimizer
            st.grad1 = {n: opt.state[p]["exp_avg"] / (1.0 - 0.9)
                        for n, p in params.items()}
    st.after = {k: v.detach().clone() for k, v in params.items()}
    st.k = CHECKED_STEPS
    ctx.sync()
    st.setup_s = ctx.since_start()
    return st


def _step(st):
    raw, draws = _batch(st, st.k)
    st.k += 1
    with harness.span("bench.train.step"):
        return st.run(raw, 1, [[draws]])


def window(ctx, st, seconds):
    """Steps back to back for `seconds`, each on its own batch."""
    B = st.batch_size
    totals, stamps = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        totals.append(_step(st))
        stamps.append(time.perf_counter())
        if stamps[-1] >= deadline:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(totals))).sum()) * B
    c = ctx.config
    rec = {"setup_s": st.setup_s, "window_s": window_s,
           "attempted": len(totals) * B, "failed": failed,
           "examples": len(totals) * B - failed,
           "train_flops": len(totals) * F.train_step_flops(
               B, c["data"]["max_objects"], c["data"]["max_triples"],
               c["model"]["embedding_dim"], c["model"]["gconv_num_layers"]),
           "log": {"train.steps": len(totals),
                   "train.steps by quarter of the window":
                   harness.by_quarter(stamps, t0, seconds)}}
    return rec


def trace(ctx, st):
    n = ctx.traffic["trace_steps"]

    def steps():
        for _ in range(n):
            _step(st)

    tr = harness.traced(steps, ctx.device)
    return {"trace_window_s": tr["window_s"], "busy_s": tr["busy_s"],
            "breakdown": tr["breakdown"]}


def reference_steps(ctx, st, n: int = CHECKED_STEPS, rows=None,
                    dtype=torch.float32):
    """The plain reference's first n steps on the same batches and draws:
    (losses, first gradients, parameters before, parameters after).
    `rows` plants a fault: each step on those rows of its batch only.
    `dtype` float64 gives a witness of float32's rounding."""
    t, m = ctx.traffic, ctx.config["model"]
    with harness.default_dtype(dtype):
        ref = vae_ref.Sg2ScVAE(m["embedding_dim"], m["gconv_num_layers"]).to(
            ctx.device, dtype)
        ref.load_state_dict(st.sd)
        ref.train()
        params = dict(ref.named_parameters())
        before = {k: v.detach().clone() for k, v in params.items()}
        opt = torch.optim.Adam(ref.parameters(), lr=t["learning_rate"],
                               betas=(0.9, 0.999), eps=1e-8, foreach=False)
        losses, grads = [], None
        for k, (raw, (graph, noise)) in enumerate(st.first[:n]):
            sel = slice(None) if rows is None else rows
            b = S.build_graphs(raw.objs[sel], raw.boxes[sel],
                               raw.angles[sel], raw.obj_mask[sel],
                               raw.room_ids[sel], st.size_info,
                               S.GraphDraws(*(d[sel] for d in graph)))
            b = S.Scenes(*(x.to(dtype) if x.is_floating_point() else x
                           for x in b))
            opt.zero_grad(set_to_none=True)
            mu, logvar = ref.encode(b)
            z = mu + noise[sel].to(dtype) * torch.exp(0.5 * logvar)
            boxes, ang = ref.decode(z, b)
            total = vae_ref.vae_losses(b, mu, logvar, boxes, ang,
                                       t["kl_loss_weight"],
                                       t["kl_free_bits"])
            total.backward()
            if k == 0:
                grads = {name: p.grad.detach().clone()
                         for name, p in params.items()}
            opt.step()
            losses.append(float(total.detach()))
    return losses, grads, before, {k: v.detach().clone()
                                   for k, v in params.items()}


KINDS = ("lower", "half_batch", "float64")


def control(ctx, st, kind: str):
    """(compared, logged) numbers of a control against the reference
    (float32, TF32 off): `lower`, the reference under TF32; `half_batch`,
    each step on the first half of its batch; `float64`, a witness and no
    control: the float32 reference against the reference in float64."""
    with harness.tf32(False):
        ref = reference_steps(ctx, st)
        if kind == "float64":
            ref, other = reference_steps(ctx, st, dtype=torch.float64), ref
    if kind != "float64":
        half = slice(0, ctx.traffic["batch_size"] // 2)
        with harness.tf32(kind == "lower"):
            other = reference_steps(
                ctx, st, rows=half if kind == "half_batch" else None)
    numbers, _ = compare.compare_steps(other, ref)
    return compare.split(numbers, COMPARED)


def check(ctx, st, rec):
    prog_losses = [float(x) for x in st.first_losses]
    del st.state, st.run
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with harness.tf32(False):
        ref = reference_steps(ctx, st)
    numbers, log = compare.compare_steps(
        (prog_losses, st.grad1, st.before, st.after), ref)
    numbers, log["not compared"] = compare.split(numbers, COMPARED)
    rec["log"].update({f"train.{k}": v for k, v in log.items()})
    rec["log"]["train.reference_s"] = time.perf_counter() - t0
    return numbers
