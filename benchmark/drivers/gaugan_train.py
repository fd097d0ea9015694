"""GauGAN training as `python -m sln_tpu_torch.tools.train_spade --arch
gaugan` runs it: the networks and the trainer built by the CLI's own
`gaugan_networks` and `build_gaugan` from the CLI's own flags, stepped
(g_update, then d_update) on a new batch each step, drawn from the seed
out of a pool of synthetic label maps and images made on the device at
set-up; closed loop.

Weights, spectral vectors and VGG19 are seeded on the device (the
convolutions do the same work whatever the values). Set-up builds the
networks on the meta device, assigns them those weights (nothing is
drawn twice) and takes the trainer through its first three steps by the
window's own call; the window goes on with that same state. After the
window, the program's state freed, the plain reference repeats those
steps from the same weights, u, v and batches.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness
from benchmark.counts import gaugan as C
from benchmark.reference import compare
from benchmark.reference import gaugan as ref
from benchmark.traffic import labels as L
from benchmark.traffic import scenes as S

CHECKED_STEPS = 3
# grad1_gap here is the median of G's leaves' first-gradient gaps, not the
# worst leaf's: the worst leaf's reads float32's rounding many times over,
# as high as under TF32. D's first gradient is held by the median of its
# leaves' differences (median_diff; a gap of norms reads a hinge with its
# sign flipped as 0), which reads rounding many times G's (D's gradient at
# step 1 is the difference of the fake's and the real's nearly equal
# terms, which share the label map), as high as under TF32, but far below
# a fault in D's own update (half its batch, no real term, the targets
# swapped); TF32 fails on G's. delta_gap is the worst leaf's change over
# the three steps, where Adam's first step (beta1 = 0) turns
# rounding-level gradients into +-lr moves, so its limit sits between the
# program's reading and 1, a state left unchanged (PERF.md)
COMPARED = ("grad1_gap", "d_grad1_median_diff", "delta_gap")


class State:
    pass


def cli_args(ctx) -> list:
    """The CLI flags of the configuration and traffic."""
    c, t = ctx.config, ctx.traffic
    argv = ["--arch", "gaugan", "--label_nc", str(c["label_nc"]),
            "--crop", str(c["crop_size"]), "--ngf", str(c["ngf"]),
            "--ndf", str(c["ndf"]), "--n_layers_D", str(c["n_layers_D"]),
            "--num_D", str(c["num_D"]),
            "--lambda_feat", str(c["lambda_feat"]),
            "--lambda_vgg", str(c["lambda_vgg"]),
            "--lr_g", str(c["lr_g"]), "--lr_d", str(c["lr_d"]),
            "--batch_size", str(t["batch_size"]), "--device", ctx.device]
    if not c["contain_dontcare_label"]:
        argv.append("--no-contain_dontcare_label")
    return argv


def _init_spectral(net: torch.nn.Module, gen: torch.Generator) -> None:
    """Every spectral conv's u from a normal draw, normalised, then 8
    power-iteration steps (and v from the last)."""
    for m in net.modules():
        if isinstance(m, ref.SNConv2d):
            w_mat = m.weight.reshape(m.out_channels, -1)
            u = torch.randn(m.out_channels, generator=gen,
                            device=w_mat.device)
            u = u / torch.linalg.vector_norm(u)
            for _ in range(8):
                u, v = ref.power_step(w_mat, u)
            m.u, m.v = u, v


def seeded_weights(ctx) -> tuple:
    """(G, D, VGG19) state_dicts made on the device from the seed: conv
    weights in GauGAN's init (xavier normal, gain 0.02) for G and D and in
    torchvision's (kaiming normal, fan_out) for VGG19, biases zero,
    running statistics 0 and 1, then u and v by power iteration."""
    c, dev = ctx.config, ctx.device
    with torch.device("meta"):
        nc = c["semantic_nc"]
        shapes = [ref.Generator(nc, c["ngf"], c["crop_size"]),
                  ref.MultiscaleD(nc + 3, c["ndf"], c["n_layers_D"],
                                  c["num_D"]),
                  ref.VGG19()]
    drawn = [(i, k, v.shape) for i, net in enumerate(shapes)
             for k, v in net.named_parameters() if v.dim() == 4]
    total = sum(math.prod(s) for _, _, s in drawn)
    flat = torch.randn(total, device=dev,
                       generator=S.device_generator(dev, ctx.seed, 10))
    sds, at = [{}, {}, {}], 0
    for i, k, shape in drawn:
        n = math.prod(shape)
        fan_out, fan_in = shape[0] * shape[2] * shape[3], \
            shape[1] * shape[2] * shape[3]
        std = (math.sqrt(2.0 / fan_out) if i == 2
               else 0.02 * math.sqrt(2.0 / (fan_in + fan_out)))
        sds[i][k] = flat[at:at + n].view(shape) * std
        at += n
    for i, net in enumerate(shapes):
        for k, v in net.named_parameters():
            sds[i].setdefault(k, torch.zeros(v.shape, device=dev))
        for k, v in net.named_buffers():
            sds[i][k] = (torch.ones(v.shape, device=dev)
                         if k.endswith("running_var")
                         else torch.zeros(v.shape, device=dev))
    gen = S.device_generator(dev, ctx.seed, 11)
    for i in (0, 1):
        net = shapes[i].to_empty(device=dev)
        net.load_state_dict(sds[i])
        _init_spectral(net, gen)
        sds[i] = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return tuple(sds)


def make_inputs(ctx) -> State:
    """What the benchmark hands both sides: the pool of (label, image)
    pairs, the batches' order, the first steps' batches and the
    weights."""
    st = State()
    c, t, dev = ctx.config, ctx.traffic, ctx.device
    st.device, st.B = dev, t["batch_size"]
    st.nc = c["semantic_nc"]
    st.labels, st.images = L.label_pairs(
        t["pool"], c["crop_size"], c["label_nc"],
        t["dontcare_share"] if c["contain_dontcare_label"] else 0.0,
        tuple(t["regions"]), t["noise_std"],
        S.device_generator(dev, ctx.seed, 1))
    ctx.mark("pool")
    st.gen = S.device_generator(dev, ctx.seed, 2)
    st.first = [_draw(st) for _ in range(CHECKED_STEPS)]
    st.sd_g, st.sd_d, st.sd_vgg = seeded_weights(ctx)
    return st


def _draw(st):
    """The next batch's (label ids (B, 1, S, S), images (B, 3, S, S))."""
    idx = torch.randint(0, st.labels.shape[0], (st.B,), generator=st.gen,
                        device=st.device)
    return st.labels[idx], st.images[idx]


def _program_batch(st, batch):
    from sln_tpu_torch.spade import labels as label_maps
    label, image = batch
    return label_maps.one_hot(label, st.nc), image


def _leaves(trainer) -> dict:
    s = trainer.state
    out = {f"G.{k}": v for k, v in s.generator.named_parameters()}
    out.update({f"D.{k}": v for k, v in s.discriminator.named_parameters()})
    return out


def _spectral(trainer) -> dict:
    s = trainer.state
    out = {}
    for tag, net in (("G", s.generator), ("D", s.discriminator)):
        out.update({f"{tag}.{k}": v.detach().clone()
                    for k, v in net.named_buffers()
                    if k.endswith((".u", ".v"))})
    return out


def setup(ctx):
    from sln_tpu_torch.tools import train_spade

    ctx.mark("imports")
    st = make_inputs(ctx)
    ctx.mark("inputs")
    args = train_spade.parse_args(cli_args(ctx))
    with torch.device("meta"):
        nets = train_spade.gaugan_networks(args)
    for net, sd in zip(nets, (st.sd_g, st.sd_d, st.sd_vgg)):
        # copies: the reference starts from st.sd_* after the window
        net.load_state_dict({k: v.clone() for k, v in sd.items()},
                            assign=True)
    st.trainer = train_spade.build_gaugan(args, ctx.device, nets)
    ctx.mark("program")
    st.first_losses = []
    for k, batch in enumerate(st.first):
        out = st.trainer.step(_program_batch(st, batch))
        st.first_losses.append((out["g_loss"], out["d_loss"]))
        if k == 0:
            st.grad1 = {n: None if p.grad is None else p.grad.clone()
                        for n, p in _leaves(st.trainer).items()}
    st.after = {k: v.detach().clone() for k, v in _leaves(st.trainer).items()}
    st.uv_after = _spectral(st.trainer)
    ctx.sync()
    st.setup_s = ctx.since_start()
    return st


def _step(st):
    batch = _program_batch(st, _draw(st))
    with harness.span("bench.gaugan.step"):
        out = st.trainer.step(batch)
    return torch.stack([out["g_loss"], out["d_loss"]])


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _timed(fn, events):
    def timed(*a, **kw):
        events.append(_event())
        out = fn(*a, **kw)
        events.append(_event())
        return out
    return timed


def window(ctx, st, seconds):
    """Steps back to back for `seconds`, each on its own batch; in a
    traced run, CUDA events around each g_update and d_update."""
    B = st.B
    events = ({"g": [], "d": []} if ctx.trace and ctx.device != "cpu"
              else None)
    if events is not None:
        st.trainer.g_update = _timed(st.trainer.g_update, events["g"])
        st.trainer.d_update = _timed(st.trainer.d_update, events["d"])
    losses, stamps = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        losses.append(_step(st))
        stamps.append(time.perf_counter())
        if stamps[-1] >= deadline:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    if events is not None:
        del st.trainer.g_update, st.trainer.d_update
    n = len(losses)
    st.window_steps = n
    failed = int((~torch.isfinite(torch.stack(losses)).all(1)).sum()) * B
    rec = {"setup_s": st.setup_s, "window_s": window_s,
           "attempted": n * B, "failed": failed, "examples": n * B - failed,
           "log": {"gaugan.steps": n,
                   "gaugan.steps by quarter of the window":
                   harness.by_quarter(stamps, t0, seconds),
                   "gaugan.last losses (g, d)":
                   [float(x) for x in losses[-1]]}}
    if events is not None:
        for key in ("g", "d"):
            ev = events[key]
            rec[f"{key}_update_ms"] = sum(
                a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2])) / n
    return rec


def trace(ctx, st):
    from sln_tpu_torch import trace as program_trace

    n = ctx.traffic["trace_steps"]

    def steps():
        for _ in range(n):
            _step(st)

    tr = harness.traced(steps, ctx.device)
    counts = program_trace.counters()
    # counted after the window: the count's forward on the meta device
    # costs seconds the program's set-up does not need
    per_step = C.step_flops(ctx.config, st.B)["step"]
    return {"trace_window_s": tr["window_s"], "busy_s": tr["busy_s"],
            "breakdown": tr["breakdown"],
            "train_flops": st.window_steps * per_step,
            "log_trace": {"steps": n,
                          "gan.images": counts.get("gan.images"),
                          "spectral.power_iters":
                          counts.get("spectral.power_iters")}}


def reference_steps(ctx, st, fault=None):
    """The plain reference's first steps from the same weights, u, v and
    batches: (losses, first gradients, leaves before, leaves after) and
    its u and v after."""
    nets = ref.Nets(ctx.config, st.sd_g, st.sd_d, st.sd_vgg, ctx.device,
                    fault)
    out = ref.steps(nets, st.first, ctx.config, st.nc)
    return out, ref.spectral(nets)


def median_diff(prog: dict, ref: dict, leaves: list) -> float:
    """The median over `leaves` of |prog - ref| / max(|ref|, the median
    leaf's |ref|): compare.median_gap with the difference's norm in place
    of the norms' difference, so a gradient of the right norm and the
    wrong direction reads as far as it is."""
    ref_n = {k: float(ref[k].double().norm()) for k in leaves}
    med = float(torch.tensor(list(ref_n.values())).median())
    gaps = [(ref_n[k] if prog.get(k) is None else
             float((prog[k].double() - ref[k].double()).norm()))
            / max(ref_n[k], med, 1e-30) for k in leaves]
    return float(torch.tensor(gaps).median())


def _numbers(prog, ref_out):
    """compare.compare_steps' numbers and log, with grad1_gap the median
    leaf's first-gradient gap over G's leaves (the worst leaf's is logged
    as grad1_worst_gap) and d_grad1_median_diff D's median leaf's
    difference (median_diff); G's median difference and D's median gap
    logged beside them."""
    numbers, log = compare.compare_steps(prog, ref_out)
    leaves = compare.counted_leaves(ref_out[1])
    for net in ("g", "d"):
        mine = [k for k in leaves if k.startswith(net.upper() + ".")]
        numbers[f"{net}_grad1_median_gap"] = compare.median_gap(
            prog[1], ref_out[1], mine)
        numbers[f"{net}_grad1_median_diff"] = median_diff(
            prog[1], ref_out[1], mine)
    numbers["grad1_worst_gap"] = numbers["grad1_gap"]
    numbers["grad1_gap"] = numbers["g_grad1_median_gap"]
    return numbers, log


def _uv_gap(prog: dict, want: dict) -> float:
    """The worst u or v's largest |difference| (unit vectors)."""
    return max(float((prog[k] - want[k]).abs().max()) for k in want)


def check(ctx, st, rec):
    prog_losses = [float(g) + float(d) for g, d in st.first_losses]
    before = {**{f"G.{k}": v for k, v in st.sd_g.items()},
              **{f"D.{k}": v for k, v in st.sd_d.items()}}
    before = {k: before[k] for k in st.after}
    prog = (prog_losses, st.grad1, before, st.after)
    rec["log"]["gaugan.trace counters"] = rec.get("log_trace")
    del st.trainer
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with harness.tf32(False):
        (losses, grads, rb, ra), uv = reference_steps(ctx, st)
    ref_out = ([g + d for g, d in losses], grads, rb, ra)
    numbers, log = _numbers(prog, ref_out)
    numbers, log["not compared"] = compare.split(numbers, COMPARED)
    log["not compared"]["uv_gap"] = _uv_gap(st.uv_after, uv)
    rec["log"].update({f"gaugan.{k}": v for k, v in log.items()})
    rec["log"]["gaugan.reference_s"] = time.perf_counter() - t0
    return numbers


KINDS = ("lower", "no_vgg", "g_spectral_frozen", "bn_running",
         "d_half_batch", "d_no_real", "d_flipped")


def control(ctx, st, kind: str):
    """(compared, logged) numbers of a control against the reference
    (float32, TF32 off): `lower`, the reference under TF32; the others
    the reference with that fault planted (benchmark/reference/gaugan.py).
    """
    with harness.tf32(False):
        (losses, grads, rb, ra), uv = reference_steps(ctx, st)
    ref_out = ([g + d for g, d in losses], grads, rb, ra)
    with harness.tf32(kind == "lower"):
        (losses, grads, ob, oa), ouv = reference_steps(
            ctx, st, None if kind == "lower" else kind)
    other = ([g + d for g, d in losses], grads, ob, oa)
    numbers, _ = _numbers(other, ref_out)
    compared, logged = compare.split(numbers, COMPARED)
    logged["uv_gap"] = _uv_gap(ouv, uv)
    return compared, logged
