#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sln_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, as below
    python3 chip_smoke.py --kernels-only   # device, build, kernels, times
    python3 chip_smoke.py --train-recipe   # every phase, then the recipe

Phases, each printing a line as it ends:
  1. device   the card must be there (else this exits non-zero); prints
              nvidia-smi's name and power limit
  2. build    nvcc builds the CUDA kernels from sln_tpu_torch/csrc; prints
              registers and spills (ptxas), each kernel's resident blocks
              and warps per SM, and the opcodes of its inner loop
              (cuobjdump -sass; printed where found, never a failure)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes: 8 synthetic rooms (seed 3) at
              96 px, one room at 256 px, and a scene whose faces are all
              invalid (every tile's chunk list is empty); the backward
              takes the forward kernel's residuals; forward and backward,
              each run twice on the same inputs, must give the same bits
  4. main     the render-and-refine path through the port's entry points:
              `python -m sln_tpu_torch.test --fine_tune` (one room, 96 px,
              60 iterations, the committed checkpoint), the batched serving
              configuration (8 rooms, 96 px, 60 iterations) and one room at
              256 px; launch counts prove both kernels ran; two iterations
              on the card agree with the same iterations on the CPU; and
              the refine is reproducible: one 8-room step run twice from
              the same state gives the same bits in the loss, z.grad, every
              parameter's grad and every op's output in between, and a
              second fine_tune and a second serving run repeat the first
              ones' loss histories bit for bit
  5. sampling the sampling and evaluation modes on the card: `--batch_gen`
              and `--measure_acc_l1_std` through the entry point (64
              synthetic rooms), the heat map's 20,000 layouts, and the
              quality cell of bench.py:589-634: a fresh posterior over
              4,096 synthetic rooms (seed 42), held against the JAX
              package's artifacts/mean_cov.pkl, then acc / L1 / std on 512
              val rooms (seed 7) within bands of the JAX package's
              numbers; the sweep's and the eval's seconds and the
              sampler's layouts/s (the card's name and power limit beside)
  6. train    training on the card (no rasterizer kernel on this path):
              `python -m sln_tpu_torch.train` through its main at the
              committed model's recipe and width (4,096 synthetic rooms,
              batch 256, free bits 0.05), 200 iterations: finite losses, the
              last printed total_loss below the first, the checkpoint trio
              written, and restore_model on it decoding as the trained model
              bit for bit; two steps on the card against the same two on the
              CPU from the trained state (same random numbers, rtol 1e-4);
              the same step twice op by op and 20 more steps twice: the
              same bits in every op output, loss, parameter, Adam and
              BatchNorm state;
              scenes/s at batch 256 (CUDA events, best of two windows of 60
              steps) and the profile of three steps. With --train-recipe, the
              whole recipe (6,000 iterations) follows, its losses beside the
              committed checkpoint's, and the quality cell on the result
              (without the cached-posterior comparison: another model has
              another posterior), acc_pred >= 0.870 and l1_pred <= 0.1115
  7. spade    SPADE shading on the card at full width (ngf 64, 256 px, nz
              256) from artifacts/spade_gan.ckpt, named explicitly so a
              missing file fails: its load; the generator on one held-out
              room and 2 z, card against CPU (fp32, max abs 1e-3 on the
              tanh output) and the same bits twice on the card;
              `python -m sln_tpu_torch.test --gan_shade` through its main
              (4 val rooms x 50 z = 200 PNGs of 256 x 256 x 3, two forward
              launches per rendered room); the quality cell of
              bench.py:426-454 (8 held-out rooms, seed 19, graph keys from
              100) at three z seeds, PSNR and L1 within bands around the
              JAX package's 28.39 dB / 0.0425; and the serving rate
              (seg_mods once per room, then 5 decode chunks of 10 z; CUDA
              events) with seg_mods' and one decode chunk's times beside
              their conv-FLOP bounds, the decode on cuDNN's convs beside
              it, and the profile of two rooms
  8. times    active chunks per tile and work items at 96 px / 8 rooms and
              256 px / 1 room; kernel and plain-version times at the 96 px,
              8-room shapes and both kernels' at 256 px (CUDA events),
              beside each kernel's bound; each kernel's device time split
              between its launches (torch.profiler)
  9. profile  torch.profiler over three 8-room refine steps: device busy
              share, the top kernels by device time, the CUDA runtime calls,
              device-to-host copies, and the runtime's copies and
              synchronisations inside the steps and outside them
Then one JSON line of kernel records, the refine, sampling, train and spade
lines, the card's nvidia-smi line, and as the last line {"ok": true,
"device": {...}}. Any failed phase raises, so the script exits non-zero and
prints no result. All outputs go to a temporary directory that is removed at
the end.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import pickle
import re
import shutil
import struct
import subprocess
import tempfile
import time
import zlib

import numpy as np
import torch

from sln_tpu_torch import kernels, test as entry
from sln_tpu_torch.config import TrainConfig, default_config
from sln_tpu_torch.data.augment import build_graphs, draw_graph_randomness
from sln_tpu_torch.models.vae import reparameterize
from sln_tpu_torch.render import assets, scene as scene_lib
from sln_tpu_torch.render import rasterizer_cuda as rc
from sln_tpu_torch.train import checkpoint as train_ckpt
from sln_tpu_torch.train import cli as train_cli, loop as train_loop
from sln_tpu_torch.workloads import acc_l1_std, common, gan_shade, heatmap
from sln_tpu_torch.workloads import posterior, refine

# artifacts/latest_bench_with_model.ckpt
CHECKPOINT = TrainConfig(output_dir="artifacts", checkpoint_name="bench")
ITERS = 60
ITERS_256 = 5
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# operations per active (pixel, face) pair, counted from
# sln_tpu_torch/csrc/soft_raster.cu (FMA = 2; each add, mul, min/max,
# comparison, select, division and transcendental = 1); C = classes
FWD_OPS_PER_PAIR = (67, 2)      # 67 + 2*C, all counted at the fp32 peak
# the forward's class sum W @ onehot runs on the tensor cores as two TF32
# products (W = W_hi + W_lo): 2 x 2C operations per pair at the TF32 peak,
# the other 67 at the fp32 peak
FWD_MMA_OPS_PER_PAIR = 4        # x C
BWD_OPS_PER_PAIR = (166, 2)     # 166 + 2*C
TOL = {"depth": (1e-4, 1e-3), "classes": (1e-4, 1e-4),
       "res": (1e-3, 1e-3)}     # (rtol, atol)
# the quality cell (bench.py:589-634) against the JAX package: its cached
# posterior, and bands around its acc / L1 / std_pos (0.883, 0.1092,
# 0.0026). The JAX package's own spread on the CPU, recomputing the
# posterior with another key: 0.0034 (mean) and 0.084 (cov); acc 0.880 to
# 0.883, L1 0.1091 to 0.1092, std_pos 0.00243 to 0.00250 over three eval
# seeds; the bands widen that for the port's other draws
JAX_POSTERIOR = "artifacts/mean_cov.pkl"
POSTERIOR_BOUNDS = {"mean max abs": 0.01, "cov rel frobenius": 0.2}
QUALITY_BANDS = {"acc_pred": (0.870, 0.895), "l1_pred": (0.1070, 0.1115),
                 "std_pos": (0.0021, 0.0029)}
# the shading phase: the committed generator, and bands around the JAX
# package's quality cell (bench.py:426-454: 28.39 dB PSNR, L1 0.0425 over
# 8 held-out rooms, one z each); the port's z come from torch.Generators
# seeded with each of SPADE_Z_SEEDS
SPADE_CHECKPOINT = "artifacts/spade_gan.ckpt"
SPADE_BANDS = {"psnr": (28.0, 28.8), "l1": (0.040, 0.045)}
SPADE_Z_SEEDS = (3, 4, 5)
SPADE_ROOMS = 4         # val rooms through --gan_shade, 50 z each


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def batch_of_rooms(cfg, n, seed, device):
    arrays, size_info = common.load_arrays(max(n, 8), cfg, device,
                                           synthetic_seed=seed)

    def t(k):
        return torch.as_tensor(arrays[k][:n], device=device)

    return build_graphs(t("objs"), t("boxes"), t("angles"), t("obj_mask"),
                        t("room_ids"), size_info,
                        max_on_rels=cfg.data.max_on_rels,
                        generator=torch.Generator(device).manual_seed(0))


def packed_scene(batch, midx, bank, rcfg, drop_scene=None):
    """The kernels' inputs for the batch's GT layout; every face of scene
    `drop_scene` is marked invalid."""
    scene = scene_lib.assemble_scene(batch.objs, batch.boxes,
                                     batch.angles.float(), batch.obj_mask,
                                     midx, bank)
    if drop_scene is not None:
        valid = scene.face_valid.clone()
        valid[drop_scene] = False
        scene = scene._replace(face_valid=valid)
    room = scene_lib.room_dims_of(batch.objs, batch.boxes, batch.obj_mask)
    geom = scene_lib.scene_geometry(scene, room, rcfg)
    return rc.prepare_faces(geom, scene_lib.NUM_RENDER_CLASSES,
                            rcfg.camera.image_size)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check_close(name, got, want, rtol, atol):
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol "
            f"{atol}; max abs err {max_err(got, want):.3e}")


def compare_kernels(case, packed, S, rcfg, gen):
    """Kernel vs plain version on the card; returns (fwd err, bwd err)."""
    consts = (S, rcfg.sigma_px, rcfg.gamma, rcfg.z_far)
    fwd_k = rc.raster_fwd_cuda(*packed, *consts)
    again = rc.raster_fwd_cuda(*packed, *consts)
    for name, a, b in zip(("depth", "classes", "res"), fwd_k, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{case} fwd {name}: two launches on the "
                                 "same inputs differ")
    fwd_p = rc.raster_fwd_plain(*packed, *consts)
    for name, k, p in zip(("depth", "classes"), fwd_k, fwd_p):
        check_close(f"{case} fwd {name}", k, p, *TOL[name])
    # residuals are read back only where the pixel is covered (alpha > 0);
    # elsewhere the backward multiplies them by zero
    covered = (1.0 - torch.exp(fwd_p[2][..., 3])) > 1e-6
    check_close(f"{case} fwd res", fwd_k[2][covered], fwd_p[2][covered],
                *TOL["res"])
    B, P, C = fwd_p[1].shape
    gd = torch.randn(B, P, 1, generator=gen, device=gen.device)
    gc = torch.randn(B, P, C, generator=gen, device=gen.device)
    # the backward reads the forward kernel's residuals and classes
    g_k = rc.raster_bwd_cuda(*packed, fwd_k[2], fwd_k[1], gd, gc, *consts)
    if not torch.equal(g_k, rc.raster_bwd_cuda(*packed, fwd_k[2], fwd_k[1],
                                               gd, gc, *consts)):
        raise AssertionError(f"{case} bwd: two launches on the same inputs "
                             "differ")
    g_p = rc.raster_bwd_plain(*packed, fwd_k[2], fwd_k[1], gd, gc, *consts)
    scale = max(float(g_p.abs().max()), 1e-3)
    check_close(f"{case} bwd fgrad", g_k, g_p, 2e-3, 2e-3 * scale)
    e_fwd = max(max_err(fwd_k[0], fwd_p[0]), max_err(fwd_k[1], fwd_p[1]))
    e_bwd = max_err(g_k, g_p)
    n_active = int(packed[2].sum())
    print(f"  {case}: B={B} P={P} Fp={packed[0].shape[-1]} "
          f"active (tile, chunk) pairs={n_active}; max abs err fwd depth "
          f"{max_err(fwd_k[0], fwd_p[0]):.3e} classes "
          f"{max_err(fwd_k[1], fwd_p[1]):.3e}, bwd {e_bwd:.3e} "
          f"(max |ref| {scale:.3e}); fwd and bwd each bitwise equal over 2 "
          "launches",
          flush=True)
    return e_fwd, e_bwd


def bits_checksum(t: torch.Tensor) -> torch.Tensor:
    """An int64 sum of a tensor's 32-bit words (of its values, for types
    narrower than 32 bits), on the device: changed bits change it unless
    their changes cancel."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.element_size() in (4, 8):
        return flat.view(torch.int32).sum(dtype=torch.int64)
    return flat.to(torch.int64).sum()


def op_trace_mode():
    """A TorchDispatchMode that records every aten op run under it, forward
    and backward, with a checksum of the bits of each tensor it returns
    (ops that return uninitialised memory, torch.empty and kin, excepted)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpTrace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names, self.sums = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if "empty" not in name:
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        self.names.append(name)
                        self.sums.append(bits_checksum(t))
            return out

    return OpTrace()


def step_twice_bitwise(model, batch, inputs, bank, cfg, device) -> None:
    """One refine step, twice, from the same state with the same noise: the
    loss, z.grad and every parameter's .grad must be the same bits, and so
    must every op's output in between; names the first op that differs."""
    midx, target, size_t, room_row = inputs
    with torch.no_grad():
        z0 = model.encode(batch)[0]
    noise = cfg.refine.angle_noise_scale * torch.randn(
        batch.objs.shape, device=device,
        generator=torch.Generator(device).manual_seed(2))
    runs = []
    for _ in range(2):
        r = refine.make_refine_step(copy.deepcopy(model), batch, midx, bank,
                                    target, size_t, room_row, cfg, z0)
        with op_trace_mode() as trace:
            loss = r.step(noise)["total"]
        torch.cuda.synchronize()
        grads = [r.z.grad] + [p.grad for p in r.model.parameters()
                              if p.grad is not None]
        runs.append((loss, grads, trace))
    (l1, g1, t1), (l2, g2, t2) = runs
    if t1.names != t2.names:
        raise AssertionError("two identical refine steps ran different ops")
    differ = (torch.stack(t1.sums) != torch.stack(t2.sums)).nonzero()
    first = t1.names[int(differ[0])] if len(differ) else "none"
    same = torch.equal(l1, l2) and all(torch.equal(a, b)
                                       for a, b in zip(g1, g2))
    print(f"  one refine step twice (B={batch.objs.shape[0]}): loss, z.grad "
          f"and {len(g1) - 1} parameter grads bitwise "
          f"{'equal' if same else 'DIFFERENT'}; {len(t1.names)} op outputs "
          f"compared, {len(differ)} differ, first: {first}", flush=True)
    if not same or len(differ):
        raise AssertionError("the refine step is not bitwise reproducible")


def event_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dev_us(e) -> float:
    """A profiler event's own device time, in us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_split(fn, n: int = 20) -> dict:
    """Device ms per call of each rasterizer kernel that fn launches
    (torch.profiler over n calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        hit = re.search(r"raster_\w+_kernel", e.key)
        if e.device_type == DeviceType.CUDA and hit:
            split[hit.group(0)] = dev_us(e) / 1e3 / n
    return split


def profile_steps(step, n: int, label: str) -> dict:
    """torch.profiler over n calls of `step`: where the step's time goes.
    Returns the wall and busy ms per step and the kernels per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function("profiled_step"):
                step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()

    # device-side ranges of annotations (profiled_step, Optimizer.step#...)
    # share their name with a host event; they span kernels, not add to them
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels_ = [e for e in events if e.device_type == DeviceType.CUDA
                and e.key not in host_keys]
    busy_ms = sum(dev_us(e) for e in kernels_) / 1e3 / n
    per_step = sum(e.count for e in kernels_) / n
    print(f"  profiled {label}: wall {wall_ms:.3f} ms under "
          f"the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{per_step:.0f} kernels per step")
    for e in sorted(kernels_, key=dev_us, reverse=True)[:10]:
        print(f"    device {dev_us(e) / 1e3 / n:8.3f} ms/step "
              f"x{e.count / n:5.0f}  {e.key[:90]}")
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("cuda")]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        print(f"    host   {e.self_cpu_time_total / 1e3 / n:8.3f} ms/step "
              f"x{e.count / n:5.0f}  {e.key}")
    # the runtime's copies and waits, inside the steps and outside them
    # (this script's synchronize and the profiler's own when it stops)
    steps = [e.time_range for e in prof.events()
             if e.name == "profiled_step" and e.device_type == DeviceType.CPU]

    def in_step(e):
        return any(r.start <= e.time_range.start <= r.end for r in steps)

    waits = {"in steps": {}, "outside": {}}
    for e in prof.events():
        if e.name.startswith("cuda") and ("Memcpy" in e.name
                                          or "Synchronize" in e.name):
            side = waits["in steps" if in_step(e) else "outside"]
            side[e.name] = side.get(e.name, 0) + 1
    dtoh = sum(e.count for e in kernels_ if "DtoH" in e.key) / n
    print(f"  {n} steps: {dtoh * n:.0f} device-to-host copies; runtime "
          f"copies and synchronisations {json.dumps(waits)}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "kernels_per_step": per_step,
            "dtoh_per_step": dtoh, "runtime_waits": waits}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sass_loop_counts(lib_path, kernel: str):
    """Opcode counts in a kernel's innermost loop (the span of a backward
    branch that holds MUFU.EX2), from `cuobjdump -sass`. A diagnostic:
    returns the reason instead where the tool or the loop is not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"not counted: {err}"
    body = next((f for f in re.split(r"\n\s*Function : ", sass)[1:]
                 if kernel in f.split("\n", 1)[0]), "")
    insts = []
    for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
        op = re.sub(r"^@!?U?P\w+\s+", "", text.strip())
        insts.append((int(addr, 16), op.split()[0] if op else "", op))
    spans = []
    for a, op, text in insts:
        hit = re.search(r"BRA\S*\s+(?:\S+,\s*)?0x([0-9a-f]+)", text)
        if op.startswith("BRA") and hit and int(hit.group(1), 16) < a:
            ops = [o for b, o, _ in insts if int(hit.group(1), 16) <= b <= a]
            if "MUFU.EX2" in ops:
                spans.append(ops)
    if not spans:
        return f"not counted: no loop with MUFU.EX2 in {kernel}"
    ops = min(spans, key=len)
    return {"instructions": len(ops),
            "LDS": sum(o.startswith("LDS") for o in ops),
            "LDS.128": sum(o.startswith("LDS") and o.endswith(".128")
                           for o in ops),
            "HMMA": sum(o.startswith("HMMA") for o in ops),
            "SHFL": sum(o.startswith("SHFL") for o in ops),
            **{o: ops.count(o) for o in ("MUFU.EX2", "MUFU.RCP", "MUFU.LG2")}}


def chunk_stats(counts) -> str:
    """Active chunks per (scene, tile): how unequal one block per tile
    was, and how many equal work items the lists make."""
    c = counts.flatten().float()
    return (f"active chunks per tile min {int(c.min())} mean "
            f"{float(c.mean()):.3f} max {int(c.max())}, empty tiles "
            f"{int((c == 0).sum())} of {c.numel()}, work items "
            f"{int(c.sum())}")


def bound(ops, byts, mma_ops=0):
    """(ms, what bounds it): fp32 operations at the fp32 peak plus
    tensor-core operations at the TF32 peak, against the bytes at the
    memory rate."""
    t_ops = (ops / PEAK_FP32_FLOPS + mma_ops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = byts / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fwd_bounds(packed, outs):
    """The forward's bound with every operation at the fp32 peak, and
    recounted with its class product at the TF32 tensor-core peak."""
    C = packed[1].shape[-1]
    pairs = int(packed[2].sum()) * rc.PT * rc.FC
    byts = nbytes(*packed, *outs)
    a, b = FWD_OPS_PER_PAIR
    return (bound(pairs * (a + b * C), byts),
            bound(pairs * a, byts, pairs * FWD_MMA_OPS_PER_PAIR * C))


def times_phase(packed96, packed256, rcfg96, rcfg256, device):
    """Kernel times (CUDA events) at the main path's shapes, beside their
    plain versions and bounds."""
    with phase("times"):
        print(f"  96 px, 8 rooms: {chunk_stats(packed96[2])}")
        print(f"  256 px, 1 room: {chunk_stats(packed256[2])}")
        gen = torch.Generator(device).manual_seed(1)

        def bwd_inputs(packed, rcfg, S):
            consts = (S, rcfg.sigma_px, rcfg.gamma, rcfg.z_far)
            depth, classes, res = rc.raster_fwd_plain(*packed, *consts)
            gd = torch.randn(depth.shape, generator=gen, device=device)
            gc = torch.randn(classes.shape, generator=gen, device=device)
            return (*packed, res, classes, gd, gc, *consts), consts, depth

        args96, consts, depth = bwd_inputs(packed96, rcfg96, 96)
        fdata, onehot, counts, clist, res, classes, gd, gc = args96[:8]
        C = onehot.shape[-1]
        pairs = int(counts.sum()) * rc.PT * rc.FC
        args256, consts256, depth256 = bwd_inputs(packed256, rcfg256, 256)
        pairs256 = int(packed256[2].sum()) * rc.PT * rc.FC

        def fwd96():
            return rc.raster_fwd_cuda(*packed96, *consts)

        def fwd256():
            return rc.raster_fwd_cuda(*packed256, *consts256)

        fwd_ms = event_ms(fwd96, 50, 5)
        fwd256_ms = event_ms(fwd256, 50, 5)
        bwd_ms = event_ms(lambda: rc.raster_bwd_cuda(*args96), 50, 5)
        bwd256_ms = event_ms(lambda: rc.raster_bwd_cuda(*args256), 50, 5)
        fwd_plain = event_ms(lambda: rc.raster_fwd_plain(*packed96,
                                                         *consts), 5, 1)
        bwd_plain = event_ms(lambda: rc.raster_bwd_plain(*args96), 5, 1)

        fwd_fp32, fwd_bound = fwd_bounds(packed96, (depth, classes, res))
        fwd256_fp32, fwd256_bound = fwd_bounds(
            packed256, (depth256, args256[5], args256[4]))
        bwd_bound = bound(
            pairs * (BWD_OPS_PER_PAIR[0] + BWD_OPS_PER_PAIR[1] * C),
            nbytes(*packed96, res, classes, gd, gc, fdata))
        bwd256_bound = bound(
            pairs256 * (BWD_OPS_PER_PAIR[0] + BWD_OPS_PER_PAIR[1] * C),
            nbytes(*args256[:8], args256[0]))
        print(f"  96 px, 8 rooms: {pairs} active (pixel, face) pairs of "
              f"{8 * 96 * 96 * fdata.shape[-1]}")
        print(f"  fwd kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
              f"bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}; class product "
              f"at the TF32 peak), all-fp32 bound {fwd_fp32[0]:.4f} ms")
        print(f"  bwd kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
              f"bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        print(f"  256 px, 1 room: {pairs256} active pairs; fwd kernel "
              f"{fwd256_ms:.4f} ms, bound {fwd256_bound[0]:.4f} ms "
              f"({fwd256_bound[1]}), all-fp32 bound {fwd256_fp32[0]:.4f} ms; "
              f"bwd kernel {bwd256_ms:.4f} ms, bound {bwd256_bound[0]:.4f} "
              f"ms ({bwd256_bound[1]})")
        for name, fn in (("96 px, 8 rooms", fwd96), ("256 px, 1 room",
                                                     fwd256)):
            split = kernel_split(fn)
            total = sum(split.values())
            merge = sum(v for k, v in split.items() if "merge" in k)
            print(f"  fwd device ms per call, {name}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f"; merge share {merge / max(total, 1e-12):.3f}")
        for name, args in (("96 px, 8 rooms", args96), ("256 px, 1 room",
                                                        args256)):
            split = kernel_split(lambda: rc.raster_bwd_cuda(*args))
            total = sum(split.values())
            after = sum(v for k, v in split.items()
                        if k != "raster_bwd_kernel")
            print(f"  bwd device ms per call, {name}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f"; reduce and combine share "
                  f"{after / max(total, 1e-12):.3f}")
        print("  library_ms: none; no single PyTorch call computes the "
              "soft rasterizer")
    return fwd_ms, bwd_ms, fwd_plain, bwd_plain, fwd_bound, bwd_bound


def quality_cell(model, cfg, tmp: str, device, against_jax: bool = True):
    """The quality cell of bench.py:589-634: a fresh posterior over 4,096
    synthetic rooms (seed 42), held against the JAX package's cached one
    when `against_jax`, then acc / L1 / std on 512 val rooms (seed 7).
    Returns (the numbers and seconds, mean, cov)."""
    train, size_info = common.load_arrays(4096, cfg, device,
                                          synthetic_seed=42)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, cov = posterior.collect_posterior_stats(model, train, size_info,
                                                  cfg, device=device)
    sweep_s = time.perf_counter() - t0
    out_dir = tempfile.mkdtemp(prefix="quality_", dir=tmp)
    with open(os.path.join(out_dir, "mean_cov.pkl"), "wb") as f:
        pickle.dump([mean, cov], f)
    q = {"posterior_sweep_s": sweep_s}
    if against_jax:
        with open(JAX_POSTERIOR, "rb") as f:
            mean_j, cov_j = (np.asarray(x) for x in pickle.load(f))
        d_post = {"mean max abs": float(np.abs(mean - mean_j).max()),
                  "cov rel frobenius": float(np.linalg.norm(cov - cov_j)
                                             / np.linalg.norm(cov_j))}
        print(f"  posterior over 4096 rooms vs {JAX_POSTERIOR}: "
              + ", ".join(f"{k} {v:.5f} (bound {POSTERIOR_BOUNDS[k]})"
                          for k, v in d_post.items()), flush=True)
        for k, v in d_post.items():
            if not v <= POSTERIOR_BOUNDS[k]:
                raise AssertionError(f"posterior {k} {v} beyond "
                                     f"{POSTERIOR_BOUNDS[k]}")
        q["posterior"] = d_post
    val, _ = common.load_arrays(512, cfg, device, synthetic_seed=7)
    t0 = time.perf_counter()
    q.update(acc_l1_std.run_acc_l1(model, val, size_info, cfg, mean, cov,
                                   batch_size=256, device=device))
    q.update(acc_l1_std.run_std(model, val, size_info, cfg, mean, cov,
                                nsample=10, batch_size=256, device=device))
    q["eval_s"] = time.perf_counter() - t0
    print("  quality (512 val rooms, seed 7, nsample 10): "
          + " ".join(f"{k} {q[k]:.5f}" for k in (
              "acc_pred", "acc_rand", "acc_pert", "l1_pred", "l1_rand",
              "l1_pert", "std_angle", "std_pos", "std_size"))
          + f"; {q['total_triples']} triples", flush=True)
    return q, mean, cov


def sampling_phase(cfg, tmp: str, device, smi: str) -> dict:
    """The sampling and evaluation modes on the card; returns the quality
    cell's numbers and times."""
    with phase("sampling"):
        cli = ["--synthetic", "64", "--output_dir", CHECKPOINT.output_dir,
               "--checkpoint_name", CHECKPOINT.checkpoint_name,
               "--test_dir", tmp]
        out = entry.main(["--batch_gen", *cli])
        for path in (out, os.path.join(tmp, "mean_cov.pkl")):
            if not os.path.isfile(path):
                raise AssertionError(f"--batch_gen wrote no {path}")
        with open(out) as f:
            n_rooms = len(json.load(f))
        got = entry.main(["--measure_acc_l1_std", *cli])
        if not all(np.isfinite(v) for v in got.values()):
            raise AssertionError(f"--measure_acc_l1_std: {got}")
        print(f"  --batch_gen: {n_rooms} rooms x 4 layouts; "
              f"--measure_acc_l1_std (64 rooms): acc_pred "
              f"{got['acc_pred']:.4f} l1_pred {got['l1_pred']:.4f} std_pos "
              f"{got['std_pos']:.5f}", flush=True)

        # the quality cell: a fresh posterior (the cached one is only read)
        model = common.restore_model(cfg, device)
        q, mean, cov = quality_cell(model, cfg, tmp, device)
        for k, (lo, hi) in QUALITY_BANDS.items():
            if not lo <= q[k] <= hi:
                raise AssertionError(f"{k} {q[k]} outside [{lo}, {hi}]")

        # the heat map's layouts and the sampler's rate (bench.py:642-700)
        pkl = heatmap.produce_heatmap(model, mean, cov, tmp, device=device)
        with open(pkl, "rb") as f:
            boxes = pickle.load(f)[2]
        # the default graph's 5 objects and its __room__ node
        if boxes.shape != (20000, 6, 6) or not np.isfinite(boxes).all():
            raise AssertionError(f"heat map boxes {boxes.shape}")
        batch = heatmap.heatmap_scene_batch(4096, 8, 24, device=device)
        sample = heatmap.make_sampler(model, batch, mean, cov)
        gen = torch.Generator(device).manual_seed(0)
        shape = (4096, 8, len(mean))
        ms = event_ms(lambda: sample(torch.randn(shape, generator=gen,
                                                 device=device)), 40, 5)
        rate = 4096 / (ms / 1e3)
        print(f"  heat map: {boxes.shape[0]} layouts of "
              f"{boxes.shape[1]} boxes; sampler {ms:.4f} ms per batch of "
              f"4096 (CUDA events, 40 calls) = {rate:.0f} layouts/s")
        print(f"  posterior sweep {q['posterior_sweep_s']:.2f} s (4096 "
              f"rooms), eval {q['eval_s']:.2f} s (512 rooms), sampler "
              f"{rate:.0f} layouts/s, on {smi}", flush=True)
    return {**q, "sampler_layouts_per_s": rate}


# the committed model's recipe (artifacts/latest_bench_with_model.ckpt's
# pickled args): full width, batch 256, fp32
RECIPE = ["--synthetic", "4096", "--batch_size", "256", "--KL_free_bits",
          "0.05", "--manual_seed", "42", "--learning_rate", "1e-4",
          "--KL_loss_weight", "0.1", "--embedding_dim", "64",
          "--gconv_num_layers", "5", "--mlp_normalization", "batch"]
# the phase's short run: at the 52-74 ms per step measured on an H100
# (PERF.md §6), 200 steps take ~15 s, which leaves the phase under a
# minute with the set-up, the CPU steps, the repeat and the profile; the
# loss falls from its early KL peak by more than its batch-to-batch spread
TRAIN_ITERS = 200
REPEAT_ITERS = 20
RECIPE_ITERS = 6000
# the committed checkpoint's loss history (t = 2000 / 4000 / 6000)
COMMITTED_LOSSES = {
    "total_loss": (4.616121292114258, 4.023364067077637, 3.557696580886841),
    "bbox_pred": (0.13908325135707855, 0.11583220213651657,
                  0.11067518591880798),
    "angle_pred": (2.823082447052002, 2.83974289894104, 2.8030567169189453),
    "KLD_raw": (16.535429000854492, 10.57508373260498, 6.286194801330566)}
# a port-trained model against the JAX package's 0.883 / 0.1092
RECIPE_QUALITY = {"acc_pred": (0.870, None), "l1_pred": (None, 0.1115)}


def train_run(argv, device):
    """`python -m sln_tpu_torch.train` through its main, rasterizer launch
    counts around it; returns (state, checkpoint dict, seconds)."""
    rc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ckpt = train_cli.main([*argv, "--device", device.type])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"  python -m sln_tpu_torch.train {' '.join(argv)}: {seconds:.1f} "
          f"s; rasterizer launches fwd {rc.FWD_LAUNCHES}, bwd "
          f"{rc.BWD_LAUNCHES} (training renders nothing)", flush=True)
    history = ckpt["losses"]
    for name, vals in history.items():
        if not np.isfinite(vals).all():
            raise AssertionError(f"training {name}: non-finite {vals}")
    return state, ckpt, seconds


def train_phase(tmp: str, device, smi: str, recipe: bool) -> dict:
    """Training on the card; returns its numbers."""
    with phase("train"):
        out_dir = os.path.join(tmp, "train")
        argv = [*RECIPE, "--num_iterations", str(TRAIN_ITERS),
                "--print_every", str(TRAIN_ITERS // 3),
                "--checkpoint_every", str(TRAIN_ITERS),
                "--snapshot_every", str(TRAIN_ITERS),
                "--output_dir", out_dir, "--checkpoint_name", "smoke"]
        state, ckpt, seconds = train_run(argv, device)
        total = ckpt["losses"]["total_loss"]
        if not total[-1] < total[0]:
            raise AssertionError(f"total_loss did not fall: {total}")
        print(f"  total_loss at t = {ckpt['losses_ts']}: {total}")
        written = sorted(os.listdir(out_dir))
        if written != ["latest_smoke_with_model.ckpt", "metrics.jsonl",
                       "smoke_no_model.ckpt",
                       "smokesnapshot_000000K.ckpt"]:
            raise AssertionError(f"the trainer wrote {written}")
        # what it wrote decodes as the trained model does, bit for bit
        cfg = train_cli.config_from_args(train_cli.parse_args(argv))
        restored = common.restore_model(cfg, device)
        batch = batch_of_rooms(cfg, 8, 3, device)
        z = torch.randn(batch.boxes.shape[:2] + (cfg.model.latent_dim,),
                        generator=torch.Generator(device).manual_seed(4),
                        device=device)
        with torch.no_grad():
            want = state.model.eval().decode(z, batch)
            got = restored.decode(z, batch)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the restored checkpoint decodes "
                                 "differently from the trained model")
        print(f"  wrote {written}; restore_model decodes as the trained "
              "model, bit for bit", flush=True)

        arrays, size_info = common.load_arrays(4096, cfg, device,
                                               synthetic_seed=42)
        rows = np.arange(cfg.train.batch_size)
        raw_host = {k: v[rows] for k, v in arrays.items()}

        # (b) two steps on the card and on the CPU from the trained state,
        # with the same random numbers. Not from zero moments: Adam's first
        # update is lr g / (|g| + eps), so a gradient near zero flips the
        # sign of its lr-sized step on rounding, and the second step's loss
        # would carry that
        trained = train_ckpt.load_checkpoint(train_ckpt.latest_path(
            out_dir, "smoke"))
        gen = torch.Generator().manual_seed(0)
        B, O = raw_host["objs"].shape
        draws = [[(draw_graph_randomness(B, O, gen, "cpu"),
                   torch.randn(B, O, cfg.model.latent_dim, generator=gen))]
                 for _ in range(2)]
        runs = {}
        for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
            si = type(size_info)(*(x.to(dev) for x in size_info))
            st = train_loop.create_state(cfg, dev, trained)
            step = train_loop.make_train_step(st, cfg, si)
            raw = train_loop.stage_arrays(raw_host, dev)
            runs[name] = [{k: float(v) for k, v in step(raw, d).items()}
                          for d in draws]
        for a, b in zip(runs["card"], runs["cpu"]):
            for k in b:
                if not np.isclose(a[k], b[k], rtol=1e-4, atol=0):
                    raise AssertionError(f"card vs CPU {k}: {a[k]} vs {b[k]}"
                                         " beyond rtol 1e-4")
        print(f"  card vs CPU, 2 steps at batch {B}: total_loss "
              f"{[r['total_loss'] for r in runs['card']]} vs "
              f"{[r['total_loss'] for r in runs['cpu']]}", flush=True)

        # (c) the same run twice: the same bits
        staged = train_loop.stage_arrays(arrays, device)
        pair = []
        for _ in range(2):
            st = train_loop.create_state(cfg, device)
            pair.append((st, train_loop.make_train_step(st, cfg, size_info)))
        raw = train_loop.gather_batch(staged, rows)
        traces = []
        for st, step in pair:
            with op_trace_mode() as trace:
                step(raw)
            traces.append(trace)
        t1, t2 = traces
        if t1.names != t2.names:
            raise AssertionError("two identical train steps ran different "
                                 "ops")
        differ = (torch.stack(t1.sums) != torch.stack(t2.sums)).nonzero()
        first = t1.names[int(differ[0])] if len(differ) else "none"
        histories = []
        for st, step in pair:
            rng = np.random.default_rng(0)
            hist = []
            while len(hist) < REPEAT_ITERS:
                for idx in train_loop.batch_indices(len(arrays["objs"]), B,
                                                    rng):
                    if len(hist) < REPEAT_ITERS:
                        hist.append(step(train_loop.gather_batch(
                            staged, idx))["total_loss"])
            histories.append(torch.stack(hist))
        same_hist = torch.equal(*histories)
        same_state = all(torch.equal(a, b) for a, b in zip(
            pair[0][0].state_tensors(), pair[1][0].state_tensors()))
        print(f"  one train step twice: {len(t1.names)} op outputs "
              f"compared, {len(differ)} differ, first: {first}; "
              f"{REPEAT_ITERS + 1} steps twice: loss histories "
              f"{'equal' if same_hist else 'DIFFER'},"
              f" parameters, Adam and BatchNorm state "
              f"{'equal' if same_state else 'DIFFER'}", flush=True)
        if len(differ) or not same_hist or not same_state:
            raise AssertionError("training is not bitwise reproducible")

        # (d) throughput (bench.py:460-526: one batch, warmed up, best of
        # two windows of 60 steps) and the profile of three steps
        step = pair[0][1]
        step(raw)
        windows = [event_ms(lambda: step(raw), 60, 0) for _ in range(2)]
        rate = B / (min(windows) / 1e3)
        prof = profile_steps(lambda: step(raw), 3, f"train step (batch {B})")
        print(f"  train step at batch {B}: {windows[0]:.3f}, "
              f"{windows[1]:.3f} ms (CUDA events, 60 steps each) = "
              f"{rate:.0f} scenes/s, on {smi}", flush=True)
        result = {"train_run_s": seconds, "iterations": TRAIN_ITERS,
                  "total_loss": total, "card_vs_cpu": runs,
                  "step_ms": windows, "train_scenes_per_sec": rate,
                  "profile": prof}

    if recipe:
        with phase("train recipe"):
            out_dir = os.path.join(tmp, "recipe")
            # prints at 2000 / 4000 / 6000, saves at 3000 / 6000, as the
            # committed checkpoint's run did
            argv = [*RECIPE, "--num_iterations", str(RECIPE_ITERS),
                    "--print_every", str(RECIPE_ITERS // 3),
                    "--checkpoint_every", str(RECIPE_ITERS // 2),
                    "--snapshot_every", str(RECIPE_ITERS // 2),
                    "--output_dir", out_dir, "--checkpoint_name", "bench"]
            _, ckpt, seconds = train_run(argv, device)
            for name, committed in COMMITTED_LOSSES.items():
                print(f"  {name} at t = {ckpt['losses_ts']}: "
                      f"{ckpt['losses'][name]} (committed checkpoint: "
                      f"{list(committed)})")
            cfg = train_cli.config_from_args(train_cli.parse_args(argv))
            q, _, _ = quality_cell(common.restore_model(cfg, device), cfg,
                                   tmp, device, against_jax=False)
            result["recipe"] = {"seconds": seconds,
                                "losses_ts": ckpt["losses_ts"],
                                "losses": ckpt["losses"], "quality": q}
            print(f"  recipe: {RECIPE_ITERS} iterations in {seconds:.1f} s, "
                  f"on {smi}", flush=True)
            for k, (lo, hi) in RECIPE_QUALITY.items():
                if (lo is not None and q[k] < lo) or (hi is not None
                                                      and q[k] > hi):
                    raise AssertionError(f"port-trained {k} {q[k]} misses "
                                         f"({lo}, {hi})")
    return result


def png_shape(path: str):
    """(height, width, channels) of an 8-bit RGB PNG, read with the
    standard library; raises unless its pixel data decompresses to
    exactly that size."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2) or len(zlib.decompress(
            chunks[b"IDAT"])) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: not 8-bit RGB of {w} x {h}")
    return h, w, 3


def conv_flops(model, fn) -> float:
    """The operations (FMA = 2) of every Conv2d and Linear that fn runs,
    counted from their shapes."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total[0] += (2 * out.numel() * mod.in_channels // mod.groups
                         * kh * kw)
        else:
            total[0] += 2 * out.numel() * mod.in_features
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return float(total[0])


def spade_phase(cfg, tmp: str, device, smi: str) -> dict:
    """SPADE shading on the card; returns its numbers and the forward
    kernel's launches on the --gan_shade run."""
    with phase("spade"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = gan_shade.make_spade_model(cfg, SPADE_CHECKPOINT, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        sp = cfg.spade
        if (model.ngf, model.crop_size, model.nz) != (sp.ngf, sp.crop_size,
                                                      sp.nz):
            raise AssertionError(f"{SPADE_CHECKPOINT}: ngf {model.ngf}, "
                                 f"crop {model.crop_size}, nz {model.nz}")
        print(f"  {SPADE_CHECKPOINT}: {n_params} parameters (float16 -> "
              f"float32), loaded onto the card in {load_s:.2f} s",
              flush=True)

        # the quality cell's held-out rooms, rendered by the port
        segs = gan_shade.render_spade_inputs(8, cfg, model.crop_size,
                                             synthetic_seed=19,
                                             key_offset=100, device=device)
        seg1 = segs[:1]
        z2 = torch.randn(2, model.nz, device=device,
                         generator=torch.Generator(device).manual_seed(0))
        with torch.inference_mode():
            runs = [model.decode(model.seg_mods(seg1), z2) for _ in range(2)]
            cpu_model = copy.deepcopy(model).cpu()
            on_cpu = cpu_model.decode(cpu_model.seg_mods(seg1.cpu()),
                                      z2.cpu())
        del cpu_model
        err = max_err(runs[0].cpu(), on_cpu)
        print(f"  generator, 1 room x 2 z at {model.crop_size} px: card vs "
              f"CPU max abs err {err:.3e} (bound 1e-3); two runs on the card "
              f"{'equal' if torch.equal(*runs) else 'DIFFER'}", flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"generator card vs CPU {err} > 1e-3")
        if not torch.equal(*runs):
            raise AssertionError("two generator runs on the card differ")

        # the entry point: 4 val rooms x 50 z
        out_root = os.path.join(tmp, "spade")
        rc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = entry.main([
            "--gan_shade", "--synthetic", "32",
            "--output_dir", CHECKPOINT.output_dir,
            "--checkpoint_name", CHECKPOINT.checkpoint_name,
            "--test_dir", out_root, "--spade_checkpoint", SPADE_CHECKPOINT,
            "--device", device.type])
        torch.cuda.synchronize()
        shade_s = time.perf_counter() - t0
        launches = rc.FWD_LAUNCHES
        print(f"  --gan_shade: {len(paths)} PNGs in {shade_s:.1f} s "
              f"(setup, weights, render, shading, PNG writes); rasterizer "
              f"launches fwd {launches}, bwd {rc.BWD_LAUNCHES}", flush=True)
        out_dir = os.path.join(out_root, "data", "SPADE_out")
        if len(paths) != SPADE_ROOMS * 50 or sorted(paths) != sorted(
                os.path.join(out_dir, f) for f in os.listdir(out_dir)):
            raise AssertionError(f"--gan_shade wrote {len(paths)} PNGs")
        shapes = {png_shape(p) for p in paths}
        if shapes != {(model.crop_size, model.crop_size, 3)}:
            raise AssertionError(f"--gan_shade PNG shapes {shapes}")
        if launches != 2 * SPADE_ROOMS or rc.BWD_LAUNCHES:
            raise AssertionError(f"--gan_shade: fwd {launches} / bwd "
                                 f"{rc.BWD_LAUNCHES} launches for "
                                 f"{SPADE_ROOMS} rooms")

        # the quality cell: PSNR / L1 against the shading target
        metrics = gan_shade.make_shading_metrics(model)
        target = gan_shade.shading_target(segs)
        quality = {}
        for seed in SPADE_Z_SEEDS:
            z = torch.randn(len(segs), model.nz, device=device,
                            generator=torch.Generator(device).manual_seed(
                                seed))
            l1, psnr, _ = metrics(segs, target, z)
            quality[seed] = {"psnr": psnr, "l1": l1}
        print("  quality (8 held-out rooms, one z each): " + "; ".join(
            f"z seed {k}: PSNR {v['psnr']:.4f} dB, L1 {v['l1']:.5f}"
            for k, v in quality.items()), flush=True)
        for seed, q in quality.items():
            for k, (lo, hi) in SPADE_BANDS.items():
                if not lo <= q[k] <= hi:
                    raise AssertionError(f"z seed {seed}: {k} {q[k]} "
                                         f"outside [{lo}, {hi}]")

        # the serving rate: seg_mods once per room, 5 chunks of 10 z
        zs = gan_shade.draw_zs(50, model.nz, device=device)
        with torch.inference_mode():
            def room(seg):
                mods = model.seg_mods(seg)
                for z in zs:
                    model.decode(mods, z)
            room(seg1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(len(segs)):
                room(segs[i:i + 1])
            end.record()
            torch.cuda.synchronize()
            room_ms = start.elapsed_time(end) / len(segs)
            mods = model.seg_mods(seg1)
            seg_ms = event_ms(lambda: model.seg_mods(seg1), 10, 2)
            dec_ms = event_ms(lambda: model.decode(mods, zs[0]), 10, 2)
            seg_flops = conv_flops(model, lambda: model.seg_mods(seg1))
            dec_flops = conv_flops(model, lambda: model.decode(mods, zs[0]))
            # the same decode with cuDNN's convolutions (fp32, deterministic
            # algorithms), which the generator does not use: see
            # spade/generator.py fp32_math
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True,
                                            allow_tf32=False):
                cudnn_ms = event_ms(lambda: type(model).decode.__wrapped__(
                    model, mods, zs[0]), 3, 1)
            prof = profile_steps(lambda: room(seg1), 2,
                                 "shading room (seg_mods + 5 decodes of "
                                 "10 z)")
        rate = 50 / (room_ms / 1e3)
        seg_bound = seg_flops / PEAK_FP32_FLOPS * 1e3
        dec_bound = dec_flops / PEAK_FP32_FLOPS * 1e3
        print(f"  serving: {room_ms:.3f} ms per room of 50 z (CUDA events, "
              f"{len(segs)} rooms) = {rate:.1f} imgs/s; seg_mods "
              f"{seg_ms:.3f} ms (bound {seg_bound:.3f}: "
              f"{seg_flops / 1e9:.1f} GFLOP at the fp32 peak), decode of 10 "
              f"z {dec_ms:.3f} ms (bound {dec_bound:.3f}: "
              f"{dec_flops / 1e9:.1f} GFLOP; with cuDNN's deterministic "
              f"fp32 convs {cudnn_ms:.3f} ms), on {smi}", flush=True)
    return {"parameters": n_params, "load_s": load_s,
            "card_vs_cpu_max_abs_err": err, "gan_shade_s": shade_s,
            "gan_shade_pngs": len(paths), "fwd_launches": launches,
            "quality": quality, "room_ms": room_ms,
            "imgs_per_sec_device": rate, "seg_mods_ms": seg_ms,
            "seg_mods_bound_ms": seg_bound, "decode10_ms": dec_ms,
            "decode10_bound_ms": dec_bound, "decode10_cudnn_ms": cudnn_ms,
            "room_profile": prof}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the device, build, kernels and times phases")
    ap.add_argument("--train-recipe", action="store_true",
                    help="also train the committed model's whole recipe "
                         "and score it")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="sln_chip_smoke_")
    try:
        run(tmp, args.kernels_only, args.train_recipe)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(tmp: str, kernels_only: bool = False, recipe: bool = False) -> None:
    with phase("device"):
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False: "
                               "chip_smoke.py needs an NVIDIA card")
        device = torch.device("cuda")
        # fp32 everywhere: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = smi_line()
        print(f"  nvidia-smi: {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}")

    with phase("build"):
        t0 = time.perf_counter()
        kernels.build()
        kernels.load()
        print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f}"
              f" s: {kernels.library_path().name}")
        for line in kernels.last_build_log.splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                print(f"  {line.strip()}")
        for name, info, kernel in (
                ("fwd item", kernels.fwd_launch_info(),
                 "raster_fwd_item_kernel"),
                ("bwd", kernels.bwd_launch_info(), "raster_bwd_kernel")):
            print(f"  {name} kernel: {info}; resident warps per SM "
                  f"{info['blocks_per_sm'] * info['threads'] // 32}")
            counts_ = sass_loop_counts(kernels.library_path(), kernel)
            print(f"  {name} inner loop (SASS): {json.dumps(counts_)}")

    cfg = default_config().replace(train=CHECKPOINT)
    rcfg96 = refine.refine_render_config(cfg)
    cfg256 = cfg.replace(refine=dataclasses.replace(cfg.refine,
                                                    render_size=256))
    rcfg256 = refine.refine_render_config(cfg256)
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device=device)
    batch8 = batch_of_rooms(cfg, 8, 3, device)
    inputs96 = refine.prepare_refine_inputs(batch8, bank_host, bank, rcfg96)
    midx8 = inputs96[0]

    with phase("kernels"):
        gen = torch.Generator(device).manual_seed(0)
        packed96 = packed_scene(batch8, midx8, bank, rcfg96)
        errs = [compare_kernels("96px_8rooms", packed96, 96, rcfg96, gen)]
        one = batch8.select([0])
        packed256 = packed_scene(one, midx8[:1], bank, rcfg256)
        errs.append(compare_kernels("256px_1room", packed256, 256, rcfg256,
                                    gen))
        # scene 1 has no valid face: each of its tiles has an empty list
        edge = packed_scene(batch8.select([0, 1]), midx8[:2], bank, rcfg96,
                            drop_scene=1)
        if int(edge[2][1].sum()) != 0:
            raise AssertionError("the all-invalid scene has active chunks")
        errs.append(compare_kernels("96px_edge_cases", edge, 96, rcfg96,
                                    gen))
        err_fwd = max(e[0] for e in errs)
        err_bwd = max(e[1] for e in errs)

    if kernels_only:
        times_phase(packed96, packed256, rcfg96, rcfg256, device)
        return

    launches = {"fwd": 0, "bwd": 0}

    def counted(name, fn, min_iters):
        rc.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        f, b = rc.FWD_LAUNCHES, rc.BWD_LAUNCHES
        if f < min_iters or b < min_iters:
            raise AssertionError(f"{name}: fwd {f} / bwd {b} launches for "
                                 f"{min_iters} iterations")
        launches["fwd"] += f
        launches["bwd"] += b
        print(f"  {name}: kernel launches fwd {f}, bwd {b}")
        return out

    def check_losses(name, totals):
        totals = np.asarray(totals, np.float64)
        if not np.isfinite(totals).all():
            raise AssertionError(f"{name}: non-finite loss {totals}")
        print(f"  {name}: total loss {totals[0]:.6f} -> {totals[-1]:.6f}")

    def timed_refine(name, model, batch, inputs, cfg_run, iters):
        midx, target, size_t, room_row = inputs
        with torch.no_grad():
            mu, logvar = model.encode(batch)
            z0 = reparameterize(mu, logvar,
                                torch.Generator(device).manual_seed(13))
        refiner = refine.make_refine_step(copy.deepcopy(model), batch, midx,
                                          bank, target, size_t, room_row,
                                          cfg_run, z0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        hist = refiner.run(iters)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        check_losses(name, hist["total"].cpu())
        histories[name] = hist["total"]
        _, imgs, _, _ = refiner.snapshot()
        S = cfg_run.refine.render_size
        if imgs.shape != (batch.objs.shape[0], 70, S, S) or not bool(
                torch.isfinite(imgs).all()):
            raise AssertionError(f"{name}: render {tuple(imgs.shape)} "
                                 "not finite or of the wrong shape")
        print(f"  {name}: {ms:.3f} ms/step over {iters} steps "
              f"(CUDA events, B={batch.objs.shape[0]}, {S} px)", flush=True)
        refiners[name] = refiner
        return ms

    step_ms, refiners, histories = {}, {}, {}

    def fine_tune():
        return entry.main([
            "--fine_tune", "--synthetic", "32",
            "--output_dir", CHECKPOINT.output_dir,
            "--checkpoint_name", CHECKPOINT.checkpoint_name,
            "--test_dir", tmp])

    with phase("main"):
        t0 = time.perf_counter()
        hist = counted("fine_tune 1 room 96px", fine_tune, ITERS)
        for room, losses in hist.items():
            check_losses(f"fine_tune room {room}",
                         [h["total"] for h in losses])
            if len(losses) != ITERS:
                raise AssertionError(f"{len(losses)} iterations, not {ITERS}")
        print(f"  fine_tune wall time {time.perf_counter() - t0:.1f} s "
              "(setup, checkpoint load, target render and 60 iterations)")

        model = common.restore_model(cfg, device)
        step_ms["96px_8rooms"] = counted(
            "serving 8 rooms 96px",
            lambda: timed_refine("serving 8 rooms 96px", model, batch8,
                                 inputs96, cfg, ITERS), ITERS)
        inputs256 = refine.prepare_refine_inputs(one, bank_host, bank,
                                                 rcfg256)
        step_ms["256px_1room"] = counted(
            "1 room 256px",
            lambda: timed_refine("1 room 256px", model, one, inputs256,
                                 cfg256, ITERS_256), ITERS_256)

        # the same two iterations on the card and on the CPU (plain path)
        def two_iters(dev):
            b = one._replace(**{k: getattr(one, k).to(dev)
                                for k in one._fields})
            bk = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                       device=dev)
            ins = refine.prepare_refine_inputs(b, bank_host, bk, rcfg96)
            m = copy.deepcopy(model).to(dev)
            with torch.no_grad():
                z0 = m.encode(b)[0]
            r = refine.make_refine_step(m, b, ins[0], bk, *ins[1:], cfg, z0,
                                        torch.Generator(dev).manual_seed(1))
            noise = torch.zeros_like(b.boxes[..., 0])
            return np.array([float(r.step(noise)["total"])
                             for _ in range(2)])
        card, cpu = two_iters(device), two_iters(torch.device("cpu"))
        if not np.allclose(card, cpu, rtol=1e-3, atol=0):
            raise AssertionError(f"card {card} vs CPU {cpu} beyond rtol "
                                 "1e-3")
        print(f"  card vs CPU, 2 iterations 1 room 96px: {card} vs {cpu}")

        # determinism: the same work twice gives the same bits
        step_twice_bitwise(model, batch8, inputs96, bank, cfg, device)
        again = counted("fine_tune 1 room 96px, again", fine_tune, ITERS)
        if again != hist:
            raise AssertionError("two fine_tune runs gave different loss "
                                 "histories")
        counted("serving 8 rooms 96px, again",
                lambda: timed_refine("serving 8 rooms 96px, again", model,
                                     batch8, inputs96, cfg, ITERS), ITERS)
        if not torch.equal(histories["serving 8 rooms 96px"],
                           histories["serving 8 rooms 96px, again"]):
            raise AssertionError("two serving runs gave different loss "
                                 "histories")
        print(f"  two fine_tunes ({ITERS} iterations) and two 8-room serving"
              " runs: bitwise-equal loss histories", flush=True)

    quality = sampling_phase(cfg, tmp, device, smi)
    training = train_phase(tmp, device, smi, recipe)
    shading = spade_phase(cfg, tmp, device, smi)
    launches["fwd"] += shading["fwd_launches"]

    fwd_ms, bwd_ms, fwd_plain, bwd_plain, fwd_bound, bwd_bound = \
        times_phase(packed96, packed256, rcfg96, rcfg256, device)

    with phase("profile"):
        profile_steps(refiners["serving 8 rooms 96px"].step, 3,
                      "step (8 rooms, 96 px)")

    def record(name, replaces, launches_n, err, ms, plain, bnd):
        return {"name": name, "route": "cuda",
                "source": "sln_tpu_torch/csrc/soft_raster.cu",
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        record("soft_raster_fwd", "sln_tpu/render/rasterizer_pallas.py:145",
               launches["fwd"], err_fwd, fwd_ms, fwd_plain, fwd_bound),
        record("soft_raster_bwd", "sln_tpu/render/rasterizer_pallas.py:194",
               launches["bwd"], err_bwd, bwd_ms, bwd_plain, bwd_bound)]}))
    print(json.dumps({"refine_ms_per_step": step_ms}))
    print(json.dumps({"sampling": quality}))
    print(json.dumps({"train": training}))
    print(json.dumps({"spade": shading}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
