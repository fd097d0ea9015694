#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sln_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, as below
    python3 chip_smoke.py --kernels-only   # device, build, kernels, times

Phases, each printing a line as it ends:
  1. device   the card must be there (else this exits non-zero); prints
              nvidia-smi's name and power limit
  2. build    nvcc builds the CUDA kernels from sln_tpu_torch/csrc; prints
              registers and spills (ptxas), the backward's resident blocks
              and warps per SM, and the opcodes of its inner loop
              (cuobjdump -sass; printed where found, never a failure)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes: 8 synthetic rooms (seed 3) at
              96 px, one room at 256 px, and a scene whose faces are all
              invalid (every tile's chunk list is empty)
  4. main     the render-and-refine path through the port's entry points:
              `python -m sln_tpu_torch.test --fine_tune` (one room, 96 px,
              60 iterations, the committed checkpoint), the batched serving
              configuration (8 rooms, 96 px, 60 iterations) and one room at
              256 px; launch counts prove both kernels ran; two iterations
              on the card agree with the same iterations on the CPU
  5. times    active chunks per tile and work items at 96 px / 8 rooms and
              256 px / 1 room; kernel and plain-version times at the 96 px,
              8-room shapes and the backward's at 256 px (CUDA events),
              beside each kernel's bound
  6. profile  torch.profiler over three 8-room refine steps: device busy
              share, the top kernels by device time, the CUDA runtime calls,
              device-to-host copies, and the runtime's copies and
              synchronisations inside the steps and outside them
Then one JSON line of kernel records, the card's nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failed phase raises, so the
script exits non-zero and prints no result. All outputs go to a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from sln_tpu_torch import kernels, test as entry
from sln_tpu_torch.config import TrainConfig, default_config
from sln_tpu_torch.data.augment import build_graphs
from sln_tpu_torch.models.vae import reparameterize
from sln_tpu_torch.render import assets, scene as scene_lib
from sln_tpu_torch.render import rasterizer_cuda as rc
from sln_tpu_torch.workloads import common, refine

# artifacts/latest_bench_with_model.ckpt
CHECKPOINT = TrainConfig(output_dir="artifacts", checkpoint_name="bench")
ITERS = 60
ITERS_256 = 5
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# operations per active (pixel, face) pair, counted from
# sln_tpu_torch/csrc/soft_raster.cu (FMA = 2; each add, mul, min/max,
# comparison, select, division and transcendental = 1); C = classes
FWD_OPS_PER_PAIR = (67, 2)      # 67 + 2*C
BWD_OPS_PER_PAIR = (166, 2)     # 166 + 2*C
TOL = {"depth": (1e-4, 1e-3), "classes": (1e-4, 1e-4),
       "res": (1e-3, 1e-3)}     # (rtol, atol)


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
    g_k = rc.raster_bwd_cuda(*packed, fwd_p[2], fwd_p[1], gd, gc, *consts)
    g_p = rc.raster_bwd_plain(*packed, fwd_p[2], fwd_p[1], gd, gc, *consts)
    scale = max(float(g_p.abs().max()), 1e-3)
    check_close(f"{case} bwd fgrad", g_k, g_p, 2e-3, 2e-3 * scale)
    e_fwd = max(max_err(fwd_k[0], fwd_p[0]), max_err(fwd_k[1], fwd_p[1]))
    e_bwd = max_err(g_k, g_p)
    n_active = int(packed[2].sum())
    print(f"  {case}: B={B} P={P} Fp={packed[0].shape[-1]} "
          f"active (tile, chunk) pairs={n_active}; max abs err fwd depth "
          f"{max_err(fwd_k[0], fwd_p[0]):.3e} classes "
          f"{max_err(fwd_k[1], fwd_p[1]):.3e}, bwd {e_bwd:.3e} "
          f"(max |ref| {scale:.3e})", flush=True)
    return e_fwd, e_bwd


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


def profile_steps(refiner, n: int) -> None:
    """torch.profiler over n refine steps: where the step's time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    refiner.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function("refine_step"):
                refiner.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side ranges of annotations (refine_step, Optimizer.step#...)
    # share their name with a host event; they span kernels, not add to them
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels_ = [e for e in events if e.device_type == DeviceType.CUDA
                and e.key not in host_keys]
    busy_ms = sum(dev_us(e) for e in kernels_) / 1e3 / n
    print(f"  profiled step (8 rooms, 96 px): wall {wall_ms:.3f} ms under "
          f"the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels_) / n:.0f} kernels per step")
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
             if e.name == "refine_step" and e.device_type == DeviceType.CPU]

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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sass_loop_counts(lib_path):
    """Opcode counts in the backward kernel's innermost loop (the span of a
    backward branch that holds MUFU.EX2), from `cuobjdump -sass`. A
    diagnostic: returns the reason instead where the tool or the loop is
    not found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"not counted: {err}"
    body = next((f for f in re.split(r"\n\s*Function : ", sass)[1:]
                 if "raster_bwd_kernel" in f.split("\n", 1)[0]), "")
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
        return "not counted: no loop with MUFU.EX2 in raster_bwd_kernel"
    ops = min(spans, key=len)
    return {"instructions": len(ops),
            "LDS": sum(o.startswith("LDS") for o in ops),
            "LDS.128": sum(o.startswith("LDS") and o.endswith(".128")
                           for o in ops),
            **{o: ops.count(o) for o in ("MUFU.EX2", "MUFU.RCP", "MUFU.LG2")}}


def chunk_stats(counts) -> str:
    """Active chunks per (scene, tile): how unequal one block per tile
    was, and how many equal work items the lists make."""
    c = counts.flatten().float()
    return (f"active chunks per tile min {int(c.min())} mean "
            f"{float(c.mean()):.3f} max {int(c.max())}, empty tiles "
            f"{int((c == 0).sum())} of {c.numel()}, work items "
            f"{int(c.sum())}")


def bound(ops, byts):
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = byts / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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
        fwd_ms = event_ms(lambda: rc.raster_fwd_cuda(*packed96, *consts),
                          50, 5)
        bwd_ms = event_ms(lambda: rc.raster_bwd_cuda(*args96), 50, 5)
        fwd_plain = event_ms(lambda: rc.raster_fwd_plain(*packed96,
                                                         *consts), 5, 1)
        bwd_plain = event_ms(lambda: rc.raster_bwd_plain(*args96), 5, 1)
        args256 = bwd_inputs(packed256, rcfg256, 256)[0]
        bwd256_ms = event_ms(lambda: rc.raster_bwd_cuda(*args256), 50, 5)
        pairs256 = int(packed256[2].sum()) * rc.PT * rc.FC

        fwd_bound = bound(
            pairs * (FWD_OPS_PER_PAIR[0] + FWD_OPS_PER_PAIR[1] * C),
            nbytes(*packed96, depth, classes, res))
        bwd_bound = bound(
            pairs * (BWD_OPS_PER_PAIR[0] + BWD_OPS_PER_PAIR[1] * C),
            nbytes(*packed96, res, classes, gd, gc, fdata))
        bwd256_bound = bound(
            pairs256 * (BWD_OPS_PER_PAIR[0] + BWD_OPS_PER_PAIR[1] * C),
            nbytes(*args256[:8], args256[0]))
        print(f"  96 px, 8 rooms: {pairs} active (pixel, face) pairs of "
              f"{8 * 96 * 96 * fdata.shape[-1]}")
        print(f"  fwd kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
              f"bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]})")
        print(f"  bwd kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
              f"bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        print(f"  256 px, 1 room: bwd kernel {bwd256_ms:.4f} ms, bound "
              f"{bwd256_bound[0]:.4f} ms ({bwd256_bound[1]}), {pairs256} "
              "active pairs")
        print("  library_ms: none; no single PyTorch call computes the "
              "soft rasterizer")
    return fwd_ms, bwd_ms, fwd_plain, bwd_plain, fwd_bound, bwd_bound


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the device, build, kernels and times phases")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="sln_chip_smoke_")
    try:
        run(tmp, args.kernels_only)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(tmp: str, kernels_only: bool = False) -> None:
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
        info = kernels.bwd_launch_info()
        print(f"  bwd kernel: {info}; resident warps per SM "
              f"{info['blocks_per_sm'] * info['threads'] // 32}")
        print(f"  bwd inner loop (SASS): "
              f"{json.dumps(sass_loop_counts(kernels.library_path()))}")

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

    step_ms, refiners = {}, {}
    with phase("main"):
        t0 = time.perf_counter()
        hist = counted("fine_tune 1 room 96px", lambda: entry.main([
            "--fine_tune", "--synthetic", "32",
            "--output_dir", CHECKPOINT.output_dir,
            "--checkpoint_name", CHECKPOINT.checkpoint_name,
            "--test_dir", tmp]), ITERS)
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

    fwd_ms, bwd_ms, fwd_plain, bwd_plain, fwd_bound, bwd_bound = \
        times_phase(packed96, packed256, rcfg96, rcfg256, device)

    with phase("profile"):
        profile_steps(refiners["serving 8 rooms 96px"], 3)

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
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
