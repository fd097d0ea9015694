#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sln_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, as below
    python3 chip_smoke.py --kernels-only   # device, build, kernels, times
    python3 chip_smoke.py --train-recipe   # every phase, then the recipe
    python3 chip_smoke.py --spade-recipe   # every phase, then the shading
                                           # generator's whole recipe
    python3 chip_smoke.py --parallel-only  # device, build, parallel
    python3 chip_smoke.py --layout-eval-only  # device, build, layout_eval
    python3 chip_smoke.py --train-scan-only   # device, build, train_scan
    python3 chip_smoke.py --tp-only        # device, build, tensor_parallel
    python3 chip_smoke.py --spade-variants-only  # device, build,
                                                 # spade_variants

Phases, each printing a line as it ends:
  1. device   the card must be there (else this exits non-zero); prints
              nvidia-smi's name and power limit
  2. build    nvcc builds the CUDA kernels from sln_tpu_torch/csrc; prints
              registers and spills (ptxas), each kernel's resident blocks
              and warps per SM, and the opcodes of its inner loop
              (cuobjdump -sass; printed where found, never a failure)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes: 8 synthetic rooms (seed 3) at
              96 px, one room at 256 px, a scene whose faces are all
              invalid (every tile's chunk list is empty), and the dry run's
              refine shape (sln_tpu_torch.dryrun.refine_setup: 4 rooms at
              8 object slots, 32 px); the backward
              takes the forward kernel's residuals; forward and backward,
              each run twice on the same inputs, must give the same bits;
              and the culled kernels against the dense plain
              soft_rasterize on the shading quality cell's 8 rooms at 256
              px, whose sliver faces reach far beyond their rows: no
              class-mask value flipped, depth within TOL["depth"]
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
  6b. train_scan
              the device-resident train loop (train.loop.make_train_scan) at
              the JAX bench's train_device settings (bench.py:527-560:
              batch 256 of 4,096 synthetic rooms, seed 0, a fresh init at
              the default width): its CUDA graph of the step for 60 steps
              against 60 eager steps from the same init with the same
              draws, the summed loss and every parameter, BatchNorm and
              Adam tensor the same bits (else the differing tensors printed
              and the JAX scan test's gates, total rtol 1e-5 and parameters
              1e-6), state.step advanced by 60; a profiled window of 10
              scan steps with 10 graph launches and no eager step between
              them (host kernel launches per replay under 5 % of an eager
              step's); scenes/s of the graph and of the eager loop (CUDA
              events, best of two windows of 60 steps) and each one's
              device busy share; the microbatched step (microbatch 128)
              and --compute_dtype bfloat16, 10 steps each, held the same
              way
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
  8. spade_train
              SPADE GAN training at the committed recipe's width (ngf 64,
              ndf 64, nz 256, 256 px, batch 8, lambda_l1 50):
              `python -m sln_tpu_torch.tools.train_spade` through its main,
              20 steps from scratch on 96 rendered pairs (two forward
              launches each), evaluated before the first step and at the
              last: finite losses, held-out L1 falling, the checkpoint and
              the float16 artifact written outside the repo and shading as
              the trained generator does, bit for bit; a warm start from
              artifacts/spade_gan.ckpt evaluated before any step beside its
              recorded 28.40 dB / 0.0430; one step card against CPU (batch
              2); one step twice op by op and 10 more steps twice, the same
              bits; imgs/s at batch 8 beside the step's conv/GEMM bound,
              peak memory and a profile of two steps; `--mmd` (nef 16) 5
              steps twice. With --spade-recipe the whole recipe follows: 4
              chained runs of 750 steps, val PSNR / L1 every 250 beside the
              committed generator's, and the quality cell on the result
  8b. spade_variants
              the rest of SPADE at full width (the classic generator,
              generators 2, 3 and 5 at ngf 64, 256 px, nz 256; ConvEncoder,
              ConvEncoderPSPSE and ConvEncoderPSPSEMMD2 at nef 64 on 256 px
              RGB; NLayerDiscriminatorMMD and MultiscaleDiscriminatorMMD at
              ndf 64, nz 256 on RGB + 41 segmentation channels), each from
              init_like_jax on the card with the JAX classes' parameter
              counts: two forwards at batch 2 the same bits, card against
              the module copied to the CPU at batch 1 (max abs 1e-3), the
              spectral vectors after one train=True forward card against
              CPU (1e-4), a backward through generator 3 and through
              ConvEncoderPSPSE, card against CPU and each against the
              card's float64 (gradients finite; relative error of all of
              them and of each tensor 1e-2), forward ms at
              batch 2 (CUDA events, best of 3) beside the share of the
              fp32 peak its conv FLOPs take
  9. bf16     the bfloat16 compute modes: `python -m sln_tpu_torch.train
              --compute_dtype bfloat16` through its main at the recipe's
              width (200 iterations): finite losses falling, the trio
              restored bit for bit, a bf16 model with float32 parameters;
              card against CPU in bf16: one MLP + BatchNorm stack at the
              recipe's width on the same inputs within half the card's
              bf16-fp32 gap, and two train steps (from the committed and
              from this run's state) nearer the CPU's bf16 than the card's
              fp32 (relative Frobenius norms); one step twice op by op;
              scenes/s beside fp32's. The quality cell
              with a bf16 VAE inside the fp32 bands, and the sampler's
              layouts/s in both dtypes. `--fine_tune --compute_dtype
              bfloat16` (one room, 96 px, 60 iterations) and the 8-room
              serving loop, each twice: both kernels launched, the same
              loss histories, step ms beside fp32's. `--gan_shade
              --spade_dtype bfloat16` through main (200 PNGs): bf16 weights
              but SE's, the same bits as fp32 weights cast per call, the
              quality cell at three z seeds inside the fp32 bands, the mean
              image difference from fp32, imgs/s and a decode chunk's ms
              beside fp32's and the bf16 conv-FLOP bound, and the decode on
              cuDNN's and on im2col + cuBLAS's deterministic bf16 convs
  10. draw3d  `--draw_3d` on the card: `--batch_gen` (16 val rooms, 64
              layouts), then `--draw_3d --renderer preview` and `--renderer
              auto` through main at 256 px (no Blender binary on the card:
              auto says it falls back; 64 PNGs each, the same bytes; one
              forward call, two launches, per layout), `--renderer blender`
              unavailable and `--gan_shade --semantic_source blender`
              raising BlenderNotAvailable; 8 layouts' kernel renders against
              the plain dense soft_rasterize on the card and 2 against the
              CPU (no class-mask flip, the same foreground and winning
              classes, depth within TOL["depth"]), one layout twice (the
              same bits); layouts/s (CUDA events, no files; and through main
              with the PNG writes) and the geometry / kernel / shading
              split; `--gan_shade --semantic_source files` on masks and
              .npy depth written in the Blender artifact names (read back
              to the written channels, 200 PNGs); `--fine_tune
              --save_semantic_gifs` (its PNG and GIF dumps, and the main
              phase's loss history bit for bit)
  11. parallel data parallelism (sln_tpu_torch.parallel) over ranks, one
              process each: `python -m sln_tpu_torch.train --num_data_shards
              1` under a one-rank launcher's environment (an NCCL group of
              one) against the plain trainer, 20 steps at the recipe's width,
              the same losses and state bit for bit; then one
              `torch.distributed.run` launch of this script's
              --parallel-worker on 2 ranks sharing the card over gloo (on a
              machine with more cards, one NCCL rank per card), each held
              against the single process on the same card: the DP train step
              at batch 256 from the committed weights, two steps (losses and
              the first gradient within the larger of 1e-5 and PAR_FLOOR_FACTOR
              times the float32 floor measured here: one process with the
              batch's halves swapped; parameters within 2.5e-3; every rank's
              state the same bits), scenes/s and the all-reduce's device
              time (a profile of three steps); the sharded sampler at batch
              4,096 on the committed VAE (boxes within 1e-5, at most 1 angle
              bin flipped in 10,000 valid objects), layouts/s; the sharded
              refine of 8 rooms at 96 px on the committed checkpoint (the
              first 4 steps' losses and z within rtol 1e-3, all 60 reported,
              both kernels launched on every rank, the launches added to the
              kernel line); sharded colorize of one room x 50 z on
              artifacts/spade_gan.ckpt (within 1e-3), imgs/s
  11b. tensor_parallel
              tensor parallelism and the multi-slice mesh: `python -m
              sln_tpu_torch.dryrun` under torch.distributed.run on 4 ranks
              (dp 2 x tp 2) and on 8 (adding 2 slices x 2 x 2), ranks
              sharing the card over gloo (one NCCL rank per card where the
              cards suffice): every variant's line, the refine's launches
              added to the kernel line; then the parallel phase's worker
              with --model-ranks 2 on 4 ranks (dp 2 x tp 2; with more
              cards, one NCCL rank each): the recipe-width step at batch
              256 from the committed weights, two steps against one
              process on the same card at the parallel phase's gates
              (losses and first gradient within the larger of 1e-5 and
              PAR_FLOOR_FACTOR times the float32 floor, parameters
              2.5e-3), each data group's shards and every rank's
              replicated tensors the same bits, ms per step
  12. layout_eval
              the host runtime and the layout evaluation: the native
              library built by g++ from csrc/native.cpp (compiler and build
              seconds); a room-JSON file of 16,384 rooms through
              tensorize_file (the C++ packer) and through json +
              tensorize_rooms, the arrays bit-equal, both rates in rooms/s
              beside the host CPU; the C++ cuboid IoU against ops/iou.py on
              the card over 10,000 random rotated pairs (1e-4) and
              layout_iou card against CPU (1e-5); `python -m
              sln_tpu_torch.tools.eval_refinement_quality --output_dir
              artifacts --checkpoint_name bench --rooms 8` through its main
              at three seeds (sigma 1, 60 iterations, 96 px, lr_z 2e-4):
              both kernels launched, every value within PROBE_BANDS of the
              JAX package's record (artifacts/refine_sweep.json row 0),
              iou_refined - iou_perturbed >= -0.005, the loss histories'
              first and last 10 iterations, seconds per probe; the probe on
              the JAX package's own batch, z0 and noise
              (artifacts/refine_probe_inputs.npz): the IoU and box L1 at z0
              and z_gt within 1e-4 of the JAX package's on the CPU, its
              first 8 losses within rtol 1e-3, the same IoU gate; and
              iou_at_z_gt over 8 graph draws; `sweep_refinement` at two
              rows into a temporary --out (row 0 repeats the probe's
              digits, artifacts/refine_sweep.json byte for byte unchanged); an asset bank built by the
              build_asset_bank CLI from a multi-part .obj corpus written to
              a temporary directory, shells included, loaded through
              scene_spec.load_bank and device_bank, retrieval picking the
              matching class, and one refine step on the card with it
              (finite loss, z moved, both kernels launched)
  13. times   active chunks per tile and work items at 96 px / 8 rooms and
              256 px / 1 room; kernel and plain-version times at the 96 px,
              8-room shapes and both kernels' at 256 px (CUDA events),
              beside each kernel's bound; each kernel's device time split
              between its launches (torch.profiler)
  14. profile torch.profiler over three 8-room refine steps: device busy
              share, the top kernels by device time, the CUDA runtime calls,
              device-to-host copies, and the runtime's copies and
              synchronisations inside the steps and outside them
Then one JSON line of kernel records, the refine, sampling, train,
train_scan, spade, spade_train, spade_variants and culling lines, one line per bf16 group
(bf16_train, bf16_sampling, bf16_refine, bf16_shading), the draw3d,
parallel, tensor_parallel and layout_eval lines, the card's nvidia-smi
line, and as the last line {"ok": true, "device": {...}}. Any failed phase
raises, so the script exits non-zero and prints no result. All outputs go to a temporary directory
that is removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import dataclasses
import json
import os
import pickle
import platform
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sln_tpu_torch import dryrun, kernels, test as entry
from sln_tpu_torch.config import TrainConfig, default_config
from sln_tpu_torch.data.vocab import NYU40_CLASSES
from sln_tpu_torch.data.augment import build_graphs, draw_graph_randomness
from sln_tpu_torch.models.vae import reparameterize
from sln_tpu_torch.parallel.mesh import global_from_host_shards, make_mesh
from sln_tpu_torch.parallel.sharding import gather_params, partition_specs
from sln_tpu_torch.render import assets, blender_bridge, image_io, preview
from sln_tpu_torch.render import rasterizer as raster
from sln_tpu_torch.render import rasterizer_cuda as rc
from sln_tpu_torch.render import scene as scene_lib
from sln_tpu_torch.render.blender import scene_spec
from sln_tpu_torch.spade import classic as spade_classic
from sln_tpu_torch.spade import encoders as spade_encoders
from sln_tpu_torch.spade import port as spade_port
from sln_tpu_torch.spade import variants as spade_variants
from sln_tpu_torch.spade.discriminator import (ConvEncoder,
                                               instance_normed_biases)
from sln_tpu_torch.spade.generator import conv_math
from sln_tpu_torch.spade.losses import GanState, make_gan_train_step
from sln_tpu_torch.spade.spectral import SpectralConv
from sln_tpu_torch.tools import train_spade
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
                            rcfg.camera.image_size, rcfg.sigma_px, rcfg.gamma)


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


def culled_against_dense(cfg, device) -> dict:
    """The culled path (sort, pack, cull, the forward kernels) against the
    dense plain soft_rasterize, on the card, on the shading quality cell's
    rooms at 256 px (synthetic seed 19, graph keys from 100), whose sliver
    faces reach far beyond their row spans: no class-mask value flipped at
    0.5, depth within the kernels' tolerance (TOL["depth"])."""
    arrays, size_info = common.load_arrays(8, cfg, device, synthetic_seed=19)
    rcfg, bank_host, bank = gan_shade._render_setup(cfg, 256, device)
    kw = dict(sigma=rcfg.sigma_px, gamma=rcfg.gamma, z_far=rcfg.z_far)
    C = scene_lib.NUM_RENDER_CLASSES
    out = {"depth_max_abs_err": 0.0, "mask_flips": 0, "chunks_per_tile": []}
    for i in range(8):
        b = gan_shade._room_batch(arrays, i, size_info, cfg, 100 + i, device)
        dims = scene_lib.room_dims_of(b.objs, b.boxes, b.obj_mask)
        abs_boxes = b.boxes * torch.cat([dims, dims], -1)[:, None]
        midx = torch.as_tensor(assets.retrieve_models(
            b.objs.cpu().numpy(), abs_boxes.cpu().numpy(), bank_host),
            device=device)
        scene = scene_lib.assemble_scene(b.objs, b.boxes, b.angles.float(),
                                         b.obj_mask, midx, bank)
        geom = scene_lib.scene_geometry(scene, dims, rcfg)
        with torch.no_grad():
            d_k, c_k = rc.soft_rasterize_cuda(geom, C, 256, **kw)
            d_o, c_o = raster.soft_rasterize(geom, C, 256, **kw)
        check_close(f"culled vs dense room {i} depth", d_k, d_o,
                    *TOL["depth"])
        flips = int(((c_k > 0.5) != (c_o > 0.5)).sum())
        counts = rc.prepare_faces(geom, C, 256, rcfg.sigma_px,
                                  rcfg.gamma)[2]
        out["depth_max_abs_err"] = max(out["depth_max_abs_err"],
                                       max_err(d_k, d_o))
        out["mask_flips"] += flips
        out["chunks_per_tile"].append(float(counts.float().mean()))
    print(f"  culled kernels vs dense soft_rasterize, 8 quality-cell rooms "
          f"at 256 px: depth max abs err {out['depth_max_abs_err']:.3e} "
          f"(rtol {TOL['depth'][0]}, atol {TOL['depth'][1]}), class-mask "
          f"flips at 0.5: {out['mask_flips']}; active chunks per tile, "
          f"mean per room: "
          + ", ".join(f"{c:.3f}" for c in out["chunks_per_tile"]),
          flush=True)
    if out["mask_flips"]:
        raise AssertionError(f"{out['mask_flips']} class-mask values flip "
                             "between the culled and the dense render")
    return out


def bits_checksum(t: torch.Tensor) -> torch.Tensor:
    """An int64 sum of a tensor's 32-bit words (16-bit words for 16-bit
    types, values for narrower ones), on the device: changed bits change
    it unless their changes cancel."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.element_size() in (4, 8):
        return flat.view(torch.int32).sum(dtype=torch.int64)
    if flat.element_size() == 2:
        return flat.view(torch.int16).sum(dtype=torch.int64)
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
    """One eager refine step, twice, from the same state with the same
    noise: the loss, z.grad and every parameter's .grad must be the same
    bits, and so must every op's output in between; names the first op
    that differs. (Through `step` a Refiner whose step graph the card
    holds would replay it, and the op trace would see no op.)"""
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
            loss = r._step(noise)["total"]
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


def conv_flops(model, fn) -> float:
    """The operations (FMA = 2) of every Conv2d, SpectralConv and Linear
    that fn runs, counted from their shapes."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total[0] += (2 * out.numel() * mod.in_channels // mod.groups
                         * kh * kw)
        elif isinstance(mod, SpectralConv):
            total[0] += 2 * out.numel() * mod.weight[0].numel()
        else:
            total[0] += 2 * out.numel() * mod.in_features
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                                 SpectralConv))]
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
        shapes = {image_io.read_png(p).shape for p in paths}
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
            # spade/generator.py conv_math
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


# the committed shading generator's recipe (artifacts/spade_gan.ckpt's
# pickled config): full width, 96 synthetic pairs at 256 px, batch 8, run as
# 4 chained runs of 750 steps with --resume, evals and saves every 250
SPADE_RECIPE = ["--synthetic", "96", "--crop", "256", "--ngf", "64",
                "--ndf", "64", "--nz", "256", "--batch_size", "8",
                "--lr_g", "1e-4", "--lr_d", "4e-4", "--lambda_l1", "50"]
SPADE_RECORDED = {"val_psnr": 28.40038998921712,
                  "val_l1": 0.04302995279431343, "trained_steps": 3000}
SPADE_TRAIN_STEPS = 20
SPADE_REPEAT_STEPS = 10
SPADE_MMD_STEPS = 5
SPADE_RECIPE_RUNS, SPADE_RECIPE_STEPS = 4, 750
# card against CPU, one step: losses rtol, gradients' relative error per
# tensor (norm of the difference over the norm), and parameters after
# Adam where the gradient is well above rounding (|g| > 1e-6 and > 1e-3 of
# the tensor's largest): Adam with b1 = 0 moves each weight by about
# lr sign(g) on step 1, so a gradient near rounding may step either way
SPADE_STEP_RTOL = 1e-3
SPADE_GRAD_REL = 1e-3


def _gan_copy(trainer, device) -> GanState:
    """A fresh GanState (new Adams) from a copy of the trainer's networks
    on `device`."""
    st, args = trainer.state, trainer.args
    return GanState(copy.deepcopy(st.generator).to(device),
                    copy.deepcopy(st.discriminator).to(device), args.lr_g,
                    args.lr_d)


def _check_finite(name, hist):
    for k, v in hist.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{name} {k}: non-finite {v}")


def _outside_repo(path: str) -> bool:
    repo = os.path.dirname(os.path.abspath(__file__))
    return not os.path.realpath(path).startswith(os.path.realpath(repo)
                                                 + os.sep)


def spade_train_phase(cfg, tmp: str, device, smi: str,
                      recipe: bool) -> dict:
    """SPADE GAN training on the card at the committed recipe's width;
    returns its numbers and the forward kernel's launches on the entry
    point's run."""
    cpu = torch.device("cpu")
    res = {}
    with phase("spade_train"):
        root = os.path.join(tmp, "spade_train")
        out_dir, art = os.path.join(root, "run"), os.path.join(root,
                                                               "serving.ckpt")
        argv = [*SPADE_RECIPE, "--steps", str(SPADE_TRAIN_STEPS),
                "--eval_every", str(SPADE_TRAIN_STEPS), "--print_every", "5",
                "--output_dir", out_dir, "--artifact", art, "--device",
                device.type]
        rc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_spade.main(argv, eval_before=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, n_pairs = rc.FWD_LAUNCHES, trainer.val_split["n_total"]
        print(f"  pairs: {n_pairs} rooms rendered at {trainer.args.crop} px "
              f"in {trainer.data_s:.1f} s; rasterizer launches fwd {launches}, "
              f"bwd {rc.BWD_LAUNCHES}", flush=True)
        if launches != 2 * n_pairs or rc.BWD_LAUNCHES:
            raise AssertionError(f"rendering {n_pairs} pairs: fwd "
                                 f"{launches} / bwd {rc.BWD_LAUNCHES}")
        hist = trainer.loss_history()
        _check_finite("spade train", hist)
        (_, l1_0, psnr_0), (t_last, l1_n, psnr_n) = (trainer.evals[0],
                                                     trainer.evals[-1])
        print(f"  python -m sln_tpu_torch.tools.train_spade "
              f"{' '.join(argv[:-6])}: {run_s:.1f} s; d_loss "
              f"{hist['d_loss'][0]:.4f} -> {hist['d_loss'][-1]:.4f}, g_loss "
              f"{hist['g_loss'][0]:.4f} -> {hist['g_loss'][-1]:.4f}; "
              f"held-out ({trainer.n_val} rooms) L1 {l1_0:.5f} / PSNR "
              f"{psnr_0:.3f} dB at step 0 -> {l1_n:.5f} / {psnr_n:.3f} dB at "
              f"step {t_last}", flush=True)
        if not l1_n < l1_0:
            raise AssertionError(f"held-out L1 did not fall: {l1_0} -> "
                                 f"{l1_n}")
        ckpt = os.path.join(out_dir, "spade_gan.ckpt")
        for path in (ckpt, art):
            if not os.path.isfile(path) or not _outside_repo(path):
                raise AssertionError(f"the trainer wrote no {path} outside "
                                     "the repo")
        # what it wrote shades as the trained generator does, bit for bit:
        # the checkpoint (float32) and the serving artifact (float16)
        G = trainer.state.generator.eval()
        seg1 = trainer.val_segs[:1]
        z1 = torch.randn(1, G.nz, device=device,
                         generator=torch.Generator(device).manual_seed(11))
        G16 = copy.deepcopy(G)
        with torch.no_grad():
            for p in G16.parameters():
                p.copy_(p.half().float())
        with torch.inference_mode():
            want, want16 = G(seg1, z1), G16(seg1, z1)
            got = gan_shade.make_spade_model(cfg, ckpt, device)(seg1, z1)
            got16 = gan_shade.make_spade_model(cfg, art, device)(seg1, z1)
        del G16
        if not (torch.equal(got, want) and torch.equal(got16, want16)):
            raise AssertionError("a reloaded checkpoint or artifact shades "
                                 "otherwise than the trained generator")
        print(f"  wrote {ckpt} and {art} (outside the repo); "
              "make_spade_model shades a held-out room with each as the "
              "trained generator does (the artifact: with its weights "
              "rounded to float16), bit for bit", flush=True)
        res.update(run_s=run_s, pairs_s=trainer.data_s, fwd_launches=launches,
                   evals=trainer.evals, first_losses={
                       k: float(v[0]) for k, v in hist.items()},
                   last_losses={k: float(v[-1]) for k, v in hist.items()})

        # warm start from the committed generator, evaluated before any step
        warm = train_spade.main(
            [*SPADE_RECIPE, "--steps", "0", "--eval_every", "250",
             "--output_dir", os.path.join(root, "warm"), "--resume",
             SPADE_CHECKPOINT, "--device", device.type], eval_before=True)
        _, l1_w, psnr_w = warm.evals[0]
        print(f"  --resume {SPADE_CHECKPOINT}, before any step, on the "
              f"trainer's held-out split ({warm.n_val} rooms): val PSNR "
              f"{psnr_w:.4f} dB, val L1 {l1_w:.5f} (recorded in the "
              f"checkpoint: {SPADE_RECORDED['val_psnr']:.2f} dB, "
              f"{SPADE_RECORDED['val_l1']:.4f})", flush=True)
        res["warm_start"] = {"val_psnr": psnr_w, "val_l1": l1_w}
        del warm

        # one step, card against CPU, from the trained state, batch 2
        seg2, rgb2 = trainer.val_segs[:2], trainer.val_rgbs[:2]
        z2 = torch.randn(2, G.nz, device=device,
                         generator=torch.Generator(device).manual_seed(12))
        skip = {f"d.{n}" for n in instance_normed_biases(
            trainer.state.discriminator)}
        lrs = {"d": trainer.args.lr_d, "g": trainer.args.lr_g}
        runs = {}
        for name, dev in (("card", device), ("cpu", cpu)):
            st = _gan_copy(trainer, dev)
            nets = (("d", st.discriminator), ("g", st.generator))
            t0 = time.perf_counter()
            losses = make_gan_train_step(st, lambda_l1=50.0)(
                seg2.to(dev), rgb2.to(dev), z2.to(dev))
            losses = {k: float(v) for k, v in losses.items()}
            runs[name] = (losses, {f"{k}.{n}": (p.grad.cpu(), p.detach().cpu())
                                   for k, m in nets
                                   for n, p in m.named_parameters()},
                          time.perf_counter() - t0)
            del st
        (l_k, t_k, s_k), (l_c, t_c, s_c) = runs["card"], runs["cpu"]
        loss_rel = max(abs(l_k[k] - l_c[k]) / abs(l_c[k]) for k in l_c)
        grad_rel, n_cmp, p_err = 0.0, 0, 0.0
        for key, (g, p) in t_c.items():
            if key in skip:
                continue
            g_card, p_card = t_k[key]
            grad_rel = max(grad_rel, float((g_card - g).norm()
                                           / g.norm().clamp(min=1e-30)))
            sel = (g.abs() > 1e-6) & (g.abs() > 1e-3 * g.abs().max())
            n_cmp += int(sel.sum())
            if bool(sel.any()):
                err = float((p_card - p)[sel].abs().max())
                p_err = max(p_err, err)
                bound_p = 2e-3 * lrs[key[0]] + 1e-7
                if err > bound_p:
                    raise AssertionError(f"{key} after Adam: card vs CPU "
                                         f"{err} beyond {bound_p}")
        print(f"  one step card vs CPU (full width, batch 2, from the "
              f"trained state): d_loss {l_k['d_loss']:.7f} vs "
              f"{l_c['d_loss']:.7f}, g_loss {l_k['g_loss']:.7f} vs "
              f"{l_c['g_loss']:.7f} (max rel {loss_rel:.2e}, rtol "
              f"{SPADE_STEP_RTOL}); gradients of {len(t_c) - len(skip)} "
              f"tensors (not the {len(skip)} instance-normed conv biases, "
              f"whose gradient is rounding alone) max relative error "
              f"{grad_rel:.2e} (bound {SPADE_GRAD_REL}); parameters after "
              f"Adam at the {n_cmp} weights whose gradient is well above "
              f"rounding: max abs diff {p_err:.2e} (bound 2e-3 lr); card "
              f"{s_k:.2f} s, CPU {s_c:.2f} s", flush=True)
        if loss_rel > SPADE_STEP_RTOL or grad_rel > SPADE_GRAD_REL:
            raise AssertionError("the SPADE step on the card differs from "
                                 "the CPU's")
        res["card_vs_cpu"] = {"losses_card": l_k, "losses_cpu": l_c,
                              "loss_rel": loss_rel, "grad_rel": grad_rel,
                              "params_compared": n_cmp,
                              "param_max_abs_diff": p_err, "cpu_s": s_c}
        del runs, t_k, t_c

        # the same bits twice: one step op by op, then REPEAT_STEPS steps
        B = trainer.args.batch_size
        idx8 = torch.arange(B, device=device)
        seg8, rgb8 = trainer.segs[idx8], trainer.rgbs[idx8]
        z8 = torch.randn(B, G.nz, device=device,
                         generator=torch.Generator(device).manual_seed(13))
        traces, finals = [], []
        for _ in range(2):
            st = _gan_copy(trainer, device)
            step = make_gan_train_step(st, lambda_l1=50.0)
            with op_trace_mode() as trace:
                losses = step(seg8, rgb8, z8)
            torch.cuda.synchronize()
            traces.append((trace, list(losses.values())))
            gen = torch.Generator(device).manual_seed(14)
            hist = []
            for _ in range(SPADE_REPEAT_STEPS):
                idx = torch.randint(0, len(trainer.segs), (B,),
                                    generator=gen, device=device)
                z = torch.randn(B, G.nz, generator=gen, device=device)
                hist += list(step(trainer.segs[idx], trainer.rgbs[idx],
                                  z).values())
            finals.append((torch.stack(hist), st.state_tensors()))
            del st, step
        (t1, l1s), (t2, l2s) = traces
        if t1.names != t2.names:
            raise AssertionError("two identical SPADE steps ran different "
                                 "ops")
        differ = (torch.stack(t1.sums) != torch.stack(t2.sums)).nonzero()
        first = t1.names[int(differ[0])] if len(differ) else "none"
        same_losses = all(torch.equal(a, b) for a, b in zip(l1s, l2s))
        same_hist = torch.equal(finals[0][0], finals[1][0])
        same_state = (len(finals[0][1]) == len(finals[1][1]) and all(
            torch.equal(a, b) for a, b in zip(finals[0][1], finals[1][1])))
        print(f"  one SPADE step twice (batch {B}): {len(t1.names)} op "
              f"outputs compared, {len(differ)} differ, first: {first}; "
              f"losses {'equal' if same_losses else 'DIFFER'}; "
              f"{SPADE_REPEAT_STEPS} more steps twice: losses "
              f"{'equal' if same_hist else 'DIFFER'}, parameters, spectral "
              f"vectors and Adam moments "
              f"({len(finals[0][1])} tensors) "
              f"{'equal' if same_state else 'DIFFER'}", flush=True)
        if len(differ) or not (same_losses and same_hist and same_state):
            raise AssertionError("SPADE training is not bitwise "
                                 "reproducible")
        res["op_outputs_compared"] = len(t1.names)
        del traces, finals, t1, t2

        # speed at batch 8: CUDA events, warmed up, best of two windows
        st = _gan_copy(trainer, device)
        step = make_gan_train_step(st, lambda_l1=50.0)
        for _ in range(2):
            step(seg8, rgb8, z8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        windows = [event_ms(lambda: step(seg8, rgb8, z8), SPADE_REPEAT_STEPS,
                            0) for _ in range(2)]
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        rate = B / (min(windows) / 1e3)
        with torch.no_grad():
            g_fwd = conv_flops(st.generator, lambda: st.generator(seg8, z8))
            d_fwd = conv_flops(st.discriminator, lambda: st.discriminator(
                torch.cat([seg8, rgb8], 1)))
        # D step: G forward, D forward x2 and its backward (weights and
        # inputs, 2x); G step: G forward and backward (2x), D forward x2 and
        # the fake's input gradient (1x)
        step_flops = 4 * g_fwd + 9 * d_fwd
        bound_ms = step_flops / PEAK_FP32_FLOPS * 1e3
        prof = profile_steps(lambda: step(seg8, rgb8, z8), 2,
                             f"SPADE GAN step (batch {B}, 256 px)")
        print(f"  train step at batch {B}: {windows[0]:.3f}, "
              f"{windows[1]:.3f} ms (CUDA events, {SPADE_REPEAT_STEPS} steps "
              f"each) = {rate:.2f} imgs/s; conv/GEMM bound "
              f"{bound_ms:.3f} ms ({step_flops / 1e12:.3f} TFLOP at the "
              f"fp32 peak: G forward {g_fwd / 1e9 / B:.1f} GFLOP and D "
              f"forward {d_fwd / 1e9 / B:.3f} GFLOP per image); peak device "
              f"memory {peak_gb:.2f} GiB; on {smi}", flush=True)
        res.update(step_ms=windows, train_imgs_per_sec=rate,
                   step_bound_ms=bound_ms, step_tflop=step_flops / 1e12,
                   peak_memory_gib=peak_gb, profile=prof)
        del st, step

        # the MMD mode, twice: finite losses, the same bits
        mmd = []
        for i in range(2):
            tr = train_spade.main(
                [*SPADE_RECIPE, "--mmd", "--nef", "16", "--steps",
                 str(SPADE_MMD_STEPS), "--eval_every", "0", "--print_every",
                 str(SPADE_MMD_STEPS), "--output_dir",
                 os.path.join(root, f"mmd{i}"), "--device", device.type])
            mmd.append((tr.loss_history(), tr.state.state_tensors()))
            del tr
        _check_finite("--mmd", mmd[0][0])
        same = (all(np.array_equal(mmd[0][0][k], mmd[1][0][k])
                    for k in mmd[0][0])
                and all(torch.equal(a, b) for a, b in zip(mmd[0][1],
                                                          mmd[1][1])))
        print(f"  --mmd --nef 16, {SPADE_MMD_STEPS} steps twice: "
              + ", ".join(f"{k} {v[0]:.4f} -> {v[-1]:.4f}"
                          for k, v in mmd[0][0].items())
              + f"; losses and state {'equal' if same else 'DIFFER'}",
              flush=True)
        if not same:
            raise AssertionError("two --mmd runs differ")
        res["mmd_last_losses"] = {k: float(v[-1]) for k, v in
                                  mmd[0][0].items()}
        del mmd, trainer, G
        predicted_min = (SPADE_RECIPE_RUNS * SPADE_RECIPE_STEPS
                         * min(windows) / 1e3 / 60)
        print(f"  the recipe's {SPADE_RECIPE_RUNS * SPADE_RECIPE_STEPS} "
              f"steps at this step time: {predicted_min:.1f} minutes of "
              "training (renders, evals and saves besides)", flush=True)
        res["recipe_predicted_min"] = predicted_min

    if recipe:
        with phase("spade recipe"):
            evals, prev, t0 = [], "", time.perf_counter()
            for r in range(SPADE_RECIPE_RUNS):
                out = os.path.join(root, f"recipe{r}")
                tr = train_spade.main(
                    [*SPADE_RECIPE, "--steps", str(SPADE_RECIPE_STEPS),
                     "--eval_every", "250", "--save_every", "250",
                     "--print_every", "50", "--output_dir", out, "--device",
                     device.type] + (["--resume", prev] if prev else []))
                evals += [(tr.start_step + t, l1, psnr)
                          for t, l1, psnr in tr.evals]
                _check_finite(f"recipe run {r}", tr.loss_history())
                prev = os.path.join(out, "spade_gan.ckpt")
                del tr
            seconds = time.perf_counter() - t0
            for t, l1, psnr in evals:
                print(f"  recipe step {t}: val PSNR {psnr:.4f} dB, val L1 "
                      f"{l1:.5f}")
            print(f"  recipe: {SPADE_RECIPE_RUNS} x {SPADE_RECIPE_STEPS} "
                  f"steps in {seconds:.1f} s; final val PSNR "
                  f"{evals[-1][2]:.4f} dB, L1 {evals[-1][1]:.5f} (the "
                  f"committed checkpoint: {SPADE_RECORDED['val_psnr']:.2f} "
                  f"dB, {SPADE_RECORDED['val_l1']:.4f}); on {smi}",
                  flush=True)
            model = gan_shade.make_spade_model(cfg, prev, device)
            segs = gan_shade.render_spade_inputs(8, cfg, model.crop_size,
                                                 synthetic_seed=19,
                                                 key_offset=100,
                                                 device=device)
            metrics = gan_shade.make_shading_metrics(model)
            target = gan_shade.shading_target(segs)
            quality = {}
            for seed in SPADE_Z_SEEDS:
                z = torch.randn(len(segs), model.nz, device=device,
                                generator=torch.Generator(
                                    device).manual_seed(seed))
                l1, psnr, _ = metrics(segs, target, z)
                quality[seed] = {"psnr": psnr, "l1": l1}
            print("  port-trained generator on the quality cell (8 rooms, "
                  "seed 19): " + "; ".join(
                      f"z seed {k}: PSNR {v['psnr']:.4f} dB, L1 "
                      f"{v['l1']:.5f}" for k, v in quality.items()),
                  flush=True)
            res["recipe"] = {"seconds": seconds, "evals": evals,
                             "quality": quality}
    return res


# the rest of SPADE at full width (semantic_nc 41, ngf / nef / ndf 64, nz
# 256, 256 px; the discriminators take RGB + 41 segmentation channels, as
# the shading trainer builds them), with the parameter counts of the JAX
# package's classes (jax.eval_shape); generator 3 and the PSP-SE encoder
# also take a backward. Card against CPU: outputs max abs SPADE_VARIANT_ERR
# (the spade phase's bound), the spectral vectors after one training
# forward SPADE_SPECTRAL_ERR. Gradients: the card's and the CPU's float32
# against each other and each against the card's float64, all of them as
# one vector and each tensor whose gradient is above rounding (norm over
# 1e-5 of the largest tensor's: a conv bias before an instance norm has a
# gradient of rounding alone), relative, SPADE_VARIANT_GRAD_REL: on
# generator 3, whose instance norms start at an 8 x 8 map, the card's
# float32 gradient is 1.31e-3 from float64 and the CPU's 5.1e-4 (PERF.md
# §6), so 1e-3 would gate float32's rounding, not the port
SPADE_VARIANTS = [  # (name, module, input, parameters, backward)
    ("SPADEGenerator", lambda: spade_classic.SPADEGenerator(), "gen",
     109_740_611, False),
    ("SPADEGenerator2", lambda: spade_variants.SPADEGenerator2(), "gen",
     74_106_627, False),
    ("SPADEGenerator3", lambda: spade_variants.SPADEGenerator3(), "gen",
     111_396_995, True),
    ("SPADEGenerator5", lambda: spade_variants.SPADEGenerator5(), "gen",
     110_477_539, False),
    ("ConvEncoder", lambda: ConvEncoder(64, 256, 256), "img", 6_533_248,
     False),
    ("ConvEncoderPSPSE", lambda: spade_encoders.ConvEncoderPSPSE(64, 256),
     "img", 29_612_288, True),
    ("ConvEncoderPSPSEMMD2",
     lambda: spade_encoders.ConvEncoderPSPSEMMD2(64, 256), "img",
     63_168_512, False),
    ("NLayerDiscriminatorMMD",
     lambda: spade_encoders.NLayerDiscriminatorMMD(44, 64, 3, 256), "disc",
     832_705, False),
    ("MultiscaleDiscriminatorMMD",
     lambda: spade_encoders.MultiscaleDiscriminatorMMD(44, 64, 3, 2, 256),
     "disc", 1_058_690, False),
]
SPADE_VARIANT_ERR = 1e-3
SPADE_SPECTRAL_ERR = 1e-4
SPADE_VARIANT_GRAD_REL = 1e-2


def _flat(out) -> list:
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def spade_variant_inputs(kind: str, B: int) -> tuple:
    """Seeded inputs on the CPU: (seg, z) for a generator, an image batch
    for an encoder, RGB + segmentation for a discriminator."""
    gen = torch.Generator().manual_seed(21)
    seg = torch.zeros(B, 41, 256, 256)
    seg[:, 0] = torch.rand(B, 256, 256, generator=gen) * 2 - 1
    cls = torch.randint(1, 41, (B, 1, 256, 256), generator=gen)
    seg.scatter_(1, cls, 1.0)
    rgb = torch.rand(B, 3, 256, 256, generator=gen) * 2 - 1
    if kind == "gen":
        return seg, torch.randn(B, 256, generator=gen)
    return (rgb,) if kind == "img" else (torch.cat([rgb, seg], 1),)


def float64_copy(model, device):
    """model in float64 on device, its convs computing in float64 too."""
    m = copy.deepcopy(model).to(device).double()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return m


def grad_rel(model_a, model_b) -> dict:
    """model_a's gradients against model_b's: relative error (norm of the
    difference over model_b's norm) of all of them as one vector, and the
    largest per tensor among the tensors above rounding level; raises on a
    missing or non-finite gradient."""
    ga = {n: p.grad for n, p in model_a.named_parameters()}
    gb = {n: p.grad.double().cpu() for n, p in model_b.named_parameters()}
    for n, g in ga.items():
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient of {n} missing or not finite")
    diff = {n: float((ga[n].double().cpu() - g).norm())
            for n, g in gb.items()}
    norms = {n: float(g.norm()) for n, g in gb.items()}
    floor = 1e-5 * max(norms.values())
    rels = {n: diff[n] / norms[n] for n in gb if norms[n] > floor}
    worst = max(rels, key=rels.get)
    return {"all_rel": float(np.linalg.norm(list(diff.values()))
                             / np.linalg.norm(list(norms.values()))),
            "tensor_max_rel": rels[worst], "worst_tensor": worst,
            "tensors_compared": len(rels),
            "tensors_at_rounding": len(gb) - len(rels)}


def spade_variants_phase(device, smi: str) -> dict:
    """ROADMAP item 6's classes on the card at full width, each from
    init_like_jax on the card: two forwards at batch 2 the same bits, the
    module copied to the CPU within SPADE_VARIANT_ERR at batch 1, the
    spectral vectors after one training forward card against CPU, the
    backward of generator 3 and of the PSP-SE encoder card against CPU,
    and forward ms at batch 2 beside the conv-FLOP bound."""
    res = {}
    with phase("spade_variants"):
        for i, (name, make, kind, n_expect, backward) in enumerate(
                SPADE_VARIANTS):
            t0 = time.perf_counter()
            model = spade_port.init_like_jax(make().to(device), 100 + i)
            n_params = sum(p.numel() for p in model.parameters())
            if n_params != n_expect:
                raise AssertionError(f"{name}: {n_params} parameters, the "
                                     f"JAX package's has {n_expect}")
            model_c = copy.deepcopy(model).cpu()
            x2 = [t.to(device) for t in spade_variant_inputs(kind, 2)]
            x1 = [t[:1] for t in spade_variant_inputs(kind, 2)]
            with torch.no_grad():
                runs = [_flat(model(*x2)) for _ in range(2)]
                on_cpu = _flat(model_c(*x1))
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            err = max(max_err(a[:1].cpu(), b)
                      for a, b in zip(runs[0], on_cpu))
            if not all(bool(torch.isfinite(t).all()) for t in runs[0]):
                raise AssertionError(f"{name}: output not finite")
            if not same:
                raise AssertionError(f"{name}: two runs on the card differ")
            if not err <= SPADE_VARIANT_ERR:
                raise AssertionError(f"{name}: card vs CPU {err} > "
                                     f"{SPADE_VARIANT_ERR}")
            rec = {"parameters": n_params, "outputs": len(runs[0]),
                   "card_vs_cpu_max_abs_err": err, "two_runs_equal": same}
            del runs, on_cpu
            with torch.no_grad():
                fwd = [event_ms(lambda: model(*x2), 2, 1 if k == 0 else 0)
                       for k in range(3)]
                flops = conv_flops(model, lambda: model(*x2))
            rec["forward_ms_b2"] = min(fwd)
            rec["gflop"] = flops / 1e9
            rec["peak_share"] = flops / PEAK_FP32_FLOPS / (min(fwd) / 1e3)
            line = (f"  {name}: {n_params} parameters; two card runs "
                    f"equal; card vs CPU max abs err {err:.3e} (bound "
                    f"{SPADE_VARIANT_ERR}); forward at batch 2 "
                    f"{min(fwd):.3f} ms (best of 3, CUDA events), "
                    f"{flops / 1e9:.1f} GFLOP = "
                    f"{100 * rec['peak_share']:.1f} % of the fp32 peak")
            if kind != "gen":
                with torch.no_grad():
                    model(*x2, True)
                    model_c(*x1, True)
                bufs_c = dict(model_c.named_buffers())
                sp_err = max(max_err(b.cpu(), bufs_c[n])
                             for n, b in model.named_buffers())
                rec["spectral_vectors"] = len(bufs_c)
                rec["spectral_max_abs_err"] = sp_err
                if not sp_err <= SPADE_SPECTRAL_ERR:
                    raise AssertionError(f"{name}: spectral vectors card vs "
                                         f"CPU {sp_err}")
                line += (f"; {len(bufs_c)} spectral vectors after train=True"
                         f" card vs CPU {sp_err:.3e} (bound "
                         f"{SPADE_SPECTRAL_ERR})")
            if backward:
                # card and CPU in float32, and the card in float64: the
                # float32 floor beside the card-CPU agreement
                model_64 = float64_copy(model_c, device)
                outs = {}
                for m, dev, dt in ((model, device, torch.float32),
                                   (model_c, "cpu", torch.float32),
                                   (model_64, device, torch.float64)):
                    # the backward too under conv_math, as the shading
                    # trainer's steps run (spade/losses.py)
                    with conv_math():
                        ys = _flat(m(*[t.to(dev, dt) for t in x1]))
                        gen = torch.Generator().manual_seed(22)
                        loss = sum((y * torch.randn(
                            y.shape, generator=gen).to(dev, dt)).sum()
                            for y in ys)
                        loss.backward()
                    outs[str(dt)[6:] + "_" + str(dev)] = float(loss.detach())
                g = rec["gradients"] = {
                    "card_vs_cpu": grad_rel(model, model_c),
                    "card_vs_float64": grad_rel(model, model_64),
                    "cpu_vs_float64": grad_rel(model_c, model_64),
                    "losses": outs}
                del model_64
                worst = max(max(v["all_rel"], v["tensor_max_rel"])
                            for k, v in g.items() if k != "losses")
                if not worst <= SPADE_VARIANT_GRAD_REL:
                    raise AssertionError(f"{name}: gradients {g}")
                line += "; backward at batch 1 (loss " + ", ".join(
                    f"{k} {v:.6f}" for k, v in outs.items()) + ")" + "".join(
                    f", {k.replace('_', ' ')}: all gradients "
                    f"{v['all_rel']:.2e}, per tensor at most "
                    f"{v['tensor_max_rel']:.2e} ({v['worst_tensor']})"
                    for k, v in g.items() if k != "losses") + (
                    f" (relative; bound {SPADE_VARIANT_GRAD_REL}; "
                    f"{g['card_vs_cpu']['tensors_compared']} tensors, "
                    f"{g['card_vs_cpu']['tensors_at_rounding']} at rounding "
                    "level)")
            rec["seconds"] = time.perf_counter() - t0
            print(f"{line}; {rec['seconds']:.1f} s, on {smi}", flush=True)
            res[name] = rec
            del model, model_c, x1, x2
            torch.cuda.empty_cache()
    return res


# the bf16 phase: the card's dense bf16 tensor-core peak (NVIDIA data
# sheet, H100 SXM), and the JAX package's account of bf16 shading's mean
# image error (sln_tpu/config.py:229-230), printed beside the port's
PEAK_BF16_FLOPS = 989e12
JAX_BF16_IMAGE_ERR = 1.5 / 255


def rel(a, b) -> float:
    """Relative Frobenius norm |a - b| / |b| of two equal-length lists."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_train(tmp: str, device, smi: str, fp32_rate: float) -> dict:
    """`python -m sln_tpu_torch.train --compute_dtype bfloat16` at the
    recipe's width; returns its numbers."""
    out_dir = os.path.join(tmp, "train_bf16")
    argv = [*RECIPE, "--compute_dtype", "bfloat16",
            "--num_iterations", str(TRAIN_ITERS),
            "--print_every", str(TRAIN_ITERS // 3),
            "--checkpoint_every", str(TRAIN_ITERS),
            "--snapshot_every", str(TRAIN_ITERS),
            "--output_dir", out_dir, "--checkpoint_name", "smoke"]
    state, ckpt, seconds = train_run(argv, device)
    total = ckpt["losses"]["total_loss"]
    if not total[-1] < total[0]:
        raise AssertionError(f"bf16 total_loss did not fall: {total}")
    cfg = train_cli.config_from_args(train_cli.parse_args(argv))
    if state.model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("the bf16 trainer's model is not a bf16 model "
                             "with float32 parameters")
    restored = common.restore_model(cfg, device)
    batch = batch_of_rooms(cfg, 8, 3, device)
    z = torch.randn(batch.boxes.shape[:2] + (cfg.model.latent_dim,),
                    generator=torch.Generator(device).manual_seed(4),
                    device=device)
    with torch.no_grad():
        want = state.model.eval().decode(z, batch)
        got = restored.decode(z, batch)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the restored bf16 checkpoint decodes "
                             "differently from the trained model")
    print(f"  bf16 total_loss at t = {ckpt['losses_ts']}: {total}; "
          "restore_model decodes as the trained model, bit for bit",
          flush=True)

    # card bf16 against CPU bf16. bfloat16 turns the last-bit differences
    # of the card's and the CPU's float32 sums (the BatchNorm statistics
    # over 6,144 rows, a GEMM's accumulation order) into whole-ulp flips,
    # and every layer after spreads them: measured op by op on one
    # encoder pass, 4e-5 of the first GEMM's outputs flip, 7e-3 after the
    # next BatchNorm, 1.5e-2 within the first graph conv. So the CPU tests'
    # gate, half the card's bf16-fp32 gap, is held where the inputs are
    # the same: one MLP + BatchNorm stack at the recipe's width (the first
    # graph conv's net1, train mode). Two whole steps share the cast points
    # but not the cascade: the card's bf16 must lie nearer the CPU's bf16
    # than its own fp32 (independent roundings would lie sqrt(2) times
    # further).
    cpu = torch.device("cpu")
    net = common.restore_model(cfg, cpu).gconv_net_ec.gconvs[0].net1
    g = torch.Generator().manual_seed(5)
    x = torch.randn(6144, net[0].in_features, generator=g)
    valid = torch.rand(6144, generator=g) < 0.75
    ys = {}
    for name, dev, dt in (("card_bf16", device, torch.bfloat16),
                          ("cpu_bf16", cpu, torch.bfloat16),
                          ("card_fp32", device, torch.float32)):
        m = copy.deepcopy(net).to(dev).train()
        m.dtype = dt
        with torch.no_grad():
            ys[name] = m(x.to(dev), valid.to(dev)).float().cpu()[valid]
    mlp = {"rel_card_cpu": rel(ys["card_bf16"], ys["cpu_bf16"]),
           "rel_bf16_fp32": rel(ys["card_bf16"], ys["card_fp32"])}
    print(f"  MLP + BatchNorm (384 -> 256 -> 640, 6144 rows, train mode), the "
          f"same inputs: rel(card bf16, CPU bf16) {mlp['rel_card_cpu']:.3e}, "
          f"rel(card bf16, card fp32) {mlp['rel_bf16_fp32']:.3e} (gate: the "
          f"first at most half the second)", flush=True)
    if not (0 < 2 * mlp["rel_card_cpu"] <= mlp["rel_bf16_fp32"]):
        raise AssertionError(f"bf16 MLP card vs CPU: {mlp}")

    # two steps with the same random numbers from two states: the committed
    # checkpoint's (the end of its recipe, Adam state included) and this
    # run's (200 steps in, near its early KL peak)
    arrays, size_info = common.load_arrays(4096, cfg, device,
                                           synthetic_seed=42)
    rows = np.arange(cfg.train.batch_size)
    raw_host = {k: v[rows] for k, v in arrays.items()}
    gen = torch.Generator().manual_seed(0)
    B, O = raw_host["objs"].shape
    draws = [[(draw_graph_randomness(B, O, gen, "cpu"),
               torch.randn(B, O, cfg.model.latent_dim, generator=gen))]
             for _ in range(2)]
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  compute_dtype="float32"))
    states = {"committed": train_ckpt.latest_path(
                  CHECKPOINT.output_dir, CHECKPOINT.checkpoint_name),
              "this run": train_ckpt.latest_path(out_dir, "smoke")}
    card_vs_cpu = {"mlp": mlp}
    for label, path in states.items():
        trained = train_ckpt.load_checkpoint(path)
        runs = {}
        for name, dev, c in (("card_bf16", device, cfg),
                             ("cpu_bf16", cpu, cfg),
                             ("card_fp32", device, cfg32)):
            si = type(size_info)(*(x.to(dev) for x in size_info))
            st = train_loop.create_state(c, dev, trained)
            step = train_loop.make_train_step(st, c, si)
            raw = train_loop.stage_arrays(raw_host, dev)
            runs[name] = [{k: float(v) for k, v in step(raw, d).items()}
                          for d in draws]
        keys = sorted(k for k in runs["card_bf16"][0] if k != "skipped_nan")

        def vec(name):
            return [r[k] for r in runs[name] for k in keys]
        ours = rel(vec("card_bf16"), vec("cpu_bf16"))
        gap = rel(vec("card_bf16"), vec("card_fp32"))
        card_vs_cpu[label] = {**runs, "rel_card_cpu": ours,
                              "rel_bf16_fp32": gap}
        print(f"  2 steps at batch {B} from {label}'s state, losses {keys}: "
              f"rel(card bf16, CPU bf16) {ours:.3e}, rel(card bf16, card "
              f"fp32) {gap:.3e} (gate: the first below the second); "
              f"total_loss card bf16 "
              f"{[r['total_loss'] for r in runs['card_bf16']]}", flush=True)
        if not (0 < ours < gap):
            raise AssertionError(f"bf16 train steps card vs CPU from "
                                 f"{label}'s state: {ours} not below the "
                                 f"bf16 gap {gap}")

    # one bf16 step twice, op by op: the same bits
    staged = train_loop.stage_arrays(arrays, device)
    raw = train_loop.gather_batch(staged, rows)
    pair = []
    for _ in range(2):
        st = train_loop.create_state(cfg, device)
        pair.append((st, train_loop.make_train_step(st, cfg, size_info)))
    traces = []
    for st, step in pair:
        with op_trace_mode() as trace:
            step(raw)
        traces.append(trace)
    t1, t2 = traces
    if t1.names != t2.names:
        raise AssertionError("two identical bf16 train steps ran different "
                             "ops")
    differ = (torch.stack(t1.sums) != torch.stack(t2.sums)).nonzero()
    same_state = all(torch.equal(a, b) for a, b in zip(
        pair[0][0].state_tensors(), pair[1][0].state_tensors()))
    print(f"  one bf16 train step twice: {len(t1.names)} op outputs "
          f"compared, {len(differ)} differ; parameters, Adam and BatchNorm "
          f"state {'equal' if same_state else 'DIFFER'}", flush=True)
    if len(differ) or not same_state:
        raise AssertionError("bf16 training is not bitwise reproducible")

    # throughput, the train phase's windows
    step = pair[0][1]
    step(raw)
    windows = [event_ms(lambda: step(raw), 60, 0) for _ in range(2)]
    rate = B / (min(windows) / 1e3)
    print(f"  bf16 train step at batch {B}: {windows[0]:.3f}, "
          f"{windows[1]:.3f} ms (CUDA events, 60 steps each) = {rate:.0f} "
          f"scenes/s; fp32 in this call {fp32_rate:.0f} scenes/s; on {smi}",
          flush=True)
    return {"train_run_s": seconds, "iterations": TRAIN_ITERS,
            "total_loss": total, "card_vs_cpu": card_vs_cpu,
            "step_ms": windows,
            "train_scenes_per_sec": rate,
            "fp32_train_scenes_per_sec": fp32_rate}


def bf16_sampling(cfg, tmp: str, device, smi: str) -> dict:
    """The committed checkpoint's quality cell with a bf16 VAE, and the
    sampler's rate in both dtypes; returns the numbers."""
    cfg_b = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    model_b = common.restore_model(cfg_b, device)
    q, mean, cov = quality_cell(model_b, cfg_b, tmp, device,
                                against_jax=False)
    for k, (lo, hi) in QUALITY_BANDS.items():
        if not lo <= q[k] <= hi:
            raise AssertionError(f"bf16 {k} {q[k]} outside the fp32 band "
                                 f"[{lo}, {hi}]")
    batch = heatmap.heatmap_scene_batch(4096, 8, 24, device=device)
    rates = {}
    for name, model in (("float32", common.restore_model(cfg, device)),
                        ("bfloat16", model_b)):
        sample = heatmap.make_sampler(model, batch, mean, cov)
        gen = torch.Generator(device).manual_seed(0)
        shape = (4096, 8, len(mean))
        ms = event_ms(lambda: sample(torch.randn(shape, generator=gen,
                                                 device=device)), 40, 5)
        rates[name] = 4096 / (ms / 1e3)
    print(f"  bf16 quality cell inside the fp32 bands; sampler layouts/s at "
          f"batch 4096 (CUDA events, 40 calls): fp32 {rates['float32']:.0f}, "
          f"bf16 {rates['bfloat16']:.0f}, on {smi}", flush=True)
    return {**q, "sampler_layouts_per_s": rates}


def bf16_shading(cfg, tmp: str, device, smi: str, fp32: dict) -> dict:
    """--spade_dtype bfloat16 on the committed generator; returns its
    numbers and the forward kernel's launches on the --gan_shade run."""
    from sln_tpu_torch.spade import generator as spade_gen

    cfg_b = cfg.replace(spade=dataclasses.replace(
        cfg.spade, compute_dtype="bfloat16"))
    model_b = gan_shade.make_spade_model(cfg_b, SPADE_CHECKPOINT, device)
    model_f = gan_shade.make_spade_model(cfg, SPADE_CHECKPOINT, device)
    stored = {n: p.dtype for n, p in model_b.named_parameters()}
    se = {n for n in stored if ".se." in n}
    if not se or any(stored[n] != torch.float32 for n in se) or any(
            d != torch.bfloat16 for n, d in stored.items() if n not in se):
        raise AssertionError("bf16 serving weights: SE layers must stay "
                             "float32, every other weight bfloat16")
    mb = sum(p.numel() * p.element_size() for p in model_b.parameters())
    mf = sum(p.numel() * p.element_size() for p in model_f.parameters())
    # the same model with float32 weights cast at each call
    cast = spade_gen.SPADEGenerator4(
        nz=model_f.nz, ngf=model_f.ngf, crop_size=model_f.crop_size,
        dtype=torch.bfloat16)
    cast.load_state_dict(model_f.state_dict())
    cast = cast.to(device).eval()

    segs = gan_shade.render_spade_inputs(8, cfg, model_b.crop_size,
                                         synthetic_seed=19, key_offset=100,
                                         device=device)
    zq = {seed: torch.randn(len(segs), model_b.nz, device=device,
                            generator=torch.Generator(device).manual_seed(
                                seed)) for seed in SPADE_Z_SEEDS}
    with torch.inference_mode():
        img_b = model_b(segs, zq[SPADE_Z_SEEDS[0]])
        same_bits = torch.equal(img_b, cast(segs, zq[SPADE_Z_SEEDS[0]]))
        twice = torch.equal(img_b, model_b(segs, zq[SPADE_Z_SEEDS[0]]))
        img_f = model_f(segs, zq[SPADE_Z_SEEDS[0]])
    del cast
    # mean |difference| on the [0, 255] scale of the PNGs
    img_err = float((img_b - img_f).abs().mean()) * 127.5
    print(f"  bf16 weights {mb / 2**20:.1f} MiB (fp32 {mf / 2**20:.1f}); "
          f"bf16-stored against fp32 weights cast per call: "
          f"{'the same bits' if same_bits else 'DIFFERENT BITS'}; two runs "
          f"{'equal' if twice else 'DIFFER'}; mean |bf16 - fp32| image "
          f"{img_err:.4f} / 255 (JAX package: about "
          f"{JAX_BF16_IMAGE_ERR * 255:.1f} / 255)", flush=True)
    if not same_bits or not twice:
        raise AssertionError("bf16 shading is not bitwise reproducible, or "
                             "its stored weights change the output")

    out_root = os.path.join(tmp, "spade_bf16")
    rc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = entry.main([
        "--gan_shade", "--synthetic", "32", "--spade_dtype", "bfloat16",
        "--output_dir", CHECKPOINT.output_dir,
        "--checkpoint_name", CHECKPOINT.checkpoint_name,
        "--test_dir", out_root, "--spade_checkpoint", SPADE_CHECKPOINT,
        "--device", device.type])
    torch.cuda.synchronize()
    shade_s = time.perf_counter() - t0
    launches = rc.FWD_LAUNCHES
    shapes = {image_io.read_png(p).shape for p in paths}
    print(f"  --gan_shade --spade_dtype bfloat16: {len(paths)} PNGs in "
          f"{shade_s:.1f} s; rasterizer launches fwd {launches}, bwd "
          f"{rc.BWD_LAUNCHES}", flush=True)
    if len(paths) != SPADE_ROOMS * 50 or shapes != {
            (model_b.crop_size, model_b.crop_size, 3)}:
        raise AssertionError(f"bf16 --gan_shade wrote {len(paths)} PNGs of "
                             f"{shapes}")
    if launches != 2 * SPADE_ROOMS or rc.BWD_LAUNCHES:
        raise AssertionError(f"bf16 --gan_shade: fwd {launches} / bwd "
                             f"{rc.BWD_LAUNCHES} launches")

    metrics = gan_shade.make_shading_metrics(model_b)
    target = gan_shade.shading_target(segs)
    quality = {}
    for seed, z in zq.items():
        l1, psnr, _ = metrics(segs, target, z)
        quality[seed] = {"psnr": psnr, "l1": l1}
    print("  bf16 quality (8 held-out rooms, one z each): " + "; ".join(
        f"z seed {k}: PSNR {v['psnr']:.4f} dB, L1 {v['l1']:.5f}"
        for k, v in quality.items()), flush=True)
    for seed, q in quality.items():
        for k, (lo, hi) in SPADE_BANDS.items():
            if not lo <= q[k] <= hi:
                raise AssertionError(f"bf16 z seed {seed}: {k} {q[k]} "
                                     f"outside [{lo}, {hi}]")

    # the serving rate, as the spade phase measures it
    seg1 = segs[:1]
    zs = gan_shade.draw_zs(50, model_b.nz, device=device)
    with torch.inference_mode():
        def room(seg):
            mods = model_b.seg_mods(seg)
            for z in zs:
                model_b.decode(mods, z)
        room(seg1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(len(segs)):
            room(segs[i:i + 1])
        end.record()
        torch.cuda.synchronize()
        room_ms = start.elapsed_time(end) / len(segs)
        mods = model_b.seg_mods(seg1)
        seg_ms = event_ms(lambda: model_b.seg_mods(seg1), 10, 2)
        dec_flops = conv_flops(model_b, lambda: model_b.decode(mods, zs[0]))
        # the decode on each deterministic conv route
        route_ms = {}
        chosen = spade_gen.CUDNN_CONVS[torch.bfloat16]
        try:
            for use_cudnn in (True, False):
                spade_gen.CUDNN_CONVS[torch.bfloat16] = use_cudnn
                route_ms["cudnn" if use_cudnn else "im2col"] = event_ms(
                    lambda: model_b.decode(mods, zs[0]), 10, 2)
        finally:
            spade_gen.CUDNN_CONVS[torch.bfloat16] = chosen
        dec_ms = event_ms(lambda: model_b.decode(mods, zs[0]), 10, 2)
    rate = 50 / (room_ms / 1e3)
    dec_bound = dec_flops / PEAK_BF16_FLOPS * 1e3
    route = "cudnn" if chosen else "im2col"
    print(f"  bf16 serving: {room_ms:.3f} ms per room of 50 z = {rate:.1f} "
          f"imgs/s (fp32 in this call {fp32['imgs_per_sec_device']:.1f}); "
          f"seg_mods {seg_ms:.3f} ms (fp32 {fp32['seg_mods_ms']:.3f}); "
          f"decode of 10 z {dec_ms:.3f} ms on {route} (fp32 "
          f"{fp32['decode10_ms']:.3f}; bf16 bound {dec_bound:.3f}: "
          f"{dec_flops / 1e9:.1f} GFLOP at the dense bf16 peak); decode "
          f"by route: cuDNN {route_ms['cudnn']:.3f} ms, im2col + cuBLAS "
          f"{route_ms['im2col']:.3f} ms; on {smi}", flush=True)
    return {"weights_mib": mb / 2**20, "fp32_weights_mib": mf / 2**20,
            "stored_vs_cast_same_bits": same_bits,
            "image_mean_abs_err_255": img_err, "gan_shade_s": shade_s,
            "gan_shade_pngs": len(paths), "fwd_launches": launches,
            "quality": quality, "room_ms": room_ms,
            "imgs_per_sec_device": rate,
            "fp32_imgs_per_sec_device": fp32["imgs_per_sec_device"],
            "seg_mods_ms": seg_ms, "decode10_ms": dec_ms,
            "fp32_decode10_ms": fp32["decode10_ms"],
            "decode10_bound_ms": dec_bound, "decode10_route": route,
            "decode10_route_ms": route_ms}


# the draw3d phase: --batch_gen's layouts of DRAW3D_ROOMS val rooms (4 each)
# rendered by the preview at the CLI's 256 px
DRAW3D_ROOMS = 16
DRAW3D_PX = 256


def _captured(fn):
    """(fn(), what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _with_layouts(src: str, dst: str) -> str:
    """A test dir at dst holding src's data_extracted.json."""
    os.makedirs(os.path.join(dst, "data"), exist_ok=True)
    shutil.copy(os.path.join(src, "data", "data_extracted.json"),
                os.path.join(dst, "data", "data_extracted.json"))
    return dst


def preview_gate(name, got, want) -> dict:
    """The kernels phase's culled-against-dense gate on a preview render
    (depth (1, S, S), NYU-40 classes (1, S, S, 40)): depth within
    TOL["depth"], no class-mask value flipped at 0.5, the same foreground,
    the same winning class wherever the top two differ by more than 1e-3."""
    (d_g, c_g), (d_w, c_w) = got, want
    check_close(f"{name} depth", d_g, d_w, *TOL["depth"])
    flips = int(((c_g > 0.5) != (c_w > 0.5)).sum())
    fg_g = (c_g.sum(-1) > 0.5) & (d_g < preview.Z_FAR * 0.99)
    fg_w = (c_w.sum(-1) > 0.5) & (d_w < preview.Z_FAR * 0.99)
    top2 = c_w.topk(2, -1).values
    clear = fg_w & (top2[..., 0] - top2[..., 1] > 1e-3)
    argmax_diff = int((c_g.argmax(-1) != c_w.argmax(-1))[clear].sum())
    if flips or not torch.equal(fg_g, fg_w) or argmax_diff:
        raise AssertionError(f"{name}: {flips} class-mask flips, "
                             f"{int((fg_g != fg_w).sum())} foreground "
                             f"pixels differ, {argmax_diff} winning classes "
                             "differ")
    return {"depth_max_abs_err": max_err(d_g, d_w),
            "classes_max_abs_err": max_err(c_g, c_w)}


def draw3d_phase(tmp: str, device, smi: str, fine_tune_hist) -> dict:
    """--draw_3d on the card: the preview through main under each renderer
    (no Blender binary here), its kernel against the plain dense render and
    the CPU, its rate; --gan_shade from Blender-named files; the refine
    dumps of --save_semantic_gifs. Returns its numbers and the forward
    kernel's launches."""
    with phase("draw3d"):
        root = os.path.join(tmp, "draw3d")
        common_argv = ["--output_dir", CHECKPOINT.output_dir,
                       "--checkpoint_name", CHECKPOINT.checkpoint_name,
                       "--device", device.type]
        entry.main(["--batch_gen", "--synthetic", str(4 * DRAW3D_ROOMS),
                    *common_argv, "--test_dir", root])
        layouts = list(scene_spec.iter_extracted_layouts(root))
        n = len(layouts)
        if n != 4 * DRAW3D_ROOMS:
            raise AssertionError(f"--batch_gen wrote {n} layouts")
        found = shutil.which("blender")
        print(f"  shutil.which('blender'): {found}", flush=True)
        if found is not None:
            raise AssertionError("this phase expects no Blender binary")

        # the preview through main: one forward call (two launches) per
        # layout, nothing else
        runs = {}
        for renderer in ("preview", "auto"):
            test_dir = _with_layouts(root, os.path.join(tmp, renderer))
            rc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            count, text = _captured(lambda: entry.main([
                "--draw_3d", "--renderer", renderer, "--test_dir", test_dir,
                "--device", device.type]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[renderer] = {"wall_s": wall, "fwd": rc.FWD_LAUNCHES,
                              "bwd": rc.BWD_LAUNCHES, "dir": os.path.join(
                                  test_dir, "data", "rendered")}
            if count != n or rc.FWD_LAUNCHES != 2 * n or rc.BWD_LAUNCHES:
                raise AssertionError(
                    f"--draw_3d --renderer {renderer}: {count} images, "
                    f"launches fwd {rc.FWD_LAUNCHES} / bwd "
                    f"{rc.BWD_LAUNCHES} for {n} layouts")
            fallback = "using the rasterizer preview renderer" in text
            if fallback != (renderer == "auto"):
                raise AssertionError(f"--renderer {renderer} printed: "
                                     f"{text[:300]}")
            print(f"  --draw_3d --renderer {renderer}: {count} PNGs in "
                  f"{wall:.2f} s (layouts, render, PNG writes); launches "
                  f"fwd {rc.FWD_LAUNCHES}, bwd {rc.BWD_LAUNCHES}"
                  + ("; printed the fallback to the preview" if fallback
                     else ""), flush=True)
        names = sorted(os.listdir(runs["preview"]["dir"]))
        want = sorted(scene_spec.color_filename(r, k)
                      for r, k, *_ in layouts)
        if names != want or sorted(os.listdir(runs["auto"]["dir"])) != want:
            raise AssertionError(f"--draw_3d wrote {names[:4]}...")
        shapes = {image_io.read_png(os.path.join(runs["preview"]["dir"],
                                                 f)).shape for f in names}
        if shapes != {(DRAW3D_PX, DRAW3D_PX, 3)}:
            raise AssertionError(f"preview PNG shapes {shapes}")
        for f in names:
            with open(os.path.join(runs["preview"]["dir"], f), "rb") as a, \
                    open(os.path.join(runs["auto"]["dir"], f), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{f}: auto and preview differ")
        print(f"  {n} PNGs of {DRAW3D_PX} x {DRAW3D_PX} x 3 (read_png); "
              "auto's bytes equal preview's", flush=True)
        none, text = _captured(lambda: entry.main([
            "--draw_3d", "--renderer", "blender", "--device", device.type,
            "--test_dir", _with_layouts(root, os.path.join(tmp, "blender"))]))
        if none is not None or "draw_3d unavailable" not in text:
            raise AssertionError(f"--renderer blender: {text[:300]}")
        try:
            entry.main(["--gan_shade", "--semantic_source", "blender",
                        "--synthetic", "32", *common_argv,
                        "--test_dir", os.path.join(tmp, "gan_blender")])
            raise AssertionError("--semantic_source blender ran without "
                                 "a Blender binary")
        except blender_bridge.BlenderNotAvailable as e:
            print(f"  --renderer blender: 'draw_3d unavailable'; --gan_shade"
                  f" --semantic_source blender raised BlenderNotAvailable "
                  f"({str(e)[:40]}...)", flush=True)

        # the kernel against the plain dense render on the card, and
        # against the CPU; the same bits twice
        bank, shells = scene_spec.load_bank()
        S = DRAW3D_PX
        dense, cpu = [], []
        for i, (_, _, objs, boxes, angles) in enumerate(layouts[:8]):
            geom, focal = preview.layout_geometry(objs, boxes, angles, bank,
                                                  shells, S, device)
            with torch.no_grad():
                k = preview.rasterize_nyu(geom, S)
                if not all(torch.equal(a, b) for a, b in zip(
                        k, preview.rasterize_nyu(geom, S))):
                    raise AssertionError(f"layout {i}: two kernel renders "
                                         "differ")
                dense.append(preview_gate(
                    f"layout {i} kernel vs dense", k, preview.rasterize_nyu(
                        geom, S, raster=raster.soft_rasterize)))
                if i < 2:
                    g_cpu, _ = preview.layout_geometry(
                        objs, boxes, angles, bank, shells, S, "cpu")
                    on_cpu = preview.rasterize_nyu(g_cpu, S)
                    cpu.append(preview_gate(
                        f"layout {i} card vs CPU", k,
                        tuple(x.to(device) for x in on_cpu)))
        objs, boxes, angles = layouts[0][2:]
        twice = [preview.render_preview(objs, boxes, angles, bank, shells,
                                        S, device=device) for _ in range(2)]
        if not torch.equal(*twice):
            raise AssertionError("two preview renders of one layout differ")
        gate = {k: max(d[k] for d in dense) for k in dense[0]}
        gate_cpu = {k: max(d[k] for d in cpu) for k in cpu[0]}
        print(f"  8 layouts, kernel vs plain dense soft_rasterize on the "
              f"card: depth max abs err {gate['depth_max_abs_err']:.3e}, "
              f"classes {gate['classes_max_abs_err']:.3e}, 0 mask flips, "
              f"same foreground and winning classes; 2 layouts card vs CPU:"
              f" depth {gate_cpu['depth_max_abs_err']:.3e}, classes "
              f"{gate_cpu['classes_max_abs_err']:.3e}; one layout rendered "
              "twice: the same bits", flush=True)

        # the rate: CUDA events around the renders (no files), then each
        # stage synchronised on its own
        for args in layouts[:2]:
            preview.render_preview(*args[2:], bank, shells, S, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for args in layouts:
            preview.render_preview(*args[2:], bank, shells, S, device=device)
        end.record()
        torch.cuda.synchronize()
        render_ms = start.elapsed_time(end) / n
        stages = {"geometry": 0.0, "kernel": 0.0, "shade": 0.0}
        kernel_dev_ms = 0.0
        with torch.no_grad():
            for args in layouts:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                geom, focal = preview.layout_geometry(*args[2:], bank, shells,
                                                      S, device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                start.record()
                d, c = preview.rasterize_nyu(geom, S)
                end.record()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                kernel_dev_ms += start.elapsed_time(end)
                preview.shade(d[0], c[0], focal, preview.Z_FAR)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                    stages[key] += dt * 1e3 / n
        total = sum(stages.values())
        share = {k: v / total for k, v in stages.items()}
        rate = 1e3 / render_ms
        print(f"  preview rate: {render_ms:.3f} ms per layout (CUDA events "
              f"over {n} layouts, no files) = {rate:.1f} layouts/s; with "
              f"the PNG writes, through main: {n / runs['preview']['wall_s']:.1f}"
              f" layouts/s; per layout, each stage synchronised: geometry "
              f"{stages['geometry']:.3f} ms ({share['geometry']:.1%}), "
              f"pack + cull + kernel + scatter {stages['kernel']:.3f} ms "
              f"({share['kernel']:.1%}; {kernel_dev_ms / n:.3f} ms by CUDA "
              f"events), shading {stages['shade']:.3f} ms "
              f"({share['shade']:.1%}); on {smi}", flush=True)

        # --gan_shade from Blender-named files: the first four val rooms'
        # masks and .npy depth, from the port's rasterizer render
        cfg = default_config().replace(train=CHECKPOINT)
        sem = os.path.join(tmp, "files", "data", "semantic_masks")
        os.makedirs(sem)
        val, size_info = common.load_arrays(8, cfg, device,
                                            synthetic_seed=99)
        rcfg, bank_host, dbank = gan_shade._render_setup(cfg, 256, device)
        written = {}
        for i in range(SPADE_ROOMS):
            room_id = str(int(val["room_ids"][i]))
            b = gan_shade._room_batch(val, i, size_info, cfg, 0, device)
            with torch.no_grad():
                ch = gan_shade.render_scene_channels(b, bank_host, dbank,
                                                     rcfg).cpu().numpy()
            name = scene_spec.pred_name(room_id, 0)
            depth = np.where(ch[0] < 0, 1e10, ch[0]).astype(np.float32)
            np.save(os.path.join(sem, name + "_depth.npy"), depth)
            masks = ch[1:41] > 0.5
            for c in np.nonzero(masks.any((1, 2)))[0]:
                image_io.write_png(os.path.join(sem, scene_spec.mask_filename(
                    name, NYU40_CLASSES[c])),
                    np.repeat(masks[c, ..., None] * np.uint8(255), 3, -1))
            d = depth - depth.min()
            dmax = d[d < 20].max()
            written[room_id] = np.concatenate([
                ((np.clip(d, 0, dmax) / dmax - 0.5) * 2.0)[None],
                masks.astype(np.float32)]).astype(np.float32)
        # the loader keeps the files whose names contain the room id (as
        # the JAX package's does), so a room whose id lies inside another
        # room's file names ("0" in every "_pred_00_") reads theirs too
        names_of = {r: [f for f in os.listdir(sem) if f.startswith(
            scene_spec.pred_name(r, 0))] for r in written}
        exact = [r for r in written if not any(
            r in f for o, fs in names_of.items() if o != r for f in fs)]
        for room_id in exact:
            got_in = gan_shade.spade_input_from_files(sem, room=room_id)
            if not np.array_equal(got_in, written[room_id]):
                raise AssertionError(f"room {room_id}: the 41 channels read "
                                     "back differ from those written")
        if len(exact) < 2:
            raise AssertionError(f"only rooms {exact} have unambiguous "
                                 "file names")
        t0 = time.perf_counter()
        paths = entry.main(["--gan_shade", "--semantic_source", "files",
                            "--synthetic", "32", *common_argv,
                            "--spade_checkpoint", SPADE_CHECKPOINT,
                            "--test_dir", os.path.join(tmp, "files")])
        files_s = time.perf_counter() - t0
        shapes = {image_io.read_png(p).shape for p in paths}
        if len(paths) != SPADE_ROOMS * 50 or shapes != {(256, 256, 3)}:
            raise AssertionError(f"--semantic_source files wrote "
                                 f"{len(paths)} PNGs of {shapes}")
        print(f"  --gan_shade --semantic_source files: {SPADE_ROOMS} rooms' "
              f"masks and depth written as Blender names them; rooms "
              f"{exact} read back to the same 41 channels (the others' ids "
              f"lie inside other rooms' file names); {len(paths)} PNGs of "
              f"256 x 256 x 3 in {files_s:.1f} s", flush=True)

        # the refine dumps, and a loss history the flag does not move
        rc.reset_launch_counts()
        hist = entry.main(["--fine_tune", "--synthetic", "32",
                           "--save_semantic_gifs", *common_argv,
                           "--test_dir", os.path.join(tmp, "gifs")])
        ft_fwd, ft_bwd = rc.FWD_LAUNCHES, rc.BWD_LAUNCHES
        if hist != fine_tune_hist:
            raise AssertionError("--save_semantic_gifs moved the fine_tune "
                                 "loss history")
        (room, _), = hist.items()
        out = os.path.join(tmp, "gifs", "data", "finetune", room)
        files = set(os.listdir(out))
        last = f"{ITERS - 1:03d}"
        need = {f"{p}_depth.{x}" for p in ("target", "000", last)
                for x in ("png", "gif")}
        need |= {"z_value.pkl", "bbox_rot_0.pkl", f"bbox_rot_{ITERS - 1}.pkl",
                 "bbox_rot_gt.pkl", "000_wall.gif", f"{last}_wall.gif"}
        if not need <= files:
            raise AssertionError(f"fine_tune dumps miss {need - files}")
        gifs = sorted(f for f in files - need if f.endswith(".gif"))
        pngs = {image_io.read_png(os.path.join(out, f)).shape
                for f in files if f.endswith(".png")}
        if pngs != {(96, 96, 4)}:
            raise AssertionError(f"fine_tune depth PNGs {pngs}")
        print(f"  --fine_tune --save_semantic_gifs: {len(files)} files "
              f"(depth PNG + GIF of target, 000 and {last}, {len(gifs) + 2}"
              f" class GIFs, the pkls), PNGs 96 x 96 x 4 (read_png); loss "
              f"history equal to the main phase's bit for bit; launches fwd "
              f"{ft_fwd}, bwd {ft_bwd}", flush=True)
    return {"layouts": n, "px": S, "render_ms": render_ms,
            "layouts_per_s": rate,
            "layouts_per_s_with_writes": n / runs["preview"]["wall_s"],
            "stage_ms": stages, "stage_share": share,
            "kernel_event_ms": kernel_dev_ms / n, "dense_gate": gate,
            "cpu_gate": gate_cpu, "gan_shade_files_pngs": len(paths),
            "files_rooms_read_back": exact,
            "fine_tune_files": len(files), "smi": smi,
            "fwd_launches": runs["preview"]["fwd"] + runs["auto"]["fwd"],
            "fine_tune_launches": [ft_fwd, ft_bwd]}



# ---------------------------------------------------------------------------
# the parallel phase: data parallelism over ranks (sln_tpu_torch.parallel)
# ---------------------------------------------------------------------------
PAR_TRAIN_ITERS = 20    # the one-rank NCCL trainer against the plain one
PAR_BATCH = 256         # the DP train step's global batch (the recipe's)
PAR_STEPS = 2           # DP train steps held against the single process
PAR_ROOMS = 8           # the sharded refine: 8 rooms at 96 px
PAR_GATED = 4           # its first 4 steps are gated, all ITERS reported
PAR_LAYOUTS = 4096      # the sharded sampler's batch
PAR_Z = 50              # sharded colorize: one room, 50 z
# the gates (PERF.md §2): losses, the first step's gradient (relative
# norm), parameters after Adam (tests/test_train.py:191-200's bound),
# the refine against the single process (its card-against-CPU gate),
# sampled boxes, angle bins flipped per valid object, shaded images
PAR_GATES = {"loss_rtol": 1e-5, "grad_rel": 1e-5, "param_atol": 2.5e-3,
             "refine_rtol": 1e-3, "boxes_atol": 1e-5,
             "angle_flips_per_object": 1e-4, "image_atol": 1e-3}
# At the recipe's width the step's losses and gradient move by more than
# the 1e-5 gates when only the order of its sums changes: one process on
# the same rows with the batch's halves swapped moved the first gradient by
# 2.1e-2 (relative norm) and the losses by 9.9e-4 on an H100 (PERF.md §6).
# The loss and gradient gates are the larger of their bound and this
# factor times the floor measured in the same call
PAR_FLOOR_FACTOR = 4.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: replicas compared bit for
    bit without moving them between processes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def collective_profile(fn, n: int = 3) -> dict:
    """torch.profiler over n calls of fn: the NCCL kernels' device ms and
    count per call (gloo reduces on the host: no device time), the
    all-reduce calls per call, and the device's busy ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.key not in host_keys]
    nccl = [e for e in dev if "nccl" in e.key.lower()]
    calls = [e for e in events if e.device_type == DeviceType.CPU
             and e.key == "c10d::allreduce_"]
    return {"nccl_ms_per_step": sum(dev_us(e) for e in nccl) / 1e3 / n,
            "nccl_kernels_per_step": sum(e.count for e in nccl) / n,
            "allreduce_calls_per_step": sum(e.count for e in calls) / n,
            "busy_ms_per_step": sum(dev_us(e) for e in dev) / 1e3 / n}


def par_train(device, mesh=None, swap: bool = False) -> dict:
    """PAR_STEPS train steps at the recipe's width on the first global
    batch (this rank's rows of it under a mesh) from the committed
    checkpoint's weights (fresh Adam), with the steps' own draws; then
    scenes/s (CUDA events, best of two windows of 60 steps; 5 over gloo)
    and a profile of three steps. Under a mesh with a model axis the state
    is sharded over it (shard_state) and the gradient and parameters
    returned are gathered whole. swap: one process on the same rows and draws with the
    batch's halves swapped, the float32 floor of the gates (the same sums
    in another order)."""
    cfg = train_cli.config_from_args(train_cli.parse_args(RECIPE))
    arrays, size_info = common.load_arrays(4096, cfg, device,
                                           synthetic_seed=42)
    restored = train_ckpt.load_checkpoint(train_ckpt.latest_path(
        CHECKPOINT.output_dir, CHECKPOINT.checkpoint_name))
    rank, world = (mesh.data_index, mesh.data_size) if mesh else (0, 1)
    half = PAR_BATCH // 2
    order = (np.r_[half:PAR_BATCH, :half] if swap else np.arange(PAR_BATCH))
    rows = order[train_loop.shard_rows(PAR_BATCH, 0, rank, world)]
    raw = train_loop.stage_arrays({k: v[rows] for k, v in arrays.items()},
                                  device)
    state = train_loop.create_state(cfg, device, restored)
    tp = mesh is not None and mesh.num_model > 1
    if tp:
        train_loop.shard_state(state, mesh)
    step = train_loop.make_train_step(state, cfg, size_info, mesh=mesh)
    names = [n for n, _ in state.model.named_parameters()]

    def flat(tensors):
        """The full tensors (gathered over the model group under tensor
        parallelism), flattened in parameter order."""
        named = dict(zip(names, tensors))
        if tp:
            named = gather_params(state.model, mesh, named)
        return torch.cat([named[n].reshape(-1) for n in names]).cpu()

    def swapped_draws():
        """The step's own draws (loop.py global_draws), rows reordered."""
        gen = torch.Generator(device).manual_seed(
            train_loop.step_seed(cfg.train.seed, state.step))
        graph = draw_graph_randomness(PAR_BATCH, cfg.data.max_objects, gen,
                                      device)
        noise = torch.randn((PAR_BATCH, cfg.data.max_objects,
                             cfg.model.latent_dim), generator=gen,
                            device=device)
        idx = torch.as_tensor(order, device=device)
        return [(type(graph)(*(d[idx] for d in graph)), noise[idx])]

    losses, grads = [], None
    for _ in range(PAR_STEPS):
        out = step(raw, swapped_draws() if swap else None)
        losses.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = flat([p.grad for p in state.model.parameters()])
    params = flat([p.detach() for p in state.model.parameters()])
    out = {"losses": losses, "grads": grads, "params": params,
           "digest": state_digest(state.state_tensors()),
           "replicated_digest": state_digest(replicated_tensors(state))}
    if not swap:
        # ranks sharing a card over gloo take 0.4 s (data parallel) to 1.7 s
        # (tensor parallel) a step (PERF.md §6): shorter windows there
        reps = 5 if mesh is not None and mesh.backend == "gloo" else 60
        windows = [event_ms(lambda: step(raw), reps, 0) for _ in range(2)]
        out.update(step_ms=windows,
                   scenes_per_s=PAR_BATCH / (min(windows) / 1e3),
                   profile=collective_profile(lambda: step(raw), 3))
    return out


def replicated_tensors(state) -> list:
    """The state tensors that tensor parallelism leaves whole: parameters,
    BatchNorm buffers and Adam state of every unsplit name."""
    specs = partition_specs(state.model)
    named = dict(state.model.named_parameters())
    return ([t for n, t in state.model.state_dict().items()
             if specs[n] is None]
            + [v for n, p in named.items() if specs[n] is None
               for v in state.optimizer.state[p].values()])


def train_deviation(a: dict, b: dict) -> tuple:
    """(losses' max relative difference over the steps, the first
    gradient's relative norm, the parameters' max abs difference) of run a
    against run b."""
    loss = max(abs(x[k] - y[k]) / abs(y[k])
               for x, y in zip(a["losses"], b["losses"]) for k in y if y[k])
    return (loss, rel(a["grads"], b["grads"]),
            float((a["params"] - b["params"]).abs().max()))


def par_sampler(device, mesh=None) -> dict:
    """The committed VAE's sampler at batch PAR_LAYOUTS on the JAX
    package's posterior, eps from seed 0; layouts/s by CUDA events."""
    cfg = default_config().replace(train=CHECKPOINT)
    model = common.restore_model(cfg, device)
    with open(JAX_POSTERIOR, "rb") as f:
        mean, cov = (np.asarray(x) for x in pickle.load(f))
    batch = heatmap.heatmap_scene_batch(PAR_LAYOUTS, 8, 24, device=device)
    sample = heatmap.make_sampler(model, batch, mean, cov, mesh=mesh)
    eps = torch.randn((PAR_LAYOUTS, 8, len(mean)), device=device,
                      generator=torch.Generator(device).manual_seed(0))
    boxes, angles = sample(eps)
    ms = event_ms(lambda: sample(eps), 20, 2)
    return {"boxes": boxes.cpu(), "angles": angles.cpu(),
            "mask": batch.obj_mask.cpu(), "ms": ms,
            "layouts_per_s": PAR_LAYOUTS / (ms / 1e3)}


def par_refine(device, mesh=None) -> dict:
    """The batched refine (PAR_ROOMS synthetic rooms, seed 3, at 96 px) on
    artifacts/latest_bench_with_model.ckpt for ITERS steps (this rank's
    rooms under a mesh): the losses, z after PAR_GATED steps, both
    kernels' launches and ms per step (CUDA events)."""
    cfg = default_config().replace(train=CHECKPOINT)
    rcfg = refine.refine_render_config(cfg)
    bank_host = assets.build_procedural_bank(cfg.render.mesh_subdiv)
    bank = scene_lib.device_bank(bank_host, cfg.render.shell_subdiv,
                                 device=device)
    batch = batch_of_rooms(cfg, PAR_ROOMS, 3, device)
    inputs = refine.prepare_refine_inputs(batch, bank_host, bank, rcfg)
    model = common.restore_model(cfg, device)
    with torch.no_grad():
        mu, logvar = model.encode(batch)
        z0 = reparameterize(mu, logvar,
                            torch.Generator(device).manual_seed(13))
    args = (batch, *inputs, z0, model)
    if mesh is not None:
        args = refine.shard_refine_inputs(mesh, *args)
    b, midx, target, size_t, room_row, z0, model = args
    rc.reset_launch_counts()
    refiner = refine.make_refine_step(model, b, midx, bank, target, size_t,
                                      room_row, cfg, z0, mesh=mesh)
    first = refiner.run(PAR_GATED)
    z = refiner.z.detach()
    if mesh is not None:
        z = global_from_host_shards(z, mesh)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rest = refiner.run(ITERS - PAR_GATED)
    end.record()
    torch.cuda.synchronize()
    return {"total": torch.cat([first["total"], rest["total"]]).cpu(),
            "z": z.cpu(), "launches": (rc.FWD_LAUNCHES, rc.BWD_LAUNCHES),
            "ms_per_step": start.elapsed_time(end) / (ITERS - PAR_GATED)}


def par_colorize(device, mesh=None) -> dict:
    """One held-out room (seed 19, graph key 100) shaded with PAR_Z z by
    the committed generator; imgs/s by the host clock over 3 rooms (each
    colorize ends in a copy to the host)."""
    cfg = default_config()
    model = gan_shade.make_spade_model(cfg, SPADE_CHECKPOINT, device)
    seg = gan_shade.render_spade_inputs(1, cfg, model.crop_size,
                                        synthetic_seed=19, key_offset=100,
                                        device=device)[0]
    zs = gan_shade.draw_zs(PAR_Z, model.nz, device=device)
    imgs = gan_shade.colorize(model, seg, zs, PAR_Z, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        gan_shade.colorize(model, seg, zs, PAR_Z, mesh=mesh)
    s = (time.perf_counter() - t0) / 3
    return {"imgs": imgs, "s_per_room": s, "imgs_per_s": PAR_Z / s}


def parallel_worker(out_dir: str, num_model: int = 1) -> None:
    """One rank under torch.distributed.run, on a mesh of num_model model
    ranks: the train step (par_train), and with num_model 1 (the parallel
    phase) the sharded sampler, refine and colorize too; its results to
    out_dir/rank<r>.pt."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(num_model=num_model, device="cuda")
    try:
        kernels.load()
        out = {"rank": mesh.rank, "coords": mesh.coords,
               "world": mesh.world_size, "backend": mesh.backend,
               "device": str(mesh.device),
               "train": par_train(mesh.device, mesh)}
        if num_model == 1:
            out.update(sampler=par_sampler(mesh.device, mesh),
                       refine=par_refine(mesh.device, mesh),
                       colorize=par_colorize(mesh.device, mesh))
        torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


def torchrun(nproc: int, args: list, timeout: int = 600):
    """torch.distributed.run of `args` on nproc ranks from the repo's root:
    (stdout, seconds); raises with the log on a failure."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args)} on {nproc} ranks exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    return proc.stdout, time.perf_counter() - t0


def launch_workers(out_dir: str, world: int, num_model: int,
                   timeout: int = 900) -> tuple:
    """parallel_worker on `world` ranks: (each rank's results, seconds)."""
    os.makedirs(out_dir)
    log, seconds = torchrun(world, [os.path.abspath(__file__),
                                    "--parallel-worker", out_dir,
                                    "--model-ranks", str(num_model)],
                            timeout)
    for line in log.splitlines():
        if line.startswith("| "):
            print(f"  {line}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    print(f"  {world} ranks ({ranks[0]['backend']}; devices "
          f"{[r['device'] for r in ranks]}) in {seconds:.1f} s", flush=True)
    return ranks, seconds


def train_step_gates(what: str, ranks: list, ref: dict, floor: tuple,
                     smi: str) -> dict:
    """The ranks' train step (par_train) against the single process `ref`
    at PAR_GATES, the loss and gradient gates raised to PAR_FLOOR_FACTOR
    times the float32 floor; every rank of a data group the same bits in
    its state, every rank the same bits in the replicated tensors. Prints
    the check and the timing; raises on a miss; returns the numbers."""
    world, g = len(ranks), PAR_GATES
    tr = ranks[0]["train"]
    loss_err, grad_rel, param_err = train_deviation(tr, ref)
    loss_gate = max(g["loss_rtol"], PAR_FLOOR_FACTOR * floor[0])
    grad_gate = max(g["grad_rel"], PAR_FLOOR_FACTOR * floor[1])
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coords"][2], set()).add(r["train"]["digest"])
    shards_same = all(len(d) == 1 for d in by_model.values())
    repl_same = len({r["train"]["replicated_digest"] for r in ranks}) == 1
    print(f"  {what} ({ranks[0]['backend']}), batch {PAR_BATCH}, "
          f"{PAR_STEPS} steps from the committed weights against one "
          f"process: losses max rel {loss_err:.3e} (gate {loss_gate:.3e}), "
          f"first gradient rel norm {grad_rel:.3e} (gate {grad_gate:.3e}), "
          f"parameters max abs {param_err:.3e} (gate {g['param_atol']}); "
          f"the float32 floor (one process, the halves swapped): losses "
          f"{floor[0]:.3e}, gradient {floor[1]:.3e}, parameters "
          f"{floor[2]:.3e}; each data group's state "
          f"{'bitwise equal' if shards_same else 'DIFFERS'}, the replicated "
          f"tensors {'bitwise equal' if repl_same else 'DIFFER'} on every "
          f"rank", flush=True)
    prof = tr["profile"]
    print(f"  train scenes/s at batch {PAR_BATCH}: 1 process "
          f"{ref['scenes_per_s']:.0f} ({ref['step_ms'][0]:.3f}, "
          f"{ref['step_ms'][1]:.3f} ms), {world} ranks "
          f"{tr['scenes_per_s']:.0f} ({tr['step_ms'][0]:.3f}, "
          f"{tr['step_ms'][1]:.3f} ms); all-reduce per step "
          f"{prof['nccl_ms_per_step']:.3f} ms on the device (each NCCL "
          f"kernel's time includes its wait for the other ranks) in "
          f"{prof['nccl_kernels_per_step']:.0f} NCCL kernels "
          f"({prof['allreduce_calls_per_step']:.0f} all-reduce calls), "
          f"device busy {prof['busy_ms_per_step']:.3f} ms per step "
          f"(profile of 3 steps), on {smi}", flush=True)
    if (loss_err > loss_gate or grad_rel > grad_gate
            or param_err > g["param_atol"] or not shards_same
            or not repl_same):
        raise AssertionError(f"the {what} misses its gates")
    return {"world": world, "backend": ranks[0]["backend"],
            "loss_max_rel": loss_err, "grad_rel_norm": grad_rel,
            "param_max_abs": param_err,
            "floor": {"loss_max_rel": floor[0], "grad_rel_norm": floor[1],
                      "param_max_abs": floor[2]},
            "gates": {"loss": loss_gate, "grad": grad_gate,
                      "param": g["param_atol"]},
            "scenes_per_s": {"1": ref["scenes_per_s"],
                             str(world): tr["scenes_per_s"]},
            "step_ms": {"1": ref["step_ms"], str(world): tr["step_ms"]},
            "profile": {"1": ref["profile"], str(world): prof}}


def one_rank_trainer(tmp: str, device) -> dict:
    """`python -m sln_tpu_torch.train --num_data_shards 1` under a launcher's
    environment of one rank (an NCCL process group of one), against the
    plain trainer: the same loss history and state, bit for bit."""
    runs = {}
    for name in ("nccl", "plain"):
        out_dir = os.path.join(tmp, f"par_{name}")
        argv = [*RECIPE, "--num_iterations", str(PAR_TRAIN_ITERS),
                "--print_every", "1", "--checkpoint_every",
                str(PAR_TRAIN_ITERS), "--output_dir", out_dir,
                "--checkpoint_name", "smoke", "--device", device.type]
        launcher = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                    "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(free_port())}
        if name == "nccl":
            argv += ["--num_data_shards", "1"]
            os.environ.update(launcher)
        try:
            (state, ckpt), log = _captured(lambda: train_cli.main(argv))
        finally:
            for k in launcher:
                os.environ.pop(k, None)
        runs[name] = (ckpt["losses"], state_digest(state.state_tensors()),
                      log)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if f"backend {backend}" not in runs["nccl"][2]:
        raise AssertionError(f"the one-rank trainer ran without a {backend}"
                             " process group")
    same = (runs["nccl"][0] == runs["plain"][0],
            runs["nccl"][1] == runs["plain"][1])
    print(f"  --num_data_shards 1 over NCCL against the plain trainer, "
          f"{PAR_TRAIN_ITERS} steps at the recipe's width: loss histories "
          f"{'equal' if same[0] else 'DIFFER'}, parameters, Adam and "
          f"BatchNorm state {'equal' if same[1] else 'DIFFER'}", flush=True)
    if not all(same):
        raise AssertionError("a one-rank NCCL world is not the plain "
                             "trainer, bit for bit")
    return {"steps": PAR_TRAIN_ITERS, "bitwise_equal": True,
            "total_loss": runs["nccl"][0]["total_loss"][-1]}


def parallel_phase(tmp: str, device, smi: str) -> dict:
    """The parallel phase: returns its numbers and the ranks' rasterizer
    launches (fwd, bwd) on the sharded refine."""
    with phase("parallel"):
        cards = torch.cuda.device_count()
        world = cards if cards > 1 else 2
        result = {"one_rank_nccl_trainer": one_rank_trainer(tmp, device)}

        t0 = time.perf_counter()
        ref = {"train": par_train(device), "sampler": par_sampler(device),
               "refine": par_refine(device), "colorize": par_colorize(device)}
        floor = train_deviation(par_train(device, swap=True), ref["train"])
        torch.cuda.empty_cache()
        print(f"  single-process references in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        ranks, launch_s = launch_workers(os.path.join(tmp, "parallel"),
                                         world, 1)
        backend = ranks[0]["backend"]
        g = PAR_GATES
        train = train_step_gates(
            f"DP train step ({PAR_BATCH // world} rows a rank)", ranks,
            ref["train"], floor, smi)

        # the sharded sampler
        sp, rs = ranks[0]["sampler"], ref["sampler"]
        m = rs["mask"]
        box_err = float((sp["boxes"] - rs["boxes"]).abs().max())
        flips = int((sp["angles"] != rs["angles"])[m].sum())
        n_obj = int(m.sum())
        same_ranks = all(torch.equal(r["sampler"]["boxes"], sp["boxes"])
                         for r in ranks)
        print(f"  sharded sampler, {PAR_LAYOUTS} layouts: boxes max abs "
              f"{box_err:.3e} (gate {g['boxes_atol']}), angle bins flipped "
              f"{flips} of {n_obj} valid objects; every rank the same "
              f"layouts: {same_ranks}; {rs['layouts_per_s']:.0f} layouts/s "
              f"on 1 process, {sp['layouts_per_s']:.0f} on {world} ranks",
              flush=True)
        if (box_err > g["boxes_atol"] or not same_ranks
                or flips > g["angle_flips_per_object"] * n_obj):
            raise AssertionError("the sharded sampler misses its gates")

        # the sharded refine
        rf, rr = ranks[0]["refine"], ref["refine"]
        hist_ok = np.allclose(rf["total"][:PAR_GATED], rr["total"][:PAR_GATED],
                              rtol=g["refine_rtol"], atol=0)
        # z relative to its largest entry: an elementwise rtol means
        # nothing for entries near 0
        z_err = float((rf["z"] - rr["z"]).abs().max())
        z_ok = z_err <= g["refine_rtol"] * float(rr["z"].abs().max())
        launches = [r["refine"]["launches"] for r in ranks]
        print(f"  sharded refine, {PAR_ROOMS} rooms at 96 px "
              f"({PAR_ROOMS // world} a rank): first {PAR_GATED} losses "
              f"{rf['total'][:PAR_GATED].tolist()} vs "
              f"{rr['total'][:PAR_GATED].tolist()}, z max abs {z_err:.3e} "
              f"of max |z| {float(rr['z'].abs().max()):.3f} (gates rtol "
              f"{g['refine_rtol']}); all {ITERS}: "
              f"{float(rf['total'][-1]):.6f} vs {float(rr['total'][-1]):.6f}"
              f" (not gated: the loss is discontinuous); launches per rank "
              f"(fwd, bwd) {launches}; {rf['ms_per_step']:.3f} ms/step on "
              f"{world} ranks, {rr['ms_per_step']:.3f} on 1 process",
              flush=True)
        if not (hist_ok and z_ok) or not all(f > 0 and b > 0
                                             for f, b in launches):
            raise AssertionError("the sharded refine misses its gates")

        # sharded colorize
        co, rcol = ranks[0]["colorize"], ref["colorize"]
        img_err = float(np.abs(co["imgs"] - rcol["imgs"]).max())
        print(f"  sharded colorize, 1 room x {PAR_Z} z: images max abs "
              f"{img_err:.3e} (gate {g['image_atol']}); "
              f"{rcol['imgs_per_s']:.1f} imgs/s on 1 process, "
              f"{co['imgs_per_s']:.1f} on {world} ranks", flush=True)
        if co["imgs"].shape != rcol["imgs"].shape or img_err > g["image_atol"]:
            raise AssertionError("sharded colorize misses its gate")

        result.update({
            "world": world, "backend": backend, "launch_s": launch_s,
            "train": train,
            "sampler": {"boxes_max_abs": box_err, "angle_flips": flips,
                        "valid_objects": n_obj,
                        "layouts_per_s": {"1": rs["layouts_per_s"],
                                          str(world): sp["layouts_per_s"]}},
            "refine": {"first_losses": rf["total"][:PAR_GATED].tolist(),
                       "z_max_abs": z_err,
                       "last_loss": {"1": float(rr["total"][-1]),
                                     str(world): float(rf["total"][-1])},
                       "launches_per_rank": launches,
                       "ms_per_step": {"1": rr["ms_per_step"],
                                       str(world): rf["ms_per_step"]}},
            "colorize": {"max_abs": img_err,
                         "imgs_per_s": {"1": rcol["imgs_per_s"],
                                        str(world): co["imgs_per_s"]}},
            "gates": g, "card": smi})
    fwd = sum(f for f, _ in launches)
    bwd = sum(b for _, b in launches)
    return result, (fwd, bwd), (ref["train"], floor)


# ---------------------------------------------------------------------------
# train_scan: the device-resident train loop (make_train_scan)
# ---------------------------------------------------------------------------
# bench.py:527-560 (the JAX bench's train_device cell): batch 256 of 4,096
# synthetic rooms (seed 0), a fresh init at the default (committed) width,
# 60 steps; the microbatched and bf16 variants 10 steps each
SCAN_BATCH = 256
SCAN_STEPS = 60
SCAN_VARIANT_STEPS = 10
SCAN_PROFILED = 10
# where the graph cannot give the eager steps' bits: the JAX scan test's
# gates (tests/test_train.py:147-155)
SCAN_GATES = {"total_rtol": 1e-5, "param_atol": 1e-6}
SCAN_VARIANTS = {"fp32": {}, "microbatch": {"microbatch": 128},
                 "bf16": {"compute_dtype": "bfloat16"}}


def scan_setup(device, variant: str):
    """(cfg, size_info, raw): the bench's configuration in `variant` and its
    first batch (np.random.default_rng(0)) staged on the card."""
    over = SCAN_VARIANTS[variant]
    cfg = default_config()
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, batch_size=SCAN_BATCH,
                                  microbatch=over.get("microbatch", 0)),
        model=dataclasses.replace(
            cfg.model, compute_dtype=over.get("compute_dtype", "float32")))
    arrays, size_info = common.load_arrays(4096, cfg, device,
                                           synthetic_seed=0)
    idx = next(train_loop.batch_indices(len(arrays["objs"]), SCAN_BATCH,
                                        np.random.default_rng(0)))
    raw = train_loop.stage_arrays({k: v[idx] for k, v in arrays.items()},
                                  device)
    return cfg, size_info, raw


def state_names(state) -> list:
    """Names of state.state_tensors(), in its order."""
    params = [n for n, _ in state.model.named_parameters()]
    return (params + [n for n, _ in state.model.named_buffers()]
            + [f"adam {k} {n}" for n, p in zip(params,
                                                state.model.parameters())
               for k in state.optimizer.state[p]])


def window_profile(fn) -> dict:
    """torch.profiler over one call of fn: wall ms, device busy ms and
    share, CUDA graph launches and kernel launches from the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    busy_ms = sum(dev_us(e) for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.key not in host_keys) / 1e3

    def count(name):
        return sum(e.count for e in events if e.key == name)

    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "graph_launches": count("cudaGraphLaunch"),
            "kernel_launches": count("cudaLaunchKernel")
            + count("cudaLaunchKernelExC")}


def graph_against_eager(device, variant: str, n: int) -> dict:
    """make_train_scan's graph for n steps against n eager steps from the
    same init with the same draws: the summed loss and every parameter,
    BatchNorm and Adam tensor, bit for bit or (reported) within
    SCAN_GATES; state.step advanced by n. Returns the check's numbers and
    (for timing) the scan, the eager step and the raw batch."""
    cfg, size_info, raw = scan_setup(device, variant)
    graphed = train_loop.create_state(cfg, device)
    run = train_loop.make_train_scan(graphed, cfg, size_info)
    t0 = time.perf_counter()
    total_g = run(raw, n)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eager = train_loop.create_state(cfg, device)
    step = train_loop.make_train_step(eager, cfg, size_info)
    total_e = torch.zeros((), device=device)
    for _ in range(n):
        total_e = total_e + step(raw)["total_loss"]
    if graphed.step != n or eager.step != n:
        raise AssertionError(f"state.step {graphed.step} after a scan of {n}")
    differ = {}
    for name, a, b in zip(state_names(graphed), graphed.state_tensors(),
                          eager.state_tensors()):
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max()
            differ[name] = float(d)
    bitwise = torch.equal(total_g, total_e) and not differ
    worst10 = dict(sorted(differ.items(), key=lambda kv: -kv[1])[:10])
    tot_rel = abs(float(total_g) - float(total_e)) / abs(float(total_e))
    print(f"  train scan {variant}, {n} steps at batch {SCAN_BATCH}: the "
          f"graph's summed loss {float(total_g):.9g}, the eager loop's "
          f"{float(total_e):.9g}; {'the same bits in the total and in all '
          if bitwise else 'DIFFERENT bits: '}"
          f"{len(graphed.state_tensors()) - len(differ)} of "
          f"{len(graphed.state_tensors())} state tensors equal"
          f"{'' if bitwise else ': largest ' + json.dumps(worst10)} (first "
          f"call "
          f"with capture {first_s:.2f} s)", flush=True)
    if not bitwise:
        params = len(list(graphed.model.parameters()))
        worst = max([v for k, v in differ.items()
                     if k in state_names(graphed)[:params]] or [0.0])
        if (tot_rel > SCAN_GATES["total_rtol"]
                or worst > SCAN_GATES["param_atol"]):
            raise AssertionError(f"the train scan's graph misses the JAX "
                                 f"scan gates: total rel {tot_rel:.3e}, "
                                 f"parameters max abs {worst:.3e}")
    return {"total": float(total_g), "eager_total": float(total_e),
            "bitwise": bitwise, "total_rel": tot_rel, "differ": differ,
            "first_call_s": first_s}, (run, step, raw)


def train_scan_phase(device, smi: str) -> dict:
    """The train_scan phase: returns its numbers."""
    with phase("train_scan"):
        result, (run, step, raw) = graph_against_eager(device, "fp32",
                                                       SCAN_STEPS)
        # the graph replayed: n cudaGraphLaunch and no eager step between
        # them (an eager step launches thousands of kernels)
        prof_g = window_profile(lambda: run(raw, SCAN_PROFILED))
        prof_e = window_profile(
            lambda: [step(raw) for _ in range(SCAN_PROFILED)])
        per_replay = prof_g["kernel_launches"] / SCAN_PROFILED
        eager_per_step = prof_e["kernel_launches"] / SCAN_PROFILED
        print(f"  profiled window of {SCAN_PROFILED} scan steps: "
              f"{prof_g['graph_launches']} graph launches, "
              f"{per_replay:.1f} kernel launches from the host per replay "
              f"(an eager step: {eager_per_step:.0f}); device busy "
              f"{prof_g['busy_share']:.1%} of {prof_g['wall_ms']:.3f} ms "
              f"(eager: {prof_e['busy_share']:.1%} of "
              f"{prof_e['wall_ms']:.3f} ms)", flush=True)
        if (prof_g["graph_launches"] != SCAN_PROFILED
                or per_replay > 0.05 * eager_per_step):
            raise AssertionError("the scan's window is not graph replays")
        windows_g = [event_ms(lambda: run(raw, SCAN_STEPS), 1, 0)
                     / SCAN_STEPS for _ in range(2)]
        windows_e = [event_ms(lambda: step(raw), SCAN_STEPS, 0)
                     for _ in range(2)]
        rate_g = SCAN_BATCH / (min(windows_g) / 1e3)
        rate_e = SCAN_BATCH / (min(windows_e) / 1e3)
        print(f"  train step at batch {SCAN_BATCH}: graph {windows_g[0]:.3f},"
              f" {windows_g[1]:.3f} ms = {rate_g:.0f} scenes/s; eager "
              f"{windows_e[0]:.3f}, {windows_e[1]:.3f} ms = {rate_e:.0f} "
              f"scenes/s (CUDA events, {SCAN_STEPS} steps a window), on "
              f"{smi}", flush=True)
        result.update(profile={"graph": prof_g, "eager": prof_e},
                      step_ms={"graph": windows_g, "eager": windows_e},
                      scenes_per_s={"graph": rate_g, "eager": rate_e})
        del run, step, raw
        torch.cuda.empty_cache()
        for variant in ("microbatch", "bf16"):
            result[variant], _ = graph_against_eager(device, variant,
                                                     SCAN_VARIANT_STEPS)
            torch.cuda.empty_cache()
        result["card"] = smi
    return result


# ---------------------------------------------------------------------------
# tensor_parallel: the dp x tp mesh, the multi-slice mesh and the dry run
# ---------------------------------------------------------------------------
TP_DRYRUN_RANKS = (4, 8)    # dp 2 x tp 2; 2 slices x 2 x 2
TP_RANKS = 4                # the recipe-width step: dp 2 x tp 2


def tensor_parallel_phase(tmp: str, device, smi: str, ref=None,
                          floor=None) -> tuple:
    """The tensor_parallel phase: returns its numbers and the dry runs'
    rasterizer launches (fwd, bwd), summed over their ranks. ref and floor
    are the parallel phase's single-process train run and float32 floor
    (par_train, train_deviation), measured here when not given."""
    with phase("tensor_parallel"):
        result, fwd, bwd = {"dryrun": {}}, 0, 0
        for n in TP_DRYRUN_RANKS:
            log, seconds = torchrun(n, ["-m", "sln_tpu_torch.dryrun"])
            lines = [ln for ln in log.splitlines()
                     if ln.startswith(("mesh:", "dryrun_", "| "))]
            for line in lines:
                print(f"  [{n} ranks] {line}")
            got = json.loads(next(ln for ln in log.splitlines()
                                  if ln.startswith('{"dryrun"')))["dryrun"]
            want = 5 if n >= 8 else 4
            if sum(ln.startswith("dryrun_") for ln in lines) != want:
                raise AssertionError(f"the dry run on {n} ranks printed "
                                     f"{lines}")
            f, b = got["serving"]["rasterizer_launches"]
            if not (f > 0 and b > 0):
                raise AssertionError(f"the dry run's refine launched fwd {f}"
                                     f", bwd {b}")
            fwd, bwd = fwd + f, bwd + b
            got["seconds"] = seconds
            result["dryrun"][str(n)] = got
            print(f"  dry run on {n} ranks in {seconds:.1f} s; rasterizer "
                  f"launches fwd {f}, bwd {b}", flush=True)

        cards = torch.cuda.device_count()
        world = cards if cards > 1 and cards % 2 == 0 else TP_RANKS
        if ref is None:
            ref = par_train(device)
            floor = train_deviation(par_train(device, swap=True), ref)
            torch.cuda.empty_cache()
        ranks, seconds = launch_workers(
            os.path.join(tmp, "tensor_parallel"), world, 2)
        result["step"] = train_step_gates(
            f"dp x tp train step ({world // 2} data x 2 model ranks)",
            ranks, ref, floor, smi)
        result["step"]["launch_s"] = seconds
        result["card"] = smi
    return result, (fwd, bwd)


# the layout_eval phase: the JAX package's record of the refinement probe
# (artifacts/refine_sweep.json row 0: a TPU run, 8 rooms, sigma 1, 60
# iterations at 96 px, lr_z 2e-4) and bands around it. The loop must not
# hurt the layout: iou_refined - iou_perturbed >= PROBE_MIN_IOU_DELTA on
# every run. Whether the last loss ends below the first is reported, not
# gated: the loss is discontinuous and the angle noise is drawn afresh each
# iteration, so the end of a 60-step trajectory is not a property of the
# loop. On the JAX package's own draws the JAX loop ends below its first
# loss on the TPU (4.5644 < 4.6789) and on the CPU by 0.0009; the JAX
# sweep's own rows end above it in 4 of 8 settings. The loop's correctness
# is gated on those draws instead (JAXIN_* below). The port draws the
# graphs and z from torch.Generators, so its rooms are other samples of the
# same scenes: on the card eight graph draws of the probe's 8 rooms give
# iou_at_z_gt 0.0699-0.1184 (sd 0.0158; the phase prints it each run), on
# the CPU six give loss_first 4.91-5.74 (sd 0.28), against the JAX
# package's one draw (0.122 and 4.6789 on the TPU). Two independent draws
# differ with sqrt(2) times that sd; each band is 3 of those: +-0.07 on the
# IoUs, +-1.2 on the losses.
JAX_SWEEP = "artifacts/refine_sweep.json"
# the JAX package's own batch, z0 and per-iteration noise for that probe,
# with what it computes from them on the CPU (tests/jax_probe_inputs.py):
# on these draws the port's numbers that no draw moves (the IoU and box L1
# at z0 and at z_gt, the z distance) agree within JAXIN_ATOL, and its first
# JAXIN_STEPS losses within rtol JAXIN_RTOL (the refine's card-against-CPU
# gate); later losses part as the discontinuous loss lets them
JAX_PROBE_INPUTS = "artifacts/refine_probe_inputs.npz"
JAXIN_KEYS = ("iou_perturbed", "iou_at_z_gt", "box_l1_perturbed",
              "box_l1_at_z_gt", "z_l1_before")
JAXIN_ATOL, JAXIN_RTOL, JAXIN_STEPS = 1e-4, 1e-3, 8
PROBE_SEEDS = (13, 14, 15)          # --seed: z0's and the angle noise's draws
PROBE_BANDS = {"iou_perturbed": 0.07, "iou_refined": 0.07,
               "iou_at_z_gt": 0.07, "loss_first": 1.2, "loss_last": 1.2}
PROBE_MIN_IOU_DELTA = -0.005        # the loop must not hurt the layout
PROBE_GRAPH_SEEDS = range(8)
SWEEP_ROWS = "0,6"                  # the reference row and sigma 0.5, lr 2e-2
PACKER_ROOMS, PACKER_BASE = 16384, 256
IOU_PAIRS = 10_000
# a SUNCG-style corpus (o/usemtl groups, quads with v/vt/vn indices):
# class -> (model id, [(part, lo, hi)]) in metres, y up
LAYOUT_CORPUS = {
    "bed": ("bed_101", [("frame", (0, .2, 0), (2.0, .5, 1.6)),
                        ("mattress", (.05, .5, .05), (1.95, .75, 1.55)),
                        ("leg_a", (0, 0, 0), (.1, .2, .1)),
                        ("leg_b", (1.9, 0, 1.5), (2.0, .2, 1.6)),
                        ("headboard", (0, .5, 0), (2.0, 1.1, .08))]),
    "chair": ("chair_7", [("seat", (0, .4, 0), (.5, .48, .5)),
                          ("back", (0, .48, .42), (.5, 1.0, .5)),
                          ("leg_a", (.02, 0, .02), (.08, .4, .08))]),
    "table": ("table_33", [("top", (0, .7, 0), (1.4, .76, .8)),
                           ("leg_a", (.05, 0, .05), (.12, .7, .12))]),
    "sofa": ("sofa_2", [("base", (0, .1, 0), (1.8, .45, .9)),
                        ("back", (0, .45, .7), (1.8, .9, .9)),
                        ("arm_l", (0, .45, 0), (.15, .65, .9))]),
}
LAYOUT_ROOM = (4.0, 2.6, 5.0)
BOX_QUADS = ((0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 3, 7, 5))


def write_box_parts(path: str, parts) -> None:
    """An .obj of axis-aligned box parts, one `o` group each."""
    with open(path, "w") as f:
        f.write("mtllib model.mtl\nvt 0 0\nvn 0 1 0\n")
        for i, (name, lo, hi) in enumerate(parts):
            f.write(f"o {name}\nusemtl {name}_mat\n")
            for x in (lo[0], hi[0]):
                for y in (lo[1], hi[1]):
                    for z in (lo[2], hi[2]):
                        f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
            for q in BOX_QUADS:
                f.write("f " + " ".join(f"{8 * i + k + 1}/1/1" for k in q)
                        + "\n")


def write_layout_corpus(root: str) -> dict:
    """<root>/object/<mid>/<mid>.obj, suncg_data_many.json, one room's
    wall/floor/ceiling shells and wall_data_wfc.json: the build_asset_bank
    CLI's arguments."""
    meta = {}
    for cls, (mid, parts) in LAYOUT_CORPUS.items():
        os.makedirs(os.path.join(root, "object", mid))
        write_box_parts(os.path.join(root, "object", mid, f"{mid}.obj"),
                        parts)
        meta[cls] = [{"id": mid,
                      "bbox_min": np.min([p[1] for p in parts], 0).tolist(),
                      "bbox_max": np.max([p[2] for p in parts], 0).tolist()}]
    X, Y, Z = LAYOUT_ROOM
    house = os.path.join(root, "room", "house0")
    os.makedirs(house)
    for suffix, lo, hi in (("w", (0, 0, 0), (X, Y, Z)),
                           ("f", (0, -.08, 0), (X, 0, Z)),
                           ("c", (0, Y, 0), (X, Y + .08, Z))):
        write_box_parts(os.path.join(house, f"fr_0rm_0{suffix}.obj"),
                        [(suffix, lo, hi)])
    paths = {"metadata": os.path.join(root, "suncg_data_many.json"),
             "wall_metadata": os.path.join(root, "wall_data_wfc.json")}
    with open(paths["metadata"], "w") as f:
        json.dump(meta, f)
    with open(paths["wall_metadata"], "w") as f:
        json.dump([{"house_id": "house0", "model_id": "fr_0rm_0",
                    "wall_bbox_min": [0, 0, 0],
                    "wall_bbox_max": list(LAYOUT_ROOM)}], f)
    return paths


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (its model name, else its
    vendor, family and model) and the machine type."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
        if fields.get(k))
    return f"{name or 'not reported'} ({platform.machine()})"


def rotated_quads(rng, n: int) -> np.ndarray:
    """n random rotated rectangles (n, 4, 2), both windings."""
    c = rng.uniform(0, 3, (n, 1, 2))
    wh = rng.uniform(0.3, 2.0, (n, 1, 2)) / 2
    base = np.array([[-1, -1], [-1, 1], [1, 1], [1, -1]]) * wh
    th = rng.uniform(0, np.pi, n)
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    q = base @ rot + c
    flip = rng.uniform(size=n) < 0.5
    q[flip] = q[flip, ::-1]
    return q


def iou_delta_gate(name: str, rec: dict) -> None:
    delta = rec["iou_refined"] - rec["iou_perturbed"]
    if delta < PROBE_MIN_IOU_DELTA:
        raise AssertionError(f"{name}: the loop cut the IoU by {-delta:.4f}")


def layout_eval_phase(tmp: str, device, smi: str) -> dict:
    """The host runtime, the layout IoU, the refinement probe and its sweep,
    and an asset bank built from .obj files (see the module docstring)."""
    from sln_tpu_torch import native
    from sln_tpu_torch.data import synthetic, tensorize
    from sln_tpu_torch.data.batch import SceneBatch
    from sln_tpu_torch.ops import iou
    from sln_tpu_torch.tools import build_asset_bank
    from sln_tpu_torch.tools import eval_refinement_quality as probe_tool
    from sln_tpu_torch.tools import sweep_refinement

    out = {"card": smi, "host_cpu": host_cpu()}
    with phase("layout_eval"):
        # 1. the native library, built by g++ from csrc/native.cpp
        cxx = native.compiler()
        version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout.splitlines()[0]
        t0 = time.perf_counter()
        built = not native.library_path().is_file()
        native.load()
        out["native_build_s"] = time.perf_counter() - t0
        print(f"  native library {native.library_path().name} "
              f"{'built' if built else 'found'} in {out['native_build_s']:.2f}"
              f" s by {cxx}: {version}")
        out["compiler"] = version

        # 2. the packer: 16,384 rooms (copies of 256 under new ids)
        base = list(synthetic.generate_rooms(PACKER_BASE, seed=5).values())
        path = os.path.join(tmp, "rooms.json")
        with open(path, "w") as f:
            json.dump({str(i): base[i % PACKER_BASE]
                       for i in range(PACKER_ROOMS)}, f)
        with open(path) as f:
            if native.pack_rooms(f.read(), 32) is None:
                raise AssertionError("the packer rejected the rooms file")
        t0 = time.perf_counter()
        packed = tensorize.tensorize_file(path, 32)
        t_pack = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = tensorize.tensorize_rooms(tensorize.load_rooms(path), 32)
        t_plain = time.perf_counter() - t0
        for k, v in plain.items():
            if packed[k].dtype != v.dtype or not np.array_equal(packed[k], v):
                raise AssertionError(f"packer {k} differs from json + "
                                     "tensorize_rooms")
        out["packer_rooms_per_s"] = PACKER_ROOMS / t_pack
        out["python_rooms_per_s"] = PACKER_ROOMS / t_plain
        print(f"  packer {out['packer_rooms_per_s']:.0f} rooms/s, json + "
              f"tensorize_rooms {out['python_rooms_per_s']:.0f} rooms/s "
              f"({PACKER_ROOMS} rooms, {os.path.getsize(path)} bytes, arrays"
              f" bit-equal; host {out['host_cpu']}, {os.cpu_count()} cores;"
              f" card {smi})", flush=True)

        # 3. the IoU: C++ (float64, host) against torch on the card
        rng = np.random.default_rng(0)
        qa, qb = rotated_quads(rng, IOU_PAIRS), rotated_quads(rng, IOU_PAIRS)
        y1 = rng.uniform(0, 1, (IOU_PAIRS, 2)).cumsum(-1)
        y2 = rng.uniform(0, 1, (IOU_PAIRS, 2)).cumsum(-1)
        cpp = np.array([native.cuboid_iou(qa[i], y1[i], qb[i], y2[i])
                        for i in range(IOU_PAIRS)])

        def on(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        card = iou.cuboid_iou(on(qa), on(y1[:, 0]), on(y1[:, 1]), on(qb),
                              on(y2[:, 0]), on(y2[:, 1])).cpu().numpy()
        out["iou_cpp_vs_card"] = float(np.abs(cpp - card).max())
        boxes = rng.uniform(0, 0.6, (2, 64, 32, 3))
        boxes = np.concatenate([boxes[0], boxes[0] + 0.05 + 0.3 * boxes[1]],
                               -1)
        ang = rng.integers(0, 24, (2, 64, 32))
        dims = rng.uniform(2, 6, (64, 3))
        args = (boxes, ang[0], boxes[:, ::-1].copy(), ang[1], dims)
        lay_card = iou.layout_iou(*map(on, args)).cpu()
        lay_cpu = iou.layout_iou(*(torch.as_tensor(a, dtype=torch.float32)
                                   for a in args))
        out["layout_iou_card_vs_cpu"] = max_err(lay_card, lay_cpu)
        overlapping = int((cpp > 0.01).sum())
        print(f"  cuboid IoU, {IOU_PAIRS} pairs ({overlapping} overlapping):"
              f" C++ vs the card {out['iou_cpp_vs_card']:.3e} (gate 1e-4); "
              f"layout_iou (64 x 32) card vs CPU "
              f"{out['layout_iou_card_vs_cpu']:.3e} (gate 1e-5)")
        if out["iou_cpp_vs_card"] > 1e-4 or overlapping < IOU_PAIRS // 10:
            raise AssertionError("cuboid IoU: C++ against the card")
        if out["layout_iou_card_vs_cpu"] > 1e-5:
            raise AssertionError("layout_iou: card against CPU")

        # 4. the probe through its entry point, three seeds
        with open(JAX_SWEEP, "rb") as f:
            sweep_bytes = f.read()
        jax_row = json.loads(sweep_bytes)[0]
        argv = ["--output_dir", CHECKPOINT.output_dir, "--checkpoint_name",
                CHECKPOINT.checkpoint_name, "--rooms", "8"]
        fwd = bwd = 0
        out["probe"] = {}
        for seed in PROBE_SEEDS:
            rc.reset_launch_counts()
            t0 = time.perf_counter()
            rec, losses = probe_tool.main(argv + ["--seed", str(seed)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            f_, b_ = rc.FWD_LAUNCHES, rc.BWD_LAUNCHES
            if f_ < ITERS or b_ < ITERS:
                raise AssertionError(f"probe seed {seed}: fwd {f_} / bwd "
                                     f"{b_} launches for {ITERS} iterations")
            fwd, bwd = fwd + f_, bwd + b_
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f"probe seed {seed}: {rec}")
            for k, width in PROBE_BANDS.items():
                if abs(rec[k] - jax_row[k]) > width:
                    raise AssertionError(
                        f"probe seed {seed}: {k} {rec[k]:.4f} outside "
                        f"{jax_row[k]} +- {width}")
            iou_delta_gate(f"probe seed {seed}", rec)
            out["probe"][str(seed)] = dict(
                rec, seconds=secs, launches=[f_, b_],
                loss_mean_first_last_10=[float(losses[:10].mean()),
                                         float(losses[-10:].mean())])
            print(f"  probe seed {seed}: IoU {rec['iou_perturbed']:.4f} -> "
                  f"{rec['iou_refined']:.4f} (at z_gt "
                  f"{rec['iou_at_z_gt']:.4f}), loss {rec['loss_first']:.4f}"
                  f" -> {rec['loss_last']:.4f}, box L1 "
                  f"{rec['box_l1_perturbed']:.5f} -> "
                  f"{rec['box_l1_refined']:.5f}; mean loss of the first and "
                  f"last 10 iterations {losses[:10].mean():.4f}, "
                  f"{losses[-10:].mean():.4f}; {secs:.2f} s, launches fwd "
                  f"{f_} bwd {b_} (JAX record: IoU {jax_row['iou_perturbed']}"
                  f" -> {jax_row['iou_refined']}, z_gt "
                  f"{jax_row['iou_at_z_gt']}, loss {jax_row['loss_first']} "
                  f"-> {jax_row['loss_last']})", flush=True)
        # the probe on the JAX package's own draws
        pargs = probe_tool.parse_args(argv)
        cfg_p = probe_tool.probe_config(pargs)
        model = common.restore_model(cfg_p, device)
        d = np.load(JAX_PROBE_INPUTS)
        jb = SceneBatch(*(torch.as_tensor(d[f"batch_{k}"], device=device)
                          for k in SceneBatch._fields))
        jb = jb._replace(**{k: getattr(jb, k).long() for k in (
            "objs", "angles", "attrs", "triples", "room_ids")})
        rc.reset_launch_counts()
        rec, losses = probe_tool.probe(
            model, jb, cfg_p, 1.0, PROBE_SEEDS[0],
            z0=torch.as_tensor(d["z0"], device=device),
            noises=torch.as_tensor(d["noise"], device=device))
        torch.cuda.synchronize()
        fwd, bwd = fwd + rc.FWD_LAUNCHES, bwd + rc.BWD_LAUNCHES
        jax_cpu = {k: float(d[f"jax_cpu_{k}"]) for k in JAXIN_KEYS
                   + ("iou_refined", "loss_first", "loss_last")}
        dev_keys = {k: abs(rec[k] - jax_cpu[k]) for k in JAXIN_KEYS}
        steps = np.abs(losses[:JAXIN_STEPS] / d["jax_cpu_totals"][:JAXIN_STEPS]
                       - 1.0).max()
        out["probe_on_jax_draws"] = dict(
            rec, losses=losses.tolist(), jax_cpu=jax_cpu,
            jax_cpu_totals=d["jax_cpu_totals"].tolist(),
            max_abs_vs_jax_cpu=dev_keys, first_steps_rel=float(steps))
        print(f"  probe on the JAX package's draws: IoU "
              f"{rec['iou_perturbed']:.5f} -> {rec['iou_refined']:.5f} (at "
              f"z_gt {rec['iou_at_z_gt']:.5f}), loss {rec['loss_first']:.4f}"
              f" -> {rec['loss_last']:.4f}; JAX on the CPU "
              f"{jax_cpu['iou_perturbed']:.5f} -> {jax_cpu['iou_refined']:.5f}"
              f" ({jax_cpu['iou_at_z_gt']:.5f}), {jax_cpu['loss_first']:.4f}"
              f" -> {jax_cpu['loss_last']:.4f}; JAX's TPU record "
              f"{jax_row['iou_perturbed']} -> {jax_row['iou_refined']} "
              f"({jax_row['iou_at_z_gt']}), {jax_row['loss_first']} -> "
              f"{jax_row['loss_last']}; draw-free keys within "
              f"{max(dev_keys.values()):.2e} (gate {JAXIN_ATOL}), first "
              f"{JAXIN_STEPS} losses within rtol {steps:.2e} (gate "
              f"{JAXIN_RTOL})", flush=True)
        if max(dev_keys.values()) > JAXIN_ATOL or steps > JAXIN_RTOL:
            raise AssertionError(f"the probe on the JAX package's draws: "
                                 f"{dev_keys}, first losses {steps}")
        iou_delta_gate("the probe on the JAX package's draws", rec)

        # the card's own spread over graph draws, at z_gt (no render)
        arrays, size_info = common.load_arrays(8, cfg_p, device,
                                               synthetic_seed=11)

        def t(k):
            return torch.as_tensor(arrays[k][:8], device=device)

        draws = []
        for gs in PROBE_GRAPH_SEEDS:
            b = build_graphs(t("objs"), t("boxes"), t("angles"),
                             t("obj_mask"), t("room_ids"), size_info,
                             max_on_rels=16,
                             generator=torch.Generator(device).manual_seed(gs))
            with torch.no_grad():
                draws.append(float(refine.decoded_layout_iou(
                    model, b, model.encode(b)[0])))
        out["iou_at_z_gt_over_graph_draws"] = draws
        print(f"  iou_at_z_gt over {len(draws)} graph draws on the card: "
              f"{min(draws):.4f}-{max(draws):.4f}, sd "
              f"{float(np.std(draws, ddof=1)):.4f}")

        # 5. the sweep: two rows, into a temporary --out
        rc.reset_launch_counts()
        sweep_out = os.path.join(tmp, "refine_sweep.json")
        rows = sweep_refinement.main(["--rows", SWEEP_ROWS, "--out",
                                      sweep_out, "--rooms", "8"])
        torch.cuda.synchronize()
        fwd, bwd = fwd + rc.FWD_LAUNCHES, bwd + rc.BWD_LAUNCHES
        with open(JAX_SWEEP, "rb") as f:
            if f.read() != sweep_bytes:
                raise AssertionError(f"{JAX_SWEEP} changed")
        with open(sweep_out) as f:
            if json.load(f) != rows or len(rows) != 2:
                raise AssertionError("the sweep's --out file")
        first = probe_tool.rounded(out["probe"][str(PROBE_SEEDS[0])])
        same = {k: first[k] for k in probe_tool.DIGITS}
        if {k: rows[0][k] for k in same} != same:
            raise AssertionError("sweep row 0 differs from the probe at "
                                 f"seed {PROBE_SEEDS[0]}: {rows[0]}")
        out["sweep"] = rows
        print(f"  sweep rows {SWEEP_ROWS}: iou_delta "
              f"{[r['iou_delta'] for r in rows]}, loss_cut_pct "
              f"{[r['loss_cut_pct'] for r in rows]}; row 0 repeats the "
              f"probe's digits; {JAX_SWEEP} unchanged")

        # 6. an asset bank from .obj files, then one refine step on it
        corpus = write_layout_corpus(os.path.join(tmp, "corpus"))
        bank_path = os.path.join(tmp, "bank.npz")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            build_asset_bank.main([
                "--obj_dir", os.path.join(tmp, "corpus", "object"),
                "--metadata", corpus["metadata"], "--out", bank_path,
                "--max_len", "0.35", "--max_faces", "512",
                "--room_dir", os.path.join(tmp, "corpus", "room"),
                "--wall_metadata", corpus["wall_metadata"]])
        out["bank_build_s"] = time.perf_counter() - t0
        bank_host, shells = scene_spec.load_bank(bank_path)
        if shells is None or shells.verts.shape[0] != 2:
            raise AssertionError("the bank's shells")
        from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME
        bed = OBJECT_IDX_TO_NAME.index("bed")
        chair = OBJECT_IDX_TO_NAME.index("chair")
        midx = assets.retrieve_models(
            np.array([bed, chair]), np.array([[0, 0, 0, 2.0, 1.0, 1.6],
                                              [0, 0, 0, .5, 1.0, .5]]),
            bank_host)
        if list(bank_host.model_class[midx]) != [bed, chair]:
            raise AssertionError(f"retrieval picked {midx}")
        bank = scene_lib.device_bank(bank_host, shells=shells, device=device)
        batch = probe_tool.val_batch(cfg_p, 1, device)
        ins = refine.prepare_refine_inputs(
            batch, bank_host, bank, refine.refine_render_config(cfg_p))
        with torch.no_grad():
            z0 = model.encode(batch)[0]
        rc.reset_launch_counts()
        refiner = refine.make_refine_step(copy.deepcopy(model), batch,
                                          ins[0], bank, *ins[1:], cfg_p, z0)
        loss = float(refiner.step()["total"])
        torch.cuda.synchronize()
        f_, b_ = rc.FWD_LAUNCHES, rc.BWD_LAUNCHES
        moved = float((refiner.z.detach() - z0).abs().max())
        if not (np.isfinite(loss) and moved > 0 and f_ > 0 and b_ > 0):
            raise AssertionError(f"refine step on the built bank: loss "
                                 f"{loss}, z moved {moved}, fwd {f_} bwd {b_}")
        fwd, bwd = fwd + f_, bwd + b_
        out["bank"] = {"models": int(bank_host.verts.shape[0]),
                       "vm": bank_host.vm, "fm": bank_host.fm,
                       "faces_per_scene": int(ins[0].shape[1] * bank_host.fm
                                              + shells.faces.shape[1]),
                       "loss": loss, "z_moved": moved,
                       "launches": [f_, b_]}
        print(f"  asset bank: {out['bank']['models']} models (Fm "
              f"{bank_host.fm}) + 2 shells built in {out['bank_build_s']:.2f}"
              f" s; one refine step on it: loss {loss:.4f}, z moved "
              f"{moved:.3e}, launches fwd {f_} bwd {b_}", flush=True)
    out["launches"] = [fwd, bwd]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the device, build, kernels and times phases")
    ap.add_argument("--train-recipe", action="store_true",
                    help="also train the committed model's whole recipe "
                         "and score it")
    ap.add_argument("--spade-recipe", action="store_true",
                    help="also train the committed shading generator's "
                         "whole recipe (4 chained runs of 750 steps)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run the device, build and parallel phases")
    ap.add_argument("--layout-eval-only", action="store_true",
                    help="run the device, build and layout_eval phases")
    ap.add_argument("--train-scan-only", action="store_true",
                    help="run the device, build and train_scan phases")
    ap.add_argument("--tp-only", action="store_true",
                    help="run the device, build and tensor_parallel phases")
    ap.add_argument("--spade-variants-only", action="store_true",
                    help="run the device, build and spade_variants phases")
    ap.add_argument("--parallel-worker", metavar="DIR",
                    help="one rank of the parallel or tensor_parallel "
                         "phase (the phase starts the ranks with "
                         "torch.distributed.run)")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="the worker's model ranks (tensor_parallel: 2)")
    args = ap.parse_args()
    if args.parallel_worker:
        parallel_worker(args.parallel_worker, args.model_ranks)
        return
    tmp = tempfile.mkdtemp(prefix="sln_chip_smoke_")
    try:
        run(tmp, args.kernels_only, args.train_recipe, args.spade_recipe,
            args.parallel_only, args.layout_eval_only, args.train_scan_only,
            args.tp_only, args.spade_variants_only)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def print_ok() -> None:
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run(tmp: str, kernels_only: bool = False, recipe: bool = False,
        spade_recipe: bool = False, parallel_only: bool = False,
        layout_only: bool = False, scan_only: bool = False,
        tp_only: bool = False, variants_only: bool = False) -> None:
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

    if parallel_only:
        parallel, *_ = parallel_phase(tmp, device, smi)
        print(json.dumps({"parallel": parallel}))
        print_ok()
        return
    if layout_only:
        print(json.dumps({"layout_eval": layout_eval_phase(tmp, device,
                                                           smi)}))
        print_ok()
        return
    if scan_only:
        print(json.dumps({"train_scan": train_scan_phase(device, smi)}))
        print_ok()
        return
    if tp_only:
        tensor_par, _ = tensor_parallel_phase(tmp, device, smi)
        print(json.dumps({"tensor_parallel": tensor_par}))
        print_ok()
        return
    if variants_only:
        print(json.dumps({"spade_variants": spade_variants_phase(device,
                                                                 smi)}))
        print_ok()
        return

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
        # the dry runs' sharded refine: 8 object slots at 32 px, the rooms
        # of its widest data group (each rank renders one of them)
        dcfg, dbatch, dbank, dinputs = dryrun.refine_setup(
            device, max(TP_DRYRUN_RANKS) // 2)
        drcfg = refine.refine_render_config(dcfg)
        errs.append(compare_kernels(
            "32px_dryrun", packed_scene(dbatch, dinputs[0], dbank, drcfg),
            32, drcfg, gen))
        err_fwd = max(e[0] for e in errs)
        err_bwd = max(e[1] for e in errs)
        culling = culled_against_dense(cfg, device)

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
    scan = train_scan_phase(device, smi)
    shading = spade_phase(cfg, tmp, device, smi)
    launches["fwd"] += shading["fwd_launches"]
    spade_training = spade_train_phase(cfg, tmp, device, smi, spade_recipe)
    launches["fwd"] += spade_training["fwd_launches"]
    variants = spade_variants_phase(device, smi)

    with phase("bf16"):
        bf16 = {"train": bf16_train(tmp, device, smi,
                                    training["train_scenes_per_sec"]),
                "sampling": bf16_sampling(cfg, tmp, device, smi)}
        cfg_b = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))

        def fine_tune_bf16():
            return entry.main([
                "--fine_tune", "--synthetic", "32", "--compute_dtype",
                "bfloat16", "--output_dir", CHECKPOINT.output_dir,
                "--checkpoint_name", CHECKPOINT.checkpoint_name,
                "--test_dir", tmp])

        hist_b = counted("bf16 fine_tune 1 room 96px", fine_tune_bf16, ITERS)
        again_b = counted("bf16 fine_tune, again", fine_tune_bf16, ITERS)
        for room, losses in hist_b.items():
            check_losses(f"bf16 fine_tune room {room}",
                         [h["total"] for h in losses])
        if again_b != hist_b:
            raise AssertionError("two bf16 fine_tune runs gave different "
                                 "loss histories")
        model_b = common.restore_model(cfg_b, device)
        ms_b = [counted(name, lambda name=name: timed_refine(
            name, model_b, batch8, inputs96, cfg_b, ITERS), ITERS)
            for name in ("bf16 serving 8 rooms 96px",
                         "bf16 serving 8 rooms 96px, again")]
        if not torch.equal(histories["bf16 serving 8 rooms 96px"],
                           histories["bf16 serving 8 rooms 96px, again"]):
            raise AssertionError("two bf16 serving runs gave different loss "
                                 "histories")
        bf16["refine"] = {
            "fine_tune_total": {r: [h["total"] for h in v]
                                for r, v in hist_b.items()},
            "serving_total": histories["bf16 serving 8 rooms 96px"]
            [[0, -1]].tolist(),
            "serving_ms_per_step": ms_b,
            "fp32_serving_ms_per_step": step_ms["96px_8rooms"]}
        print(f"  bf16 refine: two fine_tunes and two serving runs repeat "
              f"their loss histories bit for bit; serving {ms_b[0]:.3f}, "
              f"{ms_b[1]:.3f} ms/step (fp32 in this call "
              f"{step_ms['96px_8rooms']:.3f}), on {smi}", flush=True)
        bf16["shading"] = bf16_shading(cfg, tmp, device, smi, shading)
        launches["fwd"] += bf16["shading"]["fwd_launches"]

    drawing = draw3d_phase(tmp, device, smi, hist)
    launches["fwd"] += (drawing["fwd_launches"]
                        + drawing["fine_tune_launches"][0])
    launches["bwd"] += drawing["fine_tune_launches"][1]
    parallel, (par_fwd, par_bwd), (par_ref, par_floor) = parallel_phase(
        tmp, device, smi)
    launches["fwd"] += par_fwd
    launches["bwd"] += par_bwd
    tensor_par, (tp_fwd, tp_bwd) = tensor_parallel_phase(
        tmp, device, smi, par_ref, par_floor)
    launches["fwd"] += tp_fwd
    launches["bwd"] += tp_bwd
    layout = layout_eval_phase(tmp, device, smi)
    launches["fwd"] += layout["launches"][0]
    launches["bwd"] += layout["launches"][1]

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
    print(json.dumps({"refine_ms_per_step": step_ms, "total_first_last": {
        "fine_tune": [[h[0]["total"], h[-1]["total"]] for h in hist.values()],
        "serving": histories["serving 8 rooms 96px"][[0, -1]].tolist()}}))
    print(json.dumps({"sampling": quality}))
    print(json.dumps({"train": training}))
    print(json.dumps({"train_scan": scan}))
    print(json.dumps({"spade": shading}))
    print(json.dumps({"spade_train": spade_training}))
    print(json.dumps({"spade_variants": variants}))
    print(json.dumps({"culling": culling}))
    for group, numbers in bf16.items():
        print(json.dumps({f"bf16_{group}": numbers}))
    print(json.dumps({"draw3d": drawing}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"tensor_parallel": tensor_par}))
    print(json.dumps({"layout_eval": layout}))
    print_ok()


if __name__ == "__main__":
    main()
