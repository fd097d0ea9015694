"""Train the scene-graph VAE: the port's counterpart of the root train.py.

    python -m sln_tpu_torch.train --synthetic 4096 --batch_size 256 \\
        --num_iterations 6000 --KL_free_bits 0.05 --output_dir ckpts

takes the reference's flags (options/options.py) and the JAX package's
additions (`--synthetic N` trains on procedurally generated rooms), and
runs on the card unless --device cpu is given. It writes the checkpoint
trio and metrics.jsonl to --output_dir; `python -m sln_tpu_torch.test`
restores the latest checkpoint from there. Data-parallel over N ranks
(one process each; NCCL on N cards, gloo on the CPU):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m sln_tpu_torch.train --num_data_shards N ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from sln_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                  TrainConfig, default_config)
from sln_tpu_torch.data.vocab import VOCAB
from sln_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from sln_tpu_torch.test import (add_reference_compat_flags,
                                apply_reference_compat_flags, bool_flag)
from sln_tpu_torch.train import checkpoint as ckpt_lib
from sln_tpu_torch.train import loop
from sln_tpu_torch.train.metrics import MetricsLogger
from sln_tpu_torch.workloads import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # reference flags (options/options.py:18-59)
    p.add_argument("--dataset", default="suncg", choices=["suncg"])
    p.add_argument("--suncg_train_dir", default="metadata/data_rot_train.json")
    p.add_argument("--suncg_val_dir", default="metadata/data_rot_val.json")
    p.add_argument("--embedding_dim", default=64, type=int)
    p.add_argument("--gconv_mode", default="feedforward")
    p.add_argument("--gconv_num_layers", default=5, type=int)
    p.add_argument("--mlp_normalization", default="batch", type=str)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--num_iterations", default=600000, type=int)
    p.add_argument("--eval_mode_after", default=-1, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--print_every", default=100, type=int)
    p.add_argument("--checkpoint_every", default=1000, type=int)
    p.add_argument("--snapshot_every", default=10000, type=int)
    p.add_argument("--output_dir", default="./checkpoints")
    p.add_argument("--checkpoint_name", default="latest_checkpoint")
    p.add_argument("--restore_from_checkpoint", default=False,
                   type=bool_flag)
    p.add_argument("--test_dir", default="./layouts_out")
    p.add_argument("--KL_loss_weight", default=0.1, type=float)
    p.add_argument("--use_AE", default=False, type=bool_flag)
    p.add_argument("--decoder_cat", default=True, type=bool_flag)
    p.add_argument("--train_3d", default=True, type=bool_flag)
    p.add_argument("--KL_linear_decay", default=False, type=bool_flag)
    p.add_argument("--use_attr_30", default=True, type=bool_flag)
    p.add_argument("--manual_seed", default=42, type=int)
    # the JAX package's additions
    p.add_argument("--KL_free_bits", default=0.0, type=float,
                   help="per-dimension KL floor (free bits); 0 = the "
                        "reference's loss")
    p.add_argument("--synthetic", default=0, type=int,
                   help="train on N synthetic rooms instead of SUNCG json")
    p.add_argument("--max_objects", default=32, type=int)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="VAE MLP / graph-conv compute dtype (parameters, "
                        "BatchNorm statistics, Adam and the losses stay "
                        "float32)")
    p.add_argument("--num_data_shards", default=None, type=int,
                   help="data-parallel ranks; must equal the launcher's "
                        "world size (python -m torch.distributed.run "
                        "--nproc_per_node N -m sln_tpu_torch.train ...); "
                        "default: the launcher's world size, else 1")
    p.add_argument("--microbatch", default=0, type=int,
                   help="gradient-accumulation chunk size (0 = off)")
    p.add_argument("--stage_on_device", default=True, type=bool_flag,
                   help="accepted for the JAX trainer's invocations; the "
                        "dataset is always put on the device once and each "
                        "batch gathered there")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_reference_compat_flags(p)
    args = p.parse_args(argv)
    apply_reference_compat_flags(args)
    return args


def config_from_args(args) -> Config:
    return default_config().replace(
        model=ModelConfig(
            embedding_dim=args.embedding_dim,
            gconv_num_layers=args.gconv_num_layers,
            gconv_mode=args.gconv_mode,
            mlp_normalization=args.mlp_normalization,
            decoder_cat=args.decoder_cat, use_ae=args.use_AE,
            train_3d=args.train_3d, compute_dtype=args.compute_dtype),
        data=DataConfig(max_objects=args.max_objects,
                        max_triples=args.max_objects * 3,
                        max_on_rels=args.max_objects,
                        use_attr_30=args.use_attr_30,
                        train_path=args.suncg_train_dir,
                        val_path=args.suncg_val_dir),
        train=TrainConfig(
            batch_size=args.batch_size, num_iterations=args.num_iterations,
            learning_rate=args.learning_rate,
            kl_loss_weight=args.KL_loss_weight,
            kl_linear_decay=args.KL_linear_decay,
            kl_free_bits=args.KL_free_bits, seed=args.manual_seed,
            microbatch=args.microbatch,
            print_every=args.print_every,
            checkpoint_every=args.checkpoint_every,
            snapshot_every=args.snapshot_every,
            output_dir=args.output_dir,
            checkpoint_name=args.checkpoint_name),
        test_dir=args.test_dir)


def _quiet(*args, **kwargs) -> None:
    pass


def main(argv=None):
    """Train; returns (the TrainState, the checkpoint dict with its loss
    history).

    Under a launcher (python -m torch.distributed.run) each rank trains
    its rows of every global batch (parallel.mesh): every rank stages the
    whole dataset on its card and restores the same checkpoint, and rank 0
    alone prints, writes metrics.jsonl and the checkpoint trio."""
    args = parse_args(argv)
    cfg = config_from_args(args)
    mesh = make_mesh(args.num_data_shards, device=args.device)
    try:
        return _train(args, cfg, mesh)
    finally:
        mesh.close()


def _train(args, cfg: Config, mesh: Mesh):
    tc = cfg.train
    device = mesh.device
    lead = mesh.rank == 0
    say = print if lead else _quiet
    rows = loop.shard_rows(tc.batch_size, tc.microbatch, mesh.data_index,
                           mesh.data_size)
    say("| options")
    for k, v in sorted(vars(args).items()):
        say(f"{k}: {v}")

    if args.synthetic:
        say(f"| generating {args.synthetic} synthetic rooms")
    else:
        say(f"| loading {cfg.data.train_path}")
    arrays, size_info = common.load_arrays(
        args.synthetic or cfg.data.train_path, cfg, device,
        synthetic_seed=tc.seed)
    n_rooms = arrays["objs"].shape[0]
    n_objects = int(arrays["obj_mask"].sum()) - n_rooms
    say(f"Training dataset has {n_rooms} scenes and {n_objects} objects")

    ckpt = ckpt_lib.new_checkpoint({k: str(v) for k, v in vars(args).items()},
                                   VOCAB.to_dict())
    restored = None
    if args.restore_from_checkpoint:
        restored = ckpt_lib.load_checkpoint(
            ckpt_lib.latest_path(tc.output_dir, tc.checkpoint_name))
    state = loop.create_state(cfg, device, restored)
    # the replicas start from rank 0's bits
    replicate(state.state_tensors(), mesh)
    t, epoch = 0, 0
    if restored is not None:
        say("Restoring from checkpoint")
        ckpt = restored
        t, epoch = restored["counters"]["t"], restored["counters"]["epoch"]

    step_fn = loop.make_train_step(state, cfg, size_info, mesh=mesh)
    eval_step_fn = None
    if args.eval_mode_after >= 0:
        eval_step_fn = loop.make_train_step(state, cfg, size_info,
                                            eval_mode=True, mesh=mesh)
    say("| staging dataset on the device (per-step copy: the batch "
        "indices)")
    staged = loop.stage_arrays(arrays, device)
    rng_np = np.random.default_rng(tc.seed + 1)
    metrics = MetricsLogger(os.path.join(tc.output_dir, "metrics.jsonl")
                            if lead else None)
    try:
        t0 = time.time()
        while t < tc.num_iterations:
            epoch += 1
            say(f"Starting epoch {epoch}")
            for idx in loop.batch_indices(n_rooms, tc.batch_size, rng_np):
                if t >= tc.num_iterations:
                    break
                t += 1
                # frozen-BN steps past --eval_mode_after
                # (reference train.py:63-65)
                active = step_fn
                if eval_step_fn is not None and t >= args.eval_mode_after:
                    active = eval_step_fn
                losses = active(loop.gather_batch(staged, idx[rows]))

                if t % tc.print_every == 0 and lead:
                    losses = {k: float(v) for k, v in losses.items()}
                    # the global batch's scenes
                    rate = tc.print_every * tc.batch_size / max(
                        time.time() - t0, 1e-9)
                    t0 = time.time()
                    print(f"On batch {t} out of {tc.num_iterations} "
                          f"({rate:.0f} scenes/s)")
                    for name, val in losses.items():
                        print(f" [{name}]: {val:.4f}")
                    ckpt_lib.record_losses(ckpt, t, losses)
                    metrics.log(t, scenes_per_sec=rate, **losses)

                if t % tc.checkpoint_every == 0 and lead:
                    path = ckpt_lib.save_checkpoint(
                        ckpt, tc.output_dir, tc.checkpoint_name, t, epoch,
                        ckpt_lib.model_state_of(state.model, cfg.model),
                        ckpt_lib.adam_state_of(state.model, state.optimizer,
                                               cfg.model),
                        snapshot=(t % tc.snapshot_every == 0))
                    print("Saving checkpoint to", path)
    finally:
        metrics.close()
    say("done")
    return state, ckpt
