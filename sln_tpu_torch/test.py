"""Inference workload entry point of the port: --fine_tune (render-and-
refine), the counterpart of the root test.py's --fine_tune branch.

    python -m sln_tpu_torch.test --fine_tune --synthetic 32 \\
        --output_dir artifacts --checkpoint_name bench --test_dir out/

runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

from sln_tpu_torch import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fine_tune", action="store_true")
    p.add_argument("--output_dir", default="./checkpoints")
    p.add_argument("--checkpoint_name", default="latest_checkpoint")
    p.add_argument("--test_dir", default="./layouts_out")
    p.add_argument("--synthetic", default=0, type=int,
                   help="use N synthetic rooms instead of SUNCG json")
    p.add_argument("--allow_random_weights", action="store_true")
    p.add_argument("--refine_render_size", default=0, type=int,
                   help="override RefineConfig.render_size (256 = strict "
                        "reference parity; default 96 = the loss-pyramid "
                        "top)")
    p.add_argument("--refine_pyramid", default="", type=str,
                   help="comma-separated PSP pyramid sizes (default "
                        "32,48,64,96)")
    p.add_argument("--refine_iters", default=0, type=int,
                   help="override RefineConfig.num_iters (default 60)")
    p.add_argument("--room_ids", default="", type=str,
                   help="comma-separated room ids for --fine_tune")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def build_cfg(args):
    import dataclasses as dc

    from sln_tpu_torch.config import TrainConfig, default_config
    cfg = default_config()
    refine = cfg.refine
    if args.refine_render_size:
        refine = dc.replace(refine, render_size=args.refine_render_size)
    if args.refine_pyramid:
        refine = dc.replace(refine, pyramid_sizes=tuple(
            int(s) for s in args.refine_pyramid.split(",") if s))
    if args.refine_iters:
        refine = dc.replace(refine, num_iters=args.refine_iters)
    return cfg.replace(refine=refine,
                       train=TrainConfig(output_dir=args.output_dir,
                                         checkpoint_name=args.checkpoint_name),
                       test_dir=args.test_dir)


def main(argv=None):
    """Returns the workload's result (the per-room loss history for
    --fine_tune)."""
    args = parse_args(argv)
    cfg = build_cfg(args)
    device = resolve_device(args.device)
    os.makedirs(args.test_dir, exist_ok=True)

    if args.fine_tune:
        from sln_tpu_torch.workloads import common, refine
        # validation rooms, as the root test.py's setup draws them
        if args.synthetic:
            val, size_info = common.load_arrays(
                max(args.synthetic // 4, 8), cfg, device, synthetic_seed=99)
        else:
            val, size_info = common.load_arrays(
                "metadata/data_rot_val.json", cfg, device)
        model = common.restore_model(cfg, device, args.allow_random_weights)
        room_ids = ([s for s in args.room_ids.split(",") if s]
                    or [str(int(val["room_ids"][0]))])
        base = os.path.join(args.test_dir, "data", "finetune")
        dirs = [os.path.join(base, r) for r in room_ids]
        return refine.finetune_rooms(model, val, size_info, cfg, room_ids,
                                     dirs, device=device)

    print("No mode selected; see --help")
    return None


if __name__ == "__main__":
    main()
