"""Inference workload entry point of the port, the counterpart of the root
test.py's modes:

    --batch_gen            posterior cache + 4 sampled layouts per val room
    --measure_acc_l1_std   L1 / scene-graph accuracy / sample std
    --heat_map             20,000 sampled layouts of one scene graph + PNGs
    --draw_2d              top-down plot of the demo layout
    --fine_tune            render-and-refine
    --gan_shade            SPADE shading of rendered val rooms, num_z PNGs
                           per room

    python -m sln_tpu_torch.test --measure_acc_l1_std --synthetic 64 \\
        --output_dir artifacts --checkpoint_name bench --test_dir out/

runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sln_tpu_torch import resolve_device


def bool_flag(s: str) -> bool:
    """The reference's 0/1 bool parser (utils.py:106-112)."""
    if str(s).lower() in ("1", "true"):
        return True
    if str(s).lower() in ("0", "false"):
        return False
    raise argparse.ArgumentTypeError(f"invalid bool flag {s!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch_gen", action="store_true")
    p.add_argument("--measure_acc_l1_std", action="store_true")
    p.add_argument("--heat_map", action="store_true")
    p.add_argument("--draw_2d", action="store_true")
    p.add_argument("--fine_tune", action="store_true")
    p.add_argument("--gan_shade", action="store_true")
    p.add_argument("--suncg_train_dir", default="metadata/data_rot_train.json")
    p.add_argument("--suncg_val_dir", default="metadata/data_rot_val.json")
    p.add_argument("--output_dir", default="./checkpoints")
    p.add_argument("--checkpoint_name", default="latest_checkpoint")
    p.add_argument("--test_dir", default="./layouts_out")
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--synthetic", default=0, type=int,
                   help="use N synthetic rooms instead of SUNCG json")
    p.add_argument("--max_objects", default=32, type=int)
    p.add_argument("--allow_random_weights", action="store_true")
    p.add_argument("--heatmap_iters", default=20000, type=int)
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
    p.add_argument("--num_z", default=50, type=int,
                   help="z samples per room for --gan_shade (reference "
                        "test.py:94)")
    p.add_argument("--spade_checkpoint", default="", type=str,
                   help="explicit SPADE generator weights for --gan_shade "
                        "(.pth = a reference checkpoint, else a shading-"
                        "trainer pickle); default: "
                        "<output_dir>/latest_net_G_AB.pth, then the "
                        "committed artifacts/spade_gan.ckpt (skipped if "
                        "trained at other dims than --spade_crop/"
                        "--spade_ngf), then random init")
    p.add_argument("--spade_crop", default=256, type=int,
                   help="SPADE render size (reference: 256)")
    p.add_argument("--spade_ngf", default=64, type=int,
                   help="SPADE width (reference: 64)")
    p.add_argument("--spade_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="SPADE compute dtype; only float32 is ported")
    p.add_argument("--semantic_source", default="rasterizer",
                   choices=["rasterizer", "blender", "files"],
                   help="--gan_shade mask/depth source: the rasterizer "
                        "(default) or existing files in "
                        "<test_dir>/data/semantic_masks; blender is not "
                        "ported")
    # accepted as the root test.py accepts them; the Blender bridge is
    # not ported (ROADMAP item 8)
    p.add_argument("--blender_path", default="", type=str)
    p.add_argument("--blender_script", default="", type=str)
    # the model and data flags of the reference's global Options
    # (options/options.py:18-61); a restored checkpoint's weights must
    # match them, as in the reference
    p.add_argument("--embedding_dim", default=64, type=int)
    p.add_argument("--gconv_mode", default="feedforward")
    p.add_argument("--gconv_num_layers", default=5, type=int)
    p.add_argument("--mlp_normalization", default="batch", type=str)
    p.add_argument("--use_AE", default=False, type=bool_flag)
    p.add_argument("--decoder_cat", default=True, type=bool_flag)
    p.add_argument("--train_3d", default=True, type=bool_flag)
    p.add_argument("--use_attr_30", default=True, type=bool_flag)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def build_cfg(args):
    import dataclasses as dc

    from sln_tpu_torch.config import (DataConfig, ModelConfig, SpadeConfig,
                                      TrainConfig, default_config)
    cfg = default_config()
    refine = cfg.refine
    if args.refine_render_size:
        refine = dc.replace(refine, render_size=args.refine_render_size)
    if args.refine_pyramid:
        refine = dc.replace(refine, pyramid_sizes=tuple(
            int(s) for s in args.refine_pyramid.split(",") if s))
    if args.refine_iters:
        refine = dc.replace(refine, num_iters=args.refine_iters)
    return cfg.replace(
        refine=refine,
        model=ModelConfig(embedding_dim=args.embedding_dim,
                          gconv_num_layers=args.gconv_num_layers,
                          gconv_mode=args.gconv_mode,
                          mlp_normalization=args.mlp_normalization,
                          decoder_cat=args.decoder_cat,
                          use_ae=args.use_AE, train_3d=args.train_3d),
        data=DataConfig(max_objects=args.max_objects,
                        max_triples=args.max_objects * 3,
                        max_on_rels=args.max_objects,
                        use_attr_30=args.use_attr_30,
                        train_path=args.suncg_train_dir,
                        val_path=args.suncg_val_dir),
        train=TrainConfig(output_dir=args.output_dir,
                          checkpoint_name=args.checkpoint_name),
        spade=SpadeConfig(crop_size=args.spade_crop, ngf=args.spade_ngf,
                          num_z=args.num_z, compute_dtype=args.spade_dtype),
        test_dir=args.test_dir)


def setup(args, cfg, device, train: bool = True):
    """(model, train arrays (None unless `train`), val arrays, size
    table), loaded as the root test.py's setup loads them."""
    from sln_tpu_torch.workloads import common

    tr = None
    if args.synthetic:
        if train:
            tr, _ = common.load_arrays(args.synthetic, cfg, device)
        va, size_info = common.load_arrays(max(args.synthetic // 4, 8), cfg,
                                           device, synthetic_seed=99)
    else:
        if train:
            tr, _ = common.load_arrays(cfg.data.train_path, cfg, device)
        va, size_info = common.load_arrays(cfg.data.val_path, cfg, device)
    model = common.restore_model(cfg, device, args.allow_random_weights)
    return model, tr, va, size_info


# the demo layout of the reference test.py:46-53
DEMO_BOXES = np.array([
    [0.31150928, 0.31271002, 0.00309663, 0.72957528, 0.82625818, 0.05425087],
    [-0.06599953, 0.01722394, 0.28853789, 0.25737822, 0.75531799,
     0.42857787],
    [0.55675948, 0.01778692, 0.14249095, 0.90461600, 0.31667089, 0.66919732],
    [0.62057209, 0.01821164, 0.84169930, 0.83482409, 0.38932487, 0.96370161],
    [0.17114696, 0.01767171, 0.80859685, 0.46015960, 0.50266063, 0.96572173],
    [0.0, 0.0, 0.0, 1.0, 0.73272365, 0.92786783]])
DEMO_ROTS = [0.00085504, 18.07450676, 6.06250334, 12.16077995, 12.01297188,
             0.0]
DEMO_OBJS = [20, 18, 30, 3, 11, 0]


def main(argv=None):
    """Returns the workload's result: the output path (--batch_gen,
    --draw_2d), the metrics (--measure_acc_l1_std), the PNG paths
    (--heat_map, --gan_shade) or the per-room loss history
    (--fine_tune)."""
    args = parse_args(argv)
    cfg = build_cfg(args)
    device = resolve_device(args.device)
    os.makedirs(args.test_dir, exist_ok=True)

    if args.batch_gen:
        from sln_tpu_torch.workloads import batch_gen
        model, tr, va, si = setup(args, cfg, device)
        out = batch_gen.run_batch_gen(model, tr, va, si, cfg, args.test_dir,
                                      batch_size=args.batch_size,
                                      device=device)
        print("Wrote", out)
        return out

    if args.measure_acc_l1_std:
        from sln_tpu_torch.workloads import acc_l1_std, posterior
        model, tr, va, si = setup(args, cfg, device)
        mean, cov = posterior.get_or_compute_mean_cov(
            model, tr, si, cfg, args.test_dir, device)
        acc = acc_l1_std.run_acc_l1(model, va, si, cfg, mean, cov,
                                    batch_size=args.batch_size,
                                    device=device)
        print("PRED, RAND, PERT L1:", acc["l1_pred"], acc["l1_rand"],
              acc["l1_pert"])
        print("PRED, RAND, PERT ACC: ", acc["acc_pred"], acc["acc_rand"],
              acc["acc_pert"])
        std = acc_l1_std.run_std(model, va, si, cfg, mean, cov,
                                 batch_size=args.batch_size, device=device)
        print("mean angle std:", std["std_angle"])
        print("mean pos std:", std["std_pos"])
        print("mean sizes std:", std["std_size"])
        return {**acc, **std}

    if args.heat_map:
        from sln_tpu_torch.workloads import heatmap, posterior
        model, tr, va, si = setup(args, cfg, device)
        mean, cov = posterior.get_or_compute_mean_cov(
            model, tr, si, cfg, args.test_dir, device)
        print("Calling network to produce object positions...")
        pkl_path = heatmap.produce_heatmap(model, mean, cov, args.test_dir,
                                           num_iter=args.heatmap_iters,
                                           device=device)
        print("Rendering images...")
        heat_dir = os.path.join(args.test_dir, "data", "heat")
        paths = heatmap.plot_heatmap(pkl_path, heat_dir)
        print("Wrote", len(paths), "heatmaps to", heat_dir)
        return paths

    if args.draw_2d:
        from sln_tpu_torch.workloads.plot2d import plot2d
        save_dir = os.path.join(args.test_dir, "data", "2D_rendered")
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, "demo.png")
        plot2d(DEMO_BOXES, DEMO_ROTS, DEMO_OBJS, out)
        print("Wrote", out)
        return out

    if args.fine_tune:
        from sln_tpu_torch.workloads import refine
        model, _, val, size_info = setup(args, cfg, device, train=False)
        room_ids = ([s for s in args.room_ids.split(",") if s]
                    or [str(int(val["room_ids"][0]))])
        base = os.path.join(args.test_dir, "data", "finetune")
        dirs = [os.path.join(base, r) for r in room_ids]
        return refine.finetune_rooms(model, val, size_info, cfg, room_ids,
                                     dirs, device=device)

    if args.gan_shade:
        from sln_tpu_torch.workloads import gan_shade
        if args.semantic_source == "blender":
            raise NotImplementedError(
                "--semantic_source blender (the Blender mask/depth render) "
                "is not ported (ROADMAP item 8); use rasterizer or files")
        _, _, val, size_info = setup(args, cfg, device, train=False)
        out_dir = os.path.join(args.test_dir, "data", "SPADE_out")
        semantic_dir = None
        if args.semantic_source == "files":
            semantic_dir = os.path.join(args.test_dir, "data",
                                        "semantic_masks")
        return gan_shade.run_gan_shade(
            val, size_info, cfg, num_z=args.num_z, save_dir=out_dir,
            spade_checkpoint=args.spade_checkpoint or None,
            semantic_dir=semantic_dir, device=device)

    print("No mode selected; see --help")
    return None


if __name__ == "__main__":
    main()
