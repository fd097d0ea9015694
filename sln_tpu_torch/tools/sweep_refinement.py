"""Controlled refinement-value sweep on the committed bench checkpoint (the
port's counterpart of the JAX package's tools/sweep_refinement.py: the
same rows, run in-process through the port's probe).

    python -m sln_tpu_torch.tools.sweep_refinement [--rows 0,2] \\
        [--out /tmp/refine_sweep.json] [--rooms 8] [--device cuda]

Each row runs tools/eval_refinement_quality.py's protocol on
artifacts/latest_bench_with_model.ckpt (sigma-perturbed GT-encoded z,
synthetic_seed 11) at one (sigma, num_iters, lr_z) and adds iou_delta and
loss_cut_pct. It answers (a) whether any (lr_z, iters) recovers the
decoded layout's IoU by 0.01 or more, and (b) what the reference
hyperparameters (lr_z 2e-4, nesterov 0.1, 60 iterations) deliver.

The rows go to --out, never to artifacts/refine_sweep.json: that file is
the JAX package's record, and writing to it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

from sln_tpu_torch.tools import eval_refinement_quality as probe_tool

REPO = Path(__file__).resolve().parents[2]
JAX_RECORD = REPO / "artifacts" / "refine_sweep.json"
GRID = [
    # the reference hyperparameters (lr_z 0 -> RefineConfig's 2e-4)
    dict(sigma=1.0, num_iters=60),
    # the z learning-rate ladder at the reference budget
    dict(sigma=1.0, num_iters=60, lr_z=2e-3),
    dict(sigma=1.0, num_iters=60, lr_z=2e-2),
    dict(sigma=1.0, num_iters=60, lr_z=1e-1),
    # longer budgets at the two most promising rates
    dict(sigma=1.0, num_iters=240, lr_z=2e-2),
    dict(sigma=1.0, num_iters=240, lr_z=1e-1),
    # perturbation-size sensitivity at the best rate
    dict(sigma=0.5, num_iters=60, lr_z=2e-2),
    dict(sigma=2.0, num_iters=60, lr_z=2e-2),
]


def run_probe(output_dir: str, checkpoint_name: str, device: str, **kw):
    """One row: the probe's printed (rounded) record plus the row's
    settings."""
    argv = ["--output_dir", output_dir, "--checkpoint_name",
            checkpoint_name, "--device", device]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    rec = probe_tool.rounded(probe_tool.main(argv)[0])
    rec.update(kw)
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default="",
                   help="comma-separated GRID indices (default: all 8)")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "sln_tpu_torch_refine_sweep.json"))
    p.add_argument("--rooms", type=int, default=8)
    p.add_argument("--output_dir", default=str(REPO / "artifacts"))
    p.add_argument("--checkpoint_name", default="bench")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    out = Path(args.out).resolve()
    if out == JAX_RECORD.resolve():
        raise ValueError(f"{JAX_RECORD} is the JAX package's record; give "
                         "--out another path")
    picked = ([int(i) for i in args.rows.split(",")] if args.rows
              else range(len(GRID)))
    rows = []
    for i in picked:
        rec = run_probe(args.output_dir, args.checkpoint_name, args.device,
                        rooms=args.rooms, **GRID[i])
        rec["iou_delta"] = round(rec["iou_refined"] - rec["iou_perturbed"],
                                 4)
        rec["loss_cut_pct"] = round(
            100.0 * (1.0 - rec["loss_last"] / rec["loss_first"]), 2)
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print("saved", out)
    return rows


if __name__ == "__main__":
    main()
