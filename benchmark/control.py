"""The controls of `correct`: the plain reference put in the program's
place, computed one precision below the configuration's, or with a
planted fault, on a cell's own inputs at its own size, judged by the
cell's own limits as a run's check is.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--kind lower|half_batch|float64]

Each traffic loop names the kinds it has (`KINDS`) and computes them
(`control(ctx, state, kind)`): lower is TF32 for a float32 cell (TF32
off) and float8 e4m3 for a bfloat16 one; half_batch the loss's mean over
half of each batch; float64 a witness and no control, the float32
reference against the float64 one. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from benchmark import harness


def control_numbers(ctx, kind: str):
    """(compared, logged) numbers of the control `kind` on the cell's own
    inputs, or None where the cell cannot have it."""
    driver = ctx.catalog.driver(ctx.traffic["loop"])
    if kind not in getattr(driver, "KINDS", ()):
        return None
    return driver.control(ctx, driver.make_inputs(ctx), kind)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kind", default="lower")
    args = p.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    catalog = harness.Catalog()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(catalog, args.workload, seed, 0.0, False,
                              device, t0)
        out = control_numbers(ctx, args.kind)
        if out is None:
            print(f"{args.workload} has no control {args.kind!r}",
                  file=sys.stderr)
            return 2
        numbers, logged = out
        limits = ctx.workload.get("limits", {})
        print(json.dumps({
            "workload": args.workload, "seed": seed, "kind": args.kind,
            "correct": harness.judge(numbers, limits),
            "checks": {k: {"value": v if math.isfinite(v) else repr(v),
                           "limit": limits.get(k)}
                       for k, v in numbers.items()},
            "logged": logged, "seconds": time.perf_counter() - t0}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
