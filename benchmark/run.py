"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights, traffic, the program's first steps and every shape the
cell uses), then a window of --seconds in which the cell's traffic runs,
then the check of what the window produced against the plain reference.
--trace 0 prints the cell's end-to-end metrics; --trace 1 its per-layer
metrics, read from a traced part of the run. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import harness  # noqa: E402


def _env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels into sln_tpu_torch/_build/ itself; these catch
    any PyTorch extension or Triton kernel it comes to build)."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def run_cell(catalog: harness.Catalog, cell: str, seed: int,
             seconds: float, trace: bool, device: str,
             t_start: float = T_START) -> dict:
    """The result of one run (the result line's object)."""
    import torch

    ctx = harness.Context(catalog, cell, seed, seconds, trace, device,
                          t_start)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    ctx.mark("torch")
    driver = catalog.driver(ctx.traffic["loop"])
    state = driver.setup(ctx)
    rec = driver.window(ctx, state, seconds)
    if trace:
        rec.update(driver.trace(ctx, state))
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    checks = driver.check(ctx, state, rec)
    del state
    bad = harness.forbidden_modules()
    if bad:
        raise SystemExit(f"loaded modules it must not: {bad}")
    limits = ctx.workload.get("limits", {})
    correct = harness.judge(checks, limits)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in catalog.metrics_of(cell, kind):
        value = catalog.reader(m["name"])(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": harness.power_limit() if device != "cpu" else ""}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["trace_window_s"]
        out["breakdown"] = rec["breakdown"]
    ctx.log(f"set-up phases (s from start): {ctx.marks}")
    for k, v in rec.get("log", {}).items():
        ctx.log(f"{k}: {v}")
    out["checks"] = {k: {"value": v if math.isfinite(v) else repr(v),
                         "limit": limits.get(k)}
                     for k, v in checks.items()}
    for k, v in out["checks"].items():
        ctx.log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(harness.HERE)
    _env(root.parent)
    catalog = harness.Catalog(root)
    chips = catalog.workload(args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(catalog, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    sys.stdout.flush()
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
