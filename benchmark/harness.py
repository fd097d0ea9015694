"""What every cell shares: finding a cell's files by name, the run's
context, the traced window and its reduction, the result line.

Files are found by the names in BENCHMARK.json, so a new configuration,
cell or metric is a new file:
    configs/<config>.json     the configuration as it is run
    traffic/<traffic>.json    a traffic mix: its loop and its parameters
    workloads/<cell>.json     its configuration, traffic and limits
    drivers/<loop>.py         a traffic loop (setup, window, trace, check)
    metrics/<metric>.py       read(record) -> number, or None
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sln_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file (metric names hold dots, so they are loaded
    by path and not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Catalog:
    """The benchmark's entries (BENCHMARK.json) and the files they name,
    under `root` (the benchmark's folder)."""

    def __init__(self, root: Path = HERE, spec: Optional[dict] = None):
        self.root = Path(root)
        self.spec = spec if spec is not None else read_json(
            self.root.parent / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return read_json(self.root / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return read_json(self.root / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return read_json(self.root / "traffic" / f"{name}.json")

    def driver(self, name: str) -> ModuleType:
        return load_module(self.root / "drivers" / f"{name}.py",
                           f"benchmark_driver_{name}")

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        mod = load_module(self.root / "metrics" / f"{metric}.py",
                          "benchmark_metric_" + metric.replace(".", "_"))
        return mod.read

    def metrics_of(self, cell: str, kind: str) -> List[dict]:
        """The entries of `kind` ("end_to_end" or "per_layer") that `cell`
        reports: those that list it, or list no cells at all."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]


class Context:
    """One run: its arguments, device, cell and configuration."""

    def __init__(self, catalog: Catalog, cell: str, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float):
        self.catalog, self.cell = catalog, cell
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.workload = catalog.workload(cell)
        self.config = catalog.config(self.workload["config"])
        self.traffic = catalog.traffic(self.workload["traffic"])
        self.repo = HERE.parent
        self.marks: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        """Seconds from process start to the end of a set-up phase."""
        self.sync()
        self.marks[name] = round(self.since_start(), 3)

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def since_start(self) -> float:
        return time.perf_counter() - self.t_start


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a torch.profiler range in the traced run."""
    import torch
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def default_dtype(dtype):
    """torch's default floating type inside the block (the reference in
    float64, as a witness of float32's rounding)."""
    import torch
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def peaks() -> dict:
    return read_json(HERE / "peaks.json")


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or what failed."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()[:100]}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(fn: Callable[[], None], device: str) -> dict:
    """Run fn under torch.profiler (host and device) and reduce the trace:
    window_s (host clock), busy_s (union of device operations), the device
    seconds of each kernel name, the kernels launched, the device
    operations that took most time and the longest idle gaps with what the
    host was doing in them (the innermost benchmark span and host
    operation)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            fn()
            if device != "cpu":
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in cpu}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in host_names]
    win = next(e for e in cpu if e.name == "bench.window").time_range
    per_name: Dict[str, float] = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) * 1e-6
    busy = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, last = [], win.start
    for s, e in busy + [[win.end, win.end]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    spans = sorted((e for e in cpu if e.name.startswith("bench.")
                    and e.name != "bench.window"),
                   key=lambda e: e.time_range.start)
    ops = sorted((e for e in cpu if not e.name.startswith("bench.")),
                 key=lambda e: e.time_range.start)
    starts = {id(evs): [e.time_range.start for e in evs]
              for evs in (spans, ops)}

    def innermost(evs, t, look=256):
        """The latest-starting event of evs (sorted) that holds t."""
        i = bisect.bisect_right(starts[id(evs)], t)
        for e in reversed(evs[max(0, i - look):i]):
            if e.time_range.end >= t:
                return e.name
        return ""

    by_host: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        label = " / ".join(x for x in (innermost(spans, mid),
                                       innermost(ops, mid)) if x) or "idle"
        by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6
    kernels = [e for e in dev if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_s, "kernel_s": per_name,
            "kernels": len(kernels),
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}


def by_quarter(stamps: List[float], t0: float, seconds: float) -> List[int]:
    """Units issued in each quarter of the window (a warm-up inside it
    shows as a slow first quarter)."""
    out = [0, 0, 0, 0]
    for t in stamps:
        out[min(3, int(4 * (t - t0) / seconds))] += 1
    return out


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number within its limit (a missing limit, or a
    number that is not finite, fails)."""
    return bool(numbers) and all(
        k in limits and limits[k] is not None and math.isfinite(v)
        and v <= limits[k] for k, v in numbers.items())
