"""The program's spans and counters.

A span is a `torch.profiler.record_function` range that opens only while
a torch.profiler session records: run any entry point under
`torch.profiler.profile` and its `sln.*` ranges sit on the profiler's own
clock, beside the kernels they launch (Chrome trace, TensorBoard, or the
profiler's events). Without a profiler a span costs one check of the
profiler's flag and records nothing. There is no other switch.

Counters are host integers in one registry, read with `counters()`:

    <span>.calls, <span>.host_ns   each span's calls and host time,
        inclusive, on the host's clock (counted only while a profiler
        records, so after a traced part they hold that part's spans)
    raster.fwd_launches, raster.bwd_launches   the rasterizer's kernel
        launches (always counted; `rasterizer_cuda.FWD_LAUNCHES` and
        `BWD_LAUNCHES` read them)
    raster.dispatched_pairs   the (pixel, face) pairs the forward's chunk
        lists dispatch, sum(counts) x FC x PT per render (counted only
        while a profiler records)

A counter that would need a device value (`count_tensor`) keeps a
reference to the value's tensor and sums it when `counters()` is read,
after the traced work, so counting adds no kernel and no sync to it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

import torch

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = {}
_held: Dict[str, List[Tuple[torch.Tensor, int]]] = {}


class _Span(torch.profiler.record_function):
    """A profiler range that adds its host time to `<name>.host_ns` and
    one to `<name>.calls` when it closes."""

    def __enter__(self):
        super().__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        super().__exit__(*exc)
        with _lock:
            for key, n in ((".calls", 1), (".host_ns", ns)):
                _counts[self.name + key] = _counts.get(self.name + key, 0) + n


def span(name: str):
    """A context manager: a profiler range called `name` (an `sln.` name)
    that counts its calls and host time, while a profiler records; else a
    shared no-op."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to host counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count_tensor(name: str, t: torch.Tensor, scale: int = 1) -> None:
    """While a profiler records, add t.sum() x scale to counter `name`
    when `counters()` is next read; t must not be written to after. With
    no profiler, nothing is kept."""
    if not torch._C._autograd._profiler_enabled():
        return
    with _lock:
        _held.setdefault(name, []).append((t, scale))


def counters() -> Dict[str, int]:
    """Every counter's value. Held tensors are summed now (one copy to the
    host each, and only when a profiler held some) and let go."""
    with _lock:
        held = [(k, v) for k, vs in _held.items() for v in vs]
        _held.clear()
    for name, (t, scale) in held:
        count(name, int(t.sum()) * scale)
    with _lock:
        return dict(_counts)


def reset(*names: str) -> None:
    """Zero the named counters (every counter when none is named)."""
    with _lock:
        for name in names or list(_counts) + list(_held):
            _counts.pop(name, None)
            _held.pop(name, None)
