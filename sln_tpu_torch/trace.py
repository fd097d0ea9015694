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
    refine.graph_replays   refine steps run as a replay of the step's
        CUDA graph (counted only while a profiler records)
    gan.images   images through GauGAN's generator, with and without
        gradient (`GauganTrainer`; counted only while a profiler records)
    spectral.power_iters   power-iteration steps taken by SpectralConvs in
        training forwards, all summed (counted only while a profiler
        records)

A counter that would need a device value (`count_tensor`) keeps a
reference to the value's tensor and sums it when `counters()` is read,
after the traced work, so counting adds no kernel and no sync to it.

A CUDA graph's capture launches nothing, so what it counts is put aside
(`tally()`) and counted again by each replay (`Tally.replay`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = {}
_held: Dict[str, List[Tuple[torch.Tensor, int]]] = {}
_tally: Optional["Tally"] = None


def recording() -> bool:
    """Whether a torch.profiler session records."""
    return torch._C._autograd._profiler_enabled()


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
    if not recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to host counter `name` (to the open tally, inside `tally()`)."""
    with _lock:
        into = _counts if _tally is None else _tally.counts
        into[name] = into.get(name, 0) + n


def count_tensor(name: str, t: torch.Tensor, scale: int = 1) -> None:
    """While a profiler records, add t.sum() x scale to counter `name`
    when `counters()` is next read; t must not be written to after. With
    no profiler, nothing is kept. Inside `tally()` t goes to the tally,
    profiler or not."""
    with _lock:
        if _tally is not None:
            _tally.tensors.append((name, t, scale))
        elif recording():
            _held.setdefault(name, []).append((t, scale))


class Tally:
    """What a CUDA graph's capture counted: host counts, and the graph's
    static tensors that count_tensor was given (each replay overwrites
    them)."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.tensors: List[Tuple[str, torch.Tensor, int]] = []

    def replay(self) -> None:
        """Count one replay of the graph: its counts, and while a profiler
        records, a copy of each static tensor, taken now so that later
        replays leave it alone."""
        for name, n in self.counts.items():
            count(name, n)
        if recording():
            for name, t, scale in self.tensors:
                count_tensor(name, t.clone(), scale)


@contextlib.contextmanager
def tally():
    """Inside, count() and count_tensor() add to the yielded Tally and not
    to the registry, on every thread (autograd runs a card's backward on a
    thread of its own): wrap a graph's capture in it."""
    global _tally
    inner = Tally()
    with _lock:
        outer, _tally = _tally, inner
    try:
        yield inner
    finally:
        with _lock:
            _tally = outer


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
