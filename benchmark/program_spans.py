"""Host time in the program's spans, for the metric readers that read it.

The port's spans (`sln_tpu_torch/trace.py`) add their calls and host time
to the program's counters while a profiler records, so after a cell's
traced part the counters hold that part's spans alone. A program without
that module, or a run whose traced part opened none of the spans, gives
None: the metric is then left out of the line.
"""

from __future__ import annotations

from typing import Optional


def host_ms_per(span: str, unit: str) -> Optional[float]:
    """Host ms inside `span` per call of the span `unit` (a refine step,
    a shaded room), summed over the traced part."""
    try:
        from sln_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.counters()
    calls = counts.get(f"{unit}.calls")
    if not calls or f"{span}.host_ns" not in counts:
        return None
    return counts[f"{span}.host_ns"] * 1e-6 / calls
