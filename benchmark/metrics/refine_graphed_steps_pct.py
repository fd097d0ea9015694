"""Share of the traced refine steps that replayed the step's CUDA graph,
in %: the program's `refine.graph_replays` counter over its
`sln.refine.step.calls`. A program that counts no replays leaves it
out."""


def read(rec):
    try:
        from sln_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.counters()
    steps = counts.get("sln.refine.step.calls")
    if not steps or "refine.graph_replays" not in counts:
        return None
    return 100.0 * counts["refine.graph_replays"] / steps
