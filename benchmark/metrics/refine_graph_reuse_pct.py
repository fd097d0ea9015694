"""Share of the traced refine rooms' step graphs that a room replayed
without capturing it, in %: the program's `refine.graph_reuses` over its
`refine.graph_reuses` + `refine.graph_captures`. A program that counts
neither leaves it out."""


def read(rec):
    try:
        from sln_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.counters()
    reuses = counts.get("refine.graph_reuses", 0)
    captures = counts.get("refine.graph_captures", 0)
    if not reuses + captures:
        return None
    return 100.0 * reuses / (reuses + captures)
