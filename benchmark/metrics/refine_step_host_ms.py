"""Host ms per refine step inside the program's `sln.refine.step` span:
the step's own dispatch, over the traced steps."""

from benchmark.program_spans import host_ms_per


def read(rec):
    return host_ms_per("sln.refine.step", "sln.refine.step")
