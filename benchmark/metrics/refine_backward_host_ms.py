"""Host ms per refine step inside the program's `sln.refine.backward`
span (autograd's backward of the step's total loss), over the traced
steps."""

from benchmark.program_spans import host_ms_per


def read(rec):
    return host_ms_per("sln.refine.backward", "sln.refine.step")
