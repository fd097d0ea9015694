"""Host ms per shaded room inside the program's `sln.shade.decode` spans
(every z chunk's decode), over the traced rooms."""

from benchmark.program_spans import host_ms_per


def read(rec):
    return host_ms_per("sln.shade.decode", "sln.shade.colorize")
