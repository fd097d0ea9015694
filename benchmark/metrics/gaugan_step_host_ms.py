"""Host ms per GauGAN step inside the program's `sln.gan.step` span, over
the traced steps."""

from benchmark.program_spans import host_ms_per


def read(rec):
    return host_ms_per("sln.gan.step", "sln.gan.step")
