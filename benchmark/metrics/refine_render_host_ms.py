"""Host ms per refine step inside the program's `sln.render.layout` span:
the render's glue (assembly, camera, packing and culling, the forward
launch, the channel stack), over the traced steps."""

from benchmark.program_spans import host_ms_per


def read(rec):
    return host_ms_per("sln.render.layout", "sln.refine.step")
