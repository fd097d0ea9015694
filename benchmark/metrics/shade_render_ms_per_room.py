"""Device ms per room in the shading render (the forward kernel's render
and the SPADE input), by CUDA events around those calls in the window."""


def read(rec):
    return rec.get("render_ms_per_room")
