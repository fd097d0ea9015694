"""Device ms per refine step in every operation that is not a raster_*
kernel: the render glue, the losses, the decoder and the optimizer."""


def read(rec):
    if "glue_s" not in rec:
        return None
    return 1e3 * rec["glue_s"] / rec["trace_steps"]
