"""The backward kernels' (item + reduce + combine) share of their
roofline, as raster_fwd_roofline for the backward calls."""


def read(rec):
    if not rec.get("raster_bwd_s"):
        return None
    return 100.0 * rec["raster_bwd_bound_s"] / rec["raster_bwd_s"]
