"""The forward kernels' (item + merge) share of their roofline: the least
time of the traced steps' forward calls, from the (pixel, face) pairs
their inputs need, over the kernels' device time in the trace."""


def read(rec):
    if not rec.get("raster_fwd_s"):
        return None
    return 100.0 * rec["raster_fwd_bound_s"] / rec["raster_fwd_s"]
