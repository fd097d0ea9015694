"""Device kernels launched per refine step in the trace: the host's
dispatch load."""


def read(rec):
    if "glue_s" not in rec:
        return None
    return rec["kernels"] / rec["trace_steps"]
