"""The device's idle share of the traced window, in %."""


def read(rec):
    if not rec.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
