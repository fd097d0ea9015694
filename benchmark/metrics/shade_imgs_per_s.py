"""Shaded images that reached the host as uint8 in the window, over its
seconds."""


def read(rec):
    if "images" not in rec:
        return None
    return rec["images"] / rec["window_s"]
