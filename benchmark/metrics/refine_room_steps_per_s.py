"""Rooms x refine iterations completed in the window, over its seconds."""


def read(rec):
    if "room_steps" not in rec:
        return None
    return rec["room_steps"] / rec["window_s"]
