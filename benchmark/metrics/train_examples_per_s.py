"""Training examples stepped in the window, over its seconds."""


def read(rec):
    if "examples" not in rec:
        return None
    return rec["examples"] / rec["window_s"]
