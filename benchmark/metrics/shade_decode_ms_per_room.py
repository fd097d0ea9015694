"""Device ms per room in the generator's decodes (every z chunk), by CUDA
events around the decode calls in the window."""


def read(rec):
    return rec.get("decode_ms_per_room")
