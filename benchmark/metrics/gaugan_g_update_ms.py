"""Device ms per GauGAN step in the generator's update (`g_update`), by
CUDA events around its calls in the window of a traced run."""


def read(rec):
    return rec.get("g_update_ms")
