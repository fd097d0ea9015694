"""Device ms per GauGAN step in the discriminator's update (`d_update`),
by CUDA events around its calls in the window of a traced run."""


def read(rec):
    return rec.get("d_update_ms")
