"""The refine step's counted operations (needed pairs x operations per
pair, the decoder's GEMMs forward and backward, the pyramid's resizes)
over the window's seconds, against the fp32 peak, in %."""

from benchmark.harness import peaks


def read(rec):
    if "refine_flops" not in rec:
        return None
    return 100.0 * rec["refine_flops"] / rec["window_s"] / \
        peaks()["fp32_flops"]
