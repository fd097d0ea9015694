"""The VAE's counted GEMM operations, forward and backward, times the
steps of the window, over its seconds, against the fp32 peak, in %."""

from benchmark.harness import peaks


def read(rec):
    if "train_flops" not in rec:
        return None
    return 100.0 * rec["train_flops"] / rec["window_s"] / \
        peaks()["fp32_flops"]
