"""One room's counted operations (seg_mods and its decodes) times the
rooms shaded in the window, over its seconds, against the peak of the
cell's precision, in %."""

from benchmark.harness import peaks


def read(rec):
    if "shade_flops" not in rec:
        return None
    return 100.0 * rec["shade_flops"] / rec["window_s"] / \
        peaks()[rec["peak"]]
