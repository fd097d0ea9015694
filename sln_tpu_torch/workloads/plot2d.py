"""Top-down 2D layout plotter (counterpart of sln_tpu/workloads/plot2d.py;
reference testing/test_plot2d.py:9-141), an own copy of its host code, and
the PNG writer of the shading workload.

Same visual conventions: NYU-40 ScanNet colors, paint order with bed and
television last, structural classes skipped, rotation about the box center
by -angle * 2*pi/24, z flipped for display.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

from sln_tpu_torch.data.vocab import NYU40_CLASSES, OBJECT_IDX_TO_NAME

# ScanNet color table (reference test_plot2d.py:30-71), indexed by NYU-40.
MAPPED_COLORS = [
    (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
    (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
    (178, 76, 76), (247, 182, 210), (66, 188, 102), (219, 219, 141),
    (140, 57, 197), (202, 185, 52), (51, 176, 203), (200, 54, 131),
    (92, 193, 61), (78, 71, 183), (172, 114, 82), (255, 127, 14),
    (91, 163, 138), (153, 98, 156), (140, 153, 101), (158, 218, 229),
    (100, 125, 154), (178, 127, 135), (120, 185, 128), (146, 111, 194),
    (44, 160, 44), (112, 128, 144), (96, 207, 209), (227, 119, 194),
    (213, 92, 176), (94, 106, 211), (82, 84, 163), (100, 85, 144),
]

# paint order: later entries drawn on top (test_plot2d.py:25-29)
PAINT_ORDER = [c for c in NYU40_CLASSES
               if c not in ("television", "bed")] + ["television", "bed"]

DO_NOT_VIS = ("wall", "ceiling", "floor", "person", "door", "window",
              "curtain", "blinds", "__room__")


def rotated_footprint(box: np.ndarray, angle: float, room_dims: np.ndarray
                      ) -> np.ndarray:
    """Four xz corners of a normalized box rotated about its center.

    Math of test_plot2d.py:84-110 / test_utils.get_eight_coors_bbox_new.
    """
    lo = box[:3] * room_dims
    hi = box[3:] * room_dims
    center = (lo + hi) / 2.0
    lo_c, hi_c = lo - center, hi - center
    theta = -float(angle) * (2.0 * np.pi / 24.0)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    corners3 = [lo_c,
                np.array([lo_c[0], lo_c[1], hi_c[2]]),
                hi_c,
                np.array([hi_c[0], lo_c[1], lo_c[2]])]
    pts = [(rot @ p) + center for p in corners3]
    return np.array([[p[0], p[2]] for p in pts])


def plot2d(boxes: Sequence, angles: Sequence, objs: Sequence[int],
           save_path: str) -> None:
    """boxes: (n, 6) normalized with the room box last; angles: (n,) float;
    objs: (n,) class ids; draws the floor + rotated footprints."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Polygon

    boxes = np.asarray(boxes, np.float64)
    angles = np.asarray(angles, np.float64)
    room_dims = boxes[-1][3:]

    names, polys = [], []
    for i, cls in enumerate(objs):
        name = OBJECT_IDX_TO_NAME[int(cls)]
        if name in DO_NOT_VIS:
            continue
        corners = rotated_footprint(boxes[i], angles[i], room_dims)
        corners[:, 1] = 1.0 - corners[:, 1]
        names.append(name.replace("_", " "))
        polys.append(corners)

    order = sorted(range(len(names)),
                   key=lambda k: PAINT_ORDER.index(names[k]))

    fig, ax = plt.subplots()
    patches = [Polygon(np.array([[-0.1, -0.1], [-0.1, 1.1],
                                 [1.1, 1.1], [1.1, -0.1]]), closed=True)]
    colors = [MAPPED_COLORS[NYU40_CLASSES.index("floor")]]
    for k in order:
        colors.append(MAPPED_COLORS[NYU40_CLASSES.index(names[k])])
        patches.append(Polygon(polys[k], closed=True))
    colors = np.hstack([np.array(colors) / 255.0,
                        np.ones((len(colors), 1))])
    ax.add_collection(PatchCollection(patches, facecolors=colors, alpha=1.0))
    ax.set(xlim=(0.0, 1.0), ylim=(0.0, 1.0), aspect="equal")
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    plt.tight_layout()
    ax.axes.get_xaxis().set_visible(False)
    ax.axes.get_yaxis().set_visible(False)
    plt.subplots_adjust(left=0.0, right=1.0, top=1.0, bottom=0.0)
    plt.savefig(save_path)
    plt.close(fig)


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, with the standard library only
    (the card's machine has no matplotlib or imageio). Its pixels equal
    those matplotlib's imsave writes for the same array."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                         1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
