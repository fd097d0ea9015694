"""GauGAN's traffic: seeded (label map, image) pairs made on the device.

Each label map is a Voronoi partition of the square into 4-40 regions
(uniform sites); each region's class is drawn Zipf-like over the label_nc
classes (p(k) proportional to 1 / (k + 1)), and a share of regions is
don't-care (id label_nc). Each image is a per-class colour (a palette per
pool, uniform in [-0.8, 0.8]) plus Gaussian noise, clamped to [-1, 1].
The benchmark's own copy, frozen with it: the program's
`spade/labels.py` makes pairs of the same kind for its CLI.
"""

from __future__ import annotations

from typing import Tuple

import torch


def label_pairs(n: int, size: int, label_nc: int, dontcare_share: float,
                regions: Tuple[int, int], noise_std: float,
                gen: torch.Generator, chunk: int = 16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels (n, 1, size, size) uint8, images (n, 3, size, size)) on the
    generator's device."""
    dev = gen.device
    lo, hi = regions
    palette = torch.rand((label_nc + 1, 3), generator=gen,
                         device=dev) * 1.6 - 0.8
    zipf = 1.0 / torch.arange(1, label_nc + 1, device=dev,
                              dtype=torch.float32)
    axis = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5) / size
    py, px = torch.meshgrid(axis, axis, indexing="ij")
    py, px = py.reshape(1, 1, -1), px.reshape(1, 1, -1)
    labels, images = [], []
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        count = torch.randint(lo, hi + 1, (c, 1), generator=gen, device=dev)
        sy = torch.rand((c, hi, 1), generator=gen, device=dev)
        sx = torch.rand((c, hi, 1), generator=gen, device=dev)
        d2 = (py - sy) ** 2 + (px - sx) ** 2                 # (c, hi, S*S)
        unused = torch.arange(hi, device=dev)[None] >= count
        d2 = d2.masked_fill(unused[..., None], float("inf"))
        region = d2.argmin(1)
        cls = torch.multinomial(zipf, c * hi, replacement=True,
                                generator=gen).view(c, hi)
        dontcare = torch.rand((c, hi), generator=gen,
                              device=dev) < dontcare_share
        cls = cls.masked_fill(dontcare, label_nc)
        label = torch.gather(cls, 1, region).view(c, size, size)
        noise = torch.randn((c, 3, size, size), generator=gen, device=dev)
        img = palette[label].permute(0, 3, 1, 2) + noise_std * noise
        labels.append(label[:, None].to(torch.uint8))
        images.append(img.clamp(-1.0, 1.0))
    return torch.cat(labels), torch.cat(images)
