"""Label maps for GauGAN: the one-hot input (NVlabs/SPADE pix2pix_model.py
`preprocess_input`) and seeded synthetic (label, image) pairs made on the
device, for training and measuring without a dataset.

Ids follow GauGAN's ADE20K loader: classes 0..label_nc-1 and, with a
don't-care label, id label_nc; the one-hot map then has label_nc + 1
channels.
"""

from __future__ import annotations

from typing import Tuple

import torch

# the synthetic maps: a share of regions marked don't-care, the colour
# noise's standard deviation
DONTCARE_SHARE = 0.05
NOISE_STD = 0.1


def one_hot(label: torch.Tensor, nc: int) -> torch.Tensor:
    """(B, 1, H, W) or (B, H, W) integer ids -> (B, nc, H, W) float32 one-hot,
    on label's device."""
    if label.dim() == 3:
        label = label[:, None]
    out = torch.zeros((label.shape[0], nc) + tuple(label.shape[2:]),
                      device=label.device)
    return out.scatter_(1, label.long(), 1.0)


def synthetic_label_pairs(n: int, size: int, label_nc: int, dontcare: bool,
                          generator: torch.Generator,
                          regions: Tuple[int, int] = (4, 40),
                          chunk: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n (label (1, size, size) uint8, rgb (3, size, size) in [-1, 1])
    pairs on the generator's device, as ((n, 1, S, S), (n, 3, S, S)).

    Each label map is a Voronoi partition of the square into a number of
    regions drawn from `regions` (inclusive), with uniform sites; each
    region's class is drawn Zipf-like over the label_nc classes (p(k)
    proportional to 1 / (k + 1)), and with a don't-care label a share
    DONTCARE_SHARE of regions is don't-care. Each image is a per-class
    colour (one palette per call, uniform in [-0.8, 0.8]) plus Gaussian
    noise of std NOISE_STD, clamped to [-1, 1]."""
    dev = generator.device
    lo, hi = regions
    if label_nc + int(dontcare) > 256:
        raise ValueError("ids must fit uint8")
    palette = torch.rand((label_nc + 1, 3), generator=generator,
                         device=dev) * 1.6 - 0.8
    zipf = 1.0 / torch.arange(1, label_nc + 1, device=dev,
                              dtype=torch.float32)
    coords = (torch.arange(size, device=dev, dtype=torch.float32)
              + 0.5) / size
    pix = torch.stack(torch.meshgrid(coords, coords, indexing="ij"),
                      -1).view(1, 1, -1, 2)
    labels, rgbs = [], []
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        count = torch.randint(lo, hi + 1, (c, 1), generator=generator,
                              device=dev)
        sites = torch.rand((c, hi, 1, 2), generator=generator, device=dev)
        dist = (pix - sites).square().sum(-1)               # (c, hi, S*S)
        live = torch.arange(hi, device=dev)[None] < count   # (c, hi)
        dist = dist.masked_fill(~live[..., None], float("inf"))
        region = dist.argmin(1)                             # (c, S*S)
        cls = torch.multinomial(zipf, c * hi, replacement=True,
                                generator=generator).view(c, hi)
        if dontcare:
            care = torch.rand((c, hi), generator=generator,
                              device=dev) >= DONTCARE_SHARE
            cls = torch.where(care, cls, torch.full_like(cls, label_nc))
        label = cls.gather(1, region).view(c, 1, size, size)
        noise = torch.randn((c, 3, size, size), generator=generator,
                            device=dev)
        rgb = palette[label[:, 0]].permute(0, 3, 1, 2) + NOISE_STD * noise
        labels.append(label.to(torch.uint8))
        rgbs.append(rgb.clamp(-1.0, 1.0))
    return torch.cat(labels), torch.cat(rgbs)
