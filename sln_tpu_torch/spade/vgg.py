"""GauGAN's perceptual loss (NVlabs/SPADE models/networks/architecture.py
VGG19, loss.py VGGLoss): VGG19's `features` up to relu5_1, cut into five
slices that end at relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1; the
loss is sum_i w_i L1(f_i(fake), f_i(real)), w = (1/32, 1/16, 1/8, 1/4, 1),
the real image's features held constant. Images go in as they are, in
[-1, 1], with no ImageNet normalisation, as GauGAN feeds them.

The parameters are frozen, so a backward through the loss computes the
input's gradient alone. Layer indices are torchvision's (`features.<i>`),
so a torchvision VGG19 state_dict loads as it is (`load_vgg19`).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.generator import conv_math

# torchvision's cfg "E" up to conv5_1: widths of the 3x3 convs, "M" a 2x2
# max pool; each conv is followed by a ReLU
CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
       512, "M", 512)
SLICE_ENDS = (2, 7, 12, 21, 30)
WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class VGG19Features(nn.Module):
    """features[0:30] of torchvision's VGG19 -> the five slices' outputs."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for c in CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    @conv_math()
    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, start = [], 0
        for end in SLICE_ENDS:
            for i in range(start, end):
                x = self.features[i](x)
            outs.append(x)
            start = end
        return outs


def vgg_loss(vgg: VGG19Features, fake: torch.Tensor, real: torch.Tensor
             ) -> torch.Tensor:
    """sum_i WEIGHTS[i] mean |vgg_i(fake) - vgg_i(real)|, no gradient
    through the real image's features."""
    with torch.no_grad():
        real_feats = vgg(real)
    total = 0.0
    for w, f, r in zip(WEIGHTS, vgg(fake), real_feats):
        total = total + w * F.l1_loss(f, r)
    return total


@torch.no_grad()
def init_vgg19(vgg: VGG19Features, seed: int) -> VGG19Features:
    """Seeded weights in torchvision's init (kaiming normal, fan_out,
    ReLU gain: std sqrt(2 / (out x 9)); biases zero), from a CPU
    generator: a stand-in where no trained weights are at hand."""
    gen = torch.Generator().manual_seed(seed)
    for m in vgg.features:
        if isinstance(m, nn.Conv2d):
            std = math.sqrt(2.0 / (m.weight.shape[0] * 9))
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            m.bias.zero_()
    return vgg


def load_vgg19(vgg: VGG19Features, path: str) -> VGG19Features:
    """The `features.<i>` entries (i < 30) of a torchvision-layout VGG19
    state_dict file; every conv of the module must be there."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    keep = {k: v for k, v in sd.items() if k.startswith("features.")
            and int(k.split(".")[1]) < SLICE_ENDS[-1]}
    vgg.load_state_dict(keep)
    return vgg
