"""The MMD mode's image encoder (counterpart of sln_tpu/spade/encoders.py;
reference models/SPADE_related.py PSPModule :847-864, SEResBlock3
:103-126, ConvEncoder_PSP_SE_MMD :909-951).

NCHW; submodule names are the JAX package's flax names. Ported are the
classes `python -m sln_tpu_torch.tools.train_spade --mmd` runs; the
other encoder and discriminator variants of that file are not ported yet
(ROADMAP §1 item 6).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.generator import conv_math
from sln_tpu_torch.spade.layers import SEBlock2, resize_bilinear
from sln_tpu_torch.spade.spectral import SpectralConv


def adaptive_avg_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size) block means; exact for H and W
    multiples of size (every use here), where AdaptiveAvgPool2d's windows
    are equal blocks."""
    B, C, H, W = x.shape
    return x.reshape(B, C, size, H // size, size, W // size).mean((3, 5))


class PSPModule(nn.Module):
    """Pyramid pooling (reference :847-864): pooled priors at each size,
    1x1 conv, bilinear back up, concatenated with the input, a 1x1
    bottleneck and leaky 0.2."""

    def __init__(self, fin: int, out_features: int,
                 sizes: Sequence[int] = (1, 2, 4, 8)):
        super().__init__()
        self.sizes = tuple(sizes)
        for i in range(len(self.sizes)):
            self.add_module(f"stage{i}", nn.Conv2d(fin, fin, 1, bias=False))
        self.bottleneck = nn.Conv2d(fin * (len(self.sizes) + 1),
                                    out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        priors = [resize_bilinear(
            getattr(self, f"stage{i}")(adaptive_avg_pool(x, s)), H, W)
            for i, s in enumerate(self.sizes)]
        out = self.bottleneck(torch.cat(priors + [x], 1))
        return F.leaky_relu(out, 0.2)


class SEResBlock3(nn.Module):
    """Spectral-conv residual block with squeeze-excitation (reference
    :103-126); a 3x3 `skip` conv where the width or the stride changes."""

    def __init__(self, fin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv0 = SpectralConv(fin, features, 3, stride, padding=1)
        self.conv1 = SpectralConv(features, features, 3, 1, padding=1)
        self.se = SEBlock2(features, reduction=4)
        self.skip = (nn.Conv2d(fin, features, 3, stride, padding=1,
                               bias=False)
                     if fin != features or stride != 1 else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x, train), 0.2)
        h = self.se(self.conv1(h, train))
        if self.skip is not None:
            x = self.skip(x)
        return F.leaky_relu(x + h, 0.2)


class ConvEncoderPSPSEMMD(nn.Module):
    """Deterministic z encoder of the MMD mode (reference
    ConvEncoder_PSP_SE_MMD :909-951): images resized to 256 px, the PSP-SE
    trunk, a spatial mean, a 512-wide ReLU layer and the z head."""

    def __init__(self, nef: int = 64, output_nc: int = 256,
                 input_nc: int = 3):
        super().__init__()
        self.layer1 = SEResBlock3(input_nc, nef, 1)
        self.layer2 = SEResBlock3(nef, nef * 2, 2)
        self.layer3 = SEResBlock3(nef * 2, nef * 4, 2)
        self.psp = PSPModule(nef * 4, nef * 8)
        self.layer4 = SEResBlock3(nef * 8, nef * 8, 2)
        self.layer5 = SEResBlock3(nef * 8, nef * 16, 2)
        self.fc_z_pre = nn.Linear(nef * 16, 512)
        self.fc_z = nn.Linear(512, output_nc)

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.shape[2] != 256 or x.shape[3] != 256:
            x = resize_bilinear(x, 256, 256)
        x = self.layer1(x, train)
        x = self.layer2(x, train)
        x = self.layer3(x, train)
        x = self.psp(x)
        x = self.layer4(x, train)
        x = self.layer5(x, train)
        x = F.leaky_relu(x.mean((2, 3)), 0.2)
        return self.fc_z(F.relu(self.fc_z_pre(x)))
