"""The PSP-SE image encoders and the MMD discriminator wrappers
(counterpart of sln_tpu/spade/encoders.py; reference
models/SPADE_related.py PSPModule :847-864, SEResBlock3 :103-126,
ConvEncoder_PSP_SE :866-907, ConvEncoder_PSP_SE_MMD(_2) :909-979,
NLayerDiscriminator_MMD :1237-1296, MultiscaleDiscriminator_MMD_2
:1300-1337).

NCHW; submodule names are the JAX package's flax names. The MMD mode of
`python -m sln_tpu_torch.tools.train_spade --mmd` runs ConvEncoderPSPSEMMD;
the other classes here are a module API, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.discriminator import (MultiscaleDiscriminator,
                                               NLayerDiscriminator)
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


def _resize_256(x: torch.Tensor) -> torch.Tensor:
    """Every encoder reads its images at 256 px."""
    if x.shape[2] != 256 or x.shape[3] != 256:
        x = resize_bilinear(x, 256, 256)
    return x


class _PSPSETrunk(nn.Module):
    """The trunk ConvEncoderPSPSE and ConvEncoderPSPSEMMD share: SE blocks
    at strides 1, 2, 2, pyramid pooling, SE blocks at strides 2, 2, then a
    spatial mean and leaky 0.2 -> (B, 16 nef)."""

    def __init__(self, nef: int, input_nc: int):
        super().__init__()
        self.layer1 = SEResBlock3(input_nc, nef, 1)
        self.layer2 = SEResBlock3(nef, nef * 2, 2)
        self.layer3 = SEResBlock3(nef * 2, nef * 4, 2)
        self.psp = PSPModule(nef * 4, nef * 8)
        self.layer4 = SEResBlock3(nef * 8, nef * 8, 2)
        self.layer5 = SEResBlock3(nef * 8, nef * 16, 2)

    def trunk(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = _resize_256(x)
        x = self.layer1(x, train)
        x = self.layer2(x, train)
        x = self.layer3(x, train)
        x = self.psp(x)
        x = self.layer4(x, train)
        x = self.layer5(x, train)
        return F.leaky_relu(x.mean((2, 3)), 0.2)


class ConvEncoderPSPSE(_PSPSETrunk):
    """Reference ConvEncoder_PSP_SE :866-907: the PSP-SE trunk and either
    the (mu, logvar) heads (vae) or one z head."""

    def __init__(self, nef: int = 64, output_nc: int = 256, vae: bool = True,
                 input_nc: int = 3):
        super().__init__(nef, input_nc)
        self.vae = vae
        if vae:
            self.fc_mu = nn.Linear(nef * 16, output_nc)
            self.fc_var = nn.Linear(nef * 16, output_nc)
        else:
            self.fc_z = nn.Linear(nef * 16, output_nc)

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False):
        x = self.trunk(x, train)
        if self.vae:
            return self.fc_mu(x), self.fc_var(x)
        return self.fc_z(x)


class ConvEncoderPSPSEMMD(_PSPSETrunk):
    """Deterministic z encoder of the MMD mode (reference
    ConvEncoder_PSP_SE_MMD :909-951): images resized to 256 px, the PSP-SE
    trunk, a spatial mean, a 512-wide ReLU layer and the z head."""

    def __init__(self, nef: int = 64, output_nc: int = 256,
                 input_nc: int = 3):
        super().__init__(nef, input_nc)
        self.fc_z_pre = nn.Linear(nef * 16, 512)
        self.fc_z = nn.Linear(512, output_nc)

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.fc_z(F.relu(self.fc_z_pre(self.trunk(x, train))))


class ConvEncoderPSPSEMMD2(nn.Module):
    """Second MMD encoder (reference ConvEncoder_PSP_SE_MMD_2 :953-979):
    six stride-2 SE blocks, no pyramid pooling, leaky 0.2, and the (4, 4)
    map flattened, not pooled, into a 512-wide leaky layer and the z head.
    The JAX package flattens its NHWC map, so the map is flattened in
    (H, W, C) order here too, for the carried fc_z_pre weights."""

    def __init__(self, nef: int = 64, output_nc: int = 256,
                 input_nc: int = 3):
        super().__init__()
        widths = [input_nc, nef, nef * 2, nef * 4, nef * 8, nef * 16,
                  nef * 16]
        for i in range(6):
            self.add_module(f"layer{i + 1}",
                            SEResBlock3(widths[i], widths[i + 1], 2))
        self.fc_z_pre = nn.Linear(4 * 4 * nef * 16, 512)
        self.fc_z = nn.Linear(512, output_nc)

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _resize_256(x)
        for i in range(6):
            x = getattr(self, f"layer{i + 1}")(x, train)
        x = F.leaky_relu(x, 0.2).permute(0, 2, 3, 1).flatten(1)
        return self.fc_z(F.leaky_relu(self.fc_z_pre(x), 0.2))


class NLayerDiscriminatorMMD(nn.Module):
    """pix2pixHD body with the decide and z_out heads (reference
    :1237-1296): the shared NLayerDiscriminator(mmd_nz=nz), held as
    submodule `trunk` as the JAX package's flax tree holds it. Returns
    [feat_1, ..., feat_n, (logits, z)]."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 nz: int = 256):
        super().__init__()
        self.trunk = NLayerDiscriminator(input_nc, ndf, n_layers, mmd_nz=nz)

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False) -> list:
        return self.trunk(x, train)


class MultiscaleDiscriminatorMMD(nn.Module):
    """Reference MultiscaleDiscriminator_MMD_2 :1300-1337: the shared
    MultiscaleDiscriminator(mmd_nz=nz) as submodule `trunk`."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 num_d: int = 2, nz: int = 256):
        super().__init__()
        self.trunk = MultiscaleDiscriminator(input_nc, ndf, n_layers, num_d,
                                             mmd_nz=nz)

    def forward(self, x: torch.Tensor, train: bool = False) -> List[list]:
        return self.trunk(x, train)
