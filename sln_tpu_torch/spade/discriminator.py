"""SPADE discriminators and the image encoder, the training side
(counterpart of sln_tpu/spade/discriminator.py; reference
models/SPADE_related.py MultiscaleDiscriminator :397-447,
NLayerDiscriminator :450-506, the MMD heads of NLayerDiscriminator_MMD
:1237-1296, ConvEncoder :595-642).

NCHW. Submodule names are the JAX package's flax names (`discriminator_0`,
`conv0`, `head`, `decide`, `z_out0`, `z_out1`), so its parameter trees
carry across by name (spade/port.py). The quirks of the JAX package are
kept: 4x4 convs with padding 2, instance norm with the biased variance
(not on layer 0), a stride-1 last layer, and a 1x1 head with padding 1, so
the logit map is 2 px larger than the last feature map. `gaugan=True`
gives GauGAN's form instead (NVlabs/SPADE models/networks/discriminator.py,
norm_D 'spectralinstance'): a plain conv0, spectral conv1.. without bias,
a plain 4x4 stride-1 head with padding 2, and the same depth at every
scale. ConvEncoder (the
image -> (mu, logvar) posterior) is a module API, as in the JAX package:
no trainer runs it.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.generator import conv_math
from sln_tpu_torch.spade.layers import resize_bilinear
from sln_tpu_torch.spade.spectral import SpectralConv


def avg_pool_down(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(kernel 3, stride 2, padding 1, count_include_pad=False)
    (reference :430-433)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


def instance_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel norm over (H, W), the biased variance, no
    affine ('spectralinstance')."""
    mean = h.mean((2, 3), keepdim=True)
    var = h.var((2, 3), keepdim=True, correction=0)
    return (h - mean) * torch.rsqrt(var + eps)


class NLayerDiscriminator(nn.Module):
    """pix2pixHD discriminator with spectral-instance norm. forward returns
    the intermediate features and, last, the logit map; with mmd_nz > 0,
    last the (logits, z) pair of the MMD variant's decide and z_out heads
    (z the spatial mean of a (B, mmd_nz) map). `gaugan=True`: GauGAN's
    layers (plain conv0 and 4x4 head, spectral convs without bias)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 mmd_nz: int = 0, gaugan: bool = False):
        super().__init__()
        if gaugan and mmd_nz:
            raise ValueError("GauGAN's discriminator has no MMD heads")
        self.n_layers, self.mmd_nz, self.gaugan = n_layers, mmd_nz, gaugan
        nf = ndf
        self.conv0 = (nn.Conv2d(input_nc, nf, 4, 2, padding=2) if gaugan
                      else SpectralConv(input_nc, nf, 4, stride=2, padding=2))
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            self.add_module(f"conv{n}", SpectralConv(
                prev, nf, 4, stride, padding=2, bias=not gaugan))
        if mmd_nz > 0:
            self.decide = nn.Conv2d(nf, 1, 1)
            self.z_out0 = nn.Conv2d(nf, nf, 1)
            self.z_out1 = nn.Conv2d(nf, mmd_nz, 1)
        elif gaugan:
            self.head = nn.Conv2d(nf, 1, 4, padding=2)
        else:
            self.head = nn.Conv2d(nf, 1, 1, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> list:
        h = F.leaky_relu(self.conv0(x) if self.gaugan
                         else self.conv0(x, train), 0.2)
        results = [h]
        for n in range(1, self.n_layers):
            h = getattr(self, f"conv{n}")(h, train)
            h = F.leaky_relu(instance_norm(h), 0.2)
            results.append(h)
        if self.mmd_nz > 0:
            z = F.leaky_relu(self.z_out0(h), 0.01)
            z = self.z_out1(z).mean((2, 3))
            results.append((self.decide(h), z))
        else:
            results.append(self.head(h))
        return results


def instance_normed_biases(module: nn.Module) -> set:
    """Names of module's parameters that are biases of a conv followed by
    the instance norm, which subtracts them again: their gradient is zero
    up to rounding, so Adam (b1 = 0) moves them by +-lr at random. No
    output depends on them."""
    out = set()
    for name, m in module.named_modules():
        if isinstance(m, NLayerDiscriminator):
            prefix = f"{name}." if name else ""
            out |= {f"{prefix}conv{n}.bias" for n in range(1, m.n_layers)}
    return out


class MultiscaleDiscriminator(nn.Module):
    """num_d discriminators on a downsampled pyramid, each one layer
    shallower than the one before (reference :397-447); mmd_nz > 0 gives
    each the MMD heads (reference MultiscaleDiscriminator_MMD_2).
    `gaugan=True`: GauGAN's layers, n_layers at every scale."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 num_d: int = 2, mmd_nz: int = 0, gaugan: bool = False):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"discriminator_{i}", NLayerDiscriminator(
                input_nc, ndf, n_layers if gaugan else max(n_layers - i, 1),
                mmd_nz, gaugan))

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False
                ) -> List[list]:
        outs = []
        for i in range(self.num_d):
            outs.append(getattr(self, f"discriminator_{i}")(x, train))
            if i + 1 < self.num_d:
                x = avg_pool_down(x)
        return outs


class ConvEncoder(nn.Module):
    """Image -> (mu, logvar) of z (reference :595-642): the image resized
    to 256 px, five stride-2 3x3 spectral convs each with the instance
    norm and leaky 0.2 (the fifth's leaky and a sixth conv only where
    crop_size >= 256), a spatial mean, leaky 0.2, and the two heads."""

    def __init__(self, nef: int = 64, output_nc: int = 256,
                 crop_size: int = 256, input_nc: int = 3):
        super().__init__()
        self.deep = crop_size >= 256
        widths = [input_nc, nef, nef * 2, nef * 4, nef * 8, nef * 8]
        for i in range(5):
            self.add_module(f"layer{i + 1}", SpectralConv(
                widths[i], widths[i + 1], 3, stride=2, padding=1))
        if self.deep:
            self.layer6 = SpectralConv(nef * 8, nef * 8, 3, stride=2,
                                       padding=1)
        self.fc_mu = nn.Linear(nef * 8, output_nc)
        self.fc_var = nn.Linear(nef * 8, output_nc)

    @conv_math()
    def forward(self, x: torch.Tensor, train: bool = False):
        if x.shape[2] != 256 or x.shape[3] != 256:
            x = resize_bilinear(x, 256, 256)
        for i in range(5):
            x = instance_norm(getattr(self, f"layer{i + 1}")(x, train))
            if i < 4 or self.deep:
                x = F.leaky_relu(x, 0.2)
        if self.deep:
            x = self.layer6(x, train)
        x = F.leaky_relu(x.mean((2, 3)), 0.2)
        return self.fc_mu(x), self.fc_var(x)
