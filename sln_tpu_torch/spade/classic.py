"""Classic SPADE modules (counterpart of sln_tpu/spade/classic.py;
reference models/SPADE_related.py SPADEGenerator / SPADE /
SPADEResnetBlock :151-346, SEResBlock2 :87-101), and GauGAN's generator
built on the same skeleton.

The shading path runs SPADEGenerator4 (spade/generator.py); these are the
canonical SPADE modules for plain segmentation-map conditioning: no depth
branch, the instance param-free norm, zero-padded convs. The variants
2/3/5 are in spade/variants.py and reuse this file's generator skeleton.

NCHW; submodule names are the JAX package's flax names, so its parameter
trees carry across by name (spade/port.py).

`gaugan_generator` is GauGAN (NVlabs/SPADE models/networks/generator.py
SPADEGenerator, `use_vae` off, norm_G 'spectralspadesyncbatch3x3'): the
label map in through a 3x3 `fc` conv, SPADE norms with a nearest resize
and the param-free batch norm with running statistics, spectral convs in
the blocks, a plain 3x3 head. It has no counterpart in the JAX package.
`python -m sln_tpu_torch.tools.train_spade --arch gaugan` trains it; the
other classes here are a module API, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.discriminator import instance_norm
from sln_tpu_torch.spade.generator import conv_math
from sln_tpu_torch.spade.layers import (PadConv, SEBlock2, resize_bilinear,
                                        resize_nearest)
from sln_tpu_torch.spade.spectral import SpectralConv

# GauGAN's param-free batch norm (SynchronizedBatchNorm2d, affine off)
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


class SPADE(nn.Module):
    """Reference SPADE :302-346: the param-free norm of x, the
    segmentation map resized to x, a zero-padded shared conv, ReLU, and
    zero-padded gamma and beta convs; x_norm (1 + gamma) + beta.

    By default the instance norm and a bilinear resize. `gaugan=True` is
    GauGAN's form (norm_G 'spectralspadesyncbatch3x3'): a nearest resize
    and the param-free batch norm, with batch statistics over (B, H, W)
    and the biased variance in training mode, running mean and (unbiased)
    variance kept at momentum 0.1 and used in eval mode."""

    def __init__(self, norm_nc: int, label_nc: int, ks: int = 3,
                 nhidden: int = 128, gaugan: bool = False):
        super().__init__()
        pw = ks // 2
        self.gaugan = gaugan
        self.mlp_shared = nn.Conv2d(label_nc, nhidden, ks, padding=pw)
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pw)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pw)
        if gaugan:
            self.register_buffer("running_mean", torch.zeros(norm_nc))
            self.register_buffer("running_var", torch.ones(norm_nc))

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        if self.gaugan:
            seg = resize_nearest(segmap, x.shape[2], x.shape[3])
            normalized = F.batch_norm(
                x, self.running_mean, self.running_var,
                training=self.training, momentum=BN_MOMENTUM, eps=BN_EPS)
        else:
            seg = resize_bilinear(segmap, x.shape[2], x.shape[3])
            normalized = instance_norm(x)
        actv = F.relu(self.mlp_shared(seg))
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    """Reference :252-300: two SPADE + leaky 0.2 + 3x3 conv stages, and a
    1x1 `conv_s` without bias behind its own SPADE where fin != fout.

    By default spectral norm is folded or left out (plain convs).
    `gaugan=True` is GauGAN's block: GauGAN's SPADE, and the three convs
    SpectralConvs that take a power-iteration step on every forward in
    training mode, as torch's spectral_norm does."""

    def __init__(self, fin: int, fout: int, label_nc: int,
                 gaugan: bool = False):
        super().__init__()
        fmiddle = min(fin, fout)
        conv = SpectralConv if gaugan else nn.Conv2d
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, label_nc, gaugan=gaugan)
            self.conv_s = conv(fin, fout, 1, bias=False)
        self.norm_0 = SPADE(fin, label_nc, gaugan=gaugan)
        self.conv_0 = conv(fin, fmiddle, 3, padding=1)
        self.norm_1 = SPADE(fmiddle, label_nc, gaugan=gaugan)
        self.conv_1 = conv(fmiddle, fout, 3, padding=1)

    def _conv(self, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if isinstance(conv, SpectralConv):
            return conv(x, self.training)
        return conv(x)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = (self._conv(self.conv_s, self.norm_s(x, seg))
               if self.learned_shortcut else x)
        dx = self._conv(self.conv_0, F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self._conv(self.conv_1, F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx


class SEResBlock2(nn.Module):
    """Reference :87-101: two reflection-padded 3x3 convs, each followed by
    the instance norm (ReLU between), squeeze-excitation (reduction 4),
    and the residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = PadConv(dim, dim, 3, 1)
        self.conv1 = PadConv(dim, dim, 3, 1)
        self.se = SEBlock2(dim, reduction=4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(instance_norm(self.conv0(x)))
        return x + self.se(instance_norm(self.conv1(h)))


NUM_UP = {"normal": 5, "more": 6, "most": 7}


class SPADEGenerator(nn.Module):
    """Reference SPADEGenerator :151-250: z -> fc -> (16nf, sw, sw), SPADE
    residual blocks with nearest 2x upsampling (one more for n_up 'more',
    two and an `up_4` block for 'most'), an SEResBlock2 `conv_img_pre`,
    leaky 0.2, a 5x5 RGB head and tanh. fc's output is viewed as NCHW
    directly, as the reference reshapes it.

    The variants of spade/variants.py build on this skeleton through the
    arguments after `n_up`: the seed width `base` (x nf), the residual
    block, whether `conv_img_pre` exists, the head's kernel, and a bilinear
    upsample before up_3. `label_input=True` makes `fc` a 3x3 conv of the
    segmentation map resized (nearest) to (sw, sw), in place of the Linear
    on z, which the generator then takes no more (GauGAN)."""

    def __init__(self, semantic_nc: int = 41, target_nc: int = 3,
                 nz: int = 256, ngf: int = 64, crop_size: int = 256,
                 n_up: str = "normal", *, base: int = 16,
                 block: Callable[[int, int], nn.Module] = None,
                 img_pre: bool = True, head_kernel: int = 5,
                 bilinear_up_3: bool = False, label_input: bool = False):
        super().__init__()
        if block is None:
            def block(fin, fout):
                return SPADEResnetBlock(fin, fout, semantic_nc)
        nf = ngf
        self.n_up, self.base, self.ngf = n_up, base, ngf
        self.bilinear_up_3 = bilinear_up_3
        self.label_input = label_input
        self.sw = crop_size // 2 ** NUM_UP[n_up]
        if label_input:
            self.fc = nn.Conv2d(semantic_nc, base * nf, 3, padding=1)
        else:
            self.fc = nn.Linear(nz, base * nf * self.sw * self.sw)
        widths = [("head_0", base, base), ("G_middle_0", base, base),
                  ("G_middle_1", base, base), ("up_0", base, 8),
                  ("up_1", 8, 4), ("up_2", 4, 2), ("up_3", 2, 1)]
        for name, fin, fout in widths:
            self.add_module(name, block(fin * nf, fout * nf))
        final_nc = nf
        if n_up == "most":
            final_nc = nf // 2
            self.up_4 = block(nf, final_nc)
        self.conv_img_pre = SEResBlock2(final_nc) if img_pre else None
        self.conv_img = nn.Conv2d(final_nc, target_nc, head_kernel,
                                  padding=head_kernel // 2)

    @conv_math()
    def forward(self, seg: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """seg (B, semantic_nc, H, W); z (B, nz), unused with label_input
        -> (B, target_nc, crop, crop) in [-1, 1]."""
        def up(t):
            return resize_nearest(t, 2 * t.shape[2], 2 * t.shape[3])

        seg_sw = resize_nearest(seg, self.sw, self.sw)
        if self.label_input:
            x = self.fc(seg_sw)
        else:
            x = self.fc(z).view(-1, self.base * self.ngf, self.sw, self.sw)
        x = self.head_0(x, seg_sw)
        x = self.G_middle_0(up(x), seg)
        if self.n_up in ("more", "most"):
            x = up(x)
        x = self.G_middle_1(x, seg)
        for name in ("up_0", "up_1", "up_2"):
            x = getattr(self, name)(up(x), seg)
        if self.bilinear_up_3:
            x = resize_bilinear(x, 2 * x.shape[2], 2 * x.shape[3])
        else:
            x = up(x)
        x = self.up_3(x, seg)
        if self.n_up == "most":
            x = self.up_4(up(x), seg)
        if self.conv_img_pre is not None:
            x = self.conv_img_pre(x)
        return torch.tanh(self.conv_img(F.leaky_relu(x, 0.2)))


def gaugan_generator(semantic_nc: int = 151, ngf: int = 64,
                     crop_size: int = 256) -> SPADEGenerator:
    """GauGAN's generator (use_vae off, norm_G spectralspadesyncbatch3x3,
    'normal' upsampling):
    fc a 3x3 conv of the label map at (sw, sw); seven SPADE residual
    blocks with spectral convs, nearest-resized labels and the param-free
    batch norm; leaky 0.2, a 3x3 RGB head and tanh. Train it in training
    mode: every forward then advances its spectral vectors and running
    statistics, as GauGAN's does."""
    def block(fin, fout):
        return SPADEResnetBlock(fin, fout, semantic_nc, gaugan=True)

    return SPADEGenerator(semantic_nc, 3, 0, ngf, crop_size, "normal",
                          block=block, img_pre=False, head_kernel=3,
                          label_input=True)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int, gain: float = 0.02
                 ) -> nn.Module:
    """GauGAN's BaseNetwork.init_weights('xavier', 0.02): every conv's and
    Linear's weight xavier-normal with `gain` (std = gain sqrt(2 /
    (fan_in + fan_out)), fans x the kernel's area), biases zero; then
    each SpectralConv's u and v from 8 power-iteration steps (torch's
    spectral_norm starts from one random u and iterates once per
    forward). Draws from a CPU generator seeded with `seed`, so the
    values do not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, SpectralConv)):
            w = m.weight
            area = w[0, 0].numel()
            std = gain * math.sqrt(2.0 / ((w.shape[0] + w.shape[1]) * area))
            w.copy_(torch.randn(w.shape, generator=gen) * std)
            if m.bias is not None:
                m.bias.zero_()
    for m in module.modules():
        if isinstance(m, SpectralConv):
            m.reset_spectral(gen)
    return module
