"""Classic SPADE modules (counterpart of sln_tpu/spade/classic.py;
reference models/SPADE_related.py SPADEGenerator / SPADE /
SPADEResnetBlock :151-346, SEResBlock2 :87-101).

The shading path runs SPADEGenerator4 (spade/generator.py); these are the
canonical SPADE modules for plain segmentation-map conditioning: no depth
branch, the instance param-free norm, zero-padded convs. The variants
2/3/5 are in spade/variants.py and reuse this file's generator skeleton.

NCHW; submodule names are the JAX package's flax names, so its parameter
trees carry across by name (spade/port.py). No CLI reaches these classes,
in the JAX package or here: they are a module API.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.discriminator import instance_norm
from sln_tpu_torch.spade.generator import conv_math
from sln_tpu_torch.spade.layers import (PadConv, SEBlock2, resize_bilinear,
                                        resize_nearest)


class SPADE(nn.Module):
    """Reference SPADE :302-346 with the instance param-free norm: the
    segmentation map resized (bilinear) to x, a zero-padded shared conv,
    ReLU, and zero-padded gamma and beta convs."""

    def __init__(self, norm_nc: int, label_nc: int, ks: int = 3,
                 nhidden: int = 128):
        super().__init__()
        pw = ks // 2
        self.mlp_shared = nn.Conv2d(label_nc, nhidden, ks, padding=pw)
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pw)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pw)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        seg = resize_bilinear(segmap, x.shape[2], x.shape[3])
        actv = F.relu(self.mlp_shared(seg))
        return (instance_norm(x) * (1.0 + self.mlp_gamma(actv))
                + self.mlp_beta(actv))


class SPADEResnetBlock(nn.Module):
    """Reference :252-300, spectral norm folded or left out: two SPADE +
    leaky 0.2 + 3x3 conv stages, and a 1x1 `conv_s` without bias behind
    its own SPADE where fin != fout."""

    def __init__(self, fin: int, fout: int, label_nc: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, label_nc)
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
        self.norm_0 = SPADE(fin, label_nc)
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1)
        self.norm_1 = SPADE(fmiddle, label_nc)
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = (self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut
               else x)
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
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
    upsample before up_3."""

    def __init__(self, semantic_nc: int = 41, target_nc: int = 3,
                 nz: int = 256, ngf: int = 64, crop_size: int = 256,
                 n_up: str = "normal", *, base: int = 16,
                 block: Callable[[int, int], nn.Module] = None,
                 img_pre: bool = True, head_kernel: int = 5,
                 bilinear_up_3: bool = False):
        super().__init__()
        if block is None:
            def block(fin, fout):
                return SPADEResnetBlock(fin, fout, semantic_nc)
        nf = ngf
        self.n_up, self.base, self.ngf = n_up, base, ngf
        self.bilinear_up_3 = bilinear_up_3
        self.sw = crop_size // 2 ** NUM_UP[n_up]
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
    def forward(self, seg: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """seg (B, semantic_nc, H, W); z (B, nz) -> (B, target_nc, crop,
        crop) in [-1, 1]."""
        def up(t):
            return resize_nearest(t, 2 * t.shape[2], 2 * t.shape[3])

        x = self.fc(z).view(-1, self.base * self.ngf, self.sw, self.sw)
        x = self.head_0(x, resize_nearest(seg, self.sw, self.sw))
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
