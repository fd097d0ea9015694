"""SPADE building blocks in NCHW (counterpart of sln_tpu/spade/layers.py,
which is NHWC flax).

The blocks of the reference models/SPADE_related.py that the shading
generator (SPADEGenerator4) uses:

* LayerNorm2D (reference :128-149): per-sample whole-tensor norm with
  the *unbiased* std and (std + eps) in the denominator;
* SPADE4 modulation (reference :1404-1454): the depth channel gets its own
  conv branch, concatenated with the 40 label channels;
* SEBlock2 (reference :70-85);
* SPADEResnetBlock4 (reference :1457-1505).

Submodules carry the reference state_dict's names (`norm_0.mlp_shared.1`,
`conv_0.1`, `se.fc.0`), so a reference checkpoint loads strictly once its
spectral norm is folded (spade/port.py). At inference spectral norm is a
constant rescale of the kernel, so the convs here are plain.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Mods = Tuple[torch.Tensor, torch.Tensor]


class PadConv(nn.Sequential):
    """ReflectionPad2d(pad) + Conv2d(kernel, padding=0); the conv is
    submodule `1`, as in the reference's Sequentials."""

    def __init__(self, fin: int, fout: int, kernel: int, pad: int,
                 bias: bool = True):
        super().__init__(nn.ReflectionPad2d(pad),
                         nn.Conv2d(fin, fout, kernel, bias=bias))


def layer_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Reference LayerNorm2D without affine (:139-144): per-sample mean and
    unbiased std over all of (C, H, W), divide by (std + eps)."""
    B = x.shape[0]
    flat = x.reshape(B, -1).float()
    mean = flat.mean(1)
    var = flat.var(1, correction=1)
    # clamp inside the sqrt: a constant input (var == 0) would make the
    # backward pass inf / NaN
    std = torch.sqrt(var.clamp(min=1e-12))
    shape = (B, 1, 1, 1)
    return ((x - mean.reshape(shape))
            / (std.reshape(shape) + eps)).to(x.dtype)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) bilinear resize, half-pixel centres, no antialiasing
    (the reference's F.interpolate default)."""
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) nearest resize with torch's asymmetric index rule
    src = floor(dst * in / out)."""
    return F.interpolate(x, size=(h, w), mode="nearest")


class SPADE4(nn.Module):
    """Depth-aware SPADE modulation (reference :1404-1454), 'layer' norm.

    Factored into `mods` (everything computed from the segmentation map
    alone: resize, depth branch, shared conv, gamma and beta convs) and
    `apply_mods` (the z stream's side). When one room is shaded with many
    z, `mods` runs once per room; `forward` composes the two."""

    def __init__(self, norm_nc: int, label_nc: int = 41, ks: int = 3,
                 nhidden: int = 128):
        super().__init__()
        pw = ks // 2
        self.mlp_preshared_depth = PadConv(1, nhidden // 8, ks, pw)
        self.mlp_shared = PadConv(nhidden // 8 + label_nc - 1, nhidden, 3,
                                  pw)
        self.mlp_gamma = PadConv(nhidden, norm_nc, ks, pw)
        self.mlp_beta = PadConv(nhidden, norm_nc, ks, pw)

    def mods(self, segmap: torch.Tensor, h: int, w: int) -> Mods:
        """segmap (B, label_nc, Hs, Ws), depth in channel 0 -> (gamma,
        beta), each (B, norm_nc, h, w)."""
        seg = resize_bilinear(segmap, h, w)
        depth = F.leaky_relu(self.mlp_preshared_depth(seg[:, 0:1]), 0.01)
        actv = F.relu(self.mlp_shared(torch.cat([depth, seg[:, 1:]], 1)))
        return self.mlp_gamma(actv), self.mlp_beta(actv)

    @staticmethod
    def apply_mods(x: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
        """Modulate the z stream; gamma and beta broadcast over x's
        batch."""
        return layer_norm_2d(x) * (1.0 + gamma) + beta

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        return self.apply_mods(x, *self.mods(segmap, x.shape[2],
                                             x.shape[3]))


class SEBlock2(nn.Module):
    """Squeeze-excitation (reference :70-85)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(nn.Linear(channels, hidden, bias=False),
                                nn.ReLU(),
                                nn.Linear(hidden, channels, bias=False),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean((2, 3)))[:, :, None, None]


class SPADEResnetBlock4(nn.Module):
    """Reference :1457-1505, spectral norm folded into the kernels.

    `mods` / `from_mods` split the block into its segmentation-only part
    (the (gamma, beta) of each of its SPADE norms) and the z stream's
    pass; `forward` composes them."""

    def __init__(self, fin: int, fout: int, label_nc: int = 41):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = SPADE4(fin, label_nc)
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
        self.norm_0 = SPADE4(fin, label_nc)
        self.conv_0 = PadConv(fin, fmiddle, 3, 1)
        self.norm_1 = SPADE4(fmiddle, label_nc)
        self.conv_1 = PadConv(fmiddle, fout, 3, 1)
        self.se = SEBlock2(fout)

    def mods(self, seg: torch.Tensor, h: int, w: int) -> Dict[str, Mods]:
        """Every (gamma, beta) the block needs at its input resolution
        (h, w): PadConv keeps H and W, so all its norms modulate there."""
        out = {"norm_0": self.norm_0.mods(seg, h, w),
               "norm_1": self.norm_1.mods(seg, h, w)}
        if self.learned_shortcut:
            out["norm_s"] = self.norm_s.mods(seg, h, w)
        return out

    def from_mods(self, x: torch.Tensor, mods: Dict[str, Mods]
                  ) -> torch.Tensor:
        if self.learned_shortcut:
            x_s = self.conv_s(SPADE4.apply_mods(x, *mods["norm_s"]))
        else:
            x_s = x
        dx = SPADE4.apply_mods(x, *mods["norm_0"])
        dx = self.conv_0(F.leaky_relu(dx, 0.2))
        dx = SPADE4.apply_mods(dx, *mods["norm_1"])
        dx = self.conv_1(F.leaky_relu(dx, 0.2))
        return x_s + self.se(dx)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        return self.from_mods(x, self.mods(seg, x.shape[2], x.shape[3]))
