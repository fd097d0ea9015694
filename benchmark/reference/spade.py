"""Plain PyTorch SPADEGenerator4 (3D-SLN models/SPADE_related.py, after
NVlabs/SPADE), the shading generator the benchmark holds the measured
package's against, at inference (spectral norm folded into the kernels).

`precision` picks the arithmetic of every convolution and linear layer:
"fp32" (TF32 off where the caller keeps it off) or "fp8", inputs and
weights rounded to float8 e4m3 with one scale per tensor, then multiplied
in float32. Imports nothing of the measured package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2",
          "up_3")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest |x| at 448)."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class Conv(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        w = self.weight
        if self.precision == "fp8":
            x, w = fp8(x), fp8(w)
        return F.conv2d(x, w, self.bias, padding=self.padding)


class Lin(nn.Linear):
    precision = "fp32"

    def forward(self, x):
        w = self.weight
        if self.precision == "fp8":
            x, w = fp8(x), fp8(w)
        return F.linear(x, w, self.bias)


class PadConv(nn.Sequential):
    """Reflection pad (submodule 0, no parameters) and conv (submodule 1)."""

    def __init__(self, fin, fout, k, pad, bias=True):
        super().__init__(nn.Identity(), Conv(fin, fout, k, bias=bias))
        self.pad = pad

    def forward(self, x):
        # a 1 x 1 map reflects to copies of itself
        mode = "replicate" if min(x.shape[2:]) == 1 else "reflect"
        return self[1](F.pad(x, (self.pad,) * 4, mode=mode))


def layer_norm(x, eps=1e-5):
    B = x.shape[0]
    flat = x.reshape(B, -1)
    mean = flat.mean(1).reshape(B, 1, 1, 1)
    std = flat.std(1).reshape(B, 1, 1, 1)
    return (x - mean) / (std + eps)


class Spade(nn.Module):
    def __init__(self, norm_nc, label_nc=41, hidden=128):
        super().__init__()
        self.mlp_preshared_depth = PadConv(1, hidden // 8, 3, 1)
        self.mlp_shared = PadConv(hidden // 8 + label_nc - 1, hidden, 3, 1)
        self.mlp_gamma = PadConv(hidden, norm_nc, 3, 1)
        self.mlp_beta = PadConv(hidden, norm_nc, 3, 1)

    def forward(self, x, seg):
        seg = F.interpolate(seg, size=x.shape[2:], mode="bilinear",
                            align_corners=False)
        depth = F.leaky_relu(self.mlp_preshared_depth(seg[:, :1]), 0.01)
        actv = F.relu(self.mlp_shared(torch.cat([depth, seg[:, 1:]], 1)))
        return layer_norm(x) * (1 + self.mlp_gamma(actv)) \
            + self.mlp_beta(actv)


class SE(nn.Module):
    def __init__(self, c, r=8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // r, bias=False), nn.ReLU(),
                                nn.Linear(c // r, c, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean((2, 3)))[:, :, None, None]


class Block(nn.Module):
    def __init__(self, fin, fout, label_nc=41):
        super().__init__()
        mid = min(fin, fout)
        self.learned = fin != fout
        if self.learned:
            self.norm_s = Spade(fin, label_nc)
            self.conv_s = Conv(fin, fout, 1, bias=False)
        self.norm_0 = Spade(fin, label_nc)
        self.conv_0 = PadConv(fin, mid, 3, 1)
        self.norm_1 = Spade(mid, label_nc)
        self.conv_1 = PadConv(mid, fout, 3, 1)
        self.se = SE(fout)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return xs + self.se(dx)


class Generator(nn.Module):
    """z (B, nz) and a segmentation (B, 41, H, W), depth in channel 0 ->
    (B, 3, crop, crop) in [-1, 1]."""

    def __init__(self, semantic_nc=41, target_nc=3, nz=256, ngf=64,
                 crop_size=256):
        super().__init__()
        self.ngf, self.sw = ngf, crop_size // 32
        nf = ngf
        self.fc = Lin(nz, 16 * nf * self.sw * self.sw)
        widths = (16 * nf, 16 * nf, 16 * nf, 16 * nf, 8 * nf, 4 * nf,
                  2 * nf, nf)
        for name, fin, fout in zip(BLOCKS, widths[:-1], widths[1:]):
            self.add_module(name, Block(fin, fout, semantic_nc))
        self.conv_img = Conv(nf, target_nc, 5, padding=2)

    def set_precision(self, precision: str) -> "Generator":
        for m in self.modules():
            if isinstance(m, (Conv, Lin)):
                m.precision = precision
        return self

    def forward(self, seg, z):
        x = self.fc(z).view(-1, 16 * self.ngf, self.sw, self.sw)
        seg = seg.expand(x.shape[0], -1, -1, -1)
        x = self.head_0(x, F.interpolate(seg, size=(self.sw, self.sw),
                                         mode="nearest"))
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = self.G_middle_0(x, seg)
        x = self.G_middle_1(x, seg)
        for name in ("up_0", "up_1", "up_2"):
            x = getattr(self, name)(F.interpolate(x, scale_factor=2,
                                                  mode="nearest"), seg)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = self.up_3(x, seg)
        return torch.tanh(self.conv_img(F.leaky_relu(x, 0.2)))
