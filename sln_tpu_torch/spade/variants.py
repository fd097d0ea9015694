"""Experimental SPADE variants 2/3/5 (counterpart of
sln_tpu/spade/variants.py; reference models/SPADE_related.py :644-760,
:981-1182, :1607-1803). Only SPADEGenerator4 serves (spade/generator.py);
these are the reference's other generators, a module API as in the JAX
package. What each variant changes against the classic SPADE:

* SPADE2 (:796-845): the depth channel gets its own ks-kernel conv branch
  (-> nhidden/8) and the labels a 1x1 branch (-> nhidden/2), concatenated
  into a 1x1 shared conv; zero padding throughout.
* SPADE3 (:981-1032): the same two branches with reflection padding,
  leaky 0.01 on both, and a reflection-padded 3x3 shared conv (padded by
  ks // 2 whatever ks is).
* SPADE5 (:1607-1656): depth -> a 40-wide ks conv -> tanh, a gate
  multiplied into the 40 labels; concat(gated, labels) -> a 3x3 shared
  conv, leaky 0.01; the 'layer' param-free norm by default.
* SPADEResnetBlockV: the residual blocks 2/3/5; 2 has zero-padded convs,
  3 and 5 reflection-padded ones, 3 a squeeze-excitation (reduction 8)
  on the residual branch.
* SPADEGeneratorV: 2 seeds 12nf and runs an SEResBlock2 before its 5x5
  RGB head; 3 seeds 16nf with a 5x5 head; 5 seeds 16nf, upsamples
  bilinearly before up_3, has a 3x3 head, and takes n_up 'normal' only
  (the reference's 'more'/'most' branches of generator 5 fail).

NCHW; submodule names are the JAX package's flax names (spade/port.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.classic import SPADEGenerator, instance_norm
from sln_tpu_torch.spade.layers import (PadConv, SEBlock2, layer_norm_2d,
                                        resize_bilinear)


def batch_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Param-free batch norm: training statistics over (B, H, W), the
    biased variance, no running statistics."""
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


_NORMS = {"instance": instance_norm, "batch": batch_norm_2d,
          "layer": layer_norm_2d}


def param_free_norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind not in _NORMS:
        raise ValueError(f"unknown param-free norm {kind!r}")
    return _NORMS[kind](x)


class _SPADEV(nn.Module):
    """What SPADE2/3/5 share: the param-free norm of x, the segmentation
    map resized to x (bilinear), and gamma and beta convs over each
    variant's `activation` of it."""

    def __init__(self, param_free: str):
        super().__init__()
        self.param_free = param_free

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        normalized = param_free_norm(x, self.param_free)
        seg = resize_bilinear(segmap, x.shape[2], x.shape[3])
        actv = self.activation(seg)
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADE2(_SPADEV):
    """Reference SPADE2 :796-845."""

    def __init__(self, norm_nc: int, label_nc: int = 41, ks: int = 3,
                 nhidden: int = 128, param_free: str = "instance"):
        super().__init__(param_free)
        pw = ks // 2
        self.mlp_preshared_depth = nn.Conv2d(1, nhidden // 8, ks, padding=pw)
        self.mlp_preshared_label = nn.Conv2d(label_nc - 1, nhidden // 2, 1)
        self.mlp_shared = nn.Conv2d(nhidden // 8 + nhidden // 2, nhidden, 1)
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pw)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pw)

    def activation(self, seg: torch.Tensor) -> torch.Tensor:
        return F.relu(self.mlp_shared(torch.cat(
            [self.mlp_preshared_depth(seg[:, 0:1]),
             self.mlp_preshared_label(seg[:, 1:])], 1)))


class SPADE3(_SPADEV):
    """Reference SPADE3 :981-1032: reflection padding, leaky branches."""

    def __init__(self, norm_nc: int, label_nc: int = 41, ks: int = 3,
                 nhidden: int = 128, param_free: str = "instance"):
        super().__init__(param_free)
        pw = ks // 2
        self.mlp_preshared_depth = PadConv(1, nhidden // 8, ks, pw)
        self.mlp_preshared_label = nn.Conv2d(label_nc - 1, nhidden // 2, 1)
        self.mlp_shared = PadConv(nhidden // 8 + nhidden // 2, nhidden, 3, pw)
        self.mlp_gamma = PadConv(nhidden, norm_nc, ks, pw)
        self.mlp_beta = PadConv(nhidden, norm_nc, ks, pw)

    def activation(self, seg: torch.Tensor) -> torch.Tensor:
        depth = F.leaky_relu(self.mlp_preshared_depth(seg[:, 0:1]), 0.01)
        label = F.leaky_relu(self.mlp_preshared_label(seg[:, 1:]), 0.01)
        return F.relu(self.mlp_shared(torch.cat([depth, label], 1)))


class SPADE5(_SPADEV):
    """Reference SPADE5 :1607-1656: a tanh depth gate multiplied into the
    labels before the shared conv."""

    def __init__(self, norm_nc: int, label_nc: int = 41, ks: int = 3,
                 nhidden: int = 128, param_free: str = "layer"):
        super().__init__(param_free)
        pw = ks // 2
        # 40 wide whatever label_nc is, as in the reference (:1631)
        self.mlp_preshared_depth = PadConv(1, 40, ks, pw)
        self.mlp_shared = PadConv(40 + label_nc - 1, nhidden, 3, pw)
        self.mlp_gamma = PadConv(nhidden, norm_nc, ks, pw)
        self.mlp_beta = PadConv(nhidden, norm_nc, ks, pw)

    def activation(self, seg: torch.Tensor) -> torch.Tensor:
        labels = seg[:, 1:]
        gated = torch.tanh(self.mlp_preshared_depth(seg[:, 0:1])) * labels
        return F.leaky_relu(self.mlp_shared(torch.cat([gated, labels], 1)),
                            0.01)


NORMS = {2: SPADE2, 3: SPADE3, 5: SPADE5}


class SPADEResnetBlockV(nn.Module):
    """SPADEResnetBlock2/3/5 (reference :746-794, :1034-1083, :1658-1703),
    selected by `variant`."""

    def __init__(self, fin: int, fout: int, variant: int, label_nc: int = 41,
                 param_free: str = "instance"):
        super().__init__()
        fmiddle = min(fin, fout)
        norm = NORMS[variant]

        def conv(cin, cout):
            if variant == 2:
                return nn.Conv2d(cin, cout, 3, padding=1)
            return PadConv(cin, cout, 3, 1)

        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = norm(fin, label_nc, param_free=param_free)
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
        self.norm_0 = norm(fin, label_nc, param_free=param_free)
        self.conv_0 = conv(fin, fmiddle)
        self.norm_1 = norm(fmiddle, label_nc, param_free=param_free)
        self.conv_1 = conv(fmiddle, fout)
        self.se = SEBlock2(fout, reduction=8) if variant == 3 else None

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = (self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut
               else x)
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        if self.se is not None:
            dx = self.se(dx)
        return x_s + dx


class SPADEGeneratorV(SPADEGenerator):
    """SPADEGenerator2/3/5 (reference :644-744, :1084-1182, :1705-1803),
    selected by `variant`, on the classic generator's skeleton."""

    def __init__(self, variant: int, semantic_nc: int = 41,
                 target_nc: int = 3, nz: int = 256, ngf: int = 64,
                 crop_size: int = 256, n_up: str = "normal",
                 param_free: str = "instance"):
        if variant == 5 and n_up != "normal":
            # the reference's generator 5 fails on 'more'/'most' (a missing
            # self.up at :1789, :1798)
            raise ValueError("SPADEGenerator5 supports n_up='normal' only")

        def block(fin, fout):
            return SPADEResnetBlockV(fin, fout, variant, semantic_nc,
                                     param_free)

        super().__init__(semantic_nc, target_nc, nz, ngf, crop_size, n_up,
                         base=12 if variant == 2 else 16, block=block,
                         img_pre=variant == 2,
                         head_kernel=3 if variant == 5 else 5,
                         bilinear_up_3=variant == 5)
        self.variant = variant


def SPADEGenerator2(**kw) -> SPADEGeneratorV:
    return SPADEGeneratorV(variant=2, **kw)


def SPADEGenerator3(**kw) -> SPADEGeneratorV:
    return SPADEGeneratorV(variant=3, **kw)


def SPADEGenerator5(**kw) -> SPADEGeneratorV:
    return SPADEGeneratorV(variant=5, **kw)
