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

import functools
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.models.layers import linear

Mods = Tuple[torch.Tensor, torch.Tensor]


def _unreflect(g: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Adjoint of reflection padding by `pad` along `dim`: the padded
    gradient's border folded back onto the rows it copied, by slices and
    adds (no scatter). Output j < pad copied input pad - j, output
    pad + n + k copied input n - 2 - k; a single row was copied to all."""
    n = g.shape[dim] - 2 * pad
    if n == 1:
        return g.sum(dim, keepdim=True)
    core = g.narrow(dim, pad, n).clone()
    core.narrow(dim, 1, pad).add_(g.narrow(dim, 0, pad).flip(dim))
    core.narrow(dim, n - 1 - pad, pad).add_(
        g.narrow(dim, pad + n, pad).flip(dim))
    return core


class _ReflectPad2d(torch.autograd.Function):
    """F.pad(mode="reflect") whose backward sums in a fixed order. PyTorch's
    CUDA backward of reflection padding adds with atomics, so two runs
    differ in the last bits; this one gives the same bits every time."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        if x.shape[2] == 1 and x.shape[3] == 1:
            # a 1 x 1 map (the generator's 8 x 8 head at 32 px) reflects to
            # copies of itself, as numpy's and jax's reflect do; PyTorch's
            # refuses padding wider than the input
            return x.expand(-1, -1, 1 + 2 * pad, 1 + 2 * pad).contiguous()
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        return _unreflect(_unreflect(g, ctx.pad, 3), ctx.pad, 2), None


class ReflectionPad2d(nn.Module):
    """nn.ReflectionPad2d with a fixed-order backward (_ReflectPad2d)."""

    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad == 0:
            return x
        return _ReflectPad2d.apply(x, self.pad)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype`, as flax's Conv(dtype=...):
    the input, the weight and the bias are cast to it at each call, so the
    output comes out in it while the parameters keep the dtype they are
    stored in. Below float32 the bias is added after the convolution's
    output is rounded, as flax adds it; in float32 this is nn.Conv2d."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32 or self.bias is None:
            return self._conv_forward(x.to(dt), self.weight.to(dt),
                                      self.bias)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (layers.linear)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.compute_dtype)


class PadConv(nn.Sequential):
    """ReflectionPad2d(pad) + Conv2d(kernel, padding=0) computing in
    `dtype`; the conv is submodule `1`, as in the reference's
    Sequentials."""

    def __init__(self, fin: int, fout: int, kernel: int, pad: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(ReflectionPad2d(pad),
                         Conv2d(fin, fout, kernel, bias=bias,
                                compute_dtype=dtype))


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


@functools.lru_cache(maxsize=64)
def bilinear_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of a half-pixel bilinear resize along one axis,
    as F.interpolate(align_corners=False) computes them: source
    (dst + 0.5) * n_in / n_out - 0.5, clamped at 0, between floor(src)
    and the next index (the last index at the edge). Cached per size and
    device: built once, on the host."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5)
           * (n_in / n_out) - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    l1 = src - i0
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    m.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    m.index_put_((rows, i1), l1, accumulate=True)
    return m.float().to(device)


class _ResizeBilinear(torch.autograd.Function):
    """F.interpolate(bilinear) whose backward is two GEMMs with the
    per-axis weight matrices, Ah^T g Aw: a fixed order. PyTorch's CUDA
    backward of the bilinear resize adds with atomics."""

    @staticmethod
    def forward(ctx, x, h, w):
        ctx.sizes = (x.shape[2], x.shape[3], h, w)
        return F.interpolate(x, size=(h, w), mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    def backward(ctx, g):
        H, W, h, w = ctx.sizes
        ah = bilinear_matrix(H, h, g.device).to(g.dtype)  # (h, H)
        aw = bilinear_matrix(W, w, g.device).to(g.dtype)  # (w, W)
        return torch.matmul(ah.t(), torch.matmul(g, aw)), None, None


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) bilinear resize, half-pixel centres, no antialiasing
    (the reference's F.interpolate default); its backward sums in a fixed
    order (_ResizeBilinear).

    Below float32, rows are resized first and rounded to x's dtype, then
    columns, as jax.image.resize contracts one axis at a time in x's
    dtype; float32 resizes in one pass."""
    if x.requires_grad:
        return _ResizeBilinear.apply(x, h, w)
    if x.dtype != torch.float32 and (h, w) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(h, x.shape[3]), mode="bilinear",
                          align_corners=False, antialias=False)
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """F.leaky_relu with the slope rounded to x's dtype first, as jax.nn's
    weakly typed slope is (0.2 is 0.2001953125 in bfloat16); in float32
    this is F.leaky_relu."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) nearest resize with torch's asymmetric index rule
    src = floor(dst * in / out)."""
    return F.interpolate(x, size=(h, w), mode="nearest")


class SPADE4(nn.Module):
    """Depth-aware SPADE modulation (reference :1404-1454), 'layer' norm.

    Factored into `mods` (everything computed from the segmentation map
    alone: resize, depth branch, shared conv, gamma and beta convs) and
    `apply_mods` (the z stream's side). When one room is shaded with many
    z, `mods` runs once per room; `forward` composes the two. Its convs
    compute in `dtype`; the resized segmentation stays float32 until a
    conv casts it."""

    def __init__(self, norm_nc: int, label_nc: int = 41, ks: int = 3,
                 nhidden: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        pw = ks // 2
        self.mlp_preshared_depth = PadConv(1, nhidden // 8, ks, pw,
                                           dtype=dtype)
        self.mlp_shared = PadConv(nhidden // 8 + label_nc - 1, nhidden, 3,
                                  pw, dtype=dtype)
        self.mlp_gamma = PadConv(nhidden, norm_nc, ks, pw, dtype=dtype)
        self.mlp_beta = PadConv(nhidden, norm_nc, ks, pw, dtype=dtype)

    def mods(self, segmap: torch.Tensor, h: int, w: int) -> Mods:
        """segmap (B, label_nc, Hs, Ws), depth in channel 0 -> (gamma,
        beta), each (B, norm_nc, h, w)."""
        seg = resize_bilinear(segmap, h, w)
        depth = leaky_relu(self.mlp_preshared_depth(seg[:, 0:1]), 0.01)
        actv = F.relu(self.mlp_shared(
            torch.cat([depth, seg[:, 1:].to(depth.dtype)], 1)))
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
    """Squeeze-excitation (reference :70-85). Its two fc layers have no
    compute dtype, as in the JAX module, where they promote to float32:
    the mean is taken in the stream's dtype, the gate computed in float32
    and cast to the stream's dtype before the multiply."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(nn.Linear(channels, hidden, bias=False),
                                nn.ReLU(),
                                nn.Linear(hidden, channels, bias=False),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the mean accumulated in float32 and rounded once to x's dtype,
        # as jnp.mean does (PyTorch's CPU mean of bfloat16 rounds the sum
        # before it divides); a float64 stream stays float64
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = x.mean((2, 3), dtype=acc).to(x.dtype)
        gate = self.fc(mean.to(acc))
        return x * gate.to(x.dtype)[:, :, None, None]


class SPADEResnetBlock4(nn.Module):
    """Reference :1457-1505, spectral norm folded into the kernels.

    `mods` / `from_mods` split the block into its segmentation-only part
    (the (gamma, beta) of each of its SPADE norms) and the z stream's
    pass; `forward` composes them. Its convs compute in `dtype` (SEBlock2
    in float32); the residual comes out in the input's dtype."""

    def __init__(self, fin: int, fout: int, label_nc: int = 41,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = SPADE4(fin, label_nc, dtype=dtype)
            self.conv_s = Conv2d(fin, fout, 1, bias=False,
                                 compute_dtype=dtype)
        self.norm_0 = SPADE4(fin, label_nc, dtype=dtype)
        self.conv_0 = PadConv(fin, fmiddle, 3, 1, dtype=dtype)
        self.norm_1 = SPADE4(fmiddle, label_nc, dtype=dtype)
        self.conv_1 = PadConv(fmiddle, fout, 3, 1, dtype=dtype)
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
        dx = self.conv_0(leaky_relu(dx, 0.2))
        dx = SPADE4.apply_mods(dx, *mods["norm_1"])
        dx = self.conv_1(leaky_relu(dx, 0.2))
        return (x_s + self.se(dx)).to(x.dtype)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        return self.from_mods(x, self.mods(seg, x.shape[2], x.shape[3]))
