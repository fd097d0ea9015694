"""SPADEGenerator4, the shading generator (counterpart of
sln_tpu/spade/generator.py; reference models/SPADE_related.py:1507-1605).

At inference the reference builds SPADEGenerator4(semantic_nc=41,
target_nc=3, nz=256, ngf=64, norm='spectralspadelayer3x3', crop_size=256,
n_up='normal') (testing/test_SPADE_shade.py:9): z (256) -> fc -> 16nf x 8
x 8, seven SPADE-modulated residual blocks with nearest upsampling
(bilinear before up_3), a 5x5 RGB head and tanh. NCHW is the reference's
own layout, so fc's output is viewed as (B, 16nf, sw, sw) directly.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from sln_tpu_torch.spade.layers import (SPADEResnetBlock4, resize_bilinear,
                                        resize_nearest)

BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2",
          "up_3")


@contextlib.contextmanager
def fp32_math():
    """Convolutions and matmuls in full float32, as the JAX package computes
    the generator (SpadeConfig.compute_dtype "float32"), deterministically.

    PyTorch's default would let cuDNN run convolutions in TF32, so the card
    would compute otherwise than the CPU and the JAX package. cuDNN held to
    fp32 and to deterministic algorithms picks an FFT algorithm for some of
    the decoder's shapes (the 256 -> 128 3x3 conv at 128 px), many times
    slower than a GEMM, so the convolutions run on PyTorch's own CUDA path
    instead: im2col and a cuBLAS fp32 GEMM, with no atomics (chip_smoke.py
    `spade` times a decode both ways). The generator sets this itself
    around each of its passes, so every caller gets the same math."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


class SPADEGenerator4(nn.Module):
    """Factored as `seg_mods` (every segmentation-conditioned branch: the
    per-scale resizes and the depth, shared, gamma and beta convs of all
    17 SPADE norms) and `decode` (the z-dependent pass). A room's
    segmentation is fixed while its z samples vary, so the shading
    workload runs seg_mods once per room and reuses it for every z chunk.
    `forward` = decode(seg_mods(seg), z), the reference forward."""

    def __init__(self, semantic_nc: int = 41, target_nc: int = 3,
                 nz: int = 256, ngf: int = 64, crop_size: int = 256,
                 n_up: str = "normal"):
        super().__init__()
        self.nz, self.ngf, self.crop_size = nz, ngf, crop_size
        self.sw = crop_size // 2 ** {"normal": 5, "more": 6,
                                     "most": 7}[n_up]
        nf = ngf
        self.fc = nn.Linear(nz, 16 * nf * self.sw * self.sw)
        widths = (16 * nf, 16 * nf, 16 * nf, 16 * nf, 8 * nf, 4 * nf,
                  2 * nf, nf)
        for name, fin, fout in zip(BLOCKS, widths[:-1], widths[1:]):
            self.add_module(name, SPADEResnetBlock4(fin, fout, semantic_nc))
        self.conv_img = nn.Conv2d(nf, target_nc, 5, padding=2)

    @fp32_math()
    def seg_mods(self, seg: torch.Tensor) -> Dict[str, dict]:
        """seg (B, 41, H, W), depth in channel 0 -> each block's (gamma,
        beta) stacks at its scale of the upsampling schedule."""
        sw = self.sw
        # the reference's F.interpolate default is NEAREST here (:1579);
        # SPADE4.mods' bilinear resize to the same (sw, sw) is then an
        # identity
        seg_1 = resize_nearest(seg, sw, sw)
        out = {"head_0": self.head_0.mods(seg_1, sw, sw)}
        for name, scale in zip(BLOCKS[1:], (2, 2, 4, 8, 16, 32)):
            out[name] = getattr(self, name).mods(seg, scale * sw,
                                                 scale * sw)
        return out

    @fp32_math()
    def decode(self, mods: Dict[str, dict], z: torch.Tensor) -> torch.Tensor:
        """z (B, nz); mods from seg_mods (batch 1 broadcasts over B) ->
        (B, 3, crop, crop) in [-1, 1]."""
        x = self.fc(z).view(-1, 16 * self.ngf, self.sw, self.sw)

        def up_n(t):
            return resize_nearest(t, 2 * t.shape[2], 2 * t.shape[3])

        x = self.head_0.from_mods(x, mods["head_0"])
        x = up_n(x)
        x = self.G_middle_0.from_mods(x, mods["G_middle_0"])
        x = self.G_middle_1.from_mods(x, mods["G_middle_1"])
        for name in ("up_0", "up_1", "up_2"):
            x = getattr(self, name).from_mods(up_n(x), mods[name])
        x = resize_bilinear(x, 2 * x.shape[2], 2 * x.shape[3])
        x = self.up_3.from_mods(x, mods["up_3"])
        x = self.conv_img(F.leaky_relu(x, 0.2))
        return torch.tanh(x)

    def forward(self, seg: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """seg (B, 41, H, W), depth in channel 0; z (B, nz) -> (B, 3,
        crop, crop) in [-1, 1]."""
        return self.decode(self.seg_mods(seg), z)
