"""The soft rasterizer's work, counted from the inputs: the (pixel, face)
pairs a render needs, and the operations and bytes of its forward and
backward kernels for those pairs.

A pair is needed where the pixel lies within a face's reach: inside its
2-D footprint pushed out by `halo_px`, the distance beyond which the
face's share of the pixel is below exp(-144) of the nearest face's
(the measured package's cull criterion, frozen here). Counted per pixel
and face, never per tile or chunk, so the count does not move when the
program culls more or less finely.
"""

from __future__ import annotations

import torch

CULL_LOGIT = 144.0
CLASSES = 32
# operations per needed pair, FMA = 2, counted from the kernels' source
FWD_FP32_OPS = 67              # coverage, depth, softmax terms
FWD_TF32_OPS = 4 * CLASSES     # the class product, two TF32 products
BWD_FP32_OPS = 166 + 2 * CLASSES
FACE_WORDS = 17                # 16 packed float32 constants + a class id


def halo_px(inv_z: torch.Tensor, valid: torch.Tensor, sigma: float,
            gamma: float) -> torch.Tensor:
    """(B, F) float64 reach in px beyond each face's edge lines: the d
    with d (1 + d) / sigma = CULL_LOGIT + (z_far - z_near_face) / gamma."""
    iz = inv_z.double()
    z_far = torch.where(valid, 1.0 / iz.amin(-1), -torch.inf)
    gain = (z_far.amax(-1, keepdim=True) - 1.0 / iz.amax(-1)).clamp(min=0.0)
    return 0.5 * (torch.sqrt(1.0 + 4.0 * sigma * (CULL_LOGIT + gain / gamma))
                  - 1.0)


@torch.no_grad()
def needed_pairs(terms, image_size: int, sigma: float, gamma: float,
                 block: int = 8192) -> torch.Tensor:
    """(B,) int64 needed (pixel, face) pairs of each scene. `terms` are
    the face constants (nx, ny, c, inv_len * winding sign, inv_z, valid),
    each (B, F, 3) but valid (B, F), as benchmark.reference.render
    face_terms builds them."""
    nx, ny, c, il, iz, valid = terms
    halo = halo_px(iz, valid, sigma, gamma).float()
    S = image_size
    r = torch.arange(S, dtype=torch.float32, device=nx.device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    out = torch.zeros(nx.shape[0], dtype=torch.long, device=nx.device)
    for b in range(nx.shape[0]):
        for i in range(0, S * S, block):
            e = (nx[b] * px[i:i + block, None, None]
                 + ny[b] * py[i:i + block, None, None] + c[b])
            d = (e * il[b]).amin(-1)
            out[b] += ((d >= -halo[b]) & valid[b]).sum()
    return out


def fwd_seconds_bound(pairs: float, faces: int, pixels: int,
                      peaks: dict) -> float:
    """The least time of a forward call: operations at their peaks, or
    bytes (faces read once, depth and classes written once) at the
    memory's, whichever is longer."""
    ops = (pairs * FWD_FP32_OPS / peaks["fp32_flops"]
           + pairs * FWD_TF32_OPS / peaks["tf32_flops"])
    byts = 4 * (faces * FACE_WORDS + pixels * (1 + CLASSES))
    return max(ops, byts / peaks["hbm_bytes"])


def bwd_seconds_bound(pairs: float, faces: int, pixels: int,
                      peaks: dict) -> float:
    """The least time of a backward call: operations at the fp32 peak,
    or bytes (faces, the forward's outputs and their gradients read once,
    the faces' gradients written once)."""
    ops = pairs * BWD_FP32_OPS / peaks["fp32_flops"]
    byts = 4 * (faces * (FACE_WORDS + 16) + 2 * pixels * (1 + CLASSES))
    return max(ops, byts / peaks["hbm_bytes"])
