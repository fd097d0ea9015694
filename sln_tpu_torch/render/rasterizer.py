"""Differentiable soft rasterizer — plain PyTorch semantic oracle
(counterpart of sln_tpu/render/rasterizer.py).

Per pixel, every face gets a soft coverage from its signed pixel distance
d to the triangle boundary (inside > 0), faces compete for visibility in
a softmax over log cov_f - z_f / gamma, and the total opacity
A = 1 - prod_f (1 - cov_f) composites the face aggregate over the
background:

    depth   = A * sum_f w_f z_f + (1 - A) * z_far
    class_c = A * sum_f w_f [class_f = c]

`soft_rasterize` is the chunked online-softmax formulation, O(P) memory;
the path the renderer takes is render/rasterizer_cuda.py (CUDA kernels,
or their plain versions for CPU tensors), which computes the same
function on y-sorted, culled face chunks. All functions take a leading
batch axis of scenes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


class FaceGeometry(NamedTuple):
    """Per-face screen-space constants, precomputed once per render."""
    v2d: torch.Tensor        # (B, F, 3, 2) projected pixel coords
    inv_z: torch.Tensor      # (B, F, 3) 1/z of each vertex
    valid: torch.Tensor      # (B, F) bool
    face_class: torch.Tensor  # (B, F) int64
    edge_nx: torch.Tensor    # (B, F, 3) edge-function x coefficient
    edge_ny: torch.Tensor    # (B, F, 3) edge-function y coefficient
    edge_c: torch.Tensor     # (B, F, 3) edge-function offset
    inv_len: torch.Tensor    # (B, F, 3) 1 / edge length
    area_sign: torch.Tensor  # (B, F) +-1 winding sign

    def take(self, order: torch.Tensor) -> "FaceGeometry":
        """Reorder faces: order (B, F) indices along the face axis."""
        def g(x):
            idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
            return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))
        return FaceGeometry(*(g(x) for x in self))


def face_geometry(v2d: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                  face_class: torch.Tensor, near: float = 1e-3
                  ) -> FaceGeometry:
    """v2d: (B, F, 3, 2) projected verts; z: (B, F, 3) camera depths."""
    a, b = v2d, torch.roll(v2d, -1, dims=-2)          # edges a -> b
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    edge_c = dy * a[..., 0] - dx * a[..., 1]
    # clamp INSIDE the sqrt: sqrt'(0) = inf would poison the backward pass
    length = torch.sqrt((dx * dx + dy * dy).clamp(min=1e-12))
    area2 = (dx[..., 0] * (v2d[..., 2, 1] - v2d[..., 0, 1])
             - dy[..., 0] * (v2d[..., 2, 0] - v2d[..., 0, 0]))
    area_sign = torch.where(area2 >= 0, 1.0, -1.0)
    degenerate = area2.abs() < 1e-9
    behind = (z <= near).any(-1)
    return FaceGeometry(
        v2d=v2d, inv_z=1.0 / z.clamp(min=near),
        valid=valid & ~degenerate & ~behind, face_class=face_class.long(),
        edge_nx=-dy, edge_ny=dx, edge_c=edge_c, inv_len=1.0 / length,
        area_sign=area_sign)


def pixel_centers(image_size: int, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (S*S,) pixel-center coordinates, row-major."""
    r = torch.arange(image_size, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(r, r, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _pixel_face_terms(g: FaceGeometry, px, py, sigma: float, gamma: float):
    """(B, P) x (B, F) block -> visibility logit, zbuf, log(1 - cov),
    each (B, P, F)."""
    e = (g.edge_nx[:, None] * px[None, :, None, None]
         + g.edge_ny[:, None] * py[None, :, None, None]
         + g.edge_c[:, None])                                 # (B, P, F, 3)
    d = (e * (g.inv_len * g.area_sign[..., None])[:, None]).amin(-1)
    lam = torch.roll(e, -1, dims=-1)
    lam_sum = lam.sum(-1, keepdim=True)
    lam = lam / torch.where(lam_sum.abs() > 1e-12, lam_sum,
                            torch.ones_like(lam_sum))
    lam = lam.clamp(0.0, 1.0)
    lam = lam / lam.sum(-1, keepdim=True).clamp(min=1e-12)
    zbuf = 1.0 / (lam * g.inv_z[:, None]).sum(-1).clamp(min=1e-12)
    dd = d * (1.0 + F.relu(-d)) / sigma
    valid = g.valid[:, None]
    logit = torch.where(valid, F.logsigmoid(dd) - zbuf / gamma,
                        torch.full_like(dd, NEG_INF))
    lomc = torch.where(valid, F.logsigmoid(-dd), torch.zeros_like(dd))
    return logit, zbuf, lomc


def soft_rasterize(geom: FaceGeometry, num_classes: int, image_size: int,
                   sigma: float = 0.5, gamma: float = 0.02,
                   z_far: float = 100.0, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax (flash) formulation over face chunks.

    Returns (depth (B, S, S), classes (B, S, S, C))."""
    device = geom.v2d.device
    px, py = pixel_centers(image_size, device)
    B, Fn = geom.valid.shape
    P = px.shape[0]
    m = torch.full((B, P), NEG_INF / 2, device=device)
    s = torch.zeros(B, P, device=device)
    acc_z = torch.zeros(B, P, device=device)
    acc_c = torch.zeros(B, P, num_classes, device=device)
    acc_lt = torch.zeros(B, P, device=device)
    for f0 in range(0, Fn, chunk):
        g = FaceGeometry(*(x[:, f0:f0 + chunk] for x in geom))
        logit, zbuf, lomc = _pixel_face_terms(g, px, py, sigma, gamma)
        m_new = torch.maximum(m, logit.amax(-1))
        scale = torch.exp(m - m_new)
        w = torch.exp(logit - m_new[..., None])
        onehot = F.one_hot(g.face_class, num_classes).float()
        s = s * scale + w.sum(-1)
        acc_z = acc_z * scale + (w * zbuf).sum(-1)
        acc_c = acc_c * scale[..., None] + torch.bmm(w, onehot)
        acc_lt = acc_lt + lomc.sum(-1)
        m = m_new
    denom = s.clamp(min=1e-30)
    alpha = 1.0 - torch.exp(acc_lt)
    depth = alpha * (acc_z / denom) + (1.0 - alpha) * z_far
    classes = alpha[..., None] * (acc_c / denom[..., None])
    S = image_size
    return depth.reshape(B, S, S), classes.reshape(B, S, S, num_classes)
