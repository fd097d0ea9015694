"""Rotated-cuboid IoU in PyTorch, vectorized over any leading shape
(counterpart of sln_tpu/ops/iou.py, which vmaps over objects and rooms).

Replaces the reference's shapely/GEOS path (testing/test_utils.py:33-40):
the intersection of the two rotated xz footprints (Sutherland-Hodgman
clipping of convex quads, at a fixed MAX_VERTS) times the y overlap.
Everything is float32. The clipped polygon is compacted with a cumulative
sum and a scatter, not with the JAX package's one-hot matrix product: a
matmul would round the vertices to TF32 on a card where TF32 is allowed.
The host C++ version with the same semantics is csrc/native.cpp
`cuboid_iou` (float64).
"""

from __future__ import annotations

import math

import torch

MAX_VERTS = 16  # a 4-gon clipped by 4 half-planes has at most 8; padded


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., V, 2) rows at idx (..., K) -> (..., K, 2)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, 2))


def _next_index(count: torch.Tensor) -> torch.Tensor:
    """Each slot's successor in a polygon of `count` vertices (the last
    valid slot wraps to 0); clamped like an XLA gather when count exceeds
    MAX_VERTS."""
    idx = torch.arange(MAX_VERTS, device=count.device)
    nxt = torch.where(idx + 1 >= count[..., None], 0, idx + 1)
    return nxt.clamp(max=MAX_VERTS - 1)


def _clip_by_edge(poly: torch.Tensor, count: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor):
    """Clip the padded polygons poly (..., MAX_VERTS, 2) of `count` (...)
    vertices by the half-plane left of a -> b (..., 2)."""
    d = b - a
    rel = poly - a[..., None, :]
    side = d[..., 0:1] * rel[..., 1] - d[..., 1:2] * rel[..., 0]  # > 0 inside

    idx = torch.arange(MAX_VERTS, device=poly.device)
    valid = idx < count[..., None]
    nxt = _next_index(count)
    p_nxt = _take(poly, nxt)
    s_nxt = torch.gather(side, -1, nxt)

    denom = side - s_nxt
    t = side / torch.where(denom.abs() > 1e-12, denom,
                           torch.ones_like(denom))
    inter = poly + t[..., None] * (p_nxt - poly)

    # each input edge emits up to 2 vertices: its start if inside, and the
    # crossing if the edge crosses the line
    cur_in = side >= 0
    nxt_in = s_nxt >= 0
    emit1 = valid & cur_in
    emit2 = valid & (cur_in ^ nxt_in)
    n1 = emit1.long()
    per_edge = n1 + emit2.long()
    start = per_edge.cumsum(-1) - per_edge
    # emitted vertices go to distinct slots; the rest (and any slot past
    # MAX_VERTS) to a spare slot that is dropped
    spare = MAX_VERTS
    pos = torch.cat([torch.where(emit1, start, spare),
                     torch.where(emit2, start + n1, spare)], -1)
    pos = pos.clamp(max=spare)
    out = poly.new_zeros(*poly.shape[:-2], MAX_VERTS + 1, 2)
    out.scatter_(-2, pos[..., None].expand(*pos.shape, 2),
                 torch.cat([poly, inter], -2))
    return out[..., :MAX_VERTS, :], per_edge.sum(-1)


def _signed_area2(q: torch.Tensor) -> torch.Tensor:
    """Twice the signed shoelace area of quads (..., 4, 2)."""
    x, y = q[..., 0], q[..., 1]
    return (x * y.roll(-1, -1) - x.roll(-1, -1) * y).sum(-1)


def convex_intersection_area(quad_a: torch.Tensor,
                             quad_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quads (..., 4, 2), any winding."""
    quad_a, quad_b = quad_a.float(), quad_b.float()

    def ccw(q):
        return torch.where((_signed_area2(q) >= 0)[..., None, None], q,
                           q.flip(-2))

    qa, qb = ccw(quad_a), ccw(quad_b)
    lead = torch.broadcast_shapes(qa.shape[:-2], qb.shape[:-2])
    poly = qa.new_zeros(*lead, MAX_VERTS, 2)
    poly[..., :4, :] = qa
    qb = qb.expand(*lead, 4, 2)
    count = torch.full(lead, 4, dtype=torch.long, device=qa.device)
    for k in range(4):
        poly, count = _clip_by_edge(poly, count, qb[..., k, :],
                                    qb[..., (k + 1) % 4, :])
    # shoelace over the valid prefix
    idx = torch.arange(MAX_VERTS, device=poly.device)
    valid = idx < count[..., None]
    p_nxt = _take(poly, _next_index(count))
    x, y = poly[..., 0], poly[..., 1]
    terms = (x * p_nxt[..., 1] - p_nxt[..., 0] * y) * valid
    return terms.sum(-1).abs() / 2.0


def cuboid_iou(cu1_corners, cu1_ymin, cu1_ymax, cu2_corners, cu2_ymin,
               cu2_ymax) -> torch.Tensor:
    """Reference get_iou_cuboid (test_utils.py:33-40): xz polygon
    intersection x y-overlap, +1e-5 in the denominator. Corners (..., 4, 2),
    heights (...)."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=cu1_corners.device)

    cu1_ymin, cu1_ymax, cu2_ymin, cu2_ymax = map(
        f32, (cu1_ymin, cu1_ymax, cu2_ymin, cu2_ymax))
    inter2d = convex_intersection_area(cu1_corners, cu2_corners)
    h = (torch.minimum(cu1_ymax, cu2_ymax)
         - torch.maximum(cu1_ymin, cu2_ymin)).clamp(min=0.0)
    inter = inter2d * h
    v1 = _signed_area2(cu1_corners.float()).abs() / 2.0 * (cu1_ymax
                                                          - cu1_ymin)
    v2 = _signed_area2(cu2_corners.float()).abs() / 2.0 * (cu2_ymax
                                                          - cu2_ymin)
    return inter / (v1 + v2 - inter + 1e-5)


def rotated_box_corners(box: torch.Tensor, angle: torch.Tensor,
                        room_dims: torch.Tensor):
    """Normalized boxes (..., 6) + angle bins (...) -> ((..., 4, 2) rotated
    xz corners, ymin, ymax) (test_plot2d.py:84-110 math); room_dims
    broadcasts against the boxes' (..., 3)."""
    box, angle = box.float(), angle.float()
    lo = box[..., :3] * room_dims
    hi = box[..., 3:] * room_dims
    center = (lo + hi) / 2.0
    lo_c, hi_c = lo - center, hi - center
    theta = -angle * (2.0 * math.pi / 24.0)
    c, s = torch.cos(theta), torch.sin(theta)

    def rot_xz(px, pz):
        return torch.stack([c * px + s * pz, -s * px + c * pz], -1)

    corner_c = [(lo_c[..., 0], lo_c[..., 2]), (lo_c[..., 0], hi_c[..., 2]),
                (hi_c[..., 0], hi_c[..., 2]), (hi_c[..., 0], lo_c[..., 2])]
    center_xz = center[..., [0, 2]]
    corners = torch.stack([rot_xz(px, pz) + center_xz
                           for px, pz in corner_c], -2)
    return corners, lo[..., 1], hi[..., 1]


def layout_iou(boxes1, angles1, boxes2, angles2, room_dims) -> torch.Tensor:
    """Per-object IoU between two layouts: boxes (..., O, 6), angle bins
    (..., O), room_dims (..., 3) -> (..., O)."""
    dims = room_dims.float()[..., None, :]
    c1, y1a, y1b = rotated_box_corners(boxes1, angles1, dims)
    c2, y2a, y2b = rotated_box_corners(boxes2, angles2, dims)
    return cuboid_iou(c1, y1a, y1b, c2, y2a, y2b)
