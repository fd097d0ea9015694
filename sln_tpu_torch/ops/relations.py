"""Geometric relationship oracle, vectorized (counterpart of
sln_tpu/ops/relations.py:94 relation_matrix; predicate logic of the
reference's compute_rel, utils.py:36-80). Boxes are (x0, y0, z0, x1, y1,
z1); y is up."""

from __future__ import annotations

import math

import torch

# Predicate indices (sln_tpu_torch.data.vocab.PRED_IDX_TO_NAME order).
P_IN_ROOM = 0
P_LEFT_OF = 1
P_RIGHT_OF = 2
P_BEHIND = 3
P_IN_FRONT_OF = 4
P_INSIDE = 5
P_SURROUNDING = 6
P_LEFT_TOUCHING = 7
P_RIGHT_TOUCHING = 8
P_FRONT_TOUCHING = 9
P_BEHIND_TOUCHING = 10
P_ON = 15

ON_DELTA_THRESHOLD = 0.05      # reference: utils.py:49
TOUCH_IOU_LO = 0.0001          # reference: utils.py:65
TOUCH_IOU_HI = 0.5


def relation_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., O, 6) boxes -> (..., O, O) int64 predicate matrix; entry
    [i, j] is the predicate of subject i and object j (the diagonal is
    meaningless, padding rows are the caller's to mask)."""
    boxes = boxes.float()
    bi = boxes[..., :, None, :]                                 # subject
    bj = boxes[..., None, :, :]                                 # object
    c = (boxes[..., :3] + boxes[..., 3:]) / 2.0                 # (..., O, 3)
    d = c[..., :, None, :] - c[..., None, :, :]                 # (..., O, O, 3)
    theta = torch.atan2(d[..., 2], d[..., 0])

    ci = c[..., :, None, :]
    in_x = (ci[..., 0] >= bj[..., 0]) & (ci[..., 0] <= bj[..., 3])
    in_z = (ci[..., 2] >= bj[..., 2]) & (ci[..., 2] <= bj[..., 5])
    h = boxes[..., 4] - boxes[..., 1]
    delta1 = c[..., :, None, 1] - c[..., None, :, 1]
    delta2 = (h[..., :, None] + h[..., None, :]) / 2.0
    is_on = in_x & in_z & ((delta1 - delta2).abs() < ON_DELTA_THRESHOLD)

    area = (boxes[..., 3] - boxes[..., 0]) * (boxes[..., 5] - boxes[..., 2])
    ix0 = torch.maximum(bi[..., 0], bj[..., 0])
    ix1 = torch.minimum(bi[..., 3], bj[..., 3])
    iz0 = torch.maximum(bi[..., 2], bj[..., 2])
    iz1 = torch.minimum(bi[..., 5], bj[..., 5])
    area_i = (ix1 - ix0).clamp(min=0.0) * (iz1 - iz0).clamp(min=0.0)
    denom = area[..., :, None] + area[..., None, :] - area_i
    iou = area_i / torch.where(denom > 0, denom, torch.ones_like(denom))
    touching = (iou > TOUCH_IOU_LO) & (iou < TOUCH_IOU_HI)

    surrounding = ((bi[..., 0] < bj[..., 0]) & (bi[..., 3] > bj[..., 3])
                   & (bi[..., 2] < bj[..., 2]) & (bi[..., 5] > bj[..., 5]))
    inside = ((bi[..., 0] > bj[..., 0]) & (bi[..., 3] < bj[..., 3])
              & (bi[..., 2] > bj[..., 2]) & (bi[..., 5] < bj[..., 5]))

    pi = math.pi
    sector_lr = (theta >= 3 * pi / 4) | (theta <= -3 * pi / 4)
    sector_behind = (theta >= -3 * pi / 4) & (theta < -pi / 4)
    sector_right = (theta >= -pi / 4) & (theta < pi / 4)

    def pick(touch_p, apart_p):
        return torch.where(touching, touch_p, apart_p)

    directional = torch.where(
        sector_lr, pick(P_RIGHT_TOUCHING, P_LEFT_OF),
        torch.where(sector_behind, pick(P_BEHIND_TOUCHING, P_BEHIND),
                    torch.where(sector_right,
                                pick(P_LEFT_TOUCHING, P_RIGHT_OF),
                                pick(P_FRONT_TOUCHING, P_IN_FRONT_OF))))
    pred = torch.where(surrounding, P_SURROUNDING,
                       torch.where(inside, P_INSIDE, directional))
    return torch.where(is_on, P_ON, pred).long()
