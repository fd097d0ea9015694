"""Geometric relationship oracle (counterpart of sln_tpu/ops/relations.py;
predicate logic of the reference's compute_rel, utils.py:36-80), in two
forms:

* `compute_rel_host` / `compute_rel_host_idx`: scalar float64 numpy, the
  golden oracle that `relation_matrix` is held against;
* `relation_matrix`: the (..., O, O) pairwise predicate matrix in one
  vectorized torch call (scene-graph augmentation and the accuracy metric).

Boxes are (x0, y0, z0, x1, y1, z1); y is up.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sln_tpu_torch.data.vocab import PRED_IDX_TO_NAME

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


def compute_rel_host(box1, box2, name1=None, name2=None) -> str:
    """Scalar oracle: the predicate *name* of subject box1 and object box2
    (reference utils.py:36-80)."""
    box1 = np.asarray(box1, dtype=np.float64)
    box2 = np.asarray(box2, dtype=np.float64)
    c1 = (box1[:3] + box1[3:]) / 2.0
    c2 = (box2[:3] + box2[3:]) / 2.0

    if name2 == "__room__":
        return "__in_room__"

    # 'on': subject center inside object's xz footprint, resting on top
    if box2[0] <= c1[0] <= box2[3] and box2[2] <= c1[2] <= box2[5]:
        delta1 = c1[1] - c2[1]
        delta2 = (box1[4] - box1[1] + box2[4] - box2[1]) / 2.0
        if abs(delta1 - delta2) < ON_DELTA_THRESHOLD:
            return "on"

    d = c1 - c2
    theta = math.atan2(d[2], d[0])

    area_s = (box1[3] - box1[0]) * (box1[5] - box1[2])
    area_o = (box2[3] - box2[0]) * (box2[5] - box2[2])
    ix0, ix1 = max(box1[0], box2[0]), min(box1[3], box2[3])
    iz0, iz1 = max(box1[2], box2[2]), min(box1[5], box2[5])
    area_i = max(0.0, ix1 - ix0) * max(0.0, iz1 - iz0)
    iou = area_i / (area_s + area_o - area_i)
    touching = TOUCH_IOU_LO < iou < TOUCH_IOU_HI

    if (box1[0] < box2[0] and box1[3] > box2[3]
            and box1[2] < box2[2] and box1[5] > box2[5]):
        return "surrounding"
    if (box1[0] > box2[0] and box1[3] < box2[3]
            and box1[2] > box2[2] and box1[5] < box2[5]):
        return "inside"
    if theta >= 3 * math.pi / 4 or theta <= -3 * math.pi / 4:
        return "right touching" if touching else "left of"
    if -3 * math.pi / 4 <= theta < -math.pi / 4:
        return "behind touching" if touching else "behind"
    if -math.pi / 4 <= theta < math.pi / 4:
        return "left touching" if touching else "right of"
    # math.pi / 4 <= theta < 3 * math.pi / 4
    return "front touching" if touching else "in front of"


def compute_rel_host_idx(box1, box2, name1=None, name2=None) -> int:
    """compute_rel_host as a predicate index."""
    return PRED_IDX_TO_NAME.index(compute_rel_host(box1, box2, name1, name2))


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
