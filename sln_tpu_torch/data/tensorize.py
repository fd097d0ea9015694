"""Host-side tensorization: raw room JSON -> padded numpy arrays.

Own copy of the Python path of sln_tpu/data/tensorize.py (the C++ packer
behind sln_tpu/native.py is not ported). Conventions:
* slots [0..n-2] real objects, slot n-1 the __room__ node, padding after;
* non-room boxes normalized to [0,1] by the room extents; the room row
  stays absolute [0, 0, 0, X, Y, Z] (reference suncg_dataset.py:216-231).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from sln_tpu_torch.data.vocab import ROOM_IDX, VOCAB


def load_rooms(path: str) -> Dict[str, dict]:
    with open(path, "r") as f:
        return json.load(f)


def tensorize_rooms(data: Dict[str, dict], max_objects: int
                    ) -> Dict[str, np.ndarray]:
    """Pad every room to `max_objects` slots (rooms with more objects keep
    the first max_objects-1).

    Returns dict of arrays: objs (N, O) int32, boxes (N, O, 6) float32,
    angles (N, O) int32, obj_mask (N, O) bool, room_ids (N,) int32.
    """
    name_to_idx = VOCAB.object_name_to_idx
    room_keys = sorted(data.keys(), key=lambda k: int(k))
    N, O = len(room_keys), max_objects
    objs = np.zeros((N, O), np.int32)
    boxes = np.zeros((N, O, 6), np.float32)
    angles = np.zeros((N, O), np.int32)
    mask = np.zeros((N, O), bool)
    room_ids = np.zeros((N,), np.int32)

    for r, key in enumerate(room_keys):
        room = data[key]
        room_ids[r] = int(key)
        X, Y, Z = [float(v) for v in room["bbox"]]
        items = room["valid_objects"][: O - 1]
        n = len(items)
        for i, obj in enumerate(items):
            objs[r, i] = name_to_idx[obj["type"]]
            (x0, y0, z0), (x1, y1, z1) = obj["new_bbox"]
            boxes[r, i] = [x0 / X, y0 / Y, z0 / Z, x1 / X, y1 / Y, z1 / Z]
            angles[r, i] = int(obj["rotation"]) % 24
        # __room__ node, absolute box (suncg_dataset.py:132-144)
        objs[r, n] = ROOM_IDX
        boxes[r, n] = [0.0, 0.0, 0.0, X, Y, Z]
        angles[r, n] = 0
        mask[r, : n + 1] = True

    return {"objs": objs, "boxes": boxes, "angles": angles,
            "obj_mask": mask, "room_ids": room_ids}
