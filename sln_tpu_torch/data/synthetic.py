"""Procedural synthetic room generator (own copy of
sln_tpu/data/synthetic.py: generate_rooms and default_size_table).

The reference trains on SUNCG metadata (`metadata/data_rot_*.json`,
reference: data/suncg_dataset.py:18, options/options.py:19-20) which is not
redistributable. This module generates rooms in the *same JSON schema*:

    {room_id: {"valid_objects": [{"type": str,
                                  "new_bbox": [[x0,y0,z0],[x1,y1,z1]],
                                  "rotation": int}],
               "bbox": [X, Y, Z]}}

so the whole pipeline (tensorization, training, eval workloads, rendering)
runs end-to-end without SUNCG, and drops in unchanged when real metadata is
available.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Typical furniture footprints in meters: (w, h, d), jittered per instance.
_CLASS_SIZES: Dict[str, Tuple[float, float, float]] = {
    "bed": (1.6, 0.6, 2.1),
    "desk": (1.2, 0.75, 0.6),
    "chair": (0.5, 0.9, 0.5),
    "table": (1.2, 0.75, 0.8),
    "sofa": (1.9, 0.8, 0.9),
    "cabinet": (0.9, 1.2, 0.45),
    "dresser": (1.1, 0.9, 0.5),
    "night_stand": (0.5, 0.55, 0.4),
    "bookshelf": (0.9, 1.8, 0.3),
    "shelves": (0.8, 1.5, 0.3),
    "television": (0.9, 0.55, 0.1),
    "lamp": (0.3, 0.5, 0.3),
    "pillow": (0.5, 0.15, 0.35),
    "sink": (0.6, 0.3, 0.5),
    "toilet": (0.4, 0.75, 0.65),
    "bathtub": (1.6, 0.55, 0.75),
    "refridgerator": (0.75, 1.7, 0.7),
    "counter": (1.5, 0.9, 0.6),
    "mirror": (0.6, 0.9, 0.05),
    "picture": (0.6, 0.5, 0.04),
    "whiteboard": (1.2, 0.9, 0.04),
    "floor_mat": (1.2, 0.02, 0.8),
}

# "supporter" -> things that can sit on it
_ON_SUPPORTS: Dict[str, Tuple[str, ...]] = {
    "desk": ("lamp", "television"),
    "table": ("lamp", "television"),
    "night_stand": ("lamp",),
    "cabinet": ("television", "lamp"),
    "bed": ("pillow",),
    "counter": ("sink", "lamp"),
    "dresser": ("television", "lamp"),
}

_FLOOR_CLASSES: Tuple[str, ...] = (
    "bed", "desk", "chair", "table", "sofa", "cabinet", "dresser",
    "night_stand", "bookshelf", "shelves", "toilet", "bathtub",
    "refridgerator", "counter", "floor_mat",
)


def _sample_size(rng: np.random.Generator, cls: str) -> np.ndarray:
    base = np.array(_CLASS_SIZES[cls])
    return base * rng.uniform(0.75, 1.3, size=3)


def generate_rooms(num_rooms: int, seed: int = 0,
                   min_objects: int = 3, max_objects: int = 10
                   ) -> Dict[str, dict]:
    """Generate `num_rooms` rooms in the reference JSON schema."""
    rng = np.random.default_rng(seed)
    data: Dict[str, dict] = {}
    for ridx in range(num_rooms):
        X = float(rng.uniform(2.8, 6.0))
        Y = float(rng.uniform(2.4, 3.2))
        Z = float(rng.uniform(2.8, 6.0))
        n_floor = int(rng.integers(min_objects, max_objects + 1))
        objects: List[dict] = []

        placed: List[Tuple[str, np.ndarray, np.ndarray]] = []
        for _ in range(n_floor):
            cls = str(rng.choice(_FLOOR_CLASSES))
            w, h, d = _sample_size(rng, cls)
            w, d = min(w, X * 0.8), min(d, Z * 0.8)
            x0 = float(rng.uniform(0.0, X - w))
            z0 = float(rng.uniform(0.0, Z - d))
            bbox = np.array([[x0, 0.0, z0], [x0 + w, min(h, Y), z0 + d]])
            rot = int(rng.integers(0, 24))
            objects.append({"type": cls,
                            "new_bbox": bbox.tolist(),
                            "rotation": rot})
            placed.append((cls, bbox[0], bbox[1]))

        # Put small objects on supporters ('on' relations for the oracle).
        for cls, lo, hi in list(placed):
            tops = _ON_SUPPORTS.get(cls)
            if tops is None or rng.random() > 0.6:
                continue
            top_cls = str(rng.choice(tops))
            w, h, d = _sample_size(rng, top_cls)
            w = min(w, (hi[0] - lo[0]) * 0.9)
            d = min(d, (hi[2] - lo[2]) * 0.9)
            cx = float(rng.uniform(lo[0] + w / 2, hi[0] - w / 2)) \
                if hi[0] - lo[0] > w else (lo[0] + hi[0]) / 2
            cz = float(rng.uniform(lo[2] + d / 2, hi[2] - d / 2)) \
                if hi[2] - lo[2] > d else (lo[2] + hi[2]) / 2
            y0 = float(hi[1])
            bbox = np.array([[cx - w / 2, y0, cz - d / 2],
                             [cx + w / 2, min(y0 + h, Y), cz + d / 2]])
            objects.append({"type": top_cls,
                            "new_bbox": bbox.tolist(),
                            "rotation": int(rng.integers(0, 24))})

        data[str(ridx)] = {"valid_objects": objects, "bbox": [X, Y, Z]}
    return data


def default_size_table(num_rooms: int = 512, seed: int = 7):
    """Derive per-class normalized size thresholds from synthetic rooms.

    Mirrors metadata/size_info_many.json / 30_size_info_many.json
    (reference: data/suncg_dataset.py:84-87): thresholds on *normalized*
    heights and volumes used for tall/short/large/small attributes
    (suncg_dataset.py:233-289).

    Returns (table, median, avail): table (num_classes, 4) float32
    [height_3, height_7, volume_3, volume_7], median (num_classes, 2)
    [height_med, volume_med] for the 50/50 attribute mode, and avail
    (num_classes,) bool.
    """
    from sln_tpu_torch.data.vocab import OBJECT_IDX_TO_NAME

    rooms = generate_rooms(num_rooms, seed=seed)
    heights: Dict[str, List[float]] = {}
    volumes: Dict[str, List[float]] = {}
    for room in rooms.values():
        X, Y, Z = room["bbox"]
        for obj in room["valid_objects"]:
            lo, hi = np.array(obj["new_bbox"][0]), np.array(obj["new_bbox"][1])
            nh = (hi[1] - lo[1]) / Y
            nv = ((hi[0] - lo[0]) / X) * ((hi[1] - lo[1]) / Y) * ((hi[2] - lo[2]) / Z)
            heights.setdefault(obj["type"], []).append(float(nh))
            volumes.setdefault(obj["type"], []).append(float(nv))

    n = len(OBJECT_IDX_TO_NAME)
    table = np.zeros((n, 4), np.float32)
    median = np.zeros((n, 2), np.float32)
    avail = np.zeros((n,), bool)
    for i, name in enumerate(OBJECT_IDX_TO_NAME):
        if name in heights and len(heights[name]) >= 4:
            h = np.array(heights[name]); v = np.array(volumes[name])
            table[i] = [np.quantile(h, 0.3), np.quantile(h, 0.7),
                        np.quantile(v, 0.3), np.quantile(v, 0.7)]
            median[i] = [np.median(h), np.median(v)]
            avail[i] = True
    return table, median, avail
