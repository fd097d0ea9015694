"""Object / predicate / attribute vocabularies (own copy of
sln_tpu/data/vocab.py; the port imports nothing of sln_tpu).

The reference builds this dict at dataset-construction time from
metadata/valid_types.json (reference: data/suncg_dataset.py:31-73) and
repeats the class list verbatim in testing/test_utils.py:61-64 and
testing/test_plot2d.py:10-13. The NYU-40 list is repeated in
models/diff_render.py:3, testing/test_render_refine.py:32,
testing/test_SPADE_shade.py:32-36.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# 31 SUNCG valid types + the synthetic __room__ node at index 0
# (order from testing/test_utils.py:61-64, which mirrors
# ['__room__'] + metadata/valid_types.json).
OBJECT_IDX_TO_NAME: Tuple[str, ...] = (
    "__room__", "curtain", "shower_curtain", "dresser", "counter",
    "bookshelf", "picture", "mirror", "floor_mat", "chair", "sink", "desk",
    "table", "lamp", "door", "clothes", "person", "toilet", "cabinet",
    "floor", "window", "blinds", "wall", "pillow", "whiteboard", "bathtub",
    "television", "night_stand", "sofa", "refridgerator", "bed", "shelves",
)

# reference: data/suncg_dataset.py:39-56
PRED_IDX_TO_NAME: Tuple[str, ...] = (
    "__in_room__",
    "left of",
    "right of",
    "behind",
    "in front of",
    "inside",
    "surrounding",
    "left touching",
    "right touching",
    "front touching",
    "behind touching",
    "front left",     # declared but never produced by the oracle
    "front right",
    "back left",
    "back right",
    "on",
)

# reference: data/suncg_dataset.py:64-70
ATTR_IDX_TO_NAME: Tuple[str, ...] = ("none", "tall", "short", "large", "small")

# reference: models/diff_render.py:3 (space-separated names)
NYU40_CLASSES: Tuple[str, ...] = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "night stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
)

# Classes skipped by the differentiable renderer and 2D plotter
# (reference: models/diff_render.py:91, testing/test_plot2d.py:74).
DO_NOT_RENDER: Tuple[str, ...] = (
    "wall", "ceiling", "floor", "person", "door", "window", "curtain",
    "blinds",
)

ROOM_IDX = 0
IN_ROOM_PRED = 0
ON_PRED = PRED_IDX_TO_NAME.index("on")  # == 15


def _nyu40_index(name: str) -> int:
    """SUNCG class name -> NYU-40 index (0-based), '_' treated as ' '."""
    return NYU40_CLASSES.index(name.replace("_", " "))


# Map SUNCG object index (excluding __room__) -> NYU-40 class index.
OBJ_TO_NYU40: Tuple[int, ...] = tuple(
    _nyu40_index(name) for name in OBJECT_IDX_TO_NAME[1:]
)


@dataclass(frozen=True)
class Vocab:
    object_idx_to_name: Tuple[str, ...] = OBJECT_IDX_TO_NAME
    pred_idx_to_name: Tuple[str, ...] = PRED_IDX_TO_NAME
    attrib_idx_to_name: Tuple[str, ...] = ATTR_IDX_TO_NAME
    object_name_to_idx: Dict[str, int] = field(default_factory=lambda: {
        n: i for i, n in enumerate(OBJECT_IDX_TO_NAME)})
    pred_name_to_idx: Dict[str, int] = field(default_factory=lambda: {
        n: i for i, n in enumerate(PRED_IDX_TO_NAME)})
    attrib_name_to_idx: Dict[str, int] = field(default_factory=lambda: {
        n: i for i, n in enumerate(ATTR_IDX_TO_NAME)})

    @property
    def num_objects(self) -> int:
        return len(self.object_idx_to_name)

    @property
    def num_preds(self) -> int:
        return len(self.pred_idx_to_name)

    @property
    def num_attrs(self) -> int:
        return len(self.attrib_idx_to_name)

    def to_dict(self) -> Dict[str, object]:
        """Reference-format vocab dict (data/suncg_dataset.py:31-73)."""
        return {
            "object_idx_to_name": list(self.object_idx_to_name),
            "object_name_to_idx": dict(self.object_name_to_idx),
            "pred_idx_to_name": list(self.pred_idx_to_name),
            "pred_name_to_idx": dict(self.pred_name_to_idx),
            "attrib_idx_to_name": list(self.attrib_idx_to_name),
            "attrib_name_to_idx": dict(self.attrib_name_to_idx),
        }


VOCAB = Vocab()
