"""Static-shape padded scene-graph batch (counterpart of
sln_tpu/data/batch.py) as torch tensors on one device.

* per scene, object slots [0 .. n-2] hold real objects, slot n-1 holds the
  __room__ node, and slots >= n are padding with obj_mask False;
* triples carry per-scene *local* [subject, predicate, object] indices;
* padding rows use index 0 / class 0 and are excluded by masks everywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sln_tpu_torch.data.vocab import ROOM_IDX


class SceneBatch(NamedTuple):
    objs: torch.Tensor          # (B, O) int64 object class ids
    boxes: torch.Tensor         # (B, O, 6) float32 normalized boxes
    angles: torch.Tensor        # (B, O) int64 in [0, 24)
    attrs: torch.Tensor         # (B, O) int64 in [0, 5)
    obj_mask: torch.Tensor      # (B, O) bool
    triples: torch.Tensor       # (B, T, 3) int64 [s_local, pred, o_local]
    triple_mask: torch.Tensor   # (B, T) bool
    room_ids: torch.Tensor      # (B,) int64

    @property
    def edges(self) -> torch.Tensor:
        """(B, T, 2) [subject, object] local indices."""
        return self.triples[..., ::2]

    @property
    def preds(self) -> torch.Tensor:
        return self.triples[..., 1]

    @property
    def room_mask(self) -> torch.Tensor:
        """(B, O) bool: True at each scene's __room__ node."""
        return (self.objs == ROOM_IDX) & self.obj_mask

    def select(self, idx) -> "SceneBatch":
        """Rows `idx` of every field (keeps the batch axis)."""
        return SceneBatch(*(t[idx] for t in self))
