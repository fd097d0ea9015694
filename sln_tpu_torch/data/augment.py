"""Stochastic scene-graph construction on the device (counterpart of
sln_tpu/data/augment.py:50 build_graphs).

Per scene: all 'on' relations (capped at max_on_rels), one random relation
per real object (skipping 'on'-related pairs), one __in_room__ edge per
object, and random size attributes (reference suncg_dataset.py:168-289).

JAX draws its randomness from threefry streams that torch cannot
reproduce, so the draws are explicit tensors (`GraphDraws`): by default
they come from a passed `torch.Generator`; tests pass JAX's own draws.

Triple slot layout per scene (T = max_on + 2*O):
    [0, max_on)           'on' triples
    [max_on, max_on+O)    random triples (slot i for subject-or-object i)
    [max_on+O, max_on+2O) __in_room__ triples (slot i for object i)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sln_tpu_torch.data.batch import SceneBatch
from sln_tpu_torch.data.vocab import ROOM_IDX
from sln_tpu_torch.ops.relations import P_IN_ROOM, P_ON, relation_matrix


class SizeInfo(NamedTuple):
    """Per-class attribute thresholds (data.synthetic.default_size_table)."""
    table: torch.Tensor    # (C, 4) [height_3, height_7, volume_3, volume_7]
    median: torch.Tensor   # (C, 2) [height_med, volume_med]
    avail: torch.Tensor    # (C,) bool


class GraphDraws(NamedTuple):
    """The random numbers build_graphs consumes (augment.py:57-118)."""
    gumbel: torch.Tensor    # (B, O, O) partner scores
    swap: torch.Tensor      # (B, O) bool, subject/object swap
    u_none: torch.Tensor    # (B, O) uniform: attribute 'none' if > 0.5
    u_height: torch.Tensor  # (B, O) uniform: height (vs volume) if > 0.5


def draw_graph_randomness(B: int, O: int, generator: torch.Generator,
                          device) -> GraphDraws:
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    u = uniform(B, O, O).clamp(min=torch.finfo(torch.float32).tiny)
    return GraphDraws(gumbel=-torch.log(-torch.log(u)),
                      swap=uniform(B, O) < 0.5,
                      u_none=uniform(B, O), u_height=uniform(B, O))


def denormalize(boxes: torch.Tensor, room_mask: torch.Tensor):
    """(B, O, 6) normalized (room row absolute) -> all absolute."""
    room_dims = (boxes * room_mask[..., None]).sum(1)[..., 3:]   # (B, 3)
    scale = torch.cat([room_dims, room_dims], -1)[:, None, :]
    return torch.where(room_mask[..., None], boxes, boxes * scale)


def build_graphs(objs, boxes, angles, obj_mask, room_ids,
                 size_info: SizeInfo, max_on_rels: int = 32,
                 use_attr_30: bool = True,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[GraphDraws] = None) -> SceneBatch:
    """Sample triples + attributes for a padded batch of scenes.

    All tensors lie on one device; `draws` (or, when it is None, fresh
    draws from `generator`) supply the randomness."""
    objs = objs.long()
    boxes = boxes.float()
    B, O = objs.shape
    device = objs.device
    if draws is None:
        draws = draw_graph_randomness(B, O, generator, device)

    room_mask = (objs == ROOM_IDX) & obj_mask
    real_mask = obj_mask & ~room_mask
    room_slot = room_mask.to(torch.uint8).argmax(-1)              # (B,)

    relmat = relation_matrix(denormalize(boxes, room_mask))       # (B, O, O)
    eye = torch.eye(O, dtype=torch.bool, device=device)
    pair_real = real_mask[:, :, None] & real_mask[:, None, :] & ~eye
    on_valid = pair_real & (relmat == P_ON)

    # 'on' triples: first max_on_rels true pairs in row-major order
    flat_on = on_valid.reshape(B, O * O)
    order = torch.sort((~flat_on).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :max_on_rels]
    on_sel_valid = torch.gather(flat_on, 1, order)
    on_s, on_o = order // O, order % O
    on_triples = torch.stack([on_s, torch.full_like(on_s, P_ON), on_o], -1)

    # one random relation per real object (suncg_dataset.py:192-205)
    scores = torch.where(pair_real, draws.gumbel.to(device), float("-inf"))
    partner = scores.argmax(-1)                                    # (B, O)
    has_partner = pair_real.any(-1)
    swap = draws.swap.to(device)
    i_idx = torch.arange(O, device=device).expand(B, O)
    rand_s = torch.where(swap, partner, i_idx)
    rand_o = torch.where(swap, i_idx, partner)
    bidx = torch.arange(B, device=device)[:, None]
    on_between = on_valid[bidx, rand_s, rand_o] | on_valid[bidx, rand_o,
                                                           rand_s]
    rand_p = relmat[bidx, rand_s, rand_o]
    rand_valid = real_mask & has_partner & ~on_between
    rand_triples = torch.stack([rand_s, rand_p, rand_o], -1)

    # __in_room__ triples (suncg_dataset.py:207-212)
    in_room_valid = obj_mask & ~room_mask
    room_o = room_slot[:, None].expand(B, O)
    in_room_triples = torch.stack(
        [i_idx, torch.full_like(i_idx, P_IN_ROOM), room_o], -1)

    triples = torch.cat([on_triples, rand_triples, in_room_triples], 1)
    triple_mask = torch.cat([on_sel_valid, rand_valid, in_room_valid], 1)
    triples = torch.where(triple_mask[..., None], triples, 0)

    # attributes from normalized sizes (suncg_dataset.py:233-289)
    nh = boxes[..., 4] - boxes[..., 1]
    nv = (boxes[..., 3] - boxes[..., 0]) * nh * (boxes[..., 5]
                                                 - boxes[..., 2])
    avail = size_info.avail[objs]
    r_none = draws.u_none.to(device) > 0.5
    r_height = draws.u_height.to(device) > 0.5
    if use_attr_30:
        h3, h7 = size_info.table[objs, 0], size_info.table[objs, 1]
        v3, v7 = size_info.table[objs, 2], size_info.table[objs, 3]
        by_h = torch.where(nh > h7, 1, torch.where(nh < h3, 2, 0))
        by_v = torch.where(nv > v7, 3, torch.where(nv < v3, 4, 0))
    else:
        hm, vm = size_info.median[objs, 0], size_info.median[objs, 1]
        by_h = torch.where(nh > hm, 1, 2)
        by_v = torch.where(nv > vm, 3, 4)
    attrs = torch.where(r_none | ~avail, 0,
                        torch.where(r_height, by_h, by_v))
    attrs = torch.where(real_mask, attrs, 0).long()

    return SceneBatch(objs=objs, boxes=boxes, angles=angles.long(),
                      attrs=attrs, obj_mask=obj_mask, triples=triples,
                      triple_mask=triple_mask, room_ids=room_ids.long())
