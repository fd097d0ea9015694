"""The benchmark's scene traffic: synthetic rooms, their padded arrays, the
attribute size table and the stochastic scene graphs, made from a seed.

A frozen copy of the generator, tensorizer, relation oracle and graph
builder that the measured package ships (its data/synthetic.py,
data/tensorize.py, ops/relations.py and data/augment.py), kept here so
that a later change to the program cannot move the traffic. The knobs a
traffic mix sets (rooms, objects per room, room extents) come from the
cell's workload file.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

OBJECT_IDX_TO_NAME: Tuple[str, ...] = (
    "__room__", "curtain", "shower_curtain", "dresser", "counter",
    "bookshelf", "picture", "mirror", "floor_mat", "chair", "sink", "desk",
    "table", "lamp", "door", "clothes", "person", "toilet", "cabinet",
    "floor", "window", "blinds", "wall", "pillow", "whiteboard", "bathtub",
    "television", "night_stand", "sofa", "refridgerator", "bed", "shelves",
)
NAME_TO_IDX = {n: i for i, n in enumerate(OBJECT_IDX_TO_NAME)}
ROOM_IDX = 0
NUM_PREDS = 16
NUM_ATTRS = 5

_CLASS_SIZES: Dict[str, Tuple[float, float, float]] = {
    "bed": (1.6, 0.6, 2.1), "desk": (1.2, 0.75, 0.6),
    "chair": (0.5, 0.9, 0.5), "table": (1.2, 0.75, 0.8),
    "sofa": (1.9, 0.8, 0.9), "cabinet": (0.9, 1.2, 0.45),
    "dresser": (1.1, 0.9, 0.5), "night_stand": (0.5, 0.55, 0.4),
    "bookshelf": (0.9, 1.8, 0.3), "shelves": (0.8, 1.5, 0.3),
    "television": (0.9, 0.55, 0.1), "lamp": (0.3, 0.5, 0.3),
    "pillow": (0.5, 0.15, 0.35), "sink": (0.6, 0.3, 0.5),
    "toilet": (0.4, 0.75, 0.65), "bathtub": (1.6, 0.55, 0.75),
    "refridgerator": (0.75, 1.7, 0.7), "counter": (1.5, 0.9, 0.6),
    "mirror": (0.6, 0.9, 0.05), "picture": (0.6, 0.5, 0.04),
    "whiteboard": (1.2, 0.9, 0.04), "floor_mat": (1.2, 0.02, 0.8),
}
_ON_SUPPORTS: Dict[str, Tuple[str, ...]] = {
    "desk": ("lamp", "television"), "table": ("lamp", "television"),
    "night_stand": ("lamp",), "cabinet": ("television", "lamp"),
    "bed": ("pillow",), "counter": ("sink", "lamp"),
    "dresser": ("television", "lamp"),
}
_FLOOR_CLASSES: Tuple[str, ...] = (
    "bed", "desk", "chair", "table", "sofa", "cabinet", "dresser",
    "night_stand", "bookshelf", "shelves", "toilet", "bathtub",
    "refridgerator", "counter", "floor_mat",
)

# traffic keys a workload may set, with the generator's defaults
ROOM_DEFAULTS = {"min_objects": 3, "max_objects": 10,
                 "room_x": [2.8, 6.0], "room_y": [2.4, 3.2],
                 "room_z": [2.8, 6.0]}


def _sample_size(rng: np.random.Generator, cls: str) -> np.ndarray:
    return np.array(_CLASS_SIZES[cls]) * rng.uniform(0.75, 1.3, size=3)


def generate_rooms(num_rooms: int, seed, params=None) -> List[dict]:
    """`num_rooms` rooms in the reference's JSON schema ({"valid_objects":
    [{"type", "new_bbox", "rotation"}], "bbox": [X, Y, Z]}), drawn from
    `seed` (an int or a sequence of ints)."""
    p = dict(ROOM_DEFAULTS, **(params or {}))
    rng = np.random.default_rng(seed)
    rooms = []
    for _ in range(num_rooms):
        X = float(rng.uniform(*p["room_x"]))
        Y = float(rng.uniform(*p["room_y"]))
        Z = float(rng.uniform(*p["room_z"]))
        n_floor = int(rng.integers(p["min_objects"], p["max_objects"] + 1))
        objects, placed = [], []
        for _ in range(n_floor):
            cls = str(rng.choice(_FLOOR_CLASSES))
            w, h, d = _sample_size(rng, cls)
            w, d = min(w, X * 0.8), min(d, Z * 0.8)
            x0 = float(rng.uniform(0.0, X - w))
            z0 = float(rng.uniform(0.0, Z - d))
            bbox = np.array([[x0, 0.0, z0], [x0 + w, min(h, Y), z0 + d]])
            objects.append({"type": cls, "new_bbox": bbox.tolist(),
                            "rotation": int(rng.integers(0, 24))})
            placed.append((cls, bbox[0], bbox[1]))
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
            objects.append({"type": top_cls, "new_bbox": bbox.tolist(),
                            "rotation": int(rng.integers(0, 24))})
        rooms.append({"valid_objects": objects, "bbox": [X, Y, Z]})
    return rooms


def tensorize(rooms: Sequence[dict], max_objects: int
              ) -> Dict[str, np.ndarray]:
    """Rooms -> padded arrays: objs (N, O) int64, boxes (N, O, 6) float32
    (normalized; the __room__ row absolute, after the real objects),
    angles (N, O) int64, obj_mask (N, O) bool, room_ids (N,) int64."""
    N, O = len(rooms), max_objects
    objs = np.zeros((N, O), np.int64)
    boxes = np.zeros((N, O, 6), np.float32)
    angles = np.zeros((N, O), np.int64)
    mask = np.zeros((N, O), bool)
    for r, room in enumerate(rooms):
        X, Y, Z = [float(v) for v in room["bbox"]]
        items = room["valid_objects"][: O - 1]
        n = len(items)
        for i, obj in enumerate(items):
            objs[r, i] = NAME_TO_IDX[obj["type"]]
            (x0, y0, z0), (x1, y1, z1) = obj["new_bbox"]
            boxes[r, i] = [x0 / X, y0 / Y, z0 / Z, x1 / X, y1 / Y, z1 / Z]
            angles[r, i] = int(obj["rotation"]) % 24
        objs[r, n] = ROOM_IDX
        boxes[r, n] = [0.0, 0.0, 0.0, X, Y, Z]
        mask[r, : n + 1] = True
    return {"objs": objs, "boxes": boxes, "angles": angles,
            "obj_mask": mask, "room_ids": np.arange(N, dtype=np.int64)}


class SizeInfo(NamedTuple):
    table: torch.Tensor    # (C, 4) [height_3, height_7, volume_3, volume_7]
    median: torch.Tensor   # (C, 2)
    avail: torch.Tensor    # (C,) bool


def size_table(device, num_rooms: int = 512, seed: int = 7) -> SizeInfo:
    """Per-class thresholds on normalized heights and volumes, from
    synthetic rooms (the tall / short / large / small attributes)."""
    heights: Dict[str, List[float]] = {}
    volumes: Dict[str, List[float]] = {}
    for room in generate_rooms(num_rooms, seed):
        X, Y, Z = room["bbox"]
        for obj in room["valid_objects"]:
            lo, hi = np.array(obj["new_bbox"][0]), np.array(obj["new_bbox"][1])
            nh = (hi[1] - lo[1]) / Y
            nv = ((hi[0] - lo[0]) / X) * nh * ((hi[2] - lo[2]) / Z)
            heights.setdefault(obj["type"], []).append(float(nh))
            volumes.setdefault(obj["type"], []).append(float(nv))
    n = len(OBJECT_IDX_TO_NAME)
    table = np.zeros((n, 4), np.float32)
    median = np.zeros((n, 2), np.float32)
    avail = np.zeros((n,), bool)
    for i, name in enumerate(OBJECT_IDX_TO_NAME):
        if name in heights and len(heights[name]) >= 4:
            h, v = np.array(heights[name]), np.array(volumes[name])
            table[i] = [np.quantile(h, 0.3), np.quantile(h, 0.7),
                        np.quantile(v, 0.3), np.quantile(v, 0.7)]
            median[i] = [np.median(h), np.median(v)]
            avail[i] = True
    return SizeInfo(*(torch.as_tensor(x, device=device)
                      for x in (table, median, avail)))


# predicates (the reference's compute_rel)
P_IN_ROOM, P_LEFT_OF, P_RIGHT_OF, P_BEHIND, P_IN_FRONT_OF = 0, 1, 2, 3, 4
P_INSIDE, P_SURROUNDING = 5, 6
P_LEFT_TOUCHING, P_RIGHT_TOUCHING = 7, 8
P_FRONT_TOUCHING, P_BEHIND_TOUCHING = 9, 10
P_ON = 15


def relation_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., O, 6) absolute boxes -> (..., O, O) predicate of subject i
    and object j."""
    boxes = boxes.float()
    bi = boxes[..., :, None, :]
    bj = boxes[..., None, :, :]
    c = (boxes[..., :3] + boxes[..., 3:]) / 2.0
    d = c[..., :, None, :] - c[..., None, :, :]
    theta = torch.atan2(d[..., 2], d[..., 0])
    ci = c[..., :, None, :]
    in_x = (ci[..., 0] >= bj[..., 0]) & (ci[..., 0] <= bj[..., 3])
    in_z = (ci[..., 2] >= bj[..., 2]) & (ci[..., 2] <= bj[..., 5])
    h = boxes[..., 4] - boxes[..., 1]
    delta1 = c[..., :, None, 1] - c[..., None, :, 1]
    delta2 = (h[..., :, None] + h[..., None, :]) / 2.0
    is_on = in_x & in_z & ((delta1 - delta2).abs() < 0.05)
    area = (boxes[..., 3] - boxes[..., 0]) * (boxes[..., 5] - boxes[..., 2])
    ix0 = torch.maximum(bi[..., 0], bj[..., 0])
    ix1 = torch.minimum(bi[..., 3], bj[..., 3])
    iz0 = torch.maximum(bi[..., 2], bj[..., 2])
    iz1 = torch.minimum(bi[..., 5], bj[..., 5])
    area_i = (ix1 - ix0).clamp(min=0.0) * (iz1 - iz0).clamp(min=0.0)
    denom = area[..., :, None] + area[..., None, :] - area_i
    iou = area_i / torch.where(denom > 0, denom, torch.ones_like(denom))
    touching = (iou > 0.0001) & (iou < 0.5)
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


class GraphDraws(NamedTuple):
    gumbel: torch.Tensor    # (B, O, O)
    swap: torch.Tensor      # (B, O) bool
    u_none: torch.Tensor    # (B, O)
    u_height: torch.Tensor  # (B, O)


def draw_graph_randomness(B: int, O: int, generator: torch.Generator,
                          device) -> GraphDraws:
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    u = uniform(B, O, O).clamp(min=torch.finfo(torch.float32).tiny)
    return GraphDraws(gumbel=-torch.log(-torch.log(u)),
                      swap=uniform(B, O) < 0.5, u_none=uniform(B, O),
                      u_height=uniform(B, O))


class Scenes(NamedTuple):
    """A padded batch of scene graphs, field for field the measured
    package's SceneBatch, so either side takes it as it is."""
    objs: torch.Tensor
    boxes: torch.Tensor
    angles: torch.Tensor
    attrs: torch.Tensor
    obj_mask: torch.Tensor
    triples: torch.Tensor
    triple_mask: torch.Tensor
    room_ids: torch.Tensor

    @property
    def edges(self) -> torch.Tensor:
        return self.triples[..., ::2]

    @property
    def preds(self) -> torch.Tensor:
        return self.triples[..., 1]

    @property
    def room_mask(self) -> torch.Tensor:
        return (self.objs == ROOM_IDX) & self.obj_mask


def build_graphs(objs, boxes, angles, obj_mask, room_ids,
                 size_info: SizeInfo, draws: GraphDraws,
                 max_on_rels: int = 32) -> Scenes:
    """Scene graphs of a padded batch: the 'on' triples (at most
    max_on_rels), one random relation per real object, one __in_room__
    edge per object, and the size attributes (30 / 70 % thresholds)."""
    objs, boxes = objs.long(), boxes.float()
    B, O = objs.shape
    device = objs.device
    room_mask = (objs == ROOM_IDX) & obj_mask
    real_mask = obj_mask & ~room_mask
    room_slot = room_mask.to(torch.uint8).argmax(-1)
    dims = (boxes * room_mask[..., None]).sum(1)[..., 3:]
    absb = torch.where(room_mask[..., None], boxes,
                       boxes * torch.cat([dims, dims], -1)[:, None, :])
    relmat = relation_matrix(absb)
    eye = torch.eye(O, dtype=torch.bool, device=device)
    pair_real = real_mask[:, :, None] & real_mask[:, None, :] & ~eye
    on_valid = pair_real & (relmat == P_ON)
    flat_on = on_valid.reshape(B, O * O)
    order = torch.sort((~flat_on).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :max_on_rels]
    on_sel_valid = torch.gather(flat_on, 1, order)
    on_s, on_o = order // O, order % O
    on_triples = torch.stack([on_s, torch.full_like(on_s, P_ON), on_o], -1)
    scores = torch.where(pair_real, draws.gumbel, float("-inf"))
    partner = scores.argmax(-1)
    has_partner = pair_real.any(-1)
    i_idx = torch.arange(O, device=device).expand(B, O)
    rand_s = torch.where(draws.swap, partner, i_idx)
    rand_o = torch.where(draws.swap, i_idx, partner)
    bidx = torch.arange(B, device=device)[:, None]
    on_between = on_valid[bidx, rand_s, rand_o] | on_valid[bidx, rand_o,
                                                           rand_s]
    rand_p = relmat[bidx, rand_s, rand_o]
    rand_valid = real_mask & has_partner & ~on_between
    rand_triples = torch.stack([rand_s, rand_p, rand_o], -1)
    in_room_valid = obj_mask & ~room_mask
    room_o = room_slot[:, None].expand(B, O)
    in_room_triples = torch.stack(
        [i_idx, torch.full_like(i_idx, P_IN_ROOM), room_o], -1)
    triples = torch.cat([on_triples, rand_triples, in_room_triples], 1)
    triple_mask = torch.cat([on_sel_valid, rand_valid, in_room_valid], 1)
    triples = torch.where(triple_mask[..., None], triples, 0)
    nh = boxes[..., 4] - boxes[..., 1]
    nv = (boxes[..., 3] - boxes[..., 0]) * nh * (boxes[..., 5]
                                                 - boxes[..., 2])
    avail = size_info.avail[objs]
    h3, h7 = size_info.table[objs, 0], size_info.table[objs, 1]
    v3, v7 = size_info.table[objs, 2], size_info.table[objs, 3]
    by_h = torch.where(nh > h7, 1, torch.where(nh < h3, 2, 0))
    by_v = torch.where(nv > v7, 3, torch.where(nv < v3, 4, 0))
    attrs = torch.where((draws.u_none > 0.5) | ~avail, 0,
                        torch.where(draws.u_height > 0.5, by_h, by_v))
    attrs = torch.where(real_mask, attrs, 0).long()
    return Scenes(objs=objs, boxes=boxes, angles=angles.long(), attrs=attrs,
                  obj_mask=obj_mask, triples=triples,
                  triple_mask=triple_mask, room_ids=room_ids.long())


def scene_batch(rooms: Sequence[dict], max_objects: int,
                size_info: SizeInfo, generator: torch.Generator,
                device) -> Scenes:
    """Rooms -> their scene graphs on `device`, the graph draws from
    `generator`."""
    arrays = tensorize(rooms, max_objects)
    t = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    B, O = arrays["objs"].shape
    draws = draw_graph_randomness(B, O, generator, device)
    return build_graphs(t["objs"], t["boxes"], t["angles"], t["obj_mask"],
                        t["room_ids"], size_info, draws)


def device_generator(device, *seed_parts: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from the run's seed and a
    stream tag; any whole numbers, negative or beyond 64 bits too."""
    entropy = [int(s) % (1 << 128) for s in seed_parts]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state) & ((1 << 63) - 1))


def host_seed(*seed_parts: int) -> np.random.SeedSequence:
    """A numpy seed from the run's seed and a stream tag."""
    return np.random.SeedSequence([int(s) % (1 << 128) for s in seed_parts])
