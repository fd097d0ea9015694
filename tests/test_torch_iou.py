"""The port's rotated-cuboid IoU (sln_tpu_torch/ops/iou.py) against the JAX
package's (sln_tpu/ops/iou.py, jax.vmap over pairs) on random rotated
quads, the degenerate cases and a (B=4, O=16) layout, at 1e-5 absolute;
and the scalar relation oracle (ops/relations.py compute_rel_host) against
the JAX package's."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode

from sln_tpu.ops import iou as jiou
from sln_tpu.ops import relations as jrel
from sln_tpu_torch.data.vocab import PRED_IDX_TO_NAME
from sln_tpu_torch.ops import iou as tiou
from sln_tpu_torch.ops import relations as trel

torch.set_num_threads(2)

TOL = 1e-5        # absolute, on areas and IoUs


def rand_quads(rng, n):
    out = []
    for _ in range(n):
        cx, cz = rng.uniform(0, 3, 2)
        w, h = rng.uniform(0.3, 2.0, 2)
        th = rng.uniform(0, np.pi)
        c, s = np.cos(th), np.sin(th)
        base = np.array([[-w, -h], [-w, h], [w, h], [w, -h]]) / 2
        q = base @ np.array([[c, -s], [s, c]]) + [cx, cz]
        out.append(q[::-1] if rng.uniform() < 0.5 else q)   # both windings
    return np.stack(out).astype(np.float32)


_jax_area = jax.jit(jax.vmap(jiou.convex_intersection_area))
_jax_iou = jax.jit(jax.vmap(jiou.cuboid_iou))


def jax_area(qa, qb):
    return np.asarray(_jax_area(jnp.asarray(qa), jnp.asarray(qb)))


def jax_iou(qa, y1, qb, y2):
    f = jnp.asarray
    return np.asarray(_jax_iou(f(qa), f(y1[:, 0]), f(y1[:, 1]), f(qb),
                               f(y2[:, 0]), f(y2[:, 1])))


def torch_iou(qa, y1, qb, y2):
    t = torch.as_tensor
    return tiou.cuboid_iou(t(qa), t(y1[:, 0]), t(y1[:, 1]), t(qb),
                           t(y2[:, 0]), t(y2[:, 1])).numpy()


def test_random_rotated_quads_match_jax():
    rng = np.random.default_rng(3)
    qa, qb = rand_quads(rng, 300), rand_quads(rng, 300)
    y1 = rng.uniform(0, 1, (300, 2)).astype(np.float32).cumsum(-1)
    y2 = rng.uniform(0, 1, (300, 2)).astype(np.float32).cumsum(-1)
    got = tiou.convex_intersection_area(torch.as_tensor(qa),
                                        torch.as_tensor(qb)).numpy()
    want = jax_area(qa, qb)
    assert (want > 0.05).sum() > 50
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(torch_iou(qa, y1, qb, y2),
                               jax_iou(qa, y1, qb, y2), rtol=0, atol=TOL)


def _sq(x0, z0, x1, z1):
    return [[x0, z0], [x0, z1], [x1, z1], [x1, z0]]


DEGENERATE = {
    # name: (quad a, quad b, (y1min, y1max), (y2min, y2max))
    "disjoint (the clip leaves 0 vertices)": (
        _sq(0, 0, 1, 1), _sq(5, 5, 6, 6), (0, 1), (0, 1)),
    "identical": (_sq(0, 0, 2, 2), _sq(0, 0, 2, 2), (0, 1), (0, 1)),
    "identical, clockwise": (_sq(0, 0, 2, 2)[::-1], _sq(0, 0, 2, 2),
                             (0, 1), (0, 1)),
    "repeated vertex": ([[0, 0], [0, 0], [1, 1], [1, 0]], _sq(0, 0, 1, 1),
                        (0, 1), (0, 1)),
    "zero-height box": (_sq(0, 0, 1, 1), _sq(0.5, 0, 1.5, 1), (0, 0),
                        (0, 1)),
    "both zero-height": (_sq(0, 0, 1, 1), _sq(0, 0, 1, 1), (1, 1), (1, 1)),
    "zero-area quad (a segment)": ([[0, 0], [1, 1], [1, 1], [0, 0]],
                                   _sq(0, 0, 1, 1), (0, 1), (0, 1)),
    "a point": ([[0.5, 0.5]] * 4, _sq(0, 0, 1, 1), (0, 1), (0, 1)),
    "shared edge": (_sq(0, 0, 1, 1), _sq(1, 0, 2, 1), (0, 1), (0, 1)),
    "shared corner": (_sq(0, 0, 1, 1), _sq(1, 1, 2, 2), (0, 1), (0, 1)),
    "contained": (_sq(0, 0, 4, 4), _sq(1, 1, 2, 3), (0, 2), (0.5, 1)),
    "disjoint in y": (_sq(0, 0, 1, 1), _sq(0, 0, 1, 1), (0, 1), (2, 3)),
    "half overlap": ([[0, 0], [0, 1], [2, 1], [2, 0]],
                     [[1, 0], [1, 1], [3, 1], [3, 0]], (0, 1), (0, 1)),
    "nearly collinear edges": (_sq(0, 0, 1, 1),
                               [[1e-7, -1], [1e-7, 2], [1 + 1e-7, 2],
                                [1 + 1e-7, -1]], (0, 1), (0, 1)),
}


@pytest.mark.parametrize("name", list(DEGENERATE))
def test_degenerate_cases_match_jax(name):
    """The JAX function's answer in each degenerate case is the
    specification (1e-5 absolute; both finite)."""
    qa, qb, y1, y2 = DEGENERATE[name]
    qa = np.asarray([qa], np.float32)
    qb = np.asarray([qb], np.float32)
    y1 = np.asarray([y1], np.float32)
    y2 = np.asarray([y2], np.float32)
    got_a = tiou.convex_intersection_area(torch.as_tensor(qa),
                                          torch.as_tensor(qb)).numpy()
    want_a = jax_area(qa, qb)
    got, want = torch_iou(qa, y1, qb, y2), jax_iou(qa, y1, qb, y2)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got_a, want_a, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_golden_values_in_torch():
    """A unit square against itself turned 45 degrees meets in a regular
    octagon of area 2(sqrt 2 - 1), IoU 0.7071067; a 2 x 1 rectangle turned
    90 degrees 1/3; half the y overlap 2/6 (all within 1e-4)."""
    t = torch.as_tensor
    sq = np.array([[-.5, -.5], [-.5, .5], [.5, .5], [.5, -.5]], np.float32)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    rot = (sq @ np.array([[c, -s], [s, c]])).astype(np.float32)
    assert abs(float(tiou.convex_intersection_area(t(sq), t(rot)))
               - 2.0 * (math.sqrt(2.0) - 1.0)) < 1e-6
    assert abs(float(tiou.cuboid_iou(t(sq), 0.0, 1.0, t(rot), 0.0, 1.0))
               - 0.7071067) < 1e-4
    rect = np.array([[-1., -.5], [-1., .5], [1., .5], [1., -.5]], np.float32)
    rot90 = rect[:, ::-1].copy()
    assert abs(float(tiou.cuboid_iou(t(rect), 0.0, 2.0, t(rot90), 0.0, 2.0))
               - 1.0 / 3.0) < 1e-4
    assert abs(float(tiou.cuboid_iou(t(rect), 0.0, 2.0, t(rect), 1.0, 3.0))
               - 2.0 / 6.0) < 1e-4


def _layouts(rng, B, O):
    lo = rng.uniform(0, 0.6, (B, O, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (B, O, 3))], -1)
    angles = rng.integers(0, 24, (B, O)).astype(np.float32)
    return boxes.astype(np.float32), angles


def test_layout_iou_b4_o16_matches_jax():
    """(B=4, O=16) layouts: the port's broadcast over (B, O) against JAX's
    vmap over rooms of vmap over objects; corners too."""
    rng = np.random.default_rng(5)
    B, O = 4, 16
    b1, a1 = _layouts(rng, B, O)
    b2, a2 = _layouts(rng, B, O)
    b2[:, :4], a2[:, :4] = b1[:, :4], a1[:, :4]          # some identical
    b2[:, 4:8], a2[:, 4:8] = b1[:, 4:8] + 0.005, a1[:, 4:8]  # some near
    dims = rng.uniform(2.0, 6.0, (B, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jiou.layout_iou))(*map(jnp.asarray, (
        b1, a1, b2, a2, dims))))
    t = torch.as_tensor
    got = tiou.layout_iou(t(b1), t(a1), t(b2), t(a2), t(dims)).numpy()
    assert got.shape == (B, O)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[:, :4], 1.0, atol=1e-3)
    assert (got[:, 4:8] > 0.5).all()
    corners_j, ymin_j, ymax_j = jax.vmap(jiou.rotated_box_corners,
                                         (0, 0, None))(
        jnp.asarray(b1[0]), jnp.asarray(a1[0]), jnp.asarray(dims[0]))
    corners_t, ymin_t, ymax_t = tiou.rotated_box_corners(
        t(b1[0]), t(a1[0]), t(dims[0]))
    np.testing.assert_allclose(corners_t.numpy(), np.asarray(corners_j),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(ymin_t.numpy(), np.asarray(ymin_j))
    np.testing.assert_array_equal(ymax_t.numpy(), np.asarray(ymax_j))


class _Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.add(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def test_iou_makes_no_matrix_product():
    """The compaction is index arithmetic: no matmul that TF32 could round
    on a card."""
    rng = np.random.default_rng(0)
    b, a = _layouts(rng, 2, 16)
    t = torch.as_tensor
    with _Calls() as calls:
        tiou.layout_iou(t(b), t(a), t(b[::-1].copy()), t(a), t(
            np.full((2, 3), 4.0, np.float32)))
    assert "scatter_" in calls.names
    assert not calls.names & {"matmul", "__matmul__", "mm", "bmm", "einsum",
                              "linear", "tensordot"}, calls.names


def test_compute_rel_host_matches_jax():
    """Equal names and indices to the JAX package's scalar oracle over
    random box pairs (touching, nested and stacked ones included) and the
    __room__ override; relation_matrix agrees with it off the diagonal."""
    rng = np.random.default_rng(11)
    boxes = []
    for _ in range(40):
        lo = rng.uniform(0, 3, 3)
        boxes.append(np.concatenate([lo, lo + rng.uniform(0.1, 1.5, 3)]))
    base = boxes[0]
    boxes.append(np.array([base[0] + 0.1, base[4], base[2] + 0.1,
                           base[3] - 0.1, base[4] + 0.5, base[5] - 0.1]))
    boxes.append(np.array([base[0] - 0.5, base[1], base[2] - 0.5,
                           base[3] + 0.5, base[4], base[5] + 0.5]))
    boxes.append(np.array([base[3], base[1], base[2],
                           base[3] + 1.0, base[4], base[5]]))
    boxes = np.round(np.asarray(boxes), 3)
    n = len(boxes)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            name = trel.compute_rel_host(boxes[i], boxes[j])
            assert name == jrel.compute_rel_host(boxes[i], boxes[j])
            idx = trel.compute_rel_host_idx(boxes[i], boxes[j])
            assert idx == jrel.compute_rel_host_idx(boxes[i], boxes[j])
            assert PRED_IDX_TO_NAME[idx] == name
    seen = {trel.compute_rel_host(boxes[i], boxes[j])
            for i in range(n) for j in range(n) if i != j}
    assert {"on", "surrounding", "inside"} <= seen and len(seen) >= 7
    assert trel.compute_rel_host(boxes[0], boxes[1], None, "__room__") == \
        jrel.compute_rel_host(boxes[0], boxes[1], None, "__room__") == \
        "__in_room__"
    mat = trel.relation_matrix(torch.as_tensor(boxes, dtype=torch.float32))
    want = np.array([[trel.compute_rel_host_idx(boxes[i], boxes[j])
                      if i != j else -1 for j in range(n)]
                     for i in range(n)])
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(mat.numpy()[off], want[off])
