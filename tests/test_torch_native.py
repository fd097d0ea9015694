"""The port's native host runtime (sln_tpu_torch/native.py over
sln_tpu_torch/csrc/native.cpp, built by g++ at first use) against the JAX
package's library (sln_tpu/native.py over the committed
sln_tpu/cpp/libsln_native.so) and against the port's plain Python
versions: the build, the edge splitter, the cuboid IoU, the key counter,
the JSON packer (fuzzed), tensorize_file, the CLI's JSON path and the
synthetic-data disk cache."""

import ctypes
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from sln_tpu import native as jnative
from sln_tpu.data import synthetic as jsyn, tensorize as jtens
from sln_tpu.data.vocab import VOCAB as JVOCAB
from sln_tpu.ops import iou as jiou
from sln_tpu_torch import native
from sln_tpu_torch.data import tensorize
from sln_tpu_torch.ops import iou as tiou

torch.set_num_threads(2)

PORT = pathlib.Path(native.__file__).resolve().parent
ARRAY_KEYS = ("objs", "boxes", "angles", "obj_mask", "room_ids")


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def test_library_builds_from_the_port_sources_with_gxx():
    """g++ (or c++) from PATH, -O3 -shared -fPIC -std=c++17 and no
    -march=native, the port's own csrc/native.cpp, into _build/ under a
    fingerprinted name; every entry point's argtypes declared."""
    path = native.build()
    assert path.parent == PORT / "_build" and path.is_file()
    assert path.name.startswith("libsln_native_")
    cmd = native.build_command(path)
    assert os.path.basename(cmd[0]) in ("g++", "c++")
    assert "-march=native" not in cmd
    assert set(native.CXX_FLAGS) == {"-O3", "-shared", "-fPIC",
                                     "-std=c++17"}
    sources = [a for a in cmd if a.endswith(".cpp")]
    assert sources == [str(PORT / "csrc" / "native.cpp")]
    for arg in cmd[1:]:
        if os.sep in arg:
            assert pathlib.Path(arg).resolve().is_relative_to(PORT), arg
    lib = native.load()
    for fn in ("split_long_edges", "cuboid_iou", "count_top_level_keys",
               "pack_rooms_json", "native_free"):
        assert getattr(lib, fn).argtypes, fn
    assert lib.cuboid_iou.restype is ctypes.c_double


def test_failed_build_raises_with_the_compiler_log(monkeypatch, tmp_path):
    """No Python fallback hides a broken build: it raises with the log."""
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libsln_native_x.so")
    monkeypatch.setattr(native, "build_command", lambda out: [
        "sh", "-c", "echo 'native.cpp:1: error: boom' >&2; exit 3"])
    with pytest.raises(RuntimeError, match="boom"):
        native.build()
    assert not list(tmp_path.iterdir())       # no stub library left


# ---------------------------------------------------------------------------
# the edge splitter
# ---------------------------------------------------------------------------
def _f32_fma(a, b, c):
    """float32 fma(a, b, c): the product of two float32s is exact in
    float64, so one rounding of the float64 sum."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def split_contracted(verts, faces, max_len):
    """split_long_edges_py with each squared edge length contracted as
    fma(dz, dz, fma(dx, dx, dy * dy)), as the committed JAX library (built
    with -march=native, so with FMA contraction) computes it (the order
    found by trying all six on the asset corpus)."""
    max2 = np.float32(max_len) * np.float32(max_len)
    out = []

    def d2(a, b):
        dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
        return _f32_fma(dz, dz, _f32_fma(dx, dx, dy * dy))

    def rec(a, b, c, depth):
        ab, bc, ca = d2(a, b), d2(b, c), d2(c, a)
        if depth <= 0 or (ab <= max2 and bc <= max2 and ca <= max2):
            out.extend([a, b, c])
            return
        half = np.float32(0.5)
        if ab >= bc and ab >= ca:
            m = (a + b) * half
            rec(a, m, c, depth - 1)
            rec(m, b, c, depth - 1)
        elif bc >= ab and bc >= ca:
            m = (b + c) * half
            rec(a, b, m, depth - 1)
            rec(a, m, c, depth - 1)
        else:
            m = (c + a) * half
            rec(a, b, m, depth - 1)
            rec(m, b, c, depth - 1)

    for f in faces:
        rec(verts[f[0]], verts[f[1]], verts[f[2]], 24)
    return np.asarray(out, np.float32)


def _box_mesh(lo, hi):
    """An axis-aligned box as 12 triangles: many equal edge lengths."""
    c = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])], np.float32)
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 3, 7, 5)]
    f = [[a, b, c_] for a, b, c_, _ in quads] + [[a, c_, d]
                                                 for a, _, c_, d in quads]
    return c, np.asarray(f, np.int32)


def _check_split(v, f, max_len, area):
    tri = v[f]
    got = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                  tri[:, 2] - tri[:, 0]), axis=1).sum() / 2
    np.testing.assert_allclose(got, area, rtol=1e-5)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        assert np.linalg.norm(tri[:, a] - tri[:, b], axis=1).max() <= \
            max_len + 1e-5


def _area(verts, faces):
    tri = np.asarray(verts, np.float64)[faces]
    return np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0]), axis=1).sum() / 2


def test_split_long_edges_matches_jax_and_python_on_general_meshes():
    """Tolerance: bitwise. On the JAX test's triangle and on 30 random
    meshes in general position the port's C++, its Python version and the
    JAX library give the same vertices bit for bit; area kept to rtol 1e-5,
    every edge <= max_len + 1e-5."""
    cases = [(np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32),
              np.array([[0, 1, 2]], np.int32), 0.5)]
    rng = np.random.default_rng(1)
    for _ in range(30):
        cases.append((rng.uniform(-2, 2, (12, 3)).astype(np.float32),
                      rng.integers(0, 12, (10, 3)).astype(np.int32),
                      float(rng.uniform(0.1, 1.0))))
    for verts, faces, max_len in cases:
        v, f = native.split_long_edges(verts, faces, max_len)
        v_py, f_py = native.split_long_edges_py(verts, faces, max_len)
        v_j, f_j = jnative.split_long_edges(verts, faces, max_len)
        assert f.dtype == np.int32 and v.dtype == np.float32
        np.testing.assert_array_equal(f, f_py)
        np.testing.assert_array_equal(f, f_j)
        np.testing.assert_array_equal(v, v_py)
        np.testing.assert_array_equal(v, v_j)
        _check_split(v, f, max_len, _area(verts, faces))
    assert len(native.split_long_edges(*cases[0])[1]) > 8


@pytest.mark.parametrize("max_len", [0.13, 0.35, 0.6])
def test_split_long_edges_on_ties_differs_from_jax_only_by_its_fma(max_len):
    """On axis-aligned boxes (the asset corpus) edges tie in length, and
    the committed JAX library, built with -march=native, contracts the
    squared lengths into FMAs; a tie can then go the other way. Tolerances:
    the port's C++ equals its Python version bit for bit; the JAX library
    equals that Python version with the lengths contracted, bit for bit
    (so the FMA is the whole difference); both give the same face count,
    the area to rtol 1e-5 and every edge <= max_len + 1e-5."""
    for lo, hi in (((0, 0.2, 0), (2.0, 0.5, 1.6)),
                   ((0.05, 0.5, 0.05), (1.95, 0.75, 1.55)),
                   ((0, 0, 0), (4.0, 2.6, 5.0))):
        verts, faces = _box_mesh(lo, hi)
        v, f = native.split_long_edges(verts, faces, max_len)
        v_py, _ = native.split_long_edges_py(verts, faces, max_len)
        v_j, f_j = jnative.split_long_edges(verts, faces, max_len)
        np.testing.assert_array_equal(v, v_py)
        np.testing.assert_array_equal(v_j, split_contracted(verts, faces,
                                                            max_len))
        assert f.shape == f_j.shape
        for vv, ff in ((v, f), (v_j, f_j)):
            _check_split(vv, ff, max_len, _area(verts, faces))


def test_split_long_edges_rejects_bad_input():
    """Where the C++ returns an error code the binding raises (the JAX
    binding would fall back to Python)."""
    verts = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        native.split_long_edges(verts, np.array([[0, 1, 5]], np.int32), 0.5)
    with pytest.raises(ValueError):
        native.split_long_edges(verts, np.array([[0, 1, 2]], np.int32), 0.0)
    v, f = native.split_long_edges(verts, np.zeros((0, 3), np.int32), 0.5)
    assert v.shape == (0, 3) and f.shape == (0, 3)


# ---------------------------------------------------------------------------
# the cuboid IoU
# ---------------------------------------------------------------------------
def rand_quad(rng):
    cx, cz = rng.uniform(0, 3, 2)
    w, h = rng.uniform(0.3, 2.0, 2)
    th = rng.uniform(0, np.pi)
    c, s = np.cos(th), np.sin(th)
    base = np.array([[-w, -h], [-w, h], [w, h], [w, -h]]) / 2
    return base @ np.array([[c, -s], [s, c]]) + [cx, cz]


def test_cpp_cuboid_iou_matches_jax_and_torch_on_200_pairs():
    """Tolerance 1e-4 (the JAX package's own, tests/test_native.py:52): the
    port's float64 C++ against the JAX package's float32 ops/iou and
    against the port's torch version; the two C++ builds within 1e-12."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    qa = np.stack([rand_quad(rng) for _ in range(200)])
    qb = np.stack([rand_quad(rng) for _ in range(200)])
    y1 = rng.uniform(0, 0.5, (200, 2)).cumsum(-1)
    y2 = rng.uniform(0, 0.5, (200, 2)).cumsum(-1)
    got = np.array([native.cuboid_iou(qa[i], y1[i], qb[i], y2[i])
                    for i in range(200)])
    want = np.asarray(jax.vmap(jiou.cuboid_iou)(
        jnp.asarray(qa, jnp.float32), jnp.asarray(y1[:, 0], jnp.float32),
        jnp.asarray(y1[:, 1], jnp.float32), jnp.asarray(qb, jnp.float32),
        jnp.asarray(y2[:, 0], jnp.float32),
        jnp.asarray(y2[:, 1], jnp.float32)))
    t = tiou.cuboid_iou(torch.as_tensor(qa, dtype=torch.float32),
                        torch.as_tensor(y1[:, 0]), torch.as_tensor(y1[:, 1]),
                        torch.as_tensor(qb, dtype=torch.float32),
                        torch.as_tensor(y2[:, 0]), torch.as_tensor(y2[:, 1]))
    assert (got > 0.01).sum() > 30             # overlapping pairs exercised
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got - t.numpy()).max() <= 1e-4
    j = np.array([jnative.cuboid_iou(qa[i], y1[i], qb[i], y2[i])
                  for i in range(20)])
    assert np.abs(got[:20] - j).max() <= 1e-12
    py = np.array([native.cuboid_iou_py(qa[i], y1[i], qb[i], y2[i])
                   for i in range(20)])
    assert np.abs(got[:20] - py).max() <= 1e-4


def test_cpp_cuboid_iou_golden_values():
    """Analytic values within 1e-4: a unit square against itself turned
    45 degrees (0.7071067), a 2 x 1 rectangle against itself turned 90
    degrees (1/3), and the same footprint with half the y overlap (2/6)."""
    sq = np.array([[-.5, -.5], [-.5, .5], [.5, .5], [.5, -.5]])
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    rot = sq @ np.array([[c, -s], [s, c]])
    assert abs(native.cuboid_iou(sq, (0.0, 1.0), rot, (0.0, 1.0))
               - 0.7071067) < 1e-4
    rect = np.array([[-1., -.5], [-1., .5], [1., .5], [1., -.5]])
    rot90 = rect[:, ::-1].copy()
    assert abs(native.cuboid_iou(rect, (0.0, 2.0), rot90, (0.0, 2.0))
               - 1.0 / 3.0) < 1e-4
    assert abs(native.cuboid_iou(rect, (0.0, 2.0), rect, (1.0, 3.0))
               - 2.0 / 6.0) < 1e-4


# ---------------------------------------------------------------------------
# the key counter and the packer
# ---------------------------------------------------------------------------
KEY_CASES = [
    json.dumps({"1": {"a": [1, 2], "b": {"c": "d:e"}},
                "2": {"x": 'he said "y": no'}, "3": []}),
    "{}",
    '{"k": "v\\"x\\": w"}',          # a value string holding '":'
    '{"a": {"b": {"c": 1}}, "d": [{"e": 2}], "f": "\\\\"}',
    '{"1": 1, "2" : 2, "3"\n:\t3}',
    "[1, 2]", "", '"lonely": 1',
]


@pytest.mark.parametrize("text", KEY_CASES)
def test_count_top_level_keys_matches_jax(text):
    """Equal to the JAX library's count and to the Python version."""
    n = native.count_top_level_keys(text)
    assert n == jnative.count_top_level_keys(text)
    assert n == native.count_top_level_keys_py(text)


def test_count_top_level_keys_values():
    assert [native.count_top_level_keys(t) for t in KEY_CASES[:3]] == [3, 0,
                                                                        1]


def _python_pack(text, max_objects=16):
    """json + tensorize_rooms, or the exception class it raises."""
    try:
        return tensorize.tensorize_rooms(json.loads(text), max_objects)
    except Exception as e:
        return type(e)


def _check_against_jax(text, max_objects=16):
    """Never crash; the same accept or reject as the JAX packer; bit-equal
    arrays where both accept, and equal to json + tensorize_rooms."""
    got = native.pack_rooms(text, max_objects)
    want = jnative.pack_rooms(text, max_objects)
    assert (got is None) == (want is None), text[:200]
    if got is None:
        return "rejected"
    for k in ARRAY_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    py = _python_pack(text, max_objects)
    assert isinstance(py, dict), (
        f"the packer took a text json + tensorize_rooms reject "
        f"({py.__name__}): {text[:200]!r}")
    np.testing.assert_array_equal(got["objs"], py["objs"])
    np.testing.assert_allclose(got["boxes"], py["boxes"], rtol=1e-6,
                               equal_nan=True)
    for k in ("angles", "obj_mask", "room_ids"):
        np.testing.assert_array_equal(got[k], py[k], err_msg=k)
    return "accepted"


ADVERSARIAL = [
    "", "{", "[1, 2, 3]", "null", "true", "tru", "nul", "fals",
    '{"1": ' + "[" * 100_000,                        # a nesting bomb
    '{"1": ' + "[" * 100_000 + "]" * 100_000 + "}",
    '{"1": {}}',
    '{"1": {"bbox": [1, 2, 3]}}',
    '{"1": {"bbox": 3, "valid_objects": []}}',
    '{"1": {"bbox": [1, 2], "valid_objects": []}}',
    '{"1": {"bbox": [1, 2, 3, 4], "valid_objects": []}}',
    '{"1": {"bbox": ["a", "b", "c"], "valid_objects": []}}',
    '{"1": {"bbox": [1, 2, 3], "valid_objects": 7}}',
    '{"not_an_int": {"bbox": [1, 2, 3], "valid_objects": []}}',
    '{"99999999999999999999": {"bbox": [1,2,3], "valid_objects": []}}',
    '{"1": {"bbox": [1e400, 2, 3], "valid_objects": []}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [5]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed"}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed", '
    '"new_bbox": [[0,0,0]], "rotation": 0}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed", '
    '"new_bbox": [[0,0],[1,1,1]], "rotation": 0}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed", '
    '"new_bbox": [[0,0,0],[1,1,"x"]], "rotation": 0}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed", '
    '"new_bbox": [[0,0,0],[1,1,1]]}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed", '
    '"new_bbox": [[0,0,0],[1,1,1]], "rotation": 1e300}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": "bed", '
    '"new_bbox": [[0,0,0],[1,1,1]], "rotation": "NaN"}]}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": [{"type": '
    '"no_such_class", "new_bbox": [[0,0,0],[1,1,1]], "rotation": 0}]}}',
    '{"1": "' + "x" * 1_000_000 + '"}',
    '{"\\u0000weird": {"bbox": [1,2,3], "valid_objects": []}}',
    '{"1": {"bbox": [1,2,3], "valid_objects": []}} trailing garbage',
    '{"1": {"bbox": [1,2,3], "valid_objects": []}}' + "\xff\xfe",
    # valid JSON the packer leaves to json: a non-ASCII escape
    '{"1": {"bbox": [1,2,3], "valid_objects": [], "n": "\\u00e9"}}',
    # valid and taken: duplicate keys (the last wins, as in json.loads)
    '{"1": {"bbox": [1,2,3], "valid_objects": []}, '
    '"1": {"bbox": [4,5,6], "valid_objects": []}}',
]


def test_packer_adversarial_cases_match_jax():
    results = [_check_against_jax(t) for t in ADVERSARIAL]
    assert "accepted" not in results[:5], results[:5]
    assert results[-2:] == ["rejected", "accepted"]


_ROOM = ('{"bbox": [1, 2, 3], "valid_objects": [{"type": "bed", '
         '"new_bbox": [[0, 0, 0], [%s, 1, 1]], "rotation": 3}]}')
# texts on which the JAX library (strtod numbers, rooms keyed by int(key))
# and json + tensorize_rooms part: the port's packer follows json
GRAMMAR_CASES = (
    [('{"1": %s}' % (_ROOM % num), ok) for num, ok in [
        ("+0.5", False), ("01", False), ("00", False), ("0x1", False),
        (".5", False), ("1.", False), ("1e", False), ("-", False),
        ("inf", False), ("-inf", False), ("nan", False), ("-NaN", False),
        ("NaN", True), ("Infinity", True), ("-Infinity", True),
        ("-0", True), ("1E+5", True), ("-1.5e-3", True)]]
    + [('{"1": %s, "01": %s}' % (_ROOM % 1, _ROOM % 2), False),
       ('{"01": %s, "1": %s, "2": %s}' % (_ROOM % 1, _ROOM % 2, _ROOM % 3),
        False),
       # a repeated key inside a room: json.loads keeps the last
       ('{"1": {"bbox": [1, 2, 3], "bbox": [4, 5, 6], '
        '"valid_objects": []}}', True)])


@pytest.mark.parametrize("text,packed", GRAMMAR_CASES)
def test_packer_takes_exactly_what_json_takes(text, packed, tmp_path):
    """The packer accepts a text only as json.loads parses it and packs it
    as tensorize_rooms does; a text it refuses goes through
    tensorize_file's json path, which gives json's rooms or json's
    error."""
    got = native.pack_rooms(text, 8)
    assert (got is not None) == packed, text
    py = _python_pack(text, 8)
    path = tmp_path / "rooms.json"
    path.write_text(text)
    if isinstance(py, type):
        assert got is None
        with pytest.raises(py):
            tensorize.tensorize_file(str(path), 8)
        return
    for arrays in ([got] if packed else []) + [
            tensorize.tensorize_file(str(path), 8)]:
        for k in ARRAY_KEYS:
            assert arrays[k].dtype == py[k].dtype, k
            np.testing.assert_array_equal(arrays[k], py[k], err_msg=k)


def test_packer_repeated_room_ids_fall_back_to_two_rooms(tmp_path):
    path = tmp_path / "rooms.json"
    path.write_text('{"1": %s, "01": %s}' % (_ROOM % 1, _ROOM % 2))
    got = tensorize.tensorize_file(str(path), 8)
    assert got["room_ids"].tolist() == [1, 1]
    assert got["boxes"][:, 0, 3].tolist() == [1.0, 2.0]


def test_packer_mutations_match_jax():
    """300 byte flips, truncations and splices of valid room JSON."""
    base = json.dumps(jsyn.generate_rooms(6, seed=11))
    rng = np.random.default_rng(0)
    outcomes = []
    for trial in range(300):
        b = bytearray(base.encode())
        kind = trial % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 9))):
                b[int(rng.integers(len(b)))] = int(rng.integers(32, 127))
        elif kind == 1:
            b = b[: int(rng.integers(len(b)))]
        else:
            i = int(rng.integers(len(b)))
            j = int(rng.integers(i, min(i + 64, len(b))))
            b[i:j] = bytes(rng.integers(32, 127, size=j - i, dtype=np.uint8))
        outcomes.append(_check_against_jax(
            b.decode("utf-8", errors="replace")))
    assert outcomes.count("rejected") > 50
    assert outcomes.count("accepted") > 0


def test_packer_random_valid_rooms_match_jax():
    """Schema-shaped rooms with extreme values (giant coordinates, rooms
    past max_objects, negative rotations and ids): accepted, bit-equal."""
    names = [n for n in JVOCAB.object_name_to_idx if n != "__room__"]
    rng = np.random.default_rng(7)
    for trial in range(60):
        data = {}
        for r in range(int(rng.integers(0, 5))):
            objs = [{"type": str(rng.choice(names)),
                     "new_bbox": [rng.uniform(-1e6, 1e6, 3).round(3).tolist(),
                                  rng.uniform(-1e6, 1e6, 3).round(3).tolist()],
                     "rotation": int(rng.integers(-100, 100))}
                    for _ in range(int(rng.integers(0, 24)))]
            data[str(int(rng.integers(-1000, 1000)) * 1000 + r)] = {
                "bbox": rng.uniform(0.1, 100, 3).round(3).tolist(),
                "valid_objects": objs}
        assert _check_against_jax(json.dumps(data)) == "accepted"


def test_packer_sizes_by_room_count():
    """A 20,000-room file: exactly 20,000 rows, equal to JAX's."""
    base = list(jsyn.generate_rooms(16, seed=5).values())
    text = json.dumps({str(i): base[i % 16] for i in range(20_000)})
    assert native.count_top_level_keys(text) == 20_000
    got = native.pack_rooms(text, 16)
    want = jnative.pack_rooms(text, 16)
    assert got["objs"].shape == (20_000, 16)
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# tensorize_file, the CLI's JSON path, the data cache
# ---------------------------------------------------------------------------
def _write_rooms(path, n=24, seed=3):
    rooms = jsyn.generate_rooms(n, seed=seed)
    with open(path, "w") as f:
        json.dump(rooms, f)
    return rooms


@pytest.mark.parametrize("max_objects", [12, 16, 32])
def test_tensorize_file_matches_jax_bitwise(tmp_path, max_objects):
    path = tmp_path / "rooms.json"
    _write_rooms(path)
    got = tensorize.tensorize_file(str(path), max_objects)
    want = jtens.tensorize_file(str(path), max_objects)
    for k in ARRAY_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tensorize_file_parses_what_the_packer_rejects(tmp_path):
    """A text the packer rejects but json takes goes through
    tensorize_rooms, as in the JAX package; one neither takes raises."""
    path = tmp_path / "escaped.json"
    path.write_text('{"3": {"bbox": [2, 3, 4], "valid_objects": [{"type": '
                    '"bed", "new_bbox": [[0, 0, 0], [1, 1, 1]], '
                    '"rotation": 30, "note": "caf\\u00e9"}]}}')
    assert native.pack_rooms(path.read_text(), 8) is None
    got = tensorize.tensorize_file(str(path), 8)
    want = jtens.tensorize_file(str(path), 8)
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["angles"][0, 0] == 6
    bad = tmp_path / "bad.json"
    bad.write_text('{"1": {"bbox": [1, 2')
    with pytest.raises(json.JSONDecodeError):
        tensorize.tensorize_file(str(bad), 8)
    with pytest.raises(json.JSONDecodeError):
        jtens.tensorize_file(str(bad), 8)


def test_denormalize_boxes_matches_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 1, (3, 8, 6)).astype(np.float32)
    room = np.zeros((3, 8), bool)
    room[:, 5] = True
    boxes[:, 5] = [0, 0, 0, 4.0, 2.6, 5.0]
    np.testing.assert_array_equal(tensorize.denormalize_boxes(boxes, room),
                                  jtens.denormalize_boxes(boxes, room))


def test_cli_json_path_goes_through_the_packer(tmp_path, monkeypatch):
    """`python -m sln_tpu_torch.test --suncg_train_dir/--suncg_val_dir`
    reads both files through the C++ packer."""
    from sln_tpu_torch import test as entry

    path = tmp_path / "rooms.json"
    _write_rooms(path, n=8)
    calls = []
    real = native.pack_rooms

    def spy(text, max_objects, *a):
        out = real(text, max_objects, *a)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(native, "pack_rooms", spy)
    out = entry.main(["--batch_gen", "--suncg_train_dir", str(path),
                      "--suncg_val_dir", str(path), "--allow_random_weights",
                      "--embedding_dim", "16", "--gconv_num_layers", "2",
                      "--test_dir", str(tmp_path / "o"), "--device", "cpu"])
    assert calls == [True, True]
    assert os.path.isfile(out)


def test_synthetic_cache_reads_back_and_can_be_disabled(tmp_path,
                                                        monkeypatch):
    """A second load_arrays(int) reads the .npz (the generator is not
    called again) and gives equal arrays; SLN_TPU_DATA_CACHE=0 writes
    nothing; the default directory is the port's own."""
    from sln_tpu_torch.config import default_config
    from sln_tpu_torch.data import synthetic
    from sln_tpu_torch.workloads import common

    cfg = default_config()
    monkeypatch.setenv("SLN_TPU_DATA_CACHE", str(tmp_path / "cache"))
    first, _ = common.load_arrays(6, cfg, "cpu", synthetic_seed=4)
    files = list((tmp_path / "cache").iterdir())
    assert len(files) == 1 and files[0].name.startswith("syn_6_4_32_")

    def boom(*a, **k):
        raise AssertionError("regenerated instead of reading the cache")

    monkeypatch.setattr(synthetic, "generate_rooms", boom)
    second = common._synthetic_arrays_cached(6, 4, cfg.data.max_objects)
    for k in ARRAY_KEYS:
        assert second[k].dtype == first[k].dtype
        np.testing.assert_array_equal(second[k], first[k], err_msg=k)
    monkeypatch.undo()

    want = jtens.tensorize_rooms(jsyn.generate_rooms(6, seed=4), 32)
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(first[k], want[k], err_msg=k)

    monkeypatch.setattr(common.tempfile, "tempdir", str(tmp_path / "tmp"))
    monkeypatch.setenv("SLN_TPU_DATA_CACHE", "0")
    (tmp_path / "tmp").mkdir()
    off, _ = common.load_arrays(6, cfg, "cpu", synthetic_seed=4)
    np.testing.assert_array_equal(off["boxes"], first["boxes"])
    assert not list((tmp_path / "tmp").iterdir())
    monkeypatch.delenv("SLN_TPU_DATA_CACHE")
    assert common.synthetic_cache_dir() == str(
        tmp_path / "tmp" / "sln_tpu_torch_data_cache")
