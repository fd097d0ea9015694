// sln_tpu_torch native host runtime (own copy of the JAX package's
// native.cpp; the same semantics, entry point for entry point).
//
// Host C++ with an `extern "C"` interface, no PyTorch headers:
//   * split_long_edges  — the role of PyMesh's C++ remesher (reference
//     models/misc.py:79 pymesh.split_long_edges_raw(v, f, 0.6)), so
//     per-face culling and class masks behave on long thin triangles:
//     per-triangle recursive longest-edge bisection (vertices duplicated
//     per triangle; connectivity is irrelevant for rasterization).
//   * cuboid_iou        — shapely/GEOS rotated-rect intersection
//     (reference testing/test_utils.py:33-40) via Sutherland–Hodgman.
//   * pack_rooms_json   — the host-side data loader: parses the reference
//     metadata JSON schema and emits padded arrays, replacing the
//     reference's per-item Python DataLoader work
//     (data/suncg_dataset.py:110-166).
//
// Built by g++ (-O3 -shared -fPIC -std=c++17) into sln_tpu_torch/_build/
// at first use and loaded with ctypes (sln_tpu_torch/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

extern "C" {

void native_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// 1. Edge-split remesher
// ---------------------------------------------------------------------------
namespace {

struct V3 {
  float x, y, z;
};

static inline V3 mid(const V3& a, const V3& b) {
  return V3{(a.x + b.x) * 0.5f, (a.y + b.y) * 0.5f, (a.z + b.z) * 0.5f};
}

static inline float d2(const V3& a, const V3& b) {
  float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  return dx * dx + dy * dy + dz * dz;
}

static void split_tri(const V3& a, const V3& b, const V3& c, float max2,
                      int depth, std::vector<V3>* out) {
  float ab = d2(a, b), bc = d2(b, c), ca = d2(c, a);
  if (depth <= 0 || (ab <= max2 && bc <= max2 && ca <= max2)) {
    out->push_back(a);
    out->push_back(b);
    out->push_back(c);
    return;
  }
  if (ab >= bc && ab >= ca) {
    V3 m = mid(a, b);
    split_tri(a, m, c, max2, depth - 1, out);
    split_tri(m, b, c, max2, depth - 1, out);
  } else if (bc >= ab && bc >= ca) {
    V3 m = mid(b, c);
    split_tri(a, b, m, max2, depth - 1, out);
    split_tri(a, m, c, max2, depth - 1, out);
  } else {
    V3 m = mid(c, a);
    split_tri(a, b, m, max2, depth - 1, out);
    split_tri(m, b, c, max2, depth - 1, out);
  }
}

}  // namespace

// Splits every triangle until all edges are <= max_len (like
// pymesh.split_long_edges_raw). Outputs unwelded triangle soup:
// out_verts (3 * out_nf * 3 floats), faces implicit [3i, 3i+1, 3i+2].
int split_long_edges(const float* verts, int64_t num_verts,
                     const int32_t* faces, int64_t num_faces, float max_len,
                     float** out_verts, int64_t* out_num_tris) {
  if (max_len <= 0) return -1;
  float max2 = max_len * max_len;
  std::vector<V3> out;
  out.reserve(static_cast<size_t>(num_faces) * 6);
  for (int64_t f = 0; f < num_faces; ++f) {
    int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= num_verts || i1 >= num_verts ||
        i2 >= num_verts)
      return -2;
    V3 a{verts[3 * i0], verts[3 * i0 + 1], verts[3 * i0 + 2]};
    V3 b{verts[3 * i1], verts[3 * i1 + 1], verts[3 * i1 + 2]};
    V3 c{verts[3 * i2], verts[3 * i2 + 1], verts[3 * i2 + 2]};
    split_tri(a, b, c, max2, /*depth=*/24, &out);
  }
  int64_t ntri = static_cast<int64_t>(out.size()) / 3;
  float* buf = static_cast<float*>(std::malloc(out.size() * 3 * sizeof(float)));
  if (!buf) return -3;
  for (size_t i = 0; i < out.size(); ++i) {
    buf[3 * i] = out[i].x;
    buf[3 * i + 1] = out[i].y;
    buf[3 * i + 2] = out[i].z;
  }
  *out_verts = buf;
  *out_num_tris = ntri;
  return 0;
}

// ---------------------------------------------------------------------------
// 2. Rotated-cuboid IoU (Sutherland–Hodgman)
// ---------------------------------------------------------------------------
namespace {

struct P2 {
  double x, y;
};

static double polygon_area(const std::vector<P2>& p) {
  double a = 0;
  for (size_t i = 0; i < p.size(); ++i) {
    const P2& u = p[i];
    const P2& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  return std::fabs(a) * 0.5;
}

static std::vector<P2> clip(const std::vector<P2>& poly, const P2& a,
                            const P2& b) {
  std::vector<P2> out;
  double dx = b.x - a.x, dy = b.y - a.y;
  auto side = [&](const P2& p) {
    return dx * (p.y - a.y) - dy * (p.x - a.x);
  };
  size_t n = poly.size();
  for (size_t i = 0; i < n; ++i) {
    const P2& cur = poly[i];
    const P2& nxt = poly[(i + 1) % n];
    double sc = side(cur), sn = side(nxt);
    if (sc >= 0) out.push_back(cur);
    if ((sc >= 0) != (sn >= 0)) {
      double t = sc / (sc - sn);
      out.push_back(P2{cur.x + t * (nxt.x - cur.x),
                       cur.y + t * (nxt.y - cur.y)});
    }
  }
  return out;
}

static std::vector<P2> make_ccw(const double* q) {
  std::vector<P2> p = {{q[0], q[1]}, {q[2], q[3]}, {q[4], q[5]},
                       {q[6], q[7]}};
  double a2 = 0;
  for (int i = 0; i < 4; ++i) {
    a2 += p[i].x * p[(i + 1) % 4].y - p[(i + 1) % 4].x * p[i].y;
  }
  if (a2 < 0) {
    std::vector<P2> r(p.rbegin(), p.rend());
    return r;
  }
  return p;
}

}  // namespace

// quad1/quad2: 8 doubles (4 xz corners); heights in y.
// Reference semantics: testing/test_utils.py:33-40 (+1e-5 denominator).
double cuboid_iou(const double* quad1, double y1min, double y1max,
                  const double* quad2, double y2min, double y2max) {
  std::vector<P2> a = make_ccw(quad1);
  std::vector<P2> b = make_ccw(quad2);
  std::vector<P2> inter = a;
  for (int i = 0; i < 4 && !inter.empty(); ++i) {
    inter = clip(inter, b[i], b[(i + 1) % 4]);
  }
  double inter2d = inter.empty() ? 0.0 : polygon_area(inter);
  double h = std::fmax(0.0, std::fmin(y1max, y2max) - std::fmax(y1min, y2min));
  double vol_i = inter2d * h;
  double v1 = polygon_area(a) * (y1max - y1min);
  double v2 = polygon_area(b) * (y2max - y2min);
  return vol_i / (v1 + v2 - vol_i + 1e-5);
}

// ---------------------------------------------------------------------------
// 3. Room-JSON scene packer (minimal JSON subset parser, no dependencies)
// ---------------------------------------------------------------------------
namespace json {

struct Value;
using Object = std::map<std::string, Value>;
using Array = std::vector<Value>;

struct Value {
  enum Kind { kNull, kNum, kStr, kObj, kArr, kBool } kind = kNull;
  double num = 0;
  std::string str;
  std::vector<std::pair<std::string, Value>> obj;
  std::vector<Value> arr;

  // the last occurrence of a repeated key, as json.loads keeps it
  const Value* find(const std::string& key) const {
    const Value* out = nullptr;
    for (const auto& kv : obj)
      if (kv.first == key) out = &kv.second;
    return out;
  }
};

// Adversarial input (fuzz) hardening: real-data users feed this parser
// untrusted room JSON, so every failure mode must be a clean -1, never
// UB — bounded recursion (a "[[[[..." bomb would otherwise smash the
// stack), bounded literal advances, and strict element-kind checks in
// pack_rooms_json below. tests/test_torch_native.py fuzz-tests all of it
// against json + tensorize_rooms.
constexpr int kMaxDepth = 192;

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool consume(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }

  // expects the literal `lit` at p (first char already matched)
  void literal(const char* lit, size_t len) {
    if (static_cast<size_t>(end - p) < len ||
        std::memcmp(p, lit, len) != 0) {
      ok = false;
      p = end;
      return;
    }
    p += len;
  }

  Value parse(int depth = 0) {
    ws();
    Value v;
    if (p >= end || depth > kMaxDepth) {
      ok = false;
      return v;
    }
    char c = *p;
    if (c == '{') {
      ++p;
      v.kind = Value::kObj;
      ws();
      if (p < end && *p == '}') {
        ++p;
        return v;
      }
      while (ok) {
        ws();
        Value key = parse_string();
        if (!ok) break;
        consume(':');
        Value val = parse(depth + 1);
        v.obj.emplace_back(key.str, std::move(val));
        ws();
        if (p < end && *p == ',') {
          ++p;
          continue;
        }
        consume('}');
        break;
      }
    } else if (c == '[') {
      ++p;
      v.kind = Value::kArr;
      ws();
      if (p < end && *p == ']') {
        ++p;
        return v;
      }
      while (ok) {
        v.arr.push_back(parse(depth + 1));
        ws();
        if (p < end && *p == ',') {
          ++p;
          continue;
        }
        consume(']');
        break;
      }
    } else if (c == '"') {
      return parse_string();
    } else if (c == 't') {
      v.kind = Value::kBool;
      v.num = 1;
      literal("true", 4);
    } else if (c == 'f') {
      v.kind = Value::kBool;
      literal("false", 5);
    } else if (c == 'n') {
      literal("null", 4);
    } else {
      v.kind = Value::kNum;
      number(v);
    }
    return v;
  }

  // a number token exactly as Python's json.loads takes it: the JSON
  // grammar -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)? or one of its
  // NaN, Infinity and -Infinity. strtod alone would also take +0.5, 01,
  // .5, 1., hex, inf and nan, which json.loads refuses.
  void number(Value& v) {
    const char* q = p;
    auto digits = [&]() {
      const char* s = q;
      while (q < end && *q >= '0' && *q <= '9') ++q;
      return q > s;
    };
    auto word = [&](const char* w, size_t n) {
      return static_cast<size_t>(end - q) >= n && std::memcmp(q, w, n) == 0;
    };
    if (q < end && *q == '-') ++q;
    if (word("Infinity", 8)) {
      v.num = (*p == '-' ? -1.0 : 1.0) * HUGE_VAL;
      p = q + 8;
      return;
    }
    if (q == p && word("NaN", 3)) {
      v.num = std::nan("");
      p = q + 3;
      return;
    }
    if (q < end && *q == '0') {
      ++q;
    } else if (!(q < end && *q >= '1' && *q <= '9') || !digits()) {
      ok = false;
      return;
    }
    if (q < end && *q == '.' && (++q, !digits())) {
      ok = false;
      return;
    }
    if (q < end && (*q == 'e' || *q == 'E')) {
      ++q;
      if (q < end && (*q == '+' || *q == '-')) ++q;
      if (!digits()) {
        ok = false;
        return;
      }
    }
    // the token is valid JSON, so strtod reads exactly it (the text it
    // stands in is not NUL-terminated, hence the copy)
    v.num = std::strtod(std::string(p, q).c_str(), nullptr);
    p = q;
  }

  Value parse_string() {
    Value v;
    v.kind = Value::kStr;
    ws();
    if (p >= end || *p != '"') {
      ok = false;
      return v;
    }
    ++p;
    while (p < end && *p != '"') {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c < 0x20) {  // raw control chars are invalid JSON
        ok = false;
        return v;
      }
      if (c == '\\') {
        if (p + 1 >= end) {
          ok = false;
          return v;
        }
        ++p;
        // strict JSON escape set — a lenient "pass anything through"
        // here once let a fuzzed key with "\," merge two objects into
        // data json.loads rejects (the mutation fuzz tests)
        switch (*p) {
          case '"': v.str.push_back('"'); break;
          case '\\': v.str.push_back('\\'); break;
          case '/': v.str.push_back('/'); break;
          case 'b': v.str.push_back('\b'); break;
          case 'f': v.str.push_back('\f'); break;
          case 'n': v.str.push_back('\n'); break;
          case 'r': v.str.push_back('\r'); break;
          case 't': v.str.push_back('\t'); break;
          case 'u': {
            if (end - p < 5) {
              ok = false;
              return v;
            }
            unsigned cp = 0;
            for (int i = 1; i <= 4; ++i) {
              char h = p[i];
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else { ok = false; return v; }
            }
            // ASCII escapes are decoded; anything beyond defers to the
            // Python path (the caller parses with json on -1) rather than
            // risking UTF-8/surrogate divergence from json.loads
            if (cp >= 0x80) {
              ok = false;
              return v;
            }
            v.str.push_back(static_cast<char>(cp));
            p += 4;
            break;
          }
          default:
            ok = false;
            return v;
        }
      } else {
        v.str.push_back(*p);
      }
      ++p;
    }
    if (p >= end) {  // unterminated string
      ok = false;
      return v;
    }
    ++p;
    return v;
  }
};

}  // namespace json

// Cheap O(n) scan counting keys at depth 1 of a JSON object: strings
// followed by ':' while brace/bracket depth == 1. Used by the Python
// binding to size the output arrays exactly (one key per room in the
// reference schema) instead of over-allocating.
int64_t count_top_level_keys(const char* text, int64_t text_len) {
  int64_t count = 0;
  int depth = 0;
  const char* p = text;
  const char* end = text + text_len;
  while (p < end) {
    char c = *p;
    if (c == '"') {
      const char* str_start = ++p;
      while (p < end && *p != '"') {
        if (*p == '\\') ++p;
        ++p;
      }
      (void)str_start;
      if (p < end) ++p;  // closing quote
      if (depth == 1) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r'))
          ++p;
        if (p < end && *p == ':') ++count;
      }
      continue;
    }
    if (c == '{' || c == '[') ++depth;
    else if (c == '}' || c == ']') --depth;
    ++p;
  }
  return count;
}

// Parses the reference room-JSON schema and fills padded arrays.
// class_names: '\n'-joined vocabulary (index = class id).
// Outputs (caller-allocated, sized for num_rooms x max_objects):
//   objs int32, boxes float32 (x6), angles int32, mask uint8,
//   room_ids int32. Returns number of rooms, or -1 on parse error.
int64_t pack_rooms_json(const char* text, int64_t text_len,
                        const char* class_names, int32_t max_objects,
                        int32_t* objs, float* boxes, int32_t* angles,
                        uint8_t* mask, int32_t* room_ids,
                        int64_t max_rooms) {
  json::Parser parser{text, text + text_len};
  json::Value root = parser.parse();
  parser.ws();
  if (!parser.ok || root.kind != json::Value::kObj ||
      parser.p != parser.end)  // trailing garbage after the root object
    return -1;

  std::map<std::string, int32_t> name_to_idx;
  {
    std::string names(class_names);
    size_t start = 0;
    int32_t idx = 0;
    while (start <= names.size()) {
      size_t nl = names.find('\n', start);
      if (nl == std::string::npos) nl = names.size();
      name_to_idx[names.substr(start, nl - start)] = idx++;
      start = nl + 1;
    }
  }

  // sort rooms by integer id (reference iterates sorted int keys); a
  // non-integer or out-of-int32 key is a schema error (the Python path
  // raises ValueError on int(key) — report -1 so the caller falls back
  // to that clean error instead of silently packing id 0). A std::map
  // keyed by id also reproduces json.loads' duplicate-key semantics
  // (last occurrence wins). Two different keys of one id ("1" and "01")
  // are two rooms to json.loads: report -1, and the caller's json path
  // packs both.
  std::map<long long, std::pair<const std::string*, const json::Value*>>
      room_map;
  for (const auto& kv : root.obj) {
    char* key_end = nullptr;
    long long id = std::strtoll(kv.first.c_str(), &key_end, 10);
    if (kv.first.empty() || key_end != kv.first.c_str() + kv.first.size() ||
        id < INT32_MIN || id > INT32_MAX)
      return -1;
    auto seen = room_map.find(id);
    if (seen != room_map.end() && *seen->second.first != kv.first)
      return -1;
    room_map[id] = {&kv.first, &kv.second};
  }
  std::vector<std::pair<long long, const json::Value*>> rooms;
  for (const auto& kv : room_map)  // map iteration is id-sorted
    rooms.emplace_back(kv.first, kv.second.second);

  int64_t n_rooms = 0;
  const int O = max_objects;
  for (const auto& room_kv : rooms) {
    if (n_rooms >= max_rooms) break;
    const json::Value& room = *room_kv.second;
    if (room.kind != json::Value::kObj) return -1;
    const json::Value* vobjs = room.find("valid_objects");
    const json::Value* bbox = room.find("bbox");
    if (!vobjs || vobjs->kind != json::Value::kArr || !bbox ||
        bbox->kind != json::Value::kArr || bbox->arr.size() != 3)
      return -1;
    for (int i = 0; i < 3; ++i)
      if (bbox->arr[i].kind != json::Value::kNum) return -1;
    double X = bbox->arr[0].num, Y = bbox->arr[1].num, Z = bbox->arr[2].num;
    int64_t r = n_rooms;
    room_ids[r] = static_cast<int32_t>(room_kv.first);
    std::memset(objs + r * O, 0, O * sizeof(int32_t));
    std::memset(angles + r * O, 0, O * sizeof(int32_t));
    std::memset(mask + r * O, 0, O);
    std::memset(boxes + r * O * 6, 0, O * 6 * sizeof(float));

    int n = 0;
    for (const auto& item : vobjs->arr) {
      if (n >= O - 1) break;
      if (item.kind != json::Value::kObj) return -1;
      const json::Value* type = item.find("type");
      const json::Value* nb = item.find("new_bbox");
      const json::Value* rot = item.find("rotation");
      if (!type || type->kind != json::Value::kStr || !nb ||
          nb->kind != json::Value::kArr || nb->arr.size() != 2 ||
          nb->arr[0].kind != json::Value::kArr ||
          nb->arr[1].kind != json::Value::kArr ||
          nb->arr[0].arr.size() != 3 || nb->arr[1].arr.size() != 3 ||
          !rot || rot->kind != json::Value::kNum)
        return -1;
      for (int i = 0; i < 3; ++i)
        if (nb->arr[0].arr[i].kind != json::Value::kNum ||
            nb->arr[1].arr[i].kind != json::Value::kNum)
          return -1;
      auto it = name_to_idx.find(type->str);
      // the Python path raises KeyError on an unknown class name; match
      // it with a clean error instead of silently dropping the object
      if (it == name_to_idx.end()) return -1;
      objs[r * O + n] = it->second;
      const auto& lo = nb->arr[0].arr;
      const auto& hi = nb->arr[1].arr;
      float* bx = boxes + (r * O + n) * 6;
      bx[0] = static_cast<float>(lo[0].num / X);
      bx[1] = static_cast<float>(lo[1].num / Y);
      bx[2] = static_cast<float>(lo[2].num / Z);
      bx[3] = static_cast<float>(hi[0].num / X);
      bx[4] = static_cast<float>(hi[1].num / Y);
      bx[5] = static_cast<float>(hi[2].num / Z);
      // double->int cast of a NaN/huge rotation is UB; the schema means
      // a small integer, so anything else is a parse error
      double rot_d = rot->num;
      if (!(rot_d >= -1e9 && rot_d <= 1e9)) return -1;
      int rot_i = static_cast<int>(rot_d);
      angles[r * O + n] = ((rot_i % 24) + 24) % 24;
      mask[r * O + n] = 1;
      ++n;
    }
    // __room__ node last (absolute box)
    objs[r * O + n] = 0;
    float* bx = boxes + (r * O + n) * 6;
    bx[0] = bx[1] = bx[2] = 0.f;
    bx[3] = static_cast<float>(X);
    bx[4] = static_cast<float>(Y);
    bx[5] = static_cast<float>(Z);
    angles[r * O + n] = 0;
    mask[r * O + n] = 1;
    ++n_rooms;
  }
  return n_rooms;
}

}  // extern "C"
