"""PNG and GIF files with numpy and the standard library only.

The card's machine has neither matplotlib nor imageio, so the port writes
and reads its images here:

* `write_png`: an 8-bit PNG of a (H, W) gray, (H, W, 2) gray + alpha,
  (H, W, 3) RGB or (H, W, 4) RGBA uint8 array;
* `write_png_gray`: what matplotlib's `imsave(path, a, cmap="gray")` writes
  for a 2-D float array (min/max normalisation, the gray colormap's
  256-entry table, RGBA);
* `write_gif`: one 8-bit grayscale frame, LZW-coded, with the palette
  Pillow writes for `imageio.imwrite(path, uint8_2d)` (the used gray
  levels in ascending order), so both decode to the same pixels;
* `read_png`: 8-bit, non-interlaced gray, gray + alpha, RGB or RGBA files
  with any of the five filter types (what matplotlib, Pillow and Blender
  write), returned in imageio's layout: (H, W) for gray, else (H, W, C).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W) or (H, W, C) uint8, C in 1..4 -> an 8-bit PNG. Every
    scanline has filter type 0 (none)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1 to 4 channels, got {c}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              _COLOR_TYPE[c], 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def _gray_lut() -> np.ndarray:
    """matplotlib's "gray" colormap as bytes: its 256-entry table, built
    as LinearSegmentedColormap builds it (linear from 0 to 1), times 255
    and truncated."""
    n = 256
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    mid = (xind[1:-1] - 0.0) / (255.0 - 0.0) * (1.0 - 0.0) + 0.0
    lut = np.clip(np.concatenate([[0.0], mid, [1.0]]), 0.0, 1.0)
    return (lut * 255).astype(np.uint8)


_GRAY_LUT = _gray_lut()


def _gray_rgba(a: np.ndarray) -> np.ndarray:
    """(H, W) float -> (H, W, 4) uint8 as matplotlib maps it through
    Normalize() and the gray colormap: (a - min) / (max - min) in float64
    scalars stored to the array's dtype, times 256, truncated; 1.0 maps to
    the top entry, below 0 to black, above 1 to white, NaN to transparent
    black."""
    a = np.asarray(a)
    if a.dtype.kind != "f":
        a = a.astype(np.float32 if a.dtype.itemsize <= 2 else np.float64)
    x = np.array(a, copy=True)
    vmin, vmax = float(x.min()), float(x.max())
    if vmin == vmax:
        x.fill(0)
    else:
        x -= np.float64(vmin)
        x /= np.float64(vmax) - np.float64(vmin)
    x *= 256
    x[x == 256] = 255
    under, over, bad = x < 0, x >= 256, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    gray = _GRAY_LUT[np.clip(idx, 0, 255)]
    gray[under] = 0
    gray[over] = 255
    out = np.repeat(gray[..., None], 4, -1)
    out[..., 3] = 255
    out[bad] = 0
    return out


def write_png_gray(path: str, a: np.ndarray) -> None:
    """A 2-D float array as matplotlib's imsave(path, a, cmap="gray")
    writes it: an RGBA PNG of the same pixels."""
    write_png(path, _gray_rgba(a))


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------
def _lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF's variable-length LZW code of a palette-index stream (codes of
    min_code_size + 1 to 12 bits, least significant bit first; a clear
    code starts the stream and restarts it when the table is full)."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    acc = nacc = 0
    bits = min_code_size + 1
    next_code = eoi + 1
    table = {}

    def emit(code):
        nonlocal acc, nacc, bits
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
        # a code that the next entry cannot fit widens the codes after it
        if next_code >= (1 << bits) and bits < 12:
            bits += 1

    emit(clear)
    data = indices.tolist()
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        prefix = k
        if next_code >= 4095:
            emit(clear)
            table.clear()
            next_code = eoi + 1
            bits = min_code_size + 1
        else:
            table[key] = next_code
            next_code += 1
    emit(prefix)
    emit(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, a: np.ndarray) -> None:
    """(H, W) uint8 -> a one-frame GIF. The palette holds the used gray
    levels in ascending order, zero-padded to max(4, 2^ceil(log2 n))
    entries, as Pillow's GIF writer builds it for a grayscale image."""
    a = np.ascontiguousarray(a, np.uint8)
    if a.ndim != 2:
        raise ValueError(f"write_gif takes a 2-D array, got {a.shape}")
    h, w = a.shape
    used, idx = np.unique(a, return_inverse=True)
    entries = max(4, 1 << math.ceil(math.log2(len(used))))
    size_code = int(math.log2(entries)) - 1
    palette = np.zeros((entries, 3), np.uint8)
    palette[:len(used)] = used[:, None]
    min_code_size = max(2, size_code + 1)
    code = _lzw(idx.reshape(-1).astype(np.int64), min_code_size)
    blocks = b"".join(bytes([len(code[i:i + 255])]) + code[i:i + 255]
                      for i in range(0, len(code), 255))
    with open(path, "wb") as f:
        f.write(b"GIF87a" + struct.pack("<HHBBB", w, h, 0x80 | size_code,
                                        0, 0)
                + palette.tobytes()
                + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
                + bytes([min_code_size]) + blocks + b"\x00;")


# ---------------------------------------------------------------------------
# PNG reading
# ---------------------------------------------------------------------------
def _unfilter_slow(ftype: int, raw: bytes, prior: bytes, bpp: int
                   ) -> bytearray:
    """Average (3) and Paeth (4): each byte needs its decoded left
    neighbour, so they run byte by byte."""
    out = bytearray(raw)
    n = len(out)
    for i in range(n):
        left = out[i - bpp] if i >= bpp else 0
        up = prior[i]
        if ftype == 3:
            out[i] = (out[i] + ((left + up) >> 1)) & 0xFF
        else:
            ul = prior[i - bpp] if i >= bpp else 0
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up if pb <= pc
                                                       else ul)
            out[i] = (out[i] + pred) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG (gray, gray + alpha, RGB, RGBA) ->
    uint8 (H, W) for gray, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace}; read_png takes 8-bit "
                         "non-interlaced gray, gray + alpha, RGB or RGBA")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for "
                         f"{h} rows of {stride + 1}")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, line = int(raw[r, 0]), raw[r, 1:]
        if ftype == 0:
            row = line
        elif ftype == 1:
            row = (np.cumsum(line.reshape(w, bpp), 0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            row = line + prior                       # uint8 wraps mod 256
        elif ftype in (3, 4):
            row = np.frombuffer(_unfilter_slow(ftype, line.tobytes(),
                                               prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"{path}: unknown filter type {ftype}")
        out[r] = row
        prior = out[r]
    img = out.reshape(h, w, bpp)
    return img[..., 0] if bpp == 1 else img
