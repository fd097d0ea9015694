"""Soft rasterizer on packed face chunks: CUDA kernels for the card, plain
PyTorch versions for the CPU (counterpart of
sln_tpu/render/rasterizer_pallas.py, whose `_fwd_kernel` and `_bwd_kernel`
the kernels in csrc/soft_raster.cu replace).

Same function as render/rasterizer.py:soft_rasterize:

* faces are sorted by projected y centre and packed into a (B, 16, Fp)
  constant matrix `fdata` (edge-function coefficients, inverse edge
  lengths with the winding sign folded in, inverse vertex depths); an
  invalid or padded face sits "infinitely outside" (edge offset FAR_C);
* pixels are cut into tiles of PT pixels and faces into chunks of FC; each
  tile loops over its ACTIVE chunk list only (`counts`, `clist`): the
  chunks holding a face that can change an output on the tile's rows. The
  coverage falls with the distance to each edge's *line*, so a face
  reaches the face dilated in line distance by its reach (`CULL_LOGIT`,
  which grows with how much nearer than the scene's far side the face
  is), and a chunk is culled only when no such dilated face meets the
  tile's rows (`chunk_tile_mask`);
* the forward keeps per-pixel online-softmax statistics (m, s, sum w*z,
  sum log(1 - cov)) as residuals, and the backward replays the geometry
  chunk by chunk and sums closed-form cotangents into a (B, 16, Fp)
  face-constant gradient; gradients to projected vertices and depths flow
  through `pack_faces` by autograd.

`RasterizeCore` dispatches on where its tensors lie: CPU tensors take the
plain versions (`raster_fwd_plain`, `raster_bwd_plain`), CUDA tensors the
kernels (`raster_fwd_cuda`, `raster_bwd_cuda`), which raise rather than
fall back when they cannot run.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from sln_tpu_torch import trace
from sln_tpu_torch.render.rasterizer import FaceGeometry

# fdata row layout
R_NX = 0     # 0-2: edge normal x
R_NY = 3     # 3-5: edge normal y
R_C = 6      # 6-8: edge offset
R_IL = 9     # 9-11: inverse edge length * winding sign
R_SIGN = 12  # kept for layout parity with the JAX kernel; unused
R_IZ = 13    # 13-15: inverse vertex depth

FAR_C = -1e9
PT = 128     # pixels per tile: one CUDA block, one thread per pixel
FC = 128     # faces per chunk
MAX_CLASSES = 32   # the kernels' per-pixel class accumulator width

# A culled face must leave every output of the dense formula unchanged in
# fp32. At d px outside a face's edge lines its coverage logit is dd =
# -d(1 + d)/sigma. Its coverage and transmittance terms vanish once dd <
# -104 (exp underflows), and its visibility weight exp(logit - m) vanishes
# once its logit lies 104 below that of a face that covers the pixel (only
# there is the opacity nonzero, and such a face has log sigmoid(dd) > -17).
# The visibility logit also carries -zbuf/gamma: a face nearer than the
# covering one by dz gains dz/gamma, so one 8 px off an edge can still take
# the whole softmax of an edge pixel behind it. So face u reaches out to
# dd = CULL_LOGIT + (zmax - zmin_u)/gamma, zmax the farthest vertex depth
# of its scene and zmin_u its own nearest (a face's zbuf lies between its
# vertex depths). CULL_LOGIT = 8 x 9 / 0.5: at least the 8 px of the JAX
# package's halo at sigma 0.5.
CULL_LOGIT = 144.0
# faces whose inradius (px) is below this are not dilated: they are taken
# to reach every row, since 1 + halo / inradius would overflow
MIN_INRADIUS_PX = 1e-4

# kernel launches, counted in the trace registry where each wrapper
# launches its kernels: two per forward call (item, merge), three per
# backward call (item, reduce, combine); read as FWD_LAUNCHES and
# BWD_LAUNCHES
_LAUNCH_COUNTERS = {"FWD_LAUNCHES": "raster.fwd_launches",
                    "BWD_LAUNCHES": "raster.bwd_launches"}


def __getattr__(name: str) -> int:
    if name in _LAUNCH_COUNTERS:
        return trace.counters().get(_LAUNCH_COUNTERS[name], 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    trace.reset(*_LAUNCH_COUNTERS.values())


def pack_faces(geom: FaceGeometry, num_classes: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FaceGeometry (B, F, ...) -> (fdata (B, 16, Fp), onehot (B, Fp, C)),
    Fp padded to a multiple of FC."""
    B, Fn = geom.valid.shape
    pad = -Fn % FC
    v = geom.valid[:, None, :]

    def sel(x, repl):                              # (B, F, k) -> (B, k, F)
        return torch.where(v, x.transpose(1, 2), repl)

    sign = geom.area_sign[..., None]
    fdata = torch.cat([
        sel(geom.edge_nx, 0.0), sel(geom.edge_ny, 0.0),
        sel(geom.edge_c, FAR_C), sel(geom.inv_len * sign, 1.0),
        sel(sign, 1.0), sel(geom.inv_z, 1.0)], 1)               # (B, 16, F)
    pad_cols = fdata.new_ones(B, 16, pad)          # invalid padding faces
    pad_cols[:, R_NX:R_C] = 0.0
    pad_cols[:, R_C:R_IL] = FAR_C
    fdata = torch.cat([fdata, pad_cols], 2)
    classes = torch.arange(num_classes, device=fdata.device)
    onehot = ((geom.face_class[..., None] == classes)
              & geom.valid[..., None]).float()
    onehot = F.pad(onehot, (0, 0, 0, pad))
    return fdata.contiguous(), onehot.contiguous()


def cull_halo_px(geom: FaceGeometry, sigma: float, gamma: float
                 ) -> torch.Tensor:
    """(B, F) float64: each face's reach in px beyond its edge lines, the d
    with d(1 + d)/sigma = CULL_LOGIT + (zmax - zmin_u)/gamma."""
    inv_z = geom.inv_z.double()
    z_far = torch.where(geom.valid, 1.0 / inv_z.amin(-1), -math.inf)
    z_gain = (z_far.amax(-1, keepdim=True) - 1.0 / inv_z.amax(-1)).clamp(
        min=0.0)
    dd = CULL_LOGIT + z_gain / gamma
    return 0.5 * (torch.sqrt(1.0 + 4.0 * sigma * dd) - 1.0)


def dilated_row_span(geom: FaceGeometry, image_size: int, sigma: float,
                     gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ymin, ymax), each (B, F): the rows of each face dilated by its
    cull_halo_px in line distance; (inf, -inf) for an invalid face, whose
    packed edge offset FAR_C gives exact zeros.

    The three edge lines pushed out by h meet at the face scaled about its
    incentre I by 1 + h / r (r the inradius), so the dilated face's
    vertices are I + (1 + h / r)(v - I). A face with r below
    MIN_INRADIUS_PX (valid, but nearly degenerate) spans every row."""
    v = geom.v2d.double()                                   # (B, F, 3, 2)
    edge = torch.roll(v, -1, dims=-2) - v                   # edge k: k -> k+1
    length = torch.linalg.vector_norm(edge, dim=-1)         # (B, F, 3)
    perim = length.sum(-1)
    area2 = (edge[..., 0, 0] * edge[..., 2, 1]
             - edge[..., 0, 1] * edge[..., 2, 0]).abs()
    r = area2 / perim.clamp(min=1e-30)
    # vertex k's weight is the length of the edge opposite it, k+1 -> k+2
    w = torch.roll(length, -1, dims=-1)
    y = v[..., 1]
    inc_y = (w * y).sum(-1) / perim.clamp(min=1e-30)
    thin = r < MIN_INRADIUS_PX
    scale = 1.0 + cull_halo_px(geom, sigma, gamma) / torch.where(thin, 1.0,
                                                                 r)
    yd = inc_y[..., None] + scale[..., None] * (y - inc_y[..., None])
    lo = torch.where(thin, 0.0, yd.amin(-1))
    hi = torch.where(thin, float(image_size), yd.amax(-1))
    return (torch.where(geom.valid, lo, math.inf).float(),
            torch.where(geom.valid, hi, -math.inf).float())


def chunk_tile_mask(geom: FaceGeometry, image_size: int, sigma: float = 0.5,
                    gamma: float = 0.02, tile: int = PT) -> torch.Tensor:
    """(B, T, K) bool: does any face of y-sorted chunk k, dilated by its
    reach in line distance (dilated_row_span), meet the rows of pixel tile
    t (tiles of `tile` pixels)? A (tile, chunk) pair the kernels skip
    changes none of the tile's outputs. sigma and gamma are the render's."""
    B, Fn = geom.valid.shape
    pad = -Fn % FC
    ymin, ymax = dilated_row_span(geom, image_size, sigma, gamma)
    ymin = F.pad(ymin, (0, pad), value=math.inf)
    ymax = F.pad(ymax, (0, pad), value=-math.inf)
    K = (Fn + pad) // FC
    ch_min = ymin.reshape(B, K, FC).amin(-1)                    # (B, K)
    ch_max = ymax.reshape(B, K, FC).amax(-1)
    P = image_size * image_size
    if P % tile:
        raise ValueError(f"{image_size}^2 pixels do not split into tiles "
                         f"of {tile}")
    t = torch.arange(P // tile, device=ymin.device)
    tile_rmin = ((t * tile) // image_size).float()
    tile_rmax = (((t + 1) * tile - 1) // image_size).float()
    return ((ch_min[:, None, :] <= tile_rmax[None, :, None])
            & (ch_max[:, None, :] >= tile_rmin[None, :, None]))


def chunk_lists(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, K) overlap mask -> (counts (B, T, 1) int32, clist (B, T, K)
    int32): clist[b, t, :counts[b, t, 0]] holds tile t's ACTIVE chunks in
    ascending order."""
    K = mask.shape[-1]
    idx = torch.arange(K, device=mask.device)
    key = torch.where(mask, idx, idx + K)          # actives sort first
    clist = torch.argsort(key, dim=-1).to(torch.int32)
    counts = mask.sum(-1, keepdim=True).to(torch.int32)
    return counts.contiguous(), clist.contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels
# ---------------------------------------------------------------------------
def _tiling(fdata, counts, image_size):
    B, _, Fp = fdata.shape
    T = counts.shape[1]
    P = image_size * image_size
    if P % T:
        raise ValueError(f"{P} pixels do not split into {T} tiles")
    return B, Fp, T, P // T


def _tile_pixels(T: int, tile: int, image_size: int, device):
    """(T, tile, 1) pixel-centre coordinates, integer div/mod."""
    p = torch.arange(T * tile, device=device).reshape(T, tile, 1)
    return ((p % image_size).float() + 0.5, (p // image_size).float() + 0.5)


def _gather_chunk(fdata, onehot, clist, j):
    """Chunk clist[:, :, j] of every tile: fd (B, T, 16, FC),
    oh (B, T, FC, C)."""
    B, T, _ = clist.shape
    cols = clist[:, :, j].long()[..., None] * FC + torch.arange(
        FC, device=fdata.device)                                 # (B, T, FC)
    fd = torch.gather(fdata[:, None].expand(B, T, 16, -1), 3,
                      cols[:, :, None, :].expand(B, T, 16, FC))
    C = onehot.shape[-1]
    oh = torch.gather(onehot[:, None].expand(B, T, -1, C), 2,
                      cols[..., None].expand(B, T, FC, C))
    return fd, oh, cols


def _chunk_geometry(fd, px, py, sigma, gamma):
    """fd (B, T, 16, FC), px/py (T, PT, 1) -> per-(pixel, face) terms,
    each (B, T, PT, FC) (sln_tpu's _chunk_geometry, batched)."""
    def row(r):
        return fd[:, :, r:r + 1, :]

    e = [row(R_NX + k) * px + row(R_NY + k) * py + row(R_C + k)
         for k in range(3)]
    s = [e[k] * row(R_IL + k) for k in range(3)]
    d = torch.minimum(torch.minimum(s[0], s[1]), s[2])
    Tsum = e[0] + e[1] + e[2]
    Tn = torch.where(Tsum.abs() > 1e-12, Tsum, torch.ones_like(Tsum))
    inv_Tn = 1.0 / Tn
    lam = [e[1] * inv_Tn, e[2] * inv_Tn, e[0] * inv_Tn]
    c = [x.clamp(0.0, 1.0) for x in lam]
    n = (c[0] + c[1] + c[2]).clamp(min=1e-12)
    inv_n = 1.0 / n
    h = [x * inv_n for x in c]
    zinv = h[0] * row(R_IZ) + h[1] * row(R_IZ + 1) + h[2] * row(R_IZ + 2)
    zbuf = 1.0 / zinv.clamp(min=1e-12)
    dd = d * (1.0 + F.relu(-d)) * (1.0 / sigma)
    lse = torch.log1p(torch.exp(-dd.abs()))
    logit = torch.clamp(dd, max=0.0) - lse - zbuf * (1.0 / gamma)
    lomc = torch.clamp(-dd, max=0.0) - lse
    return dict(e=e, s=s, d=d, inv_Tn=inv_Tn, lam=lam, inv_n=inv_n, h=h,
                zinv=zinv, zbuf=zbuf, dd=dd, logit=logit, lomc=lomc)


def raster_fwd_plain(fdata, onehot, counts, clist, image_size: int,
                     sigma: float, gamma: float, z_far: float):
    """Plain PyTorch version of the forward kernel on the same packed
    inputs. Loops over chunk slots j, updating every (scene, tile) whose
    list has a j-th active chunk, so memory stays O(P * FC).

    Returns depth (B, P, 1), classes (B, P, C), res (B, P, 4) =
    (m, s, sum w*z, sum log(1 - cov))."""
    B, Fp, T, tile = _tiling(fdata, counts, image_size)
    C = onehot.shape[-1]
    dev = fdata.device
    px, py = _tile_pixels(T, tile, image_size, dev)
    m = torch.full((B, T, tile, 1), -1e30, device=dev)
    s = torch.zeros(B, T, tile, 1, device=dev)
    az = torch.zeros(B, T, tile, 1, device=dev)
    ac = torch.zeros(B, T, tile, C, device=dev)
    alt = torch.zeros(B, T, tile, 1, device=dev)
    for j in range(clist.shape[-1]):
        active = (counts[:, :, 0] > j)[:, :, None, None]        # (B, T, 1, 1)
        fd, oh, _ = _gather_chunk(fdata, onehot, clist, j)
        g = _chunk_geometry(fd, px, py, sigma, gamma)
        m_new = torch.maximum(m, g["logit"].amax(-1, keepdim=True))
        scale = torch.exp(m - m_new)
        w = torch.exp(g["logit"] - m_new)
        s = torch.where(active, s * scale + w.sum(-1, keepdim=True), s)
        az = torch.where(active, az * scale
                         + (w * g["zbuf"]).sum(-1, keepdim=True), az)
        ac = torch.where(active, ac * scale + w @ oh, ac)
        alt = torch.where(active, alt + g["lomc"].sum(-1, keepdim=True),
                          alt)
        m = torch.where(active, m_new, m)
    denom = s.clamp(min=1e-30)
    alpha = 1.0 - torch.exp(alt)
    depth = alpha * az / denom + (1.0 - alpha) * z_far
    classes = alpha * (ac / denom)
    res = torch.cat([m, s, az, alt], -1)
    P = T * tile
    return (depth.reshape(B, P, 1), classes.reshape(B, P, C),
            res.reshape(B, P, 4))


def raster_bwd_plain(fdata, onehot, counts, clist, res, classes, g_depth,
                     g_classes, image_size: int, sigma: float, gamma: float,
                     z_far: float) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: the closed-form VJP of
    the forward w.r.t. fdata, from the saved (m, s, sum w*z,
    sum log(1 - cov)) residuals and the forward classes. Returns fgrad
    (B, 16, Fp)."""
    B, Fp, T, tile = _tiling(fdata, counts, image_size)
    C = onehot.shape[-1]
    dev = fdata.device
    px, py = _tile_pixels(T, tile, image_size, dev)

    def tiles(x):
        return x.reshape(B, T, tile, x.shape[-1])

    res, classes = tiles(res), tiles(classes)
    gd, gC = tiles(g_depth), tiles(g_classes)
    m = res[..., 0:1]
    s = res[..., 1:2].clamp(min=1e-30)
    az, alt = res[..., 2:3], res[..., 3:4]
    alpha = 1.0 - torch.exp(alt)
    D = az / s
    Dbar = gd * alpha
    # recover C_c = ac/s from classes = alpha * ac/s
    Cc = torch.where(alpha > 1e-12, classes / alpha.clamp(min=1e-12),
                     torch.zeros_like(classes))
    Cbar = gC * alpha
    abar = gd * (D - z_far) + (gC * Cc).sum(-1, keepdim=True)
    LTbar = abar * (alpha - 1.0)
    beta = Dbar * D + (Cbar * Cc).sum(-1, keepdim=True)
    inv_sigma, inv_gamma = 1.0 / sigma, 1.0 / gamma

    fgrad = torch.zeros(B, 16, Fp, device=dev)
    for j in range(clist.shape[-1]):
        active = (counts[:, :, 0] > j)[:, :, None, None]
        fd, oh, cols = _gather_chunk(fdata, onehot, clist, j)
        g = _chunk_geometry(fd, px, py, sigma, gamma)
        e, sk, d, h, lam = g["e"], g["s"], g["d"], g["h"], g["lam"]
        zbuf, zinv = g["zbuf"], g["zinv"]
        w = torch.exp(g["logit"] - m) * (1.0 / s)               # (B,T,PT,FC)
        wbar = Dbar * zbuf + Cbar @ oh.transpose(-1, -2)
        lbar = w * (wbar - beta)
        zbufbar = Dbar * w - lbar * inv_gamma
        neg = torch.clamp(-d, min=0.0)
        sig_d = torch.sigmoid(d * (1.0 + neg) * inv_sigma)
        dbar = (lbar * (1.0 - sig_d) - LTbar * sig_d) \
            * ((1.0 + 2.0 * neg) * inv_sigma)
        zinvbar = torch.where(zinv > 1e-12, -zbufbar * zbuf * zbuf,
                              torch.zeros_like(zbuf))
        izbar = [zinvbar * h[k] for k in range(3)]
        hbar = [zinvbar * fd[:, :, R_IZ + k:R_IZ + k + 1] for k in range(3)]
        hdot = hbar[0] * h[0] + hbar[1] * h[1] + hbar[2] * h[2]
        cbar = [(hbar[k] - hdot) * g["inv_n"] for k in range(3)]
        lbar_k = [torch.where((lam[k] > 0.0) & (lam[k] < 1.0), cbar[k],
                              torch.zeros_like(cbar[k])) for k in range(3)]
        inv_Tn = g["inv_Tn"]
        erbar = [x * inv_Tn for x in lbar_k]     # -> e1, e2, e0
        Tbar = -(lbar_k[0] * lam[0] + lbar_k[1] * lam[1]
                 + lbar_k[2] * lam[2]) * inv_Tn
        # d = min_k s_k: route dbar to the argmin (ties split evenly)
        mk = [(sk[k] <= d).float() for k in range(3)]
        dbar_n = dbar / (mk[0] + mk[1] + mk[2]).clamp(min=1.0)
        sbar = [dbar_n * mk[k] for k in range(3)]
        ilbar = [sbar[k] * e[k] for k in range(3)]
        ebar = [sbar[0] * fd[:, :, R_IL:R_IL + 1] + erbar[2] + Tbar,
                sbar[1] * fd[:, :, R_IL + 1:R_IL + 2] + erbar[0] + Tbar,
                sbar[2] * fd[:, :, R_IL + 2:R_IL + 3] + erbar[1] + Tbar]
        rows = [None] * 16
        for k in range(3):
            rows[R_NX + k] = ebar[k] * px
            rows[R_NY + k] = ebar[k] * py
            rows[R_C + k] = ebar[k]
            rows[R_IL + k] = ilbar[k]
            rows[R_IZ + k] = izbar[k]
        rows[R_SIGN] = torch.zeros_like(ebar[0])
        contrib = torch.stack([r.sum(2) for r in rows], 2)       # (B,T,16,FC)
        contrib = torch.where(active, contrib, torch.zeros_like(contrib))
        fgrad.scatter_add_(
            2, cols[:, None].expand(B, 16, T, FC).reshape(B, 16, T * FC),
            contrib.permute(0, 2, 1, 3).reshape(B, 16, T * FC))
    return fgrad


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/soft_raster.cu), bound through ctypes
# ---------------------------------------------------------------------------
def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on the card, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_packed(fdata, onehot, counts, clist, image_size):
    B, _, Fp = fdata.shape
    C = onehot.shape[-1]
    T = counts.shape[1]
    K = Fp // FC
    if Fp % FC or Fp == 0:
        raise ValueError(f"Fp={Fp} must be a positive multiple of {FC}")
    if T * PT != image_size * image_size:
        raise ValueError(f"counts has {T} tiles; the kernels take tiles of "
                         f"{PT} pixels of a {image_size}^2 image")
    if not 0 < C <= MAX_CLASSES:
        raise ValueError(f"the kernels take 1..{MAX_CLASSES} classes, "
                         f"got {C}")
    _check("fdata", fdata, torch.float32, (B, 16, Fp))
    _check("onehot", onehot, torch.float32, (B, Fp, C))
    _check("counts", counts, torch.int32, (B, T, 1))
    _check("clist", clist, torch.int32, (B, T, K))
    devices = {t.device for t in (fdata, onehot, counts, clist)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    return B, Fp, C, T, K


def _raise_on(err: int, what: str) -> None:
    if err:
        from sln_tpu_torch import kernels
        raise RuntimeError(f"{what} launch failed: {kernels.error_string(err)}"
                           f" (cudaError {err})")


def raster_fwd_cuda(fdata, onehot, counts, clist, image_size: int,
                    sigma: float, gamma: float, z_far: float):
    """Launch the forward (its item kernel, then its merge kernel); outputs
    as raster_fwd_plain."""
    from sln_tpu_torch import kernels

    B, Fp, C, T, K = _check_packed(fdata, onehot, counts, clist, image_size)
    lib = kernels.load()
    P = image_size * image_size
    kw = dict(dtype=torch.float32, device=fdata.device)
    depth = torch.empty(B, P, 1, **kw)
    classes = torch.empty(B, P, C, **kw)
    res = torch.empty(B, P, 4, **kw)
    # one partial online-softmax state (m, s, sum w*z, sum log(1 - cov),
    # C class sums) per pixel of every chunk slot; the kernels touch the
    # active slots only
    scratch = torch.empty(B * T * K * (4 + C) * PT, **kw)
    with torch.cuda.device(fdata.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sln_raster_fwd(
            _ptr(fdata), _ptr(onehot), _ptr(counts), _ptr(clist),
            _ptr(depth), _ptr(classes), _ptr(res), _ptr(scratch), B, T, K,
            Fp, C, image_size, 1.0 / sigma, 1.0 / gamma, z_far,
            ctypes.c_void_p(stream))
    _raise_on(err, "sln_raster_fwd")
    trace.count("raster.fwd_launches", 2)   # the item and merge kernels
    return depth, classes, res


def raster_bwd_cuda(fdata, onehot, counts, clist, res, classes, g_depth,
                    g_classes, image_size: int, sigma: float, gamma: float,
                    z_far: float) -> torch.Tensor:
    """Launch the backward (its item kernel, then its reduce and combine
    kernels, which add each face's per-tile sums in tile order: the same
    bits from run to run); output as raster_bwd_plain."""
    from sln_tpu_torch import kernels

    B, Fp, C, T, K = _check_packed(fdata, onehot, counts, clist, image_size)
    P = image_size * image_size
    _check("res", res, torch.float32, (B, P, 4))
    _check("classes", classes, torch.float32, (B, P, C))
    _check("g_depth", g_depth, torch.float32, (B, P, 1))
    _check("g_classes", g_classes, torch.float32, (B, P, C))
    lib = kernels.load()
    kw = dict(dtype=torch.float32, device=fdata.device)
    fgrad = torch.empty(B, 16, Fp, **kw)
    # per-face sums (the 15 rows other than R_SIGN): one slot per chunk
    # slot of clist, then one per (scene, chunk, range of tiles)
    scratch = torch.empty(lib.sln_raster_bwd_scratch_floats(B, T, K), **kw)
    with torch.cuda.device(fdata.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sln_raster_bwd(
            _ptr(fdata), _ptr(onehot), _ptr(counts), _ptr(clist), _ptr(res),
            _ptr(classes), _ptr(g_depth), _ptr(g_classes), _ptr(fgrad),
            _ptr(scratch), B, T, K, Fp, C, image_size, 1.0 / sigma,
            1.0 / gamma, z_far, ctypes.c_void_p(stream))
    _raise_on(err, "sln_raster_bwd")
    trace.count("raster.bwd_launches", 3)   # item, reduce, combine
    return fgrad


class RasterizeCore(torch.autograd.Function):
    """(fdata, onehot, counts, clist) -> (depth (B, P, 1), classes
    (B, P, C)); the backward returns fgrad for fdata, a zero gradient for
    onehot and none for the int inputs. CPU tensors run the plain
    versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, fdata, onehot, counts, clist, image_size, sigma, gamma,
                z_far):
        fwd = raster_fwd_cuda if fdata.is_cuda else raster_fwd_plain
        depth, classes, res = fwd(fdata, onehot, counts, clist, image_size,
                                  sigma, gamma, z_far)
        ctx.save_for_backward(fdata, onehot, counts, clist, res, classes)
        ctx.consts = (image_size, sigma, gamma, z_far)
        return depth, classes

    @staticmethod
    def backward(ctx, g_depth, g_classes):
        fdata, onehot, counts, clist, res, classes = ctx.saved_tensors
        bwd = raster_bwd_cuda if fdata.is_cuda else raster_bwd_plain
        with trace.span("sln.raster.bwd"):
            fgrad = bwd(fdata, onehot, counts, clist, res, classes,
                        g_depth.contiguous(), g_classes.contiguous(),
                        *ctx.consts)
        return (fgrad, torch.zeros_like(onehot), None, None, None, None,
                None, None)


def rasterize_core(fdata, onehot, counts, clist, image_size: int,
                   sigma: float, gamma: float, z_far: float):
    return RasterizeCore.apply(fdata, onehot, counts, clist, image_size,
                               sigma, gamma, z_far)


def prepare_faces(geom: FaceGeometry, num_classes: int, image_size: int,
                  sigma: float = 0.5, gamma: float = 0.02):
    """y-centre sort, pack, cull: the kernels' inputs
    (fdata, onehot, counts, clist) for a batch of scenes rendered with
    sigma and gamma."""
    ycen = torch.where(geom.valid, geom.v2d[..., 1].mean(-1),
                       float("inf"))
    order = torch.argsort(ycen, dim=-1, stable=True)
    geom = geom.take(order)
    fdata, onehot = pack_faces(geom, num_classes)
    counts, clist = chunk_lists(chunk_tile_mask(geom, image_size, sigma,
                                                gamma))
    trace.count_tensor("raster.dispatched_pairs", counts, FC * PT)
    return fdata, onehot, counts, clist


def soft_rasterize_cuda(geom: FaceGeometry, num_classes: int,
                        image_size: int, sigma: float = 0.5,
                        gamma: float = 0.02, z_far: float = 100.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same function as rasterizer.soft_rasterize, on culled face chunks.
    Returns (depth (B, S, S), classes (B, S, S, C))."""
    with trace.span("sln.render.prepare"):
        fdata, onehot, counts, clist = prepare_faces(geom, num_classes,
                                                     image_size, sigma, gamma)
    with trace.span("sln.render.raster"):
        depth, classes = rasterize_core(fdata, onehot, counts, clist,
                                        image_size, sigma, gamma, z_far)
    B, S = fdata.shape[0], image_size
    return depth.reshape(B, S, S), classes.reshape(B, S, S, num_classes)
