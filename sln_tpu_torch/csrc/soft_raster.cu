// Soft-rasterizer forward and backward kernels for Hopper (sm_90a).
//
// What they replace: the two Pallas TPU kernels of the JAX package,
// sln_tpu/render/rasterizer_pallas.py `_fwd_kernel` (forward) and
// `_bwd_kernel` (its hand-written VJP). Same function, not a block-by-block
// copy; the plain PyTorch versions are raster_fwd_plain / raster_bwd_plain
// in sln_tpu_torch/render/rasterizer_cuda.py.
//
// Inputs per scene b (a batch axis replaces the JAX package's vmap):
//   fdata  (B, 16, Fp) face constants, rows R_NX..R_IZ below, the winding
//          sign folded into R_IL, invalid/padded faces at edge offset -1e9
//   onehot (B, Fp, C)  face class one-hot rows, C <= MAXC
//   counts (B, T, 1), clist (B, T, K): tile t loops over the chunks
//          clist[b, t, :counts[b, t]] only (chunks of FC y-sorted faces
//          whose rows come within 8 px of the tile; the rest underflow to
//          exact fp32 zeros, so skipping them is lossless)
//
// What bounds them on this card: arithmetic on the active (pixel, face)
// pairs. Per pair the forward evaluates the edge functions, clipped
// barycentrics, perspective depth, a log-sigmoid coverage and the online
// softmax, plus a C-wide class sum; the backward replays that geometry and
// chains the closed-form cotangents. Bytes are small beside it: the face
// constants of a chunk are read once per tile, pixels once.
//
// Both kernels cut the work into equal items. One item is one active
// (scene, tile, chunk): PT pixels x FC faces. The grid has one block per
// chunk slot of clist (K x T x B); a block past its tile's count exits at
// once, so a tile with many active chunks does not set the kernel's length,
// and no count is read back to the host (measured faster than a persistent
// grid striding over a work-item list built on the device: PERF.md).
//
// The forward, redesigned for this card:
// - An item leaves its pixels' partial online-softmax state (m, s, sum w*z,
//   sum log(1 - cov), ac[C]) in a scratch buffer; a second kernel, one
//   block per (scene, tile), merges a tile's partials in clist order with
//   the usual rescale to the larger max and writes depth, classes and the
//   residuals. No atomics: the outputs are the same bits from run to run.
//   (Writing a single-chunk tile's outputs from its item saved 1.6 % at
//   most: not kept, PERF.md.)
// - The class sum ac += w * onehot is a matrix product, W (pixels x faces)
//   times the one-hot rows (faces x classes), as the TPU kernel's jnp.dot.
//   It runs on the tensor cores (mma.sync m16n8k8, TF32 in, fp32
//   accumulate), FlashAttention-style: each warp owns 32 pixels, computes
//   the logits of 8 faces at a time in the mma A-fragment layout, takes the
//   per-pixel max over the 8 with two quad shuffles and rescales once per
//   8 faces. TF32 keeps 11 bits, too few for the classes' 1e-4 tolerance,
//   so W = W_hi + W_lo, both TF32, and two products are issued; the one-hot
//   rows are exact in TF32 and every term is positive, so the split loses
//   about 2^-22 and nothing cancels. s and sum w*z stay fp32 register sums.
// - Per-pair special functions: __expf for the softmax and coverage
//   exponentials and approximate reciprocals; log1pf stays.
//
// The backward, redesigned for this card (same item grid):
// - Per-pixel terms staged per item in shared memory as rows [q][8] (two
//   16-byte broadcast loads per pixel, seven scalar loads before) and Cbar
//   as float4. They are computed by the item itself from the forward's
//   residuals: on the card that measured faster than computing them once
//   per tile into a scratch and copying each item's rows in with
//   double-buffered cp.async (PERF.md, Findings).
// - One shared sigmoid per pair: e = exp(-|dd|) and r = 1/(1+e) give both
//   the visibility weight and the coverage sigmoid (see the inner loop);
//   __expf and approximate reciprocals.
// One thread per face: each face's 15 gradient sums stay in registers over
// the item's pixels.
//
// Cross-tile reduction of the backward, in a fixed order: the TPU kernel
// carries fgrad across a sequential grid. Here blocks run in parallel, so
// each item writes its per-face sums (15 rows: all but R_SIGN, which stays
// zero) to a scratch slot of its (scene, tile, chunk slot), as the
// forward's items leave their partial states. A second kernel,
// raster_bwd_reduce_kernel, one block per (chunk, scene, range of 64
// tiles), lists in tile order the slots of its tiles whose lists hold the
// chunk and adds them in that order (in four contiguous parts, then the
// parts in order); a third, raster_bwd_combine_kernel, adds a chunk's
// range sums in order and writes fgrad once (zeros for a face no tile
// lists). No atomics: fgrad is the same bits from run to run, which makes
// the refine trajectory reproducible. The atomicAdd it replaced summed the tiles in whatever
// order the blocks finished (PERF.md).
//
// Built by nvcc with a plain C interface (no PyTorch headers) and loaded
// with ctypes (sln_tpu_torch/kernels.py). Launchers run on the caller's
// stream, allocate nothing, never synchronise, and return
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PT = 128;    // pixels per tile = threads per block
constexpr int FC = 128;    // faces per chunk
constexpr int MAXC = 32;   // class accumulator width
constexpr int R_NX = 0, R_NY = 3, R_C = 6, R_IL = 9, R_SIGN = 12,
              R_IZ = 13;
// rows of fgrad a backward item writes to its scratch slot: all but R_SIGN
constexpr int BR = 15;
// the backward's reduce: blocks of RG groups of one thread per face, each
// block over a range of TR tiles
constexpr int RG = 4;
constexpr int RT = RG * FC;
constexpr int TR = 64;
static_assert(TR % 32 == 0 && TR <= RT, "TR: whole warps of the block");

__host__ __device__ constexpr int reduce_ranges(int T) {
  return (T + TR - 1) / TR;
}

__host__ __device__ constexpr int partial_row(int r) {
  return r < R_SIGN ? r : r - 1;
}

struct Face {
  float nx[3], ny[3], c[3], il[3], iz[3];
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Per-(pixel, face) terms of the forward, as sln_tpu's _chunk_geometry:
// the perspective depth zbuf, the softmax logit and log(1 - coverage).
// __expf (MUFU.EX2) and approximate reciprocals (MUFU.RCP, about 1 ulp; the
// arguments are clamped away from 0 and stay far below 2^126). log1pf
// stays: sum log(1 - cov) adds up many small terms.
__device__ __forceinline__ void fwd_geometry(const Face& f, float px,
                                             float py, float inv_sigma,
                                             float inv_gamma, float& zbuf,
                                             float& logit, float& lomc) {
  float e[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = f.nx[k] * px + f.ny[k] * py + f.c[k];
    s[k] = e[k] * f.il[k];
  }
  const float d = fminf(fminf(s[0], s[1]), s[2]);
  const float Tsum = e[0] + e[1] + e[2];
  const float inv_Tn =
      __fdividef(1.0f, fabsf(Tsum) > 1e-12f ? Tsum : 1.0f);
  // lam_k = e_{k+1} / T, clipped to [0, 1]
  const float c0 = fminf(fmaxf(e[1] * inv_Tn, 0.0f), 1.0f);
  const float c1 = fminf(fmaxf(e[2] * inv_Tn, 0.0f), 1.0f);
  const float c2 = fminf(fmaxf(e[0] * inv_Tn, 0.0f), 1.0f);
  const float inv_n = __fdividef(1.0f, fmaxf(c0 + c1 + c2, 1e-12f));
  const float zinv = (c0 * inv_n) * f.iz[0] + (c1 * inv_n) * f.iz[1] +
                     (c2 * inv_n) * f.iz[2];
  zbuf = __fdividef(1.0f, fmaxf(zinv, 1e-12f));
  // linear-inside / quadratic-outside coverage; log_sigmoid(dd) and
  // log_sigmoid(-dd) share one exp and one log1p
  const float dd = d * (1.0f + fmaxf(-d, 0.0f)) * inv_sigma;
  const float lse = log1pf(__expf(-fabsf(dd)));
  logit = fminf(dd, 0.0f) - lse - zbuf * inv_gamma;
  lomc = fminf(-dd, 0.0f) - lse;
}

// fp32 -> TF32 (round to nearest, ties away), as the bit pattern mma takes
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, row-major fragment) * B (8 x 8, column-major fragment):
// TF32 in, fp32 accumulate. Fragments (g = lane / 4, q = lane % 4):
// a = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g];
// d = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows of an item's partial state in the scratch buffer, each PT floats
// (pixel-fastest): m, s, sum w*z, sum log(1 - cov), then ac[0..C).
constexpr int P_M = 0, P_S = 1, P_AZ = 2, P_ALT = 3, P_AC = 4;

// The forward's stage for one item: the chunk's face constants as rows of
// 20 floats per face (four 16-byte loads; the stride spreads the four
// faces a warp reads at once over distinct banks), and its one-hot rows in
// the mma B-fragment order, [8-face step][half][lane] float4: lane-
// consecutive 16-byte loads, free of bank conflicts.
constexpr int FD_ROW = 5;  // float4 per face
struct FwdStage {
  float4 fd[FC][FD_ROW];
  float4 ohf[FC / 8][2][32];
};

__device__ __forceinline__ void load_face(const float4 (&r)[FD_ROW],
                                          Face& f) {
  const float4 a = r[0], b = r[1], c = r[2], d = r[3];
  f.nx[0] = a.x; f.nx[1] = a.y; f.nx[2] = a.z;   // rows 0-2
  f.ny[0] = a.w; f.ny[1] = b.x; f.ny[2] = b.y;   // rows 3-5
  f.c[0] = b.z;  f.c[1] = b.w;  f.c[2] = c.x;    // rows 6-8
  f.il[0] = c.y; f.il[1] = c.z; f.il[2] = c.w;   // rows 9-11
  f.iz[0] = d.y; f.iz[1] = d.z; f.iz[2] = d.w;   // rows 13-15
}

// One block per chunk slot (j, t, b) of clist; it works only if
// j < counts[b, t]. Warp w owns pixels 32 w .. 32 w + 31 of the tile, as
// two 16-row mma M-tiles. Lane (g, q) = (lane / 4, lane % 4) holds pixels
// g + 8 i (i = 0..3; rows g and g + 8 of M-tile i / 2) and, per step of 8
// faces, faces q and q + 4: the A fragments it feeds the tensor cores are
// the weights it computed itself. Each quad (the 4 lanes of one g) shares
// a pixel's running max; its s, sum w*z and sum log(1 - cov) are summed
// over the quad at the end.
__global__ void __launch_bounds__(PT)
    raster_fwd_item_kernel(const float* __restrict__ fdata,
                           const float* __restrict__ onehot,
                           const int* __restrict__ counts,
                           const int* __restrict__ clist,
                           float* __restrict__ scratch, int T, int K,
                           int Fp, int C, int S, float inv_sigma,
                           float inv_gamma) {
  __shared__ __align__(16) FwdStage st;

  const int j = blockIdx.x, t = blockIdx.y, b = blockIdx.z,
            tid = threadIdx.x;
  const size_t tile = static_cast<size_t>(b) * T + t;
  const int n = min(counts[tile], K);
  if (j >= n) return;  // uniform over the block
  const int chunk = clist[tile * K + j];
  if (chunk < 0 || chunk >= K) return;
  const int f0 = chunk * FC;
  const float* fd_b = fdata + static_cast<size_t>(b) * 16 * Fp;
  const float* oh_b = onehot + static_cast<size_t>(b) * Fp * C;
  {
    float* fd = reinterpret_cast<float*>(st.fd);
    for (int i = tid; i < 16 * FC; i += PT) {
      const int r = i / FC, f = i % FC;
      fd[f * 4 * FD_ROW + r] = fd_b[static_cast<size_t>(r) * Fp + f0 + f];
    }
    // float i of ohf is onehot[8 ks + lane % 4 + 4 (e % 2)]
    // [8 (2 h + e / 2) + lane / 4], where i = ((ks * 2 + h) * 32 + lane)
    // * 4 + e: B fragments b0, b1 of N-tiles 2h and 2h + 1
    float* oh = reinterpret_cast<float*>(st.ohf);
    for (int i = tid; i < FC * MAXC; i += PT) {
      const int e = i & 3, lane = (i >> 2) & 31, h = (i >> 7) & 1,
                ks = i >> 8;
      const int f = 8 * ks + (lane & 3) + 4 * (e & 1);
      const int c = 8 * (2 * h + (e >> 1)) + (lane >> 2);
      oh[i] = c < C ? oh_b[static_cast<size_t>(f0 + f) * C + c] : 0.0f;
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, lq = lane & 3;
  float px[4], py[4], m[4], s[4], az[4], alt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = t * PT + warp * 32 + g + 8 * i;
    px[i] = static_cast<float>(p % S) + 0.5f;
    py[i] = static_cast<float>(p / S) + 0.5f;
    m[i] = -1e30f;
    s[i] = az[i] = alt[i] = 0.0f;
  }
  float acc[2][4][4];  // [M-tile][N-tile (8 classes)][d fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int ks = 0; ks < FC / 8; ++ks) {
    Face fa, fb;
    load_face(st.fd[8 * ks + lq], fa);
    load_face(st.fd[8 * ks + lq + 4], fb);
    float wa[4], wb[4], sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float za, zb, la, lb, oa, ob;
      fwd_geometry(fa, px[i], py[i], inv_sigma, inv_gamma, za, la, oa);
      fwd_geometry(fb, px[i], py[i], inv_sigma, inv_gamma, zb, lb, ob);
      alt[i] += oa + ob;
      // the pixel's max over the step's 8 faces (its quad's lanes)
      float mx = fmaxf(la, lb);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      sc[i] = __expf(m[i] - mn);
      m[i] = mn;
      wa[i] = __expf(la - mn);
      wb[i] = __expf(lb - mn);
      s[i] = s[i] * sc[i] + (wa[i] + wb[i]);
      az[i] = az[i] * sc[i] + (wa[i] * za + wb[i] * zb);
    }
    const float4 b01 = st.ohf[ks][0][lane], b23 = st.ohf[ks][1][lane];
    const uint32_t bf[4][2] = {
        {__float_as_uint(b01.x), __float_as_uint(b01.y)},
        {__float_as_uint(b01.z), __float_as_uint(b01.w)},
        {__float_as_uint(b23.x), __float_as_uint(b23.y)},
        {__float_as_uint(b23.z), __float_as_uint(b23.w)}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float w4[4] = {wa[2 * mt], wa[2 * mt + 1], wb[2 * mt],
                           wb[2 * mt + 1]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = to_tf32(w4[e]);
        lo[e] = to_tf32(w4[e] - __uint_as_float(hi[e]));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float (&d)[4] = acc[mt][nt];
        d[0] *= sc[2 * mt];
        d[1] *= sc[2 * mt];
        d[2] *= sc[2 * mt + 1];
        d[3] *= sc[2 * mt + 1];
        mma_tf32(d, lo, bf[nt][0], bf[nt][1]);
        mma_tf32(d, hi, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // the quad's sums over its faces -> the pixel's (the same bits in all
  // four lanes: fp32 addition commutes)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
    az[i] += __shfl_xor_sync(0xffffffffu, az[i], 1);
    az[i] += __shfl_xor_sync(0xffffffffu, az[i], 2);
    alt[i] += __shfl_xor_sync(0xffffffffu, alt[i], 1);
    alt[i] += __shfl_xor_sync(0xffffffffu, alt[i], 2);
  }
  const int pl = warp * 32 + g;  // tile pixel of i = 0; i adds 8 i
  float* sp = scratch + (tile * K + j) * (P_AC + C) * PT + pl;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i == lq) {
      sp[P_M * PT + 8 * i] = m[i];
      sp[P_S * PT + 8 * i] = s[i];
      sp[P_AZ * PT + 8 * i] = az[i];
      sp[P_ALT * PT + 8 * i] = alt[i];
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 2 * mt + (e >> 1), c = 8 * nt + 2 * lq + (e & 1);
        if (c < C) sp[(P_AC + c) * PT + 8 * i] = acc[mt][nt][e];
      }
}

// One block per (scene, tile), one thread per pixel: merges the tile's
// partial states in clist order (j = 0, 1, ...) with the usual rescale to
// the larger max, and writes the outputs; a tile with no active chunk gets
// the background. The tile's classes are one contiguous run of PT * C
// floats: they go out through shared memory, so that neighbouring threads
// store neighbouring floats (a thread storing its own pixel's C floats
// touches a sector per float: 2.2x slower merge, PERF.md).
__global__ void __launch_bounds__(PT)
    raster_fwd_merge_kernel(const int* __restrict__ counts,
                            const int* __restrict__ clist,
                            const float* __restrict__ scratch,
                            float* __restrict__ depth,
                            float* __restrict__ classes,
                            float* __restrict__ res, int T, int K, int C,
                            float z_far) {
  __shared__ float cls_s[PT][MAXC + 1];  // +1: rows on distinct banks

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t tile = static_cast<size_t>(b) * T + t;
  const int n = min(counts[tile], K);
  const int* cl = clist + tile * K;
  float m = -1e30f, s = 0.0f, az = 0.0f, alt = 0.0f;
  float ac[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) ac[c] = 0.0f;
  for (int j = 0; j < n; ++j) {
    if (cl[j] < 0 || cl[j] >= K) continue;
    const float* sp = scratch + (tile * K + j) * (P_AC + C) * PT + tid;
    const float mj = sp[P_M * PT];
    const float mn = fmaxf(m, mj);
    const float a = expf(m - mn), w = expf(mj - mn);
    s = s * a + sp[P_S * PT] * w;
    az = az * a + sp[P_AZ * PT] * w;
    alt += sp[P_ALT * PT];
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) ac[c] = ac[c] * a + sp[(P_AC + c) * PT] * w;
    m = mn;
  }
  const size_t q = tile * PT + tid;
  const float denom = fmaxf(s, 1e-30f);
  const float alpha = 1.0f - expf(alt);
  depth[q] = alpha * az / denom + (1.0f - alpha) * z_far;
  reinterpret_cast<float4*>(res)[q] = make_float4(m, s, az, alt);
  const float r = alpha / denom;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) cls_s[tid][c] = ac[c] * r;
  __syncthreads();
  float* out = classes + tile * PT * C;
  for (int i = tid; i < PT * C; i += PT) out[i] = cls_s[i / C][i % C];
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// Per-(pixel, face) terms of the backward: the forward's geometry without
// the log-sigmoid, and with approximate reciprocals (MUFU.RCP, about 1 ulp;
// the arguments are clamped away from 0 and stay far below 2^126).
struct BwdTerms {
  float e[3], s[3], d, inv_Tn, lam[3], inv_n, h[3], zinv, zbuf, dd;
};

__device__ __forceinline__ void bwd_geometry(const Face& f, float px,
                                             float py, float inv_sigma,
                                             BwdTerms& g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.e[k] = f.nx[k] * px + f.ny[k] * py + f.c[k];
    g.s[k] = g.e[k] * f.il[k];
  }
  g.d = fminf(fminf(g.s[0], g.s[1]), g.s[2]);
  const float Tsum = g.e[0] + g.e[1] + g.e[2];
  const float Tn = fabsf(Tsum) > 1e-12f ? Tsum : 1.0f;
  g.inv_Tn = __fdividef(1.0f, Tn);
  g.lam[0] = g.e[1] * g.inv_Tn;  // lam_k = e_{k+1} / T
  g.lam[1] = g.e[2] * g.inv_Tn;
  g.lam[2] = g.e[0] * g.inv_Tn;
  float cl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) cl[k] = fminf(fmaxf(g.lam[k], 0.0f), 1.0f);
  g.inv_n = __fdividef(1.0f, fmaxf(cl[0] + cl[1] + cl[2], 1e-12f));
#pragma unroll
  for (int k = 0; k < 3; ++k) g.h[k] = cl[k] * g.inv_n;
  g.zinv = g.h[0] * f.iz[0] + g.h[1] * f.iz[1] + g.h[2] * f.iz[2];
  g.zbuf = __fdividef(1.0f, fmaxf(g.zinv, 1e-12f));
  g.dd = g.d * (1.0f + fmaxf(-g.d, 0.0f)) * inv_sigma;
}

// An item's per-pixel terms in shared memory: row q holds pixel q's
// (x, y, m, 1/s) and (Dbar, beta, LTbar, alpha), two 16-byte broadcast
// loads, and Cbar = g_classes * alpha as MAXC / 4 float4.
struct Stage {
  float4 pix[PT][2];
  float4 cbar[PT][MAXC / 4];
};

// One block per chunk slot (j, t, b) of clist: the block works only if
// j < counts[b, t], i.e. on one active (scene b, tile t, chunk) triple, all
// of equal cost (PT pixels x FC faces); the other blocks exit at once and
// the hardware scheduler hands their slots to the working ones. The block
// first stages its tile's per-pixel terms (thread tid owns pixel tid); then
// thread tid owns face tid of the chunk and loops over the tile's pixels.
__global__ void __launch_bounds__(PT)
    raster_bwd_kernel(const float* __restrict__ fdata,
                      const float* __restrict__ onehot,
                      const int* __restrict__ counts,
                      const int* __restrict__ clist,
                      const float* __restrict__ res,
                      const float* __restrict__ classes,
                      const float* __restrict__ g_depth,
                      const float* __restrict__ g_classes,
                      float* __restrict__ partial, int T, int K, int Fp,
                      int C, int S, float inv_sigma, float inv_gamma,
                      float z_far) {
  __shared__ __align__(16) Stage st;

  const int j = blockIdx.x, t = blockIdx.y, b = blockIdx.z,
            tid = threadIdx.x;
  if (j >= counts[b * T + t]) return;  // uniform over the block
  const int chunk = clist[(static_cast<size_t>(b) * T + t) * K + j];
  if (chunk < 0 || chunk >= K) return;
  const float* fd_b = fdata + static_cast<size_t>(b) * 16 * Fp;
  const float* oh_b = onehot + static_cast<size_t>(b) * Fp * C;
  const int col = chunk * FC + tid;  // this thread's face
  Face face;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    face.nx[k] = fd_b[static_cast<size_t>(R_NX + k) * Fp + col];
    face.ny[k] = fd_b[static_cast<size_t>(R_NY + k) * Fp + col];
    face.c[k] = fd_b[static_cast<size_t>(R_C + k) * Fp + col];
    face.il[k] = fd_b[static_cast<size_t>(R_IL + k) * Fp + col];
    face.iz[k] = fd_b[static_cast<size_t>(R_IZ + k) * Fp + col];
  }
  float oh[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    oh[c] = c < C ? oh_b[static_cast<size_t>(col) * C + c] : 0.0f;

  {  // stage the tile's per-pixel terms (thread tid: pixel tid)
    const int p = t * PT + tid;
    const size_t q = static_cast<size_t>(b) * T * PT + p;
    const float m = res[q * 4 + 0];
    const float s = fmaxf(res[q * 4 + 1], 1e-30f);
    const float az = res[q * 4 + 2];
    const float alt = res[q * 4 + 3];
    const float gd = g_depth[q];
    const float alpha = 1.0f - expf(alt);
    const float D = az / s;
    const float Dbar = gd * alpha;
    float gc_cc = 0.0f, cbar_cc = 0.0f;
    float Cbar[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      float gC = 0.0f, Cc = 0.0f;
      if (c < C) {
        gC = g_classes[q * C + c];
        // recover C_c = ac/s from classes = alpha * ac/s
        if (alpha > 1e-12f) Cc = classes[q * C + c] / fmaxf(alpha, 1e-12f);
      }
      Cbar[c] = gC * alpha;
      gc_cc += gC * Cc;
      cbar_cc += Cbar[c] * Cc;
    }
#pragma unroll
    for (int v = 0; v < MAXC / 4; ++v)
      st.cbar[tid][v] = make_float4(Cbar[4 * v], Cbar[4 * v + 1],
                                    Cbar[4 * v + 2], Cbar[4 * v + 3]);
    const float abar = gd * (D - z_far) + gc_cc;
    st.pix[tid][0] = make_float4(static_cast<float>(p % S) + 0.5f,
                                 static_cast<float>(p / S) + 0.5f, m,
                                 1.0f / s);
    st.pix[tid][1] = make_float4(Dbar, Dbar * D + cbar_cc,
                                 abar * (alpha - 1.0f), alpha);
  }
  __syncthreads();

  float g_nx[3] = {0, 0, 0}, g_ny[3] = {0, 0, 0}, g_c[3] = {0, 0, 0};
  float g_il[3] = {0, 0, 0}, g_iz[3] = {0, 0, 0};

  // two pixels per trip: their independent chains hide each other's
  // MUFU and shared-load latencies (measured ~5 % faster than one)
#pragma unroll 2
  for (int q = 0; q < PT; ++q) {
    const float4 pa = st.pix[q][0];  // x, y, m, 1/s
    const float4 pb = st.pix[q][1];  // Dbar, beta, LTbar, alpha
    const float px = pa.x, py = pa.y, Dbar = pb.x;
    BwdTerms g;
    bwd_geometry(face, px, py, inv_sigma, g);
    // One shared sigmoid per pair. With e = exp(-|dd|), r = 1/(1+e):
    //   sigmoid(dd) = dd >= 0 ? r : e*r, sigmoid(-dd) = dd >= 0 ? e*r : r,
    //   and since logit = min(dd,0) - log1p(e) - zbuf/gamma,
    //   exp(logit - m) = exp(min(dd,0) - zbuf/gamma - m) * r.
    // The new exponent is logit - m + log(1+e) <= log 2, because m is the
    // pixel's largest logit in the forward: it overflows nowhere the old
    // exp(logit - m) did not. No log1pf, one exp and one division fewer.
    const float ez = __expf(-fabsf(g.dd));
    const float r = __fdividef(1.0f, 1.0f + ez);
    const float sig_d = g.dd >= 0.0f ? r : ez * r;
    const float sig_nd = g.dd >= 0.0f ? ez * r : r;  // 1 - sig_d
    const float w =
        __expf(fminf(g.dd, 0.0f) - g.zbuf * inv_gamma - pa.z) * r * pa.w;
    float cb = 0.0f;
#pragma unroll
    for (int v = 0; v < MAXC / 4; ++v) {
      const float4 cv = st.cbar[q][v];
      cb += cv.x * oh[4 * v] + cv.y * oh[4 * v + 1] + cv.z * oh[4 * v + 2] +
            cv.w * oh[4 * v + 3];
    }
    const float wbar = Dbar * g.zbuf + cb;
    const float lbar = w * (wbar - pb.y);
    const float zbufbar = Dbar * w - lbar * inv_gamma;
    // coverage uses dd = d*(1 + relu(-d))/sigma:
    // d(dd)/d(d) = (1 + 2*relu(-d))/sigma
    const float neg = fmaxf(-g.d, 0.0f);
    const float dbar =
        (lbar * sig_nd - pb.z * sig_d) * ((1.0f + 2.0f * neg) * inv_sigma);
    // zbuf = 1/max(zinv, eps)
    const float zinvbar = g.zinv > 1e-12f ? -zbufbar * g.zbuf * g.zbuf : 0.0f;
    // zinv = sum h_k * iz_k
    float hbar[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_iz[k] += zinvbar * g.h[k];
      hbar[k] = zinvbar * face.iz[k];
    }
    // h = c / n, n = sum c; c = clip(lam, 0, 1)
    const float hdot = hbar[0] * g.h[0] + hbar[1] * g.h[1] + hbar[2] * g.h[2];
    float lbar_k[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float cbar_k = (hbar[k] - hdot) * g.inv_n;
      lbar_k[k] = (g.lam[k] > 0.0f && g.lam[k] < 1.0f) ? cbar_k : 0.0f;
    }
    // lam_k = e_{k+1} / Tn ; T = e0 + e1 + e2
    const float Tbar = -(lbar_k[0] * g.lam[0] + lbar_k[1] * g.lam[1] +
                         lbar_k[2] * g.lam[2]) * g.inv_Tn;
    // d = min_k s_k: route dbar to the argmin (ties split evenly)
    const float m0 = g.s[0] <= g.d ? 1.0f : 0.0f;
    const float m1 = g.s[1] <= g.d ? 1.0f : 0.0f;
    const float m2 = g.s[2] <= g.d ? 1.0f : 0.0f;
    const float ties = m0 + m1 + m2;  // 1, 2 or 3: no division
    const float dbar_n =
        dbar * (ties > 2.5f ? 1.0f / 3.0f : ties > 1.5f ? 0.5f : 1.0f);
    const float sbar[3] = {dbar_n * m0, dbar_n * m1, dbar_n * m2};
    // R_IL holds inv_len * sign, so s_k = e_k * il_k directly
    float ebar[3];
    ebar[0] = sbar[0] * face.il[0] + lbar_k[2] * g.inv_Tn + Tbar;
    ebar[1] = sbar[1] * face.il[1] + lbar_k[0] * g.inv_Tn + Tbar;
    ebar[2] = sbar[2] * face.il[2] + lbar_k[1] * g.inv_Tn + Tbar;
    // e_k = nx_k px + ny_k py + c_k: sum over the tile's pixels
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_il[k] += sbar[k] * g.e[k];
      g_nx[k] += ebar[k] * px;
      g_ny[k] += ebar[k] * py;
      g_c[k] += ebar[k];
    }
  }
  // the item's slot: BR rows of FC faces, thread tid's face at column tid
  float* out = partial + ((static_cast<size_t>(b) * T + t) * K + j) * BR * FC
               + tid;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[partial_row(R_NX + k) * FC] = g_nx[k];
    out[partial_row(R_NY + k) * FC] = g_ny[k];
    out[partial_row(R_C + k) * FC] = g_c[k];
    out[partial_row(R_IL + k) * FC] = g_il[k];
    out[partial_row(R_IZ + k) * FC] = g_iz[k];
  }
}

// One block per (chunk k, scene b, range s of TR tiles), RG groups of FC
// threads; thread f of each group owns face k * FC + f. First the block
// lists, in increasing tile order, the scratch slots of its tiles that
// hold chunk k: thread i < TR finds the slot j < counts of tile s TR + i
// whose clist entry is k (chunk_lists lists a chunk at most once per
// tile), and a ballot per warp appends the finds in order. Then group g
// adds the g-th quarter of that list, in order, group 0 adds the four
// group sums, in order, and writes the block's sums to its slot (b, k, s)
// of `sums`. The order depends on the lists only: the same bits from run
// to run. Ranges of TR tiles spread a chunk that many tiles list over
// several blocks (one block per chunk, walking all its tiles, took 0.05
// ms at 256 px; one thread group walking all T tiles one after another,
// 0.13 ms; PERF.md).
__global__ void __launch_bounds__(RT)
    raster_bwd_reduce_kernel(const int* __restrict__ counts,
                             const int* __restrict__ clist,
                             const float* __restrict__ partial,
                             float* __restrict__ sums, int T, int K) {
  __shared__ int slots[TR];  // (b * T + t) * K + j
  __shared__ int warp_n[TR / 32];
  __shared__ float group_sum[RG - 1][BR][FC];

  const int k = blockIdx.x, b = blockIdx.y, s = blockIdx.z,
            tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int found = -1;
  unsigned hits = 0;
  if (tid < TR) {  // whole warps
    if (s * TR + tid < T) {
      const int tile = b * T + s * TR + tid;
      const int n = min(counts[tile], K);
      for (int j = 0; j < n; ++j)
        if (clist[static_cast<size_t>(tile) * K + j] == k) {
          found = tile * K + j;
          break;
        }
    }
    hits = __ballot_sync(0xffffffffu, found >= 0);
    if (lane == 0) warp_n[warp] = __popc(hits);
  }
  __syncthreads();
  int n_slots = 0, at = 0;  // n_slots: the same in every thread
#pragma unroll
  for (int w = 0; w < TR / 32; ++w) {
    n_slots += warp_n[w];
    at += w < warp ? warp_n[w] : 0;
  }
  if (found >= 0) slots[at + __popc(hits & ((1u << lane) - 1u))] = found;
  __syncthreads();

  const int g = tid / FC, f = tid % FC;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  const int lo = n_slots * g / RG, hi = n_slots * (g + 1) / RG;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const float* p = partial + static_cast<size_t>(slots[i]) * BR * FC + f;
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] += p[r * FC];
  }
  if (g > 0) {
#pragma unroll
    for (int r = 0; r < BR; ++r) group_sum[g - 1][r][f] = acc[r];
  }
  __syncthreads();
  if (g > 0) return;
#pragma unroll
  for (int h = 0; h < RG - 1; ++h)
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] += group_sum[h][r][f];
  float* out = sums +
               ((static_cast<size_t>(b) * K + k) * gridDim.z + s) * BR * FC +
               f;
#pragma unroll
  for (int r = 0; r < BR; ++r) out[r * FC] = acc[r];
}

// One block per (chunk k, scene b), thread f owns face k * FC + f: adds
// the chunk's NS range sums in order s = 0, 1, ... and writes fgrad
// (R_SIGN zero).
__global__ void __launch_bounds__(FC)
    raster_bwd_combine_kernel(const float* __restrict__ sums,
                              float* __restrict__ fgrad, int K, int NS,
                              int Fp) {
  const int k = blockIdx.x, b = blockIdx.y, f = threadIdx.x;
  const float* p =
      sums + (static_cast<size_t>(b) * K + k) * NS * BR * FC + f;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] += p[(s * BR + r) * FC];
  }
  float* out = fgrad + static_cast<size_t>(b) * 16 * Fp + k * FC + f;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    out[static_cast<size_t>(r) * Fp] =
        r == R_SIGN ? 0.0f : acc[partial_row(r)];
}


}  // namespace

extern "C" {

int sln_tile_pixels() { return PT; }
int sln_chunk_faces() { return FC; }
int sln_max_classes() { return MAXC; }

const char* sln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// depth (B, P, 1), classes (B, P, C), res (B, P, 4); P = T * PT = S * S.
// scratch holds B * T * K * (4 + C) * PT floats: one partial state per
// chunk slot, written and read for the active slots only. Two launches on
// the stream: items, then the merge.
int sln_raster_fwd(const void* fdata, const void* onehot, const void* counts,
                   const void* clist, void* depth, void* classes, void* res,
                   void* scratch, int B, int T, int K, int Fp, int C, int S,
                   float inv_sigma, float inv_gamma, float z_far,
                   void* stream) {
  if (B > 0 && T > 0 && K > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    raster_fwd_item_kernel<<<dim3(K, T, B), PT, 0, st>>>(
        static_cast<const float*>(fdata), static_cast<const float*>(onehot),
        static_cast<const int*>(counts), static_cast<const int*>(clist),
        static_cast<float*>(scratch), T, K, Fp, C, S, inv_sigma, inv_gamma);
    raster_fwd_merge_kernel<<<dim3(T, B), PT, 0, st>>>(
        static_cast<const int*>(counts), static_cast<const int*>(clist),
        static_cast<const float*>(scratch), static_cast<float*>(depth),
        static_cast<float*>(classes), static_cast<float*>(res), T, K, C,
        z_far);
  }
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch the backward takes: one slot of per-face sums per
// chunk slot of clist (items), then one per (scene, chunk, tile range).
long long sln_raster_bwd_scratch_floats(int B, int T, int K) {
  return static_cast<long long>(B) * K * (T + reduce_ranges(T)) * BR * FC;
}

// fgrad (B, 16, Fp) is written whole; scratch holds
// sln_raster_bwd_scratch_floats(B, T, K) floats, written and read for the
// active slots only. Three launches on the stream: the items (one block
// per chunk slot; counts is read on the device only), the reduce (one
// block per (chunk, scene, range of TR tiles)) and the combine (one block
// per (chunk, scene)).
int sln_raster_bwd(const void* fdata, const void* onehot, const void* counts,
                   const void* clist, const void* res, const void* classes,
                   const void* g_depth, const void* g_classes, void* fgrad,
                   void* scratch, int B, int T, int K, int Fp, int C, int S,
                   float inv_sigma, float inv_gamma, float z_far,
                   void* stream) {
  if (B > 0 && T > 0 && K > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* partial = static_cast<float*>(scratch);
    float* sums = partial + static_cast<size_t>(B) * T * K * BR * FC;
    const int NS = reduce_ranges(T);
    raster_bwd_kernel<<<dim3(K, T, B), PT, 0, st>>>(
        static_cast<const float*>(fdata), static_cast<const float*>(onehot),
        static_cast<const int*>(counts), static_cast<const int*>(clist),
        static_cast<const float*>(res), static_cast<const float*>(classes),
        static_cast<const float*>(g_depth),
        static_cast<const float*>(g_classes), partial, T, K, Fp, C, S,
        inv_sigma, inv_gamma, z_far);
    raster_bwd_reduce_kernel<<<dim3(K, B, NS), RT, 0, st>>>(
        static_cast<const int*>(counts), static_cast<const int*>(clist),
        partial, sums, T, K);
    raster_bwd_combine_kernel<<<dim3(K, B), FC, 0, st>>>(
        sums, static_cast<float*>(fgrad), K, NS, Fp);
  }
  return static_cast<int>(cudaGetLastError());
}

// A kernel's resources on the current device: info[0..5] = SMs, resident
// blocks per SM (occupancy query), registers per thread, local (spill)
// bytes per thread, static shared bytes per block, threads per block.
static int kernel_info(const void* kernel, int* info) {
  int dev = 0;
  cudaFuncAttributes a;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&info[0], cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel, PT, 0);
  cudaFuncGetAttributes(&a, kernel);
  info[2] = a.numRegs;
  info[3] = static_cast<int>(a.localSizeBytes);
  info[4] = static_cast<int>(a.sharedSizeBytes);
  info[5] = PT;
  return static_cast<int>(cudaGetLastError());
}

// the forward's item kernel (the merge kernel's are in ptxas's log)
int sln_raster_fwd_info(int* info) {
  return kernel_info(reinterpret_cast<const void*>(raster_fwd_item_kernel),
                     info);
}

int sln_raster_bwd_info(int* info) {
  return kernel_info(reinterpret_cast<const void*>(raster_bwd_kernel), info);
}

}  // extern "C"
