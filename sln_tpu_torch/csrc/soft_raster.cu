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
// What bounds them on this card: FP32 CUDA-core arithmetic on the active
// (pixel, face) pairs. Per pair the forward evaluates the edge functions,
// clipped barycentrics, perspective depth, a log-sigmoid coverage and
// the online softmax (two exps, a log1p, three divisions), plus a
// C-wide class accumulate; the backward replays that geometry and chains
// the closed-form cotangents. Bytes are small beside it: the face
// constants of a chunk are read once per tile, pixels once.
//
// The forward: one thread per pixel, with the active chunk's face constants
// and one-hot rows staged in shared memory (every thread reads the same
// face at the same time, so the reads are broadcasts). The class
// accumulator / one-hot row (MAXC floats) is only ever indexed by
// compile-time-unrolled loops, so it stays in registers. No tensor cores,
// no cp.async, no persistent grid yet.
//
// The backward, redesigned for this card:
// - Equal work items. One item is one active (scene, tile, chunk): PT
//   pixels x FC faces. The grid has one block per chunk slot of clist
//   (K x T x B); a block past its tile's count exits at once, so a tile with
//   many active chunks no longer sets the kernel's length, and no count is
//   read back to the host (measured faster than a persistent grid striding
//   over a work-item list built on the device: PERF.md, Findings).
// - Per-pixel terms staged per item in shared memory as rows [q][8] (two
//   16-byte broadcast loads per pixel, seven scalar loads before) and Cbar
//   as float4. They are computed by the item itself from the forward's
//   residuals: on the card that measured faster than computing them once
//   per tile into a scratch and copying each item's rows in with
//   double-buffered cp.async (PERF.md, Findings).
// - One shared sigmoid per pair: e = exp(-|dd|) and r = 1/(1+e) give both
//   the visibility weight and the coverage sigmoid (see the inner loop);
//   __expf and approximate reciprocals, in the backward only.
// One thread per face: each face's 15 gradient sums stay in registers over
// the item's pixels.
//
// Cross-tile reduction of the backward: the TPU kernel carries fgrad
// across a sequential grid. Here blocks run in parallel, so each item adds
// its per-face sums to fgrad with one atomicAdd per (face, row) after the
// reduction over its 128 pixels in registers. The fp32 summation order
// over tiles therefore varies from run to run: rounding-level differences,
// held to the rtol 2e-3 / atol 2e-3*max|ref| gradient tolerance of the JAX
// package's Pallas parity test.
//
// Built by nvcc with a plain C interface (no PyTorch headers) and loaded
// with ctypes (sln_tpu_torch/kernels.py). Launchers run on the caller's
// stream, allocate nothing, never synchronise, and return
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int PT = 128;    // pixels per tile = threads per block
constexpr int FC = 128;    // faces per chunk
constexpr int MAXC = 32;   // class accumulator width
constexpr int R_NX = 0, R_NY = 3, R_C = 6, R_IL = 9, R_IZ = 13;

struct Face {
  float nx[3], ny[3], c[3], il[3], iz[3];
};

struct Terms {
  float e[3], s[3], d, inv_Tn, lam[3], inv_n, h[3], zinv, zbuf, dd, logit,
      lomc;
};

// Per-(pixel, face) terms, as sln_tpu's _chunk_geometry.
__device__ __forceinline__ void geometry(const Face& f, float px, float py,
                                         float inv_sigma, float inv_gamma,
                                         Terms& g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.e[k] = f.nx[k] * px + f.ny[k] * py + f.c[k];
    g.s[k] = g.e[k] * f.il[k];
  }
  g.d = fminf(fminf(g.s[0], g.s[1]), g.s[2]);
  const float Tsum = g.e[0] + g.e[1] + g.e[2];
  const float Tn = fabsf(Tsum) > 1e-12f ? Tsum : 1.0f;
  g.inv_Tn = 1.0f / Tn;
  g.lam[0] = g.e[1] * g.inv_Tn;  // lam_k = e_{k+1} / T
  g.lam[1] = g.e[2] * g.inv_Tn;
  g.lam[2] = g.e[0] * g.inv_Tn;
  float cl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) cl[k] = fminf(fmaxf(g.lam[k], 0.0f), 1.0f);
  g.inv_n = 1.0f / fmaxf(cl[0] + cl[1] + cl[2], 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) g.h[k] = cl[k] * g.inv_n;
  g.zinv = g.h[0] * f.iz[0] + g.h[1] * f.iz[1] + g.h[2] * f.iz[2];
  g.zbuf = 1.0f / fmaxf(g.zinv, 1e-12f);
  // linear-inside / quadratic-outside coverage; log_sigmoid(dd) and
  // log_sigmoid(-dd) share one exp and one log1p
  g.dd = g.d * (1.0f + fmaxf(-g.d, 0.0f)) * inv_sigma;
  const float lse = log1pf(expf(-fabsf(g.dd)));
  g.logit = fminf(g.dd, 0.0f) - lse - g.zbuf * inv_gamma;
  g.lomc = fminf(-g.dd, 0.0f) - lse;
}

__global__ void __launch_bounds__(PT)
    raster_fwd_kernel(const float* __restrict__ fdata,
                      const float* __restrict__ onehot,
                      const int* __restrict__ counts,
                      const int* __restrict__ clist,
                      float* __restrict__ depth, float* __restrict__ classes,
                      float* __restrict__ res, int T, int K, int Fp, int C,
                      int S, float inv_sigma, float inv_gamma, float z_far) {
  __shared__ float fd_s[16][FC];
  __shared__ __align__(16) float oh_s[FC][MAXC];

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p = t * PT + tid;
  const float px = static_cast<float>(p % S) + 0.5f;
  const float py = static_cast<float>(p / S) + 0.5f;
  const float* fd_b = fdata + static_cast<size_t>(b) * 16 * Fp;
  const float* oh_b = onehot + static_cast<size_t>(b) * Fp * C;
  const int n = min(counts[b * T + t], K);
  const int* cl = clist + (static_cast<size_t>(b) * T + t) * K;

  float m = -1e30f, s = 0.0f, az = 0.0f, alt = 0.0f;
  float ac[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) ac[c] = 0.0f;

  for (int j = 0; j < n; ++j) {
    const int chunk = cl[j];  // the same for every thread of the block
    if (chunk < 0 || chunk >= K) continue;
    const int f0 = chunk * FC;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < 16 * FC; i += PT) {
      const int r = i / FC, f = i % FC;
      fd_s[r][f] = fd_b[static_cast<size_t>(r) * Fp + f0 + f];
    }
    for (int i = tid; i < FC * MAXC; i += PT) {
      const int f = i / MAXC, c = i % MAXC;
      oh_s[f][c] = c < C ? oh_b[static_cast<size_t>(f0 + f) * C + c] : 0.0f;
    }
    __syncthreads();

    for (int f = 0; f < FC; ++f) {
      Face face;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        face.nx[k] = fd_s[R_NX + k][f];
        face.ny[k] = fd_s[R_NY + k][f];
        face.c[k] = fd_s[R_C + k][f];
        face.il[k] = fd_s[R_IL + k][f];
        face.iz[k] = fd_s[R_IZ + k][f];
      }
      Terms g;
      geometry(face, px, py, inv_sigma, inv_gamma, g);
      // online softmax, rescaling only when the running max moves
      if (g.logit > m) {
        const float sc = expf(m - g.logit);
        s *= sc;
        az *= sc;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) ac[c] *= sc;
        m = g.logit;
      }
      const float w = expf(g.logit - m);
      s += w;
      az += w * g.zbuf;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) ac[c] += w * oh_s[f][c];
      alt += g.lomc;
    }
  }

  const float denom = fmaxf(s, 1e-30f);
  const float alpha = 1.0f - expf(alt);
  const size_t q = static_cast<size_t>(b) * T * PT + p;
  depth[q] = alpha * az / denom + (1.0f - alpha) * z_far;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) classes[q * C + c] = alpha * (ac[c] / denom);
  res[q * 4 + 0] = m;
  res[q * 4 + 1] = s;
  res[q * 4 + 2] = az;
  res[q * 4 + 3] = alt;
}

// Per-(pixel, face) terms of the backward: the forward's geometry() without
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
                      float* __restrict__ fgrad, int T, int K, int Fp, int C,
                      int S, float inv_sigma, float inv_gamma, float z_far) {
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
  float* fg_b = fgrad + static_cast<size_t>(b) * 16 * Fp;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    atomicAdd(&fg_b[static_cast<size_t>(R_NX + k) * Fp + col], g_nx[k]);
    atomicAdd(&fg_b[static_cast<size_t>(R_NY + k) * Fp + col], g_ny[k]);
    atomicAdd(&fg_b[static_cast<size_t>(R_C + k) * Fp + col], g_c[k]);
    atomicAdd(&fg_b[static_cast<size_t>(R_IL + k) * Fp + col], g_il[k]);
    atomicAdd(&fg_b[static_cast<size_t>(R_IZ + k) * Fp + col], g_iz[k]);
  }
}

}  // namespace

extern "C" {

int sln_tile_pixels() { return PT; }
int sln_chunk_faces() { return FC; }
int sln_max_classes() { return MAXC; }

const char* sln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// depth (B, P, 1), classes (B, P, C), res (B, P, 4); P = T * PT = S * S
int sln_raster_fwd(const void* fdata, const void* onehot, const void* counts,
                   const void* clist, void* depth, void* classes, void* res,
                   int B, int T, int K, int Fp, int C, int S,
                   float inv_sigma, float inv_gamma, float z_far,
                   void* stream) {
  if (B > 0 && T > 0) {
    raster_fwd_kernel<<<dim3(T, B), PT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fdata), static_cast<const float*>(onehot),
        static_cast<const int*>(counts), static_cast<const int*>(clist),
        static_cast<float*>(depth), static_cast<float*>(classes),
        static_cast<float*>(res), T, K, Fp, C, S, inv_sigma, inv_gamma,
        z_far);
  }
  return static_cast<int>(cudaGetLastError());
}

// fgrad (B, 16, Fp) must be zeroed by the caller; it is accumulated into.
// One block per chunk slot of clist; counts is read on the device only.
int sln_raster_bwd(const void* fdata, const void* onehot, const void* counts,
                   const void* clist, const void* res, const void* classes,
                   const void* g_depth, const void* g_classes, void* fgrad,
                   int B, int T, int K, int Fp, int C, int S,
                   float inv_sigma, float inv_gamma, float z_far,
                   void* stream) {
  if (B > 0 && T > 0 && K > 0) {
    raster_bwd_kernel<<<dim3(K, T, B), PT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fdata), static_cast<const float*>(onehot),
        static_cast<const int*>(counts), static_cast<const int*>(clist),
        static_cast<const float*>(res), static_cast<const float*>(classes),
        static_cast<const float*>(g_depth),
        static_cast<const float*>(g_classes), static_cast<float*>(fgrad), T,
        K, Fp, C, S, inv_sigma, inv_gamma, z_far);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward kernel's resources on the current device: info[0..5] = SMs,
// resident blocks per SM (occupancy query), registers per thread, local
// (spill) bytes per thread, static shared bytes per block, threads per
// block.
int sln_raster_bwd_info(int* info) {
  const void* kernel = reinterpret_cast<const void*>(raster_bwd_kernel);
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

}  // extern "C"
