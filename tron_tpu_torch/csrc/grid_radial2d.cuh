// Device code shared by the three gridding kernels:
//   - grid_tile_*_kernel (csrc/grid_radial2d.cu; B1 _win_kernel and B2
//     _grid_kernel): the per-tile contraction over load-balanced work items,
//     whose tile bands are span_band below over a tile's pixel span;
//   - grid_radial2d_kernel<KP, LATTICE, NSLOT>: the per-pixel gather with a
//     static unroll over NSLOT row slots (csrc/grid_radial2d_batched.cu; B5
//     _win_kernel_batched);
//   - grid_seg_radial2d_kernel (csrc/grid_seg_radial2d.cu; B4 _seg_kernel),
//     the per-pixel gather over a tile's culled spoke list.
// The two per-pixel kernels evaluate one (pixel, spoke) pair with
// grid_spoke below, so they sum the same terms in the same order and give
// the same output bits; the tile kernel sums the same terms with the same
// weights, regrouped by work item.
//
// The contract (tron_tpu/ops/grid_pallas.py):
//
//   out[c, Y, X] = scale * sum_pe sum_u KB(r_u sin t_pe - Y)
//                                      * KB(r_u cos t_pe - X) * s[pe, u, c]
//
// with scale = 1/(nxos*npe), footprints clipped at the grid edge (no wrap),
// and signed samples allowed (the incremental deltas grid leaving spokes
// negated).  Two row lattices:
//   - integer radii (nR = nxos): row u sits at r_u = u - nxos/2, u >= 1
//     (row 0, radius -nxos/2, is never gridded; r = 0 is counted once);
//   - exact lattice (any nR, the raw readouts): row u sits at the radius
//     rad[u] = (u/nR - 1/2) * nxos given by the caller, the same table the
//     degridding kernel reads, so the two stay one adjoint pair; u >= 1
//     (readout 0 is never gridded).
//
// In the per-pixel kernels each thread owns pixel (Y, X) and keeps the
// real channel sums of one channel block in registers (12 at the
// whole-body geometry: 6 coils, re and im).  Per spoke it computes the
// radius band where |r cos t - X| < kw and |r sin t - Y| < kw, converts it
// to rows and widens it by one row on each side so that fp32 rounding of
// the band edges never drops a term; KB's own support test (|x| < kw,
// kernels/kb.py) then decides each term exactly as the plain version does.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "kb.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kSpokeChunk = 1024;  // spokes staged in shared memory per pass
constexpr int kMaxChannels = 16;   // real channels per register block

// What one thread needs to know about its pixel and the launch.
struct Pixel {
  float X, Y;                       // coordinates relative to the centre
  float kw, inv_kw, amp, beta;      // KB
  int h, rmin, rmax;                // integer radii: r in [rmin, rmax]
  int nR;                           // rows of a spoke
  float rows_per_unit, hrow, span;  // exact lattice: row = r*nR/nxos + nR/2
};

__device__ __forceinline__ Pixel make_pixel(int x, int y, int nR, int nxos,
                                            float kw, float beta) {
  Pixel px;
  px.h = nxos / 2;
  px.rmin = 1 - px.h;
  px.rmax = nxos - 1 - px.h;
  px.X = static_cast<float>(x - px.h);
  px.Y = static_cast<float>(y - px.h);
  px.kw = kw;
  px.inv_kw = 1.0f / kw;
  px.amp = 0.5f / kw;
  px.beta = beta;
  px.nR = nR;
  px.rows_per_unit = static_cast<float>(nR) / static_cast<float>(nxos);
  px.hrow = 0.5f * static_cast<float>(nR);
  px.span = static_cast<float>(nxos);
  return px;
}

// Narrow [lo, hi] to the radii where r*c - p lies within kw of [0, p1 - p0]
// for some p in [p0, p1], using inv = 1/c (inv == 0 marks c == 0: then the
// axis does not bound r).  p0 == p1 is one pixel's band; a tile's span
// gives the union of its pixels' bands, since the rounded (p0 - kw) * inv
// and (p1 + kw) * inv bound every pixel's own rounded ends.
__device__ __forceinline__ void narrow(float p0, float p1, float kw, float inv,
                                       float& lo, float& hi) {
  if (inv != 0.0f) {
    const float a = (p0 - kw) * inv;
    const float b = (p1 + kw) * inv;
    lo = fmaxf(lo, fminf(a, b));
    hi = fminf(hi, fmaxf(a, b));
  }
}

// The widened band of one spoke over the pixels [X0, X1] x [Y0, Y1] (one
// pixel: X0 == X1, Y0 == Y1): radii [a, b] (integer radii) or rows [a, b]
// (exact lattice).  a > b when it is empty.
template <bool LATTICE>
__device__ __forceinline__ void span_band(const Pixel& px, float X1, float Y1,
                                          float ic, float is, int& a, int& b) {
  if constexpr (!LATTICE) {
    float lo = static_cast<float>(px.rmin);
    float hi = static_cast<float>(px.rmax);
    narrow(px.X, X1, px.kw, ic, lo, hi);
    narrow(px.Y, Y1, px.kw, is, lo, hi);
    // clamp before the int conversion (1/c can be huge), then widen by one
    // row on each side
    lo = fminf(lo, static_cast<float>(px.rmax + 2));
    hi = fmaxf(hi, static_cast<float>(px.rmin - 2));
    a = max(static_cast<int>(floorf(lo)) - 1, px.rmin);
    b = min(static_cast<int>(ceilf(hi)) + 1, px.rmax);
  } else {
    float lo = -px.span;
    float hi = px.span;
    narrow(px.X, X1, px.kw, ic, lo, hi);
    narrow(px.Y, Y1, px.kw, is, lo, hi);
    lo = fminf(lo, px.span);
    hi = fmaxf(hi, -px.span);
    a = max(static_cast<int>(floorf(lo * px.rows_per_unit + px.hrow)) - 1, 1);
    b = min(static_cast<int>(ceilf(hi * px.rows_per_unit + px.hrow)) + 1,
            px.nR - 1);
  }
}

// Add spoke pe's terms at the pixel to acc (channels k0 .. k0+kn-1).
//   NSLOT == 0: a loop over the band's rows that skips a row as soon as one
//     of its two weights is 0 (B4's per-pixel code);
//   NSLOT > 0: a static unroll over NSLOT row slots (B5): slot j grids row
//     a + j with the row index clamped into the plane, and its weight is
//     multiplied by a 0/1 mask (a + j <= b); nothing is skipped.  A masked
//     or out-of-support slot adds fmaf(0, s, acc) == acc, so the sums equal
//     the loop's (B4's) bit for bit.  The caller guarantees b - a + 1 <= NSLOT.
template <int KP, bool LATTICE, int NSLOT>
__device__ __forceinline__ void grid_spoke(const float* __restrict__ planes,
                                           const float* __restrict__ rad,
                                           int pe, int k0, int kn, int K,
                                           float c, float s, float ic, float is,
                                           const Pixel& px, float (&acc)[KP]) {
  int a, b;
  span_band<LATTICE>(px, px.X, px.Y, ic, is, a, b);
  if (a > b) return;
  // row u of spoke pe at base + u*K (integer radii: u is the radius r)
  const float* base =
      LATTICE ? planes + static_cast<size_t>(pe) * px.nR * K + k0
              : planes + (static_cast<size_t>(pe) * px.nR + px.h) * K + k0;
  if constexpr (NSLOT == 0) {
    for (int u = a; u <= b; ++u) {
      const float rf = LATTICE ? __ldg(rad + u) : static_cast<float>(u);
      const float wx = kb_weight(__fsub_rn(__fmul_rn(rf, c), px.X), px.inv_kw,
                                 px.amp, px.beta);
      if (wx == 0.0f) continue;
      const float wy = kb_weight(__fsub_rn(__fmul_rn(rf, s), px.Y), px.inv_kw,
                                 px.amp, px.beta);
      if (wy == 0.0f) continue;
      const float w = wy * wx;
      const float* sr = base + static_cast<ptrdiff_t>(u) * K;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < kn) acc[k] = fmaf(w, __ldg(sr + k), acc[k]);
      }
    }
  } else {
    const int top = LATTICE ? px.nR - 1 : px.rmax;
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) {
      const int u = min(a + j, top);
      const float m = a + j <= b ? 1.0f : 0.0f;
      const float rf = LATTICE ? __ldg(rad + u) : static_cast<float>(u);
      const float wx = kb_weight(__fsub_rn(__fmul_rn(rf, c), px.X), px.inv_kw,
                                 px.amp, px.beta);
      const float wy = kb_weight(__fsub_rn(__fmul_rn(rf, s), px.Y), px.inv_kw,
                                 px.amp, px.beta);
      const float w = wy * wx * m;
      const float* sr = base + static_cast<ptrdiff_t>(u) * K;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < kn) acc[k] = fmaf(w, __ldg(sr + k), acc[k]);
      }
    }
  }
}

// Store one channel block of sums as complex64, scaled.
template <int KP>
__device__ __forceinline__ void store(float2* __restrict__ out, const float (&acc)[KP],
                                      int k0, int kn, int nxos, int x, int y,
                                      float scale) {
#pragma unroll
  for (int k = 0; k < KP; k += 2) {
    if (k < kn) {
      const int c = (k0 + k) / 2;
      out[(static_cast<size_t>(c) * nxos + y) * nxos + x] =
          make_float2(acc[k] * scale, acc[k + 1] * scale);
    }
  }
}

// One thread per output pixel, a gather over every spoke in index order;
// cos/sin and their reciprocals are staged in shared memory in chunks.
// NSLOT > 0: the static-unroll kernel (B5); NSLOT == 0, a plain row loop
// per (pixel, spoke), is not launched (B4 runs that code over culled lists).
template <int KP, bool LATTICE, int NSLOT>
__global__ void __launch_bounds__(kThreads)
grid_radial2d_kernel(const float* __restrict__ planes,  // (npe, nR, K)
                     const float* __restrict__ ct,      // (npe,)
                     const float* __restrict__ st,      // (npe,)
                     const float* __restrict__ rad,     // (nR,) or null
                     float2* __restrict__ out,          // (K/2, nxos, nxos)
                     int npe, int nR, int nxos, int K, float kw, float beta,
                     float scale) {
  __shared__ float s_c[kSpokeChunk];
  __shared__ float s_s[kSpokeChunk];
  __shared__ float s_ic[kSpokeChunk];
  __shared__ float s_is[kSpokeChunk];

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const bool active = x < nxos && y < nxos;
  const Pixel px = make_pixel(x, y, nR, nxos, kw, beta);

  for (int k0 = 0; k0 < K; k0 += KP) {
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    const int kn = min(KP, K - k0);

    for (int p0 = 0; p0 < npe; p0 += kSpokeChunk) {
      const int m = min(kSpokeChunk, npe - p0);
      __syncthreads();
      for (int i = tid; i < m; i += kThreads) {
        const float c = ct[p0 + i];
        const float s = st[p0 + i];
        s_c[i] = c;
        s_s[i] = s;
        s_ic[i] = c != 0.0f ? 1.0f / c : 0.0f;
        s_is[i] = s != 0.0f ? 1.0f / s : 0.0f;
      }
      __syncthreads();
      if (!active) continue;
      for (int i = 0; i < m; ++i) {
        grid_spoke<KP, LATTICE, NSLOT>(planes, rad, p0 + i, k0, kn, K, s_c[i],
                                       s_s[i], s_ic[i], s_is[i], px, acc);
      }
    }
    if (active) store<KP>(out, acc, k0, kn, nxos, x, y, scale);
  }
}

template <int KP, int NSLOT>
void launch_grid(const float* planes, const float* ct, const float* st,
                 const float* rad, float2* out, int npe, int nR, int nxos,
                 int K, float kw, float beta, float scale, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nxos + kBlockX - 1) / kBlockX,
                  (nxos + kBlockY - 1) / kBlockY);
  if (rad == nullptr) {
    grid_radial2d_kernel<KP, false, NSLOT><<<grid, block, 0, stream>>>(
        planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale);
  } else {
    grid_radial2d_kernel<KP, true, NSLOT><<<grid, block, 0, stream>>>(
        planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale);
  }
}

// Calls f(std::integral_constant<int, KP>{}) with the register channel block
// KP for K real channels (K even; blocks of 16 above 16 channels).
template <typename F>
void with_channel_block(int K, F&& f) {
  switch (K < kMaxChannels ? K : kMaxChannels) {
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 10: f(std::integral_constant<int, 10>{}); break;
    case 12: f(std::integral_constant<int, 12>{}); break;
    case 14: f(std::integral_constant<int, 14>{}); break;
    default: f(std::integral_constant<int, 16>{}); break;
  }
}

// The arguments every gridding entry point checks the same way.
inline bool bad_args(int npe, int nR, int nxos, int K, const void* rad) {
  return K <= 0 || (K & 1) || nxos <= 0 || npe < 0 || nR < 2 ||
         (rad == nullptr && nR != nxos);
}

}  // namespace
