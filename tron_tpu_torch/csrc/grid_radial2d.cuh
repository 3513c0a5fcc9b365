// Device code shared by the three gridding kernels (csrc/grid_radial2d.cu,
// B1 _win_kernel and B2 _grid_kernel; csrc/grid_radial2d_batched.cu, B5
// _win_kernel_batched; csrc/grid_seg_radial2d.cu, B4 _seg_kernel): the
// contract below, the band of one spoke over a pixel span (span_band), the
// store of a channel block, and the argument checks.  Their tile machinery
// (workspace, passes 1, 2 and 4, pass 3's staging and FMA walk) is in
// grid_tiles.cuh.
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
// A pixel's band of one spoke is the radius band where |r cos t - X| < kw
// and |r sin t - Y| < kw, converted to rows and widened by one row on each
// side so that fp32 rounding of the band edges never drops a term; KB's own
// support test (|x| < kw, kernels/kb.py) then decides each term exactly as
// the plain version does.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "kb.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxChannels = 16;   // real channels per register block

// A pixel (or a tile's first pixel) and the launch's KB and lattice.
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
