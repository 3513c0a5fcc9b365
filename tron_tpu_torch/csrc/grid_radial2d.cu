// Adjoint radial gridding on Hopper: one thread per output pixel, a
// race-free gather over the spokes whose radius band reaches the pixel.
//
// Replaces tron_tpu/ops/grid_pallas.py::_win_kernel (the windowed, chord-
// culled MXU gridder of the main path, in its integer-radius and its
// exact-lattice `raw_nro` modes) and ::_grid_kernel (the dense-range
// gridder for grids that do not tile); this kernel has no tiling
// constraint, so one launch covers both contracts.
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
// Design (TRON's own gather, src/tron.cu:465-536, not the TPU dataflow):
// each thread owns pixel (Y, X) and keeps the real channel sums of one
// channel block in registers (12 at the whole-body geometry: 6 coils, re
// and im).  It walks the spokes in index order; cos/sin and their
// reciprocals are staged in shared memory in chunks.  For each spoke it
// computes the radius band where |r cos t - X| < kw and |r sin t - Y| < kw,
// converts it to rows and widens it by one row on each side so that fp32
// rounding of the band edges never drops a term; KB's own support test
// (|x| < kw, kernels/kb.py) then decides each term exactly as the plain
// version does.  The TPU kernel culls per tile with host-built chord
// tables; here the culling is the per-(pixel, spoke) band test, with no
// tables.
//
// Cost: bounded by the band test (every pixel x every spoke) and the KB
// evaluations of the hits, all on the fp32 pipe.  There are no tensor
// cores in this first version, whatever precision class the caller asks
// for: every term is an fp32 FMA.  Summation order is fixed (spokes in
// index order, rows ascending), with no atomics, so the same input gives
// the same output bits.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstddef>

#include "kb.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kSpokeChunk = 1024;  // spokes staged in shared memory per pass
constexpr int kMaxChannels = 16;   // real channels per register block

// Narrow [lo, hi] to the radii where |r*c - p| < kw, using inv = 1/c
// (inv == 0 marks c == 0: then the axis does not bound r).
__device__ __forceinline__ void narrow(float p, float kw, float inv, float& lo,
                                       float& hi) {
  if (inv != 0.0f) {
    const float a = (p - kw) * inv;
    const float b = (p + kw) * inv;
    lo = fmaxf(lo, fminf(a, b));
    hi = fminf(hi, fmaxf(a, b));
  }
}

// LATTICE = false: integer radii, nR == nxos, rad unused.
// LATTICE = true: row u at radius rad[u], any nR.
template <int KP, bool LATTICE>
__global__ void __launch_bounds__(kBlockX * kBlockY)
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
  const int h = nxos / 2;
  const int rmin = 1 - h;
  const int rmax = nxos - 1 - h;
  const float X = static_cast<float>(x - h);
  const float Y = static_cast<float>(y - h);
  const float inv_kw = 1.0f / kw;
  const float amp = 0.5f / kw;
  // exact lattice: radius r lies at row r * nR/nxos + nR/2
  const float rows_per_unit = static_cast<float>(nR) / static_cast<float>(nxos);
  const float hrow = 0.5f * static_cast<float>(nR);
  const float span = static_cast<float>(nxos);

  for (int k0 = 0; k0 < K; k0 += KP) {
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    const int kn = min(KP, K - k0);

    for (int p0 = 0; p0 < npe; p0 += kSpokeChunk) {
      const int m = min(kSpokeChunk, npe - p0);
      __syncthreads();
      for (int i = tid; i < m; i += kBlockX * kBlockY) {
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
        const float c = s_c[i];
        const float s = s_s[i];
        if constexpr (!LATTICE) {
          float lo = static_cast<float>(rmin);
          float hi = static_cast<float>(rmax);
          narrow(X, kw, s_ic[i], lo, hi);
          narrow(Y, kw, s_is[i], lo, hi);
          // clamp before the int conversion (1/c can be huge), then widen
          // by one row on each side
          lo = fminf(lo, static_cast<float>(rmax + 2));
          hi = fmaxf(hi, static_cast<float>(rmin - 2));
          const int r0 = max(static_cast<int>(floorf(lo)) - 1, rmin);
          const int r1 = min(static_cast<int>(ceilf(hi)) + 1, rmax);
          if (r0 > r1) continue;
          const float* row =
              planes + (static_cast<size_t>(p0 + i) * nR + h) * K + k0;
          for (int r = r0; r <= r1; ++r) {
            const float rf = static_cast<float>(r);
            const float wx = kb_weight(__fsub_rn(__fmul_rn(rf, c), X), inv_kw,
                                       amp, beta);
            if (wx == 0.0f) continue;
            const float wy = kb_weight(__fsub_rn(__fmul_rn(rf, s), Y), inv_kw,
                                       amp, beta);
            if (wy == 0.0f) continue;
            const float w = wy * wx;
            const float* sr = row + static_cast<ptrdiff_t>(r) * K;
#pragma unroll
            for (int k = 0; k < KP; ++k) {
              if (k < kn) acc[k] = fmaf(w, __ldg(sr + k), acc[k]);
            }
          }
        } else {
          float lo = -span;
          float hi = span;
          narrow(X, kw, s_ic[i], lo, hi);
          narrow(Y, kw, s_is[i], lo, hi);
          lo = fminf(lo, span);
          hi = fmaxf(hi, -span);
          const int u0 =
              max(static_cast<int>(floorf(lo * rows_per_unit + hrow)) - 1, 1);
          const int u1 = min(
              static_cast<int>(ceilf(hi * rows_per_unit + hrow)) + 1, nR - 1);
          if (u0 > u1) continue;
          const float* row =
              planes + static_cast<size_t>(p0 + i) * nR * K + k0;
          for (int u = u0; u <= u1; ++u) {
            const float rf = __ldg(rad + u);
            const float wx = kb_weight(__fsub_rn(__fmul_rn(rf, c), X), inv_kw,
                                       amp, beta);
            if (wx == 0.0f) continue;
            const float wy = kb_weight(__fsub_rn(__fmul_rn(rf, s), Y), inv_kw,
                                       amp, beta);
            if (wy == 0.0f) continue;
            const float w = wy * wx;
            const float* sr = row + static_cast<ptrdiff_t>(u) * K;
#pragma unroll
            for (int k = 0; k < KP; ++k) {
              if (k < kn) acc[k] = fmaf(w, __ldg(sr + k), acc[k]);
            }
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int k = 0; k < KP; k += 2) {
        if (k < kn) {
          const int c = (k0 + k) / 2;
          out[(static_cast<size_t>(c) * nxos + y) * nxos + x] =
              make_float2(acc[k] * scale, acc[k + 1] * scale);
        }
      }
    }
  }
}

template <int KP>
void launch(const float* planes, const float* ct, const float* st,
            const float* rad, float2* out, int npe, int nR, int nxos, int K,
            float kw, float beta, float scale, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nxos + kBlockX - 1) / kBlockX,
                  (nxos + kBlockY - 1) / kBlockY);
  if (rad == nullptr) {
    grid_radial2d_kernel<KP, false><<<grid, block, 0, stream>>>(
        planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale);
  } else {
    grid_radial2d_kernel<KP, true><<<grid, block, 0, stream>>>(
        planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale);
  }
}

}  // namespace

extern "C" {

// planes: (npe, nR, K) f32, K = 2C even; ct, st: (npe,) f32; rad: null for
// integer radii (then nR == nxos), else (nR,) f32 row radii; out: (C, nxos,
// nxos) complex64.  Returns cudaGetLastError() after the launch (0 on
// success).
int tron_grid_radial2d_planes(const void* planes, const void* ct,
                              const void* st, const void* rad, void* out,
                              int npe, int nR, int nxos, int K, float kw,
                              float beta, float scale, void* stream) {
  if (K <= 0 || (K & 1) || nxos <= 0 || npe < 0 || nR < 2 ||
      (rad == nullptr && nR != nxos)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(planes);
  const float* c = static_cast<const float*>(ct);
  const float* s = static_cast<const float*>(st);
  const float* r = static_cast<const float*>(rad);
  float2* o = static_cast<float2*>(out);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (K < kMaxChannels ? K : kMaxChannels) {
    case 2: launch<2>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    case 4: launch<4>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    case 6: launch<6>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    case 8: launch<8>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    case 10: launch<10>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    case 12: launch<12>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    case 14: launch<14>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
    default: launch<16>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, strm); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tron_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
