// Forward radial degridding on Hopper: one thread per (spoke, readout)
// sample, a race-free gather of the sample's KB neighbourhood.
//
// Replaces tron_tpu/ops/degrid_pallas.py::_degrid_kernel (the chord-culled
// MXU degridder, the exact dataflow transpose of the gridding kernel).
//
//   s[c, p, u] = sum_dy sum_dx KB(yu - ys) KB(xu - xs) G[c, yu mod n, xu mod n]
//
// with the sample at radius rad[u] = (u/nro - 1/2) * n (any nro; the table
// is the caller's, shared with the gridding kernel's exact lattice), xs =
// rad[u] cos t_p + n/2, ys = rad[u] sin t_p + n/2, xu = ceil(xs - kw) + dx
// and yu = ceil(ys - kw) + dy for dx, dy in [0, noff), noff = int(2 kw) + 1:
// the formulas of the plain gather, ops/degrid.py, rounded step by step as
// torch rounds them.  `wrap` = 1 takes neighbours outside [0, n) mod n (the
// reference's periodic grid, src/tron.cu:569-570); `wrap` = 0 drops them
// (the clip convention of the gridding kernel, whose exact transpose this
// is then).
//
// Design (TRON's own forward gather, src/tron.cu:540-577, not the TPU's
// per-tile MXU dataflow): each thread owns one sample and writes its C
// complex outputs once, so there are no atomics and the output is
// deterministic.  The noff x-weights and noff y-weights are evaluated once
// (KB of kb.cuh, the rational I0 of kernels/kb.py), then the noff^2
// neighbours are walked row by row.  The grid is read as (n, n, 2C) f32
// planes, so one neighbour is one contiguous run of 2C floats (48 bytes at
// the whole-body geometry); at n = 512 and 6 coils the planes are 12.6 MB
// and stay in the 50 MB L2.  Channel blocks of up to 16 real channels run
// any C.
//
// Cost: per sample 2*noff KB evaluations and noff^2 reads of 2C floats from
// L2 (25 x 48 bytes at whole-body), all on the fp32 pipe: no tensor cores
// for any precision class.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstddef>

#include "kb.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChannels = 16;  // real channels per register block
constexpr int kMaxOff = 8;        // neighbours per axis: int(2 kw) + 1 <= 8

template <int KP>
__global__ void __launch_bounds__(kThreads)
degrid_radial2d_kernel(const float* __restrict__ grid,  // (n, n, K)
                       const float* __restrict__ ct,    // (npe,)
                       const float* __restrict__ st,    // (npe,)
                       const float* __restrict__ rad,   // (nro,)
                       float2* __restrict__ out,        // (K/2, npe, nro)
                       int npe, int nro, int n, int K, int noff, int wrap,
                       float kw, float beta) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= npe * nro) return;
  const int p = i / nro;
  const int u = i - p * nro;
  const float inv_kw = 1.0f / kw;
  const float amp = 0.5f / kw;
  const float half = static_cast<float>(n / 2);

  const float kr = __ldg(rad + u);
  const float xs = __fadd_rn(__fmul_rn(kr, __ldg(ct + p)), half);
  const float ys = __fadd_rn(__fmul_rn(kr, __ldg(st + p)), half);
  const int x0 = static_cast<int>(ceilf(__fsub_rn(xs, kw)));
  const int y0 = static_cast<int>(ceilf(__fsub_rn(ys, kw)));

  // weights (0 past noff and, when clipping, outside the grid) and the
  // wrapped offsets of the neighbour columns and rows
  float wx[kMaxOff];
  float wy[kMaxOff];
  int ox[kMaxOff];
  int oy[kMaxOff];
#pragma unroll
  for (int d = 0; d < kMaxOff; ++d) {
    wx[d] = 0.0f;
    wy[d] = 0.0f;
    ox[d] = 0;
    oy[d] = 0;
    if (d < noff) {
      const int xu = x0 + d;
      const int yu = y0 + d;
      if (wrap || (xu >= 0 && xu < n)) {
        wx[d] = kb_weight(__fsub_rn(static_cast<float>(xu), xs), inv_kw, amp,
                          beta);
      }
      if (wrap || (yu >= 0 && yu < n)) {
        wy[d] = kb_weight(__fsub_rn(static_cast<float>(yu), ys), inv_kw, amp,
                          beta);
      }
      ox[d] = ((xu % n) + n) % n * K;
      oy[d] = ((yu % n) + n) % n * n * K;
    }
  }

  for (int k0 = 0; k0 < K; k0 += KP) {
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    const int kn = min(KP, K - k0);
#pragma unroll
    for (int dy = 0; dy < kMaxOff; ++dy) {
      if (wy[dy] == 0.0f) continue;
      const float* row = grid + oy[dy] + k0;
#pragma unroll
      for (int dx = 0; dx < kMaxOff; ++dx) {
        const float w = wx[dx] * wy[dy];
        if (w == 0.0f) continue;
        const float2* g = reinterpret_cast<const float2*>(row + ox[dx]);
#pragma unroll
        for (int k = 0; k < KP; k += 2) {
          if (k < kn) {
            const float2 v = __ldg(g + k / 2);
            acc[k] = fmaf(w, v.x, acc[k]);
            acc[k + 1] = fmaf(w, v.y, acc[k + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KP; k += 2) {
      if (k < kn) {
        const int c = (k0 + k) / 2;
        out[(static_cast<size_t>(c) * npe + p) * nro + u] =
            make_float2(acc[k], acc[k + 1]);
      }
    }
  }
}

template <int KP>
void launch(const float* grid, const float* ct, const float* st,
            const float* rad, float2* out, int npe, int nro, int n, int K,
            int noff, int wrap, float kw, float beta, cudaStream_t stream) {
  const int blocks = (npe * nro + kThreads - 1) / kThreads;
  degrid_radial2d_kernel<KP><<<blocks, kThreads, 0, stream>>>(
      grid, ct, st, rad, out, npe, nro, n, K, noff, wrap, kw, beta);
}

}  // namespace

extern "C" {

// grid: (n, n, K) f32 planes, K = 2C even (channel 2c is coil c's real
// part, 2c+1 its imaginary part); ct, st: (npe,) f32; rad: (nro,) f32
// sample radii; out: (C, npe, nro) complex64.  npe*nro and n*n*K must fit
// an int (the wrapper checks).  Returns cudaGetLastError() after the
// launch (0 on success).
int tron_degrid_radial2d_planes(const void* grid, const void* ct,
                                const void* st, const void* rad, void* out,
                                int npe, int nro, int n, int K, int noff,
                                int wrap, float kw, float beta, void* stream) {
  if (K <= 0 || (K & 1) || n <= 0 || nro <= 0 || npe <= 0 || noff < 1 ||
      noff > kMaxOff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* g = static_cast<const float*>(grid);
  const float* c = static_cast<const float*>(ct);
  const float* s = static_cast<const float*>(st);
  const float* r = static_cast<const float*>(rad);
  float2* o = static_cast<float2*>(out);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (K < kMaxChannels ? K : kMaxChannels) {
    case 2: launch<2>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    case 4: launch<4>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    case 6: launch<6>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    case 8: launch<8>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    case 10: launch<10>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    case 12: launch<12>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    case 14: launch<14>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
    default: launch<16>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
