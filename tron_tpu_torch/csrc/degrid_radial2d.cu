// Forward radial degridding on Hopper: a warp-cooperative, race-free
// gather of each (spoke, readout) sample's KB neighbourhood.
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
// Bound: bytes.  A CGNR frame at whole-body (6 x 512^2 complex64 in, 6 x
// 204 x 512 out) moves 17.6 MB, 5.25 us at 3.35 TB/s.  Every sample reads
// noff^2 neighbours of 2C floats, 25 x 48 bytes at whole-body, ~7x the grid
// from L2 and L1; neighbouring samples of a spoke share most of them.
//
// Design: one owner per sample, so no atomics and a deterministic output,
// but spread over a group of G lanes instead of one thread, whose 25 serial
// neighbour walks with every weight and offset in registers (150 at 12
// channels) kept the occupancy low.  The grid is read as (n, n, 2C) f32
// planes, so a neighbour row dy is one run of noff * 2C floats (240 bytes
// at whole-body; split in two where it wraps).  Lane g of a group owns
// channel group g: V = 4 consecutive real channels (2 where 2C is not a
// multiple of 4), so at each neighbour the group reads one 2C-float piece
// in coalesced 16-byte loads, and the groups of a warp (8 samples at 12
// channels, consecutive readouts of a spoke) read overlapping runs.  G is
// the channel-group count rounded up to a power of two (4 at 12 channels).
// The 2*noff KB weights are evaluated once per sample, spread over the G
// lanes (the rational I0 of kb.cuh), and shared with __shfl_sync.  A lane
// owns whole channels, so the sum over neighbours is its own, in the old
// kernel's order (rows dy, then columns dx): no cross-lane reduction.  The
// grid is persistent: as many 256-thread blocks as fit on the SMs at once
// (whole waves), walking the samples in block strides.  Channel blocks of
// up to 16 real channels run any C.
//
// Precision classes (a template parameter; precision.cuh): float32 sums
// w = wx * wy times G per neighbour, one fp32 FMA each.  A bf16 class takes
// its weights rounded as kb_kernel's (kb.cuh) and
// JAX's grouping (degrid_pallas.py:93-146): per neighbour row dy, v =
// sum_dx A G over the row with A = wx and G the grid rounded to bfloat16
// and split (bfloat16 Ah Gh; bf16x2 Ah Gh + Ah Gl; bf16x3 Ah Gh + Ah Gl +
// Al Gh, exact products summed in fp32), then acc = fmaf(wy, v, acc) in
// fp32, wy not rounded.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "kb.cuh"
#include "precision.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;  // real channels per channel block
// Neighbours per axis, noff = int(2 kw) + 1, that an instantiation holds in
// registers: the narrow one (kw < 4, the default kw 2 has noff 5) and the
// wide one up to the gridding kernels' limit (kw < 7).  Two instantiations,
// so that the wide one's weight and offset arrays cost the narrow one no
// registers.
constexpr int kNarrowOff = 8;
constexpr int kWideOff = 14;

// v mod n for any int v; one compare on the common path, 0 <= v < n.
__device__ __forceinline__ int wrap_index(int v, int n) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(n)) return v;
  return ((v % n) + n) % n;
}

__host__ __device__ constexpr int pow2_at_least(int v) {
  return v <= 1 ? 1 : 2 * pow2_at_least((v + 1) / 2);
}

template <int KP, int V, int MAXOFF, int CLS>
__global__ void __launch_bounds__(kThreads)
degrid_radial2d_kernel(const float* __restrict__ grid,  // (n, n, K)
                       const float* __restrict__ ct,    // (npe,)
                       const float* __restrict__ st,    // (npe,)
                       const float* __restrict__ rad,   // (nro,)
                       float2* __restrict__ out,        // (K/2, npe, nro)
                       int npe, int nro, int n, int K, int noff, int wrap,
                       float kw, float beta) {
  constexpr int G = pow2_at_least(KP / V);  // lanes per sample
  constexpr int PER = (MAXOFF + G - 1) / G;  // weights per lane and axis
  constexpr int SPB = kThreads / G;         // samples per block step
  using Vec = typename std::conditional<V == 4, float4, float2>::type;

  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);     // channel group of this lane
  const int gbase = lane & ~(G - 1);
  const float inv_kw = 1.0f / kw;
  const float amp = 0.5f / kw;
  const float half = static_cast<float>(n / 2);
  const unsigned total = static_cast<unsigned>(npe) * nro;  // < 2^31

  for (unsigned base = blockIdx.x * SPB; base < total; base += gridDim.x * SPB) {
    const unsigned i = base + threadIdx.x / G;
    const bool valid = i < total;  // uniform over the group
    const int p = valid ? static_cast<int>(i / nro) : 0;
    const int u = valid ? static_cast<int>(i) - p * nro : 0;
    const float kr = __ldg(rad + u);
    const float xs = __fadd_rn(__fmul_rn(kr, __ldg(ct + p)), half);
    const float ys = __fadd_rn(__fmul_rn(kr, __ldg(st + p)), half);
    const int x0 = static_cast<int>(ceilf(__fsub_rn(xs, kw)));
    const int y0 = static_cast<int>(ceilf(__fsub_rn(ys, kw)));

    // lane g evaluates the weights of offsets d = g, g + G, ...; 0 past
    // noff and, when clipping, outside the grid
    float mx[PER], my[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int d = g + G * j;
      mx[j] = 0.0f;
      my[j] = 0.0f;
      if (d < noff) {
        const int xu = x0 + d;
        const int yu = y0 + d;
        if (wrap || (xu >= 0 && xu < n)) {
          mx[j] = kb_weight<CLS != kF32>(__fsub_rn(static_cast<float>(xu), xs), inv_kw, amp, beta);
        }
        if (wrap || (yu >= 0 && yu < n)) {
          my[j] = kb_weight<CLS != kF32>(__fsub_rn(static_cast<float>(yu), ys), inv_kw, amp, beta);
        }
      }
    }
    float wx[MAXOFF];
    int ox[MAXOFF];
#pragma unroll
    for (int d = 0; d < MAXOFF; ++d) {
      wx[d] = __shfl_sync(0xffffffffu, mx[(d / G) % PER], gbase | (d % G));
      ox[d] = wrap_index(x0 + d, n) * K;
    }

    // a bf16 class: A's hi half in place of wx, its lo half (bf16x3) beside it
    float al[MAXOFF];
    if constexpr (CLS != kF32) {
#pragma unroll
      for (int d = 0; d < MAXOFF; ++d) {
        const float ah = bf16r(wx[d]);
        if constexpr (CLS == kBF16x3) al[d] = bf16_lo(wx[d], ah);
        wx[d] = ah;
      }
    }

    for (int k0 = 0; k0 < K; k0 += KP) {
      const int kn = min(KP, K - k0);
      const bool mine = valid && g * V < kn;
      Vec acc{};
#pragma unroll 1
      for (int dy = 0; dy < noff; ++dy) {
        float my_d = my[0];  // my[dy / G], selected without local memory
#pragma unroll
        for (int j = 1; j < PER; ++j) my_d = dy / G == j ? my[j] : my_d;
        const float wy = __shfl_sync(0xffffffffu, my_d, gbase | (dy % G));
        if (wy == 0.0f) continue;
        const float* row = grid + static_cast<size_t>(wrap_index(y0 + dy, n)) * n * K + k0 + g * V;
        if constexpr (CLS == kF32) {
#pragma unroll
          for (int dx = 0; dx < MAXOFF; ++dx) {
            const float w = wx[dx] * wy;
            if (dx >= noff || w == 0.0f || !mine) continue;
            const Vec v = __ldg(reinterpret_cast<const Vec*>(row + ox[dx]));
            acc.x = fmaf(w, v.x, acc.x);
            acc.y = fmaf(w, v.y, acc.y);
            if constexpr (V == 4) {
              acc.z = fmaf(w, v.z, acc.z);
              acc.w = fmaf(w, v.w, acc.w);
            }
          }
        } else {
          Vec v{};  // the row's sum over x
#pragma unroll
          for (int dx = 0; dx < MAXOFF; ++dx) {
            const float a_lo = CLS == kBF16x3 ? al[dx] : 0.0f;
            if (dx >= noff || (wx[dx] == 0.0f && a_lo == 0.0f) || !mine) continue;
            const Vec gv = __ldg(reinterpret_cast<const Vec*>(row + ox[dx]));
            v.x = class_fma<CLS, false>(wx[dx], a_lo, gv.x, v.x);
            v.y = class_fma<CLS, false>(wx[dx], a_lo, gv.y, v.y);
            if constexpr (V == 4) {
              v.z = class_fma<CLS, false>(wx[dx], a_lo, gv.z, v.z);
              v.w = class_fma<CLS, false>(wx[dx], a_lo, gv.w, v.w);
            }
          }
          acc.x = fmaf(wy, v.x, acc.x);
          acc.y = fmaf(wy, v.y, acc.y);
          if constexpr (V == 4) {
            acc.z = fmaf(wy, v.z, acc.z);
            acc.w = fmaf(wy, v.w, acc.w);
          }
        }
      }
      if (mine) {
        const size_t c = (k0 + g * V) / 2;
        float2* o = out + (c * npe + p) * nro + u;
        o[0] = make_float2(acc.x, acc.y);
        if constexpr (V == 4) o[static_cast<size_t>(npe) * nro] = make_float2(acc.z, acc.w);
      }
    }
  }
}

template <int KP, int V, int MAXOFF, int CLS>
void launch(const float* grid, const float* ct, const float* st,
           const float* rad, float2* out, int npe, int nro, int n, int K,
           int noff, int wrap, float kw, float beta, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM, from the occupancy query
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, degrid_radial2d_kernel<KP, V, MAXOFF, CLS>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int spb = kThreads / pow2_at_least(KP / V);
  const long long need = (static_cast<long long>(npe) * nro + spb - 1) / spb;
  const long long full = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(need < full ? need : full);
  degrid_radial2d_kernel<KP, V, MAXOFF, CLS><<<blocks, kThreads, 0, stream>>>(
      grid, ct, st, rad, out, npe, nro, n, K, noff, wrap, kw, beta);
}

// Calls launch<KP, V, MAXOFF, CLS> for the first channel block of K real channels
// (KP = K below 16, else 16) with V = 4 floats per lane when K is a multiple
// of 4, else 2.
template <int KP, int MAXOFF, int CLS>
void dispatch_v(int K, const float* g, const float* c, const float* s,
               const float* r, float2* o, int npe, int nro, int n, int noff,
               int wrap, float kw, float beta, cudaStream_t strm) {
  if constexpr (KP % 4 == 0) {
    if (K % 4 == 0) {
      launch<KP, 4, MAXOFF, CLS>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm);
      return;
    }
  }
  launch<KP, 2, MAXOFF, CLS>(g, c, s, r, o, npe, nro, n, K, noff, wrap, kw, beta, strm);
}

// The channel-block switch for one neighbour capacity and class.
template <int MAXOFF, int CLS>
void dispatch_k(int K, const float* g, const float* c, const float* s,
               const float* r, float2* o, int npe, int nro, int n, int noff,
               int wrap, float kw, float beta, cudaStream_t strm) {
  switch (K < kMaxChannels ? K : kMaxChannels) {
    case 2: dispatch_v<2, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    case 4: dispatch_v<4, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    case 6: dispatch_v<6, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    case 8: dispatch_v<8, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    case 10: dispatch_v<10, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    case 12: dispatch_v<12, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    case 14: dispatch_v<14, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
    default: dispatch_v<16, MAXOFF, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm); break;
  }
}

}  // namespace

extern "C" {

// grid: (n, n, K) f32 planes, K = 2C even (channel 2c is coil c's real
// part, 2c+1 its imaginary part); ct, st: (npe,) f32; rad: (nro,) f32
// sample radii; out: (C, npe, nro) complex64; noff = int(2 kw) + 1 in 1 to
// 14 (kw < 7); cls the precision class (precision.cuh).  npe*nro and n*n*K
// must fit an int (the wrapper checks).  Returns cudaGetLastError() after
// the launch (0 on success).
int tron_degrid_radial2d_planes(const void* grid, const void* ct,
                                const void* st, const void* rad, void* out,
                                int npe, int nro, int n, int K, int noff,
                                int wrap, float kw, float beta, int cls, void* stream) {
  if (K <= 0 || (K & 1) || n <= 0 || nro <= 0 || npe <= 0 || noff < 1 ||
      noff > kWideOff || bad_class(cls)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* g = static_cast<const float*>(grid);
  const float* c = static_cast<const float*>(ct);
  const float* s = static_cast<const float*>(st);
  const float* r = static_cast<const float*>(rad);
  float2* o = static_cast<float2*>(out);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  with_class(cls, [&](auto cl) {
    constexpr int CLS = decltype(cl)::value;
    if (noff <= kNarrowOff) {
      dispatch_k<kNarrowOff, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm);
    } else {
      dispatch_k<kWideOff, CLS>(K, g, c, s, r, o, npe, nro, n, noff, wrap, kw, beta, strm);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
