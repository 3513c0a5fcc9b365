// Adjoint radial gridding as a tile-culled gather: one thread block per
// 16 x 16 output tile, one thread per pixel, each thread walking only the
// spokes whose line passes near its tile.
//
// Replaces tron_tpu/ops/grid_pallas.py::_seg_kernel (the segmented MXU
// gridder with angular-wedge culling, _culling_tables, reached with
// windowed=False).  Its contract is B1's (grid_radial2d.cuh); its idea is
// per-tile culling: a spoke takes part only in the tiles its line reaches.
// This is not the TPU dataflow (per-tile segment operands in VMEM, one MXU
// contraction per spoke chunk); it is B1's gather with the culling in
// front of it.
//
// Per chunk of 256 spokes (one per thread):
//   Phase 1: each thread tests one spoke against the block's tile with the
//     conservative bound of ops/cull.py: |cx sin t - cy cos t| <= d + reach,
//     d the tile's half-diagonal over pixel centres, reach = sqrt(2)*kw + 1
//     (a nonzero term at (X, Y) needs |r c - X| < kw and |r s - Y| < kw, so
//     the pixel lies within sqrt(2)*kw of the line).  The hits are compacted
//     into a shared-memory list in ascending spoke index with __ballot_sync,
//     __popc and a prefix over the block's 8 warps, with their cos, sin and
//     reciprocals.
//   Phase 2: each thread runs the per-(pixel, spoke) row loop
//     (grid_spoke<KP, LATTICE, 0>) over the listed spokes only.
// A culled spoke adds no nonzero term to any pixel of the tile, and the
// kept terms are summed in spoke order (spokes ascending, rows ascending),
// so the output equals the static-unroll kernel's bit for bit.  Any
// nxos (partial edge tiles), any npe (chunks), both row lattices.
//
// Cost: the band test now runs per (pixel, listed spoke): at whole-body
// (nxos 512, 204 spokes) a tile is reached by a few percent of the spokes
// far from the centre and by all of them at the centre, so the block
// workload is uneven; the KB evaluations of the hits are grid_spoke's.
// The culling test itself is one spoke per thread per chunk.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include "grid_radial2d.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

template <int KP, bool LATTICE>
__global__ void __launch_bounds__(kThreads)
grid_seg_radial2d_kernel(const float* __restrict__ planes,  // (npe, nR, K)
                         const float* __restrict__ ct,      // (npe,)
                         const float* __restrict__ st,      // (npe,)
                         const float* __restrict__ rad,     // (nR,) or null
                         float2* __restrict__ out,          // (K/2, nxos, nxos)
                         int npe, int nR, int nxos, int K, float kw,
                         float beta, float scale, float reach) {
  __shared__ float s_c[kThreads];
  __shared__ float s_s[kThreads];
  __shared__ float s_ic[kThreads];
  __shared__ float s_is[kThreads];
  __shared__ int s_pe[kThreads];
  __shared__ int s_warp[kWarps];

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool active = x < nxos && y < nxos;
  const Pixel px = make_pixel(x, y, nR, nxos, kw, beta);

  // the tile's pixel-centre extent (edge tiles are partial)
  const int tx0 = blockIdx.x * kBlockX;
  const int ty0 = blockIdx.y * kBlockY;
  const int tx1 = min(tx0 + kBlockX, nxos) - 1;
  const int ty1 = min(ty0 + kBlockY, nxos) - 1;
  const float cx = 0.5f * static_cast<float>(tx0 + tx1) - static_cast<float>(px.h);
  const float cy = 0.5f * static_cast<float>(ty0 + ty1) - static_cast<float>(px.h);
  const float hx = 0.5f * static_cast<float>(tx1 - tx0);
  const float hy = 0.5f * static_cast<float>(ty1 - ty0);
  const float limit = sqrtf(hx * hx + hy * hy) + reach;

  for (int k0 = 0; k0 < K; k0 += KP) {
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    const int kn = min(KP, K - k0);

    for (int p0 = 0; p0 < npe; p0 += kThreads) {
      // Phase 1: cull this chunk against the tile, compact in index order
      const int p = p0 + tid;
      float c = 0.0f, s = 0.0f;
      bool hit = false;
      if (p < npe) {
        c = ct[p];
        s = st[p];
        hit = fabsf(cx * s - cy * c) <= limit;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      __syncthreads();  // the previous chunk's list has been walked
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = s_warp[w];
        base += w < warp ? n : 0;
        total += n;
      }
      if (hit) {
        const int i = base + __popc(ballot & ((1u << lane) - 1u));
        s_c[i] = c;
        s_s[i] = s;
        s_ic[i] = c != 0.0f ? 1.0f / c : 0.0f;
        s_is[i] = s != 0.0f ? 1.0f / s : 0.0f;
        s_pe[i] = p;
      }
      __syncthreads();
      // Phase 2: the per-pixel row loop over the listed spokes
      if (!active) continue;
      for (int i = 0; i < total; ++i) {
        grid_spoke<KP, LATTICE, 0>(planes, rad, s_pe[i], k0, kn, K, s_c[i],
                                   s_s[i], s_ic[i], s_is[i], px, acc);
      }
    }
    if (active) store<KP>(out, acc, k0, kn, nxos, x, y, scale);
  }
}

template <int KP>
void launch_seg(const float* planes, const float* ct, const float* st,
                const float* rad, float2* out, int npe, int nR, int nxos, int K,
                float kw, float beta, float scale, float reach,
                cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nxos + kBlockX - 1) / kBlockX,
                  (nxos + kBlockY - 1) / kBlockY);
  if (rad == nullptr) {
    grid_seg_radial2d_kernel<KP, false><<<grid, block, 0, stream>>>(
        planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale, reach);
  } else {
    grid_seg_radial2d_kernel<KP, true><<<grid, block, 0, stream>>>(
        planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale, reach);
  }
}

}  // namespace

extern "C" {

// As tron_grid_radial2d_planes, with reach = sqrt(2)*kw + slack, the
// distance beyond a tile's half-diagonal at which a spoke's line can still
// reach it (ops/cull.py:reach).
int tron_grid_seg_radial2d_planes(const void* planes, const void* ct,
                                  const void* st, const void* rad, void* out,
                                  int npe, int nR, int nxos, int K, float kw,
                                  float beta, float scale, float reach,
                                  void* stream) {
  if (bad_args(npe, nR, nxos, K, rad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  with_channel_block(K, [&](auto kp) {
    launch_seg<decltype(kp)::value>(
        static_cast<const float*>(planes), static_cast<const float*>(ct),
        static_cast<const float*>(st), static_cast<const float*>(rad),
        static_cast<float2*>(out), npe, nR, nxos, K, kw, beta, scale, reach,
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
