// The static-unroll per-pixel gridding kernel (NSLOT > 0 instances of
// grid_radial2d_kernel in grid_radial2d.cuh).  Its own source only so that
// nvcc builds it in parallel with the others.
//
// Replaces tron_tpu/ops/grid_pallas.py::_win_kernel_batched, B1 with the
// per-hit dynamic loop replaced by a static unroll over hit slots, padded
// slots masked by a 0/1 multiply ("mask, do not perturb",
// grid_pallas.py:1190-1194).  Here the unrolled loop is the one over a
// spoke's rows: slot j grids row a + j of the spoke's band [a, b], the row
// index clamped into the plane, its weight times (a + j <= b), with no
// early exit on a zero weight.  Same terms in the same order as the
// per-pixel row loop that the tile-culled kernel (grid_seg_radial2d.cu)
// runs, so the same bits (fmaf(0, s, acc) == acc).
//
// NSLOT must cover the longest band.  Both |r c - X| < kw and |r s - Y| <
// kw hold on a radius interval shorter than 2*sqrt(2)*kw (the axis with
// |c| or |s| >= 1/sqrt(2) bounds it), i.e. 2*sqrt(2)*kw*nR/nxos rows, plus
// the floor/ceil and the one-row widening on each side: at most
// floor(2*sqrt(2)*kw*nR/nxos) + 5 rows (10 at kw 2 on integer radii).  The
// wrapper (ops/grid_cuda.py) derives that bound, picks the smallest
// instantiated NSLOT that covers it and raises when none does; this entry
// point refuses any other NSLOT.
//
// Cost: one thread per pixel walking every spoke, with NSLOT KB pairs per
// (pixel, spoke) whose band is not empty, evaluated without divergence on
// the row count; the centre tiles' pixels set its time (PERF.md).

#include "grid_radial2d.cuh"

namespace {

template <int NSLOT>
void launch_batched(const void* planes, const void* ct, const void* st,
                    const void* rad, void* out, int npe, int nR, int nxos,
                    int K, float kw, float beta, float scale, void* stream) {
  with_channel_block(K, [&](auto kp) {
    launch_grid<decltype(kp)::value, NSLOT>(
        static_cast<const float*>(planes), static_cast<const float*>(ct),
        static_cast<const float*>(st), static_cast<const float*>(rad),
        static_cast<float2*>(out), npe, nR, nxos, K, kw, beta, scale,
        static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// As tron_grid_radial2d_planes, with nslot the number of row slots: one of
// 10, 12 or 16.
int tron_grid_radial2d_batched_planes(const void* planes, const void* ct,
                                      const void* st, const void* rad,
                                      void* out, int npe, int nR, int nxos,
                                      int K, float kw, float beta, float scale,
                                      int nslot, void* stream) {
  if (bad_args(npe, nR, nxos, K, rad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (nslot) {
    case 10: launch_batched<10>(planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale, stream); break;
    case 12: launch_batched<12>(planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale, stream); break;
    case 16: launch_batched<16>(planes, ct, st, rad, out, npe, nR, nxos, K, kw, beta, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
