// Adjoint radial gridding on Hopper: one thread per output pixel, a
// race-free gather over the spokes whose radius band reaches the pixel
// (the loop kernel; its code is grid_radial2d_kernel<KP, LATTICE, 0> in
// grid_radial2d.cuh, which states the contract).
//
// Replaces tron_tpu/ops/grid_pallas.py::_win_kernel (the windowed, chord-
// culled MXU gridder of the main path, in its integer-radius and its
// exact-lattice `raw_nro` modes) and ::_grid_kernel (the dense-range
// gridder for grids that do not tile); this kernel has no tiling
// constraint, so one launch covers both contracts.
//
// Design (TRON's own gather, src/tron.cu:465-536, not the TPU dataflow):
// each thread walks every spoke in index order and bounds its own radius
// band per spoke.  The TPU kernel culls per tile with host-built chord
// tables; here the culling is the per-(pixel, spoke) band test, with no
// tables (csrc/grid_seg_radial2d.cu adds per-tile culling in front of the
// same per-pixel code).
//
// Cost: bounded by the band test (every pixel x every spoke) and the KB
// evaluations of the hits, all on the fp32 pipe; the bytes it must move
// (planes in, grids out) take a few microseconds at whole-body.  There are
// no tensor cores in this first version, whatever precision class the
// caller asks for: every term is an fp32 FMA.  Summation order is fixed
// (spokes in index order, rows ascending), with no atomics, so the same
// input gives the same output bits.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include "grid_radial2d.cuh"

extern "C" {

// planes: (npe, nR, K) f32, K = 2C even; ct, st: (npe,) f32; rad: null for
// integer radii (then nR == nxos), else (nR,) f32 row radii; out: (C, nxos,
// nxos) complex64.  Returns cudaGetLastError() after the launch (0 on
// success).
int tron_grid_radial2d_planes(const void* planes, const void* ct,
                              const void* st, const void* rad, void* out,
                              int npe, int nR, int nxos, int K, float kw,
                              float beta, float scale, void* stream) {
  if (bad_args(npe, nR, nxos, K, rad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  with_channel_block(K, [&](auto kp) {
    launch_grid<decltype(kp)::value, 0>(
        static_cast<const float*>(planes), static_cast<const float*>(ct),
        static_cast<const float*>(st), static_cast<const float*>(rad),
        static_cast<float2*>(out), npe, nR, nxos, K, kw, beta, scale,
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(cudaGetLastError());
}

const char* tron_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
