// Adjoint radial gridding on Hopper as a load-balanced per-tile
// contraction (the contract is stated in grid_radial2d.cuh).
//
// Replaces tron_tpu/ops/grid_pallas.py::_win_kernel (the windowed, chord-
// culled MXU gridder of the main path, in its integer-radius and its
// exact-lattice `raw_nro` modes) and ::_grid_kernel (the dense-range
// gridder for grids that do not tile); this kernel has no tiling
// constraint, so one entry point covers both contracts.  Each precision
// class is its own instantiation of pass 3; _grid_kernel's class rule (at
// bfloat16 the samples are rounded first, every other class is fp32,
// grid_pallas.py:832-833) is the wrapper's (ops/grid_cuda.py).
//
// Bound: bytes.  A whole-body frame (204 spokes x 512 rows x 12 channels in,
// 6 x 512^2 complex64 out) moves 17.6 MB, 5.25 us at 3.35 TB/s; its terms
// need about 77 MFLOP, 1.1 us at the fp32 rate.
//
// What limits a gather here is not the total work but its spread: with one
// thread per pixel walking every spoke, the 16 x 16 tiles at the centre of
// k-space, which every spoke crosses with a long band of rows, carry ~25x
// the median tile's rows and set the kernel's time alone (PERF.md).
// So the work is cut into items of at most kItemRows rows, each a block's
// worth, in four passes on the caller's stream:
//
//   1. band (one block per tile): each spoke's band of rows that can reach
//      the tile, span_band over the tile's pixel span (the union of its
//      pixels' bands, widened by one row as theirs are).  Spokes with an
//      empty band are dropped; the rest are compacted in ascending spoke
//      index (__ballot_sync, __popc, a prefix over the block's warps) into
//      the tile's list of (spoke, first row, row offset), with its row total.
//      The same launch's other blocks fill the weight table, once per
//      (spoke, row) instead of once per tile that lists it: KB(r c - X) at
//      the W = floor(2 kw) + 3 columns X from ceil(r c - kw) - 1 on, and
//      KB(r s - Y) likewise (the separable U = s (x) B of the TPU kernel).
//      The window is one pixel wider on each side than KB's support, so
//      every pixel outside it has a zero weight; inside it the weight is
//      kb_weight of the offset rounded by __fmul_rn/__fsub_rn, one
//      expression for every tile that lists the row.  KB is positive on all
//      of its support, so each axis keeps the run of its nonzero weights:
//      first pixel and count.
//   2. items (one block): the tiles' row totals are scanned into items of
//      at most L rows each, in list order; every tile has at least one item
//      (an empty tile writes zeros).  L is kItemRows unless the rows of the
//      frame would overflow the workspace's partial slots, which are sized
//      from host-known shapes; then L grows so that they fit.  No host sync.
//   3. contract (one block per item, one channel block per blockIdx.y): the
//      item's rows are staged through shared memory in chunks, their
//      samples and weight runs by cp.async; each staging thread derives its
//      row's warp mask from the runs.  The runs are expanded to the tile's
//      16 columns and 16 rows, then each thread owns a pixel and adds
//      wy * wx * s over the rows in order, one fp32 FMA per term at class
//      float32; a bf16 class rounds JAX's operands (A = wx, U = s * wy in
//      fp32) and adds its split products, one to three FMAs of exact
//      products per term (precision.cuh).  A warp holds two tile
//      rows and walks only the rows whose nonzero y-weights reach them, so
//      the skip is warp-uniform.  A one-item tile stores its scaled sums; a
//      split tile's items write fp32 partials.
//   4. reduce (the split tiles only): a split tile's partials are summed in
//      item order, scaled and stored.
//
// Every term of a pixel's own band lies in its tile's band, and the KB
// support test zeroes the rest, so every nonzero term of the plain version
// is summed once.  The sums follow the spokes in index order and the rows
// ascending; a split tile regroups its fp32 sums by item.  No atomics: repeat
// runs give the same bits.  No tensor cores: every term is FMAs.
// The FMA loop is about a third of pass 3's block time on the H100, the
// staging and the band pass the rest (PERF.md); B5 (grid_radial2d_batched.cu)
// runs the same passes with a 3xTF32 mma.sync contraction.  Passes 1, 2
// and 4 and pass 3's staging, weight expansion and FMA walk live in
// grid_tiles.cuh, shared with B4 and B5.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include "grid_tiles.cuh"

namespace {

// Pass 3: one item per block, one channel block per blockIdx.y; CLS the
// precision class.
template <int KP, int CLS>
__global__ void __launch_bounds__(kThreads)
grid_tile_contract_kernel(const float* __restrict__ planes,  // (npe, nR, K)
                          float2* __restrict__ out,          // (K/2, nxos, nxos)
                          int npe, int nR, int nxos, int K, int W, float scale,
                          int ntiles, Work w) {
  constexpr int KS = (KP + 3) / 4 * 4;  // a staged row, 16-byte aligned
  __shared__ __align__(16) float s_samp[kChunkRows][KS];
  __shared__ __align__(16) float s_wt[kChunkRows][2 * kTile];  // weight runs
  __shared__ int4 s_hdr[kChunkRows];  // their first column, row and counts
  __shared__ float s_wx[kChunkRows][kTile];  // the weights at the tile
  __shared__ float s_wy[kChunkRows][kTile];
  __shared__ int s_off[kChunkRows + 1];
  __shared__ int2 s_ent[kChunkRows + 1];
  __shared__ unsigned s_mask[kChunkRows];
  __shared__ int s_info[6];

  const int item = blockIdx.x;
  if (item >= w.head[1]) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (warp == 0) locate_item<true>(item, ntiles, npe, w, s_info);
  __syncthreads();
  const int t = s_info[0];
  const int end = s_info[2];
  const int slot = s_info[4];
  int e0 = s_info[3];
  const int nent = w.tile_nent[t];
  const int2* __restrict__ ent = w.ent + static_cast<size_t>(t) * npe;
  const int* __restrict__ off = w.ent_off + static_cast<size_t>(t) * npe;

  const int k0 = blockIdx.y * kMaxChannels;
  const int kn = min(KP, K - k0);
  const bool vec4 = (K & 3) == 0;
  const TileSpan ts = tile_span(t, nxos);
  const int h = nxos / 2;
  const int tx = tid % kTile;
  const int ty = tid / kTile;  // warp v holds tile rows 2v and 2v + 1
  const int wcoord = (lane < kTile ? ts.tx0 + lane : ts.ty0 + lane - kTile) - h;

  float acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0f;

  for (int q0 = s_info[1]; q0 < end; q0 += kChunkRows) {
    const int n = min(kChunkRows, end - q0);
    stage_rows<KS, true>(planes, nR, K, k0, kn, W, vec4, w, ent, off, nent, e0, q0, n, ts, h,
                         s_samp, s_wt, s_hdr, s_off, s_ent, s_mask, &s_info[5]);
    e0 = s_info[5];
    expand_weights<kTile, false>(s_hdr, &s_wt[0][0], 2 * kTile, W, n, n, wcoord, &s_wx[0][0],
                                 &s_wy[0][0]);
    __syncthreads();
    fma_rows<KP, kTile, CLS>(n, s_mask, &s_wx[0][0], &s_wy[0][0], &s_samp[0][0], KS, kn, tx, ty, acc);
    __syncthreads();  // the chunk's buffers are reused
  }
  store_item<KP>(out, acc, w, slot, K, k0, kn, nxos, ts, tx, ty, scale);
}

}  // namespace

extern "C" {

// Bytes of the workspace tron_grid_radial2d_planes (and
// tron_grid_radial2d_batched_planes) needs for these shapes.
size_t tron_grid_radial2d_workspace_bytes(int npe, int nR, int nxos, int K,
                                          float kw) {
  return band_work_bytes(npe, nR, nxos, K, kw, nullptr, nullptr);
}

// planes: (npe, nR, K) f32, K = 2C even; ct, st: (npe,) f32; rad: null for
// integer radii (then nR == nxos), else (nR,) f32 row radii; out: (C, nxos,
// nxos) complex64; cls: the precision class (precision.cuh: 0 bfloat16,
// 1 bf16x2, 2 bf16x3, 3 float32); work: at least
// tron_grid_radial2d_workspace_bytes bytes, 256-byte aligned, overwritten.
// npe * nR must fit an int and kw be below 7 (a weight window of at most 16
// pixels).  Launches the four passes on
// `stream` and returns cudaGetLastError() after them (0 on success).
int tron_grid_radial2d_planes(const void* planes, const void* ct,
                              const void* st, const void* rad, void* out,
                              int npe, int nR, int nxos, int K, float kw,
                              float beta, float scale, int cls, void* work,
                              size_t work_size, void* stream) {
  Work w;
  if (bad_tile_args(npe, nR, nxos, K, kw, rad, work) || bad_class(cls) ||
      band_work_bytes(npe, nR, nxos, K, kw, &w, static_cast<char*>(work)) > work_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(planes);
  const float* r = static_cast<const float*>(rad);
  float2* o = static_cast<float2*>(out);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int W = window_of(kw);
  const int T = tiles_of(nxos);
  with_channel_block(K, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    with_class(cls, [&](auto c) {
      constexpr int CLS = decltype(c)::value;
      constexpr bool RW = CLS != kF32;  // a bf16 class: the weights rounded as kb_kernel's
      auto contract = [&](dim3 grid) {
        grid_tile_contract_kernel<KP, CLS><<<grid, kThreads, 0, strm>>>(p, o, npe, nR, nxos, K, W, scale,
                                                        T, w);
      };
      const float* c0 = static_cast<const float*>(ct);
      const float* s0 = static_cast<const float*>(st);
      if (r == nullptr) {
        launch_band_passes<false, RW>(c0, s0, r, o, npe, nR, nxos, K, kw, beta, scale, w, strm,
                                      contract);
      } else {
        launch_band_passes<true, RW>(c0, s0, r, o, npe, nR, nxos, K, kw, beta, scale, w, strm,
                                     contract);
      }
    });
  });
  return static_cast<int>(cudaGetLastError());
}

const char* tron_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
