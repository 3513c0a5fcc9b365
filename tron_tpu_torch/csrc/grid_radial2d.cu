// Adjoint radial gridding on Hopper as a load-balanced per-tile
// contraction (the contract is stated in grid_radial2d.cuh).
//
// Replaces tron_tpu/ops/grid_pallas.py::_win_kernel (the windowed, chord-
// culled MXU gridder of the main path, in its integer-radius and its
// exact-lattice `raw_nro` modes) and ::_grid_kernel (the dense-range
// gridder for grids that do not tile); this kernel has no tiling
// constraint, so one entry point covers both contracts.
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
//      every pixel outside it has a zero weight; inside it the weight is the
//      per-pixel kernels' own expression, with the same __fmul_rn/__fsub_rn
//      rounding and bits.  KB is positive on all of its support, so each
//      axis keeps the run of its nonzero weights: first pixel and count.
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
//      wy * wx * s over the rows in order, fp32 FMA.  A warp holds two tile
//      rows and walks only the rows whose nonzero y-weights reach them, so
//      the skip is warp-uniform.  A one-item tile stores its scaled sums; a
//      split tile's items write fp32 partials.
//   4. reduce (the split tiles only): a split tile's partials are summed in
//      item order, scaled and stored.
//
// Every term of a pixel's own band lies in its tile's band, and the KB
// support test zeroes the rest, so every nonzero term of the plain version
// is summed once.  The sums follow the spokes in index order and the rows
// ascending, as the per-pixel kernels do, and a one-item tile gives their
// bits; a split tile regroups its fp32 sums by item.  No atomics: repeat
// runs give the same bits.  No tensor cores: every term is an fp32 FMA.
// The FMA loop is about a third of pass 3's block time on the H100, the
// staging and the band pass the rest (PERF.md), so a 3xTF32
// mma.sync form of it would not set the kernel's time.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include <climits>
#include <cmath>
#include <cstdint>

#include "grid_radial2d.cuh"

namespace {

constexpr int kTile = kBlockX;       // output tile edge (kBlockX == kBlockY)
constexpr int kWarps = kThreads / 32;
constexpr int kItemRows = 256;       // L: rows per work item
constexpr int kChunkRows = 128;      // rows staged in shared memory at a time
constexpr int kScanThreads = 1024;   // the items pass: 32 warps
constexpr int kMaxSlots = 4096;      // partial slots at most
constexpr int kReduceBlocks = 1024;  // the reduce pass's grid, at most
constexpr int kWeightBlocks = 1024;  // pass 1's weight-table blocks, at most
constexpr size_t kAlign = 256;

// The workspace, carved from one buffer the caller allocates.
struct Work {
  int* head;       // [3]: L, number of items, number of split tiles
  int* tile_nent;  // [T] listed spokes per tile
  int* tile_rows;  // [T] rows per tile
  int* item_base;  // [T + 1] first item of each tile
  int* part_base;  // [T] first partial slot of a split tile
  int* split;      // [T] the split tiles, ascending
  int2* ent;       // [T * npe] (spoke, first plane row) per listed spoke
  int* ent_off;    // [T * npe] the spoke's first row within the tile's rows
  int4* whdr;      // [npe * nR] weight runs: first column, first row, counts
  float* wtab;     // [npe * nR * table_stride(W)] x-weights, then y-weights
  float* part;     // [slots * K * kThreads] partial sums of split tiles
};

inline size_t up(size_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

inline int tiles_of(int nxos) {
  const int n = (nxos + kTile - 1) / kTile;
  return n * n;
}

// Weight-window width: KB's support holds at most floor(2 kw) + 1 pixels,
// plus one on each side; 2W <= 32 lanes.
inline int window_of(float kw) { return static_cast<int>(std::floor(2.0f * kw)) + 3; }

// A table row: W x-weights, W y-weights, padded to 16 bytes.
__host__ __device__ inline int table_stride(int W) { return (2 * W + 3) / 4 * 4; }

// Partial slots: enough for 4 tile-rows per sample row at L = kItemRows
// (whole-body frames list ~1.8), at most kMaxSlots; pass 2 lengthens the
// items of a frame that would need more.
inline int slots_of(int npe, int nR) {
  const long long s = (4LL * npe * nR + kItemRows - 1) / kItemRows;
  return static_cast<int>(s < 1 ? 1 : (s > kMaxSlots ? kMaxSlots : s));
}

// Items at most: every tile one, plus R / L <= slots / 2 (pass 2).
inline int max_items(int T, int slots) { return T + (slots + 1) / 2; }

inline size_t work_bytes(int npe, int nR, int nxos, int K, int W, Work* w,
                         char* base) {
  const size_t T = tiles_of(nxos);
  const size_t E = T * static_cast<size_t>(npe);
  const size_t Q = static_cast<size_t>(npe) * nR;
  const size_t S = slots_of(npe, nR);
  size_t o = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + o;
    o += up(bytes);
    return p;
  };
  Work v;
  v.head = reinterpret_cast<int*>(take(3 * sizeof(int)));
  v.tile_nent = reinterpret_cast<int*>(take(T * sizeof(int)));
  v.tile_rows = reinterpret_cast<int*>(take(T * sizeof(int)));
  v.item_base = reinterpret_cast<int*>(take((T + 1) * sizeof(int)));
  v.part_base = reinterpret_cast<int*>(take(T * sizeof(int)));
  v.split = reinterpret_cast<int*>(take(T * sizeof(int)));
  v.ent = reinterpret_cast<int2*>(take(E * sizeof(int2)));
  v.ent_off = reinterpret_cast<int*>(take(E * sizeof(int)));
  v.whdr = reinterpret_cast<int4*>(take(Q * sizeof(int4)));
  v.wtab = reinterpret_cast<float*>(take(Q * table_stride(W) * sizeof(float)));
  v.part = reinterpret_cast<float*>(take(S * static_cast<size_t>(K) * kThreads * sizeof(float)));
  if (w != nullptr) *w = v;
  return o;
}

// A tile's first pixel and the coordinates of its last (relative to the
// k-space centre); edge tiles are partial.
struct TileSpan {
  int tx0, ty0;
  float X1, Y1;
};

__device__ __forceinline__ TileSpan tile_span(int t, int nxos) {
  const int ntx = (nxos + kTile - 1) / kTile;
  TileSpan ts;
  ts.tx0 = (t % ntx) * kTile;
  ts.ty0 = (t / ntx) * kTile;
  const int h = nxos / 2;
  ts.X1 = static_cast<float>(min(ts.tx0 + kTile, nxos) - 1 - h);
  ts.Y1 = static_cast<float>(min(ts.ty0 + kTile, nxos) - 1 - h);
  return ts;
}

// Pass 1, blocks [0, T): tile t's list of (spoke, first row, row offset),
// ascending in spoke index, and its row total.
template <bool LATTICE>
__device__ void tile_list(int t, const float* __restrict__ ct,
                          const float* __restrict__ st, int npe, int nR,
                          int nxos, float kw, const Work& w) {
  __shared__ int s_cnt[kWarps];
  __shared__ int s_rows[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const TileSpan ts = tile_span(t, nxos);
  const Pixel px = make_pixel(ts.tx0, ts.ty0, nR, nxos, kw, 0.0f);
  int2* ent = w.ent + static_cast<size_t>(t) * npe;
  int* off = w.ent_off + static_cast<size_t>(t) * npe;
  int nent = 0, nrows = 0;  // block-uniform running totals
  for (int p0 = 0; p0 < npe; p0 += kThreads) {
    const int p = p0 + tid;
    int a = 1, b = 0;
    if (p < npe) {
      const float c = ct[p];
      const float s = st[p];
      span_band<LATTICE>(px, ts.X1, ts.Y1, c != 0.0f ? 1.0f / c : 0.0f,
                         s != 0.0f ? 1.0f / s : 0.0f, a, b);
    }
    const int n = a <= b ? b - a + 1 : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, n > 0);
    int incl = n;  // inclusive prefix of the rows over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) {
      s_cnt[warp] = __popc(ballot);
      s_rows[warp] = incl;
    }
    __syncthreads();
    int cbase = 0, rbase = 0, ctot = 0, rtot = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      cbase += v < warp ? s_cnt[v] : 0;
      rbase += v < warp ? s_rows[v] : 0;
      ctot += s_cnt[v];
      rtot += s_rows[v];
    }
    if (n > 0) {
      const int i = nent + cbase + __popc(ballot & ((1u << lane) - 1u));
      ent[i] = make_int2(p, LATTICE ? a : a + px.h);
      off[i] = nrows + rbase + incl - n;
    }
    nent += ctot;
    nrows += rtot;
    __syncthreads();  // s_cnt, s_rows are reused
  }
  if (tid == 0) {
    w.tile_nent[t] = nent;
    w.tile_rows[t] = nrows;
  }
}

// Pass 1, blocks [T, ...): the weight runs of kThreads / LP plane rows,
// LP = 16 lanes per row where 2W <= 16, else 32: the first half of a row's
// lanes its x-weights, the second half its y-weights.  Each axis keeps the
// run of its nonzero weights (KB is positive on all of its support), from
// its first pixel on: the row's header is (first column, first row, number
// of columns, number of rows), and its weights follow from there, zeros
// after the run.
template <bool LATTICE>
__device__ void weight_rows(int b, int nb, const float* __restrict__ ct,
                            const float* __restrict__ st,
                            const float* __restrict__ rad, int npe, int nR,
                            int nxos, float kw, float beta, int W,
                            const Work& w) {
  const int lp = 2 * W <= 16 ? 16 : 32;
  const int half = lp / 2;
  const int lane = threadIdx.x & 31;
  const int i = threadIdx.x % lp;
  const bool y_axis = i >= half;
  const int idx = y_axis ? i - half : i;
  const int axis_lane0 = (lane & ~(lp - 1)) + (y_axis ? half : 0);
  const float inv_kw = 1.0f / kw;
  const float amp = 0.5f / kw;
  const int ws = table_stride(W);
  const int step = nb * (kThreads / lp);  // rows per sweep: dp spokes and du rows
  const int dp = step / nR;
  const int du = step - dp * nR;
  const int q0 = b * (kThreads / lp) + threadIdx.x / lp;
  int p = q0 / nR;
  int u = q0 - p * nR;
  for (;; p += dp, u += du) {
    if (u >= nR) {
      u -= nR;
      ++p;
    }
    const bool valid = p < npe;
    if (!__any_sync(0xffffffffu, valid)) break;
    float wv = 0.0f;
    int start = 0;
    if (valid) {
      const float rf = LATTICE ? __ldg(rad + u) : static_cast<float>(u - nxos / 2);
      const float v = __fmul_rn(rf, y_axis ? __ldg(st + p) : __ldg(ct + p));
      start = static_cast<int>(ceilf(v - kw)) - 1;
      if (idx < W) {
        wv = kb_weight(__fsub_rn(v, static_cast<float>(start + idx)), inv_kw, amp, beta);
      }
    }
    const unsigned nz = (__ballot_sync(0xffffffffu, wv != 0.0f) >> axis_lane0) & ((1u << W) - 1u);
    if (!valid) continue;
    const int first = nz != 0u ? __ffs(nz) - 1 : 0;
    const int q = p * nR + u;
    if (idx == 0) {
      int* hd = reinterpret_cast<int*>(w.whdr + q);
      hd[y_axis ? 1 : 0] = start + first;
      hd[y_axis ? 3 : 2] = __popc(nz);
    }
    if (idx < W) {  // shift the run to the front; the lanes before it write the zeros after it
      const int at = idx >= first ? idx - first : W - first + idx;
      w.wtab[static_cast<size_t>(q) * ws + (y_axis ? W : 0) + at] = wv;
    }
  }
}

template <bool LATTICE>
__global__ void __launch_bounds__(kThreads)
grid_tile_band_kernel(const float* __restrict__ ct, const float* __restrict__ st,
                      const float* __restrict__ rad, int npe, int nR, int nxos,
                      float kw, float beta, int W, int ntiles, Work w) {
  if (static_cast<int>(blockIdx.x) < ntiles) {
    tile_list<LATTICE>(blockIdx.x, ct, st, npe, nR, nxos, kw, w);
  } else {
    weight_rows<LATTICE>(blockIdx.x - ntiles, gridDim.x - ntiles, ct, st, rad, npe,
                         nR, nxos, kw, beta, W, w);
  }
}

// Exclusive prefix over the block of N ints per thread, and the totals;
// s_warp holds 32 * N ints.
template <int N>
__device__ __forceinline__ void block_scan(const int (&v)[N], int (&excl)[N],
                                           int (&tot)[N], int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl[N];
#pragma unroll
  for (int j = 0; j < N; ++j) incl[j] = v[j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int a = __shfl_up_sync(0xffffffffu, incl[j], d);
      if (lane >= d) incl[j] += a;
    }
  }
  __syncthreads();  // s_warp is free
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < N; ++j) s_warp[j * 32 + warp] = incl[j];
  }
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp totals, in place
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int x = lane < nw ? s_warp[j * 32 + lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += a;
      }
      s_warp[j * 32 + lane] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    excl[j] = (warp > 0 ? s_warp[j * 32 + warp - 1] : 0) + incl[j] - v[j];
    tot[j] = s_warp[j * 32 + 31];
  }
}

// Pass 2: item and partial-slot bases of every tile, the split tiles, L and
// the counts.
__global__ void __launch_bounds__(kScanThreads)
grid_tile_items_kernel(int ntiles, int slots, Work w) {
  __shared__ long long s_sum[32];
  __shared__ int s_warp[32 * 3];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  long long r = 0;
  for (int t = tid; t < ntiles; t += kScanThreads) r += w.tile_rows[t];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) r += __shfl_down_sync(0xffffffffu, r, d);
  if (lane == 0) s_sum[tid >> 5] = r;
  __syncthreads();
  r = s_sum[lane];  // kScanThreads / 32 == 32 warp sums
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) r += __shfl_xor_sync(0xffffffffu, r, d);
  const long long R = r;
  // 2R / L <= slots bounds the split tiles' items (each has > L rows)
  const long long need = (2 * R + slots - 1) / slots;
  const int L = static_cast<int>(need > kItemRows ? need : kItemRows);
  int carry[3] = {0, 0, 0};
  for (int t0 = 0; t0 < ntiles; t0 += kScanThreads) {
    const int t = t0 + tid;
    int v[3] = {0, 0, 0};
    if (t < ntiles) {
      const int n = max(1, (w.tile_rows[t] + L - 1) / L);
      v[0] = n;
      v[1] = n > 1 ? n : 0;
      v[2] = n > 1 ? 1 : 0;
    }
    int excl[3], tot[3];
    block_scan<3>(v, excl, tot, s_warp);
    if (t < ntiles) {
      w.item_base[t] = carry[0] + excl[0];
      w.part_base[t] = carry[1] + excl[1];
      if (v[2]) w.split[carry[2] + excl[2]] = t;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) carry[j] += tot[j];
  }
  if (tid == 0) {
    w.item_base[ntiles] = carry[0];
    w.head[0] = L;
    w.head[1] = carry[0];
    w.head[2] = carry[2];
  }
}

// The largest i in [0, n) with a[i] <= key, for ascending a with a[0] <=
// key; the whole warp searches 32 ways at a time.
__device__ __forceinline__ int warp_search(const int* __restrict__ a, int n,
                                           int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const unsigned m = __ballot_sync(0xffffffffu, i < hi && a[i] <= key);
    lo += (31 - __clz(m)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool vec4) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (vec4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  }
}

// Pass 3: one item per block, one channel block per blockIdx.y.
template <int KP>
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
  if (warp == 0) {
    const int t = warp_search(w.item_base, ntiles, item);
    const int piece = item - w.item_base[t];
    const int rows = w.tile_rows[t];
    const int L = w.head[0];
    const int start = min(piece * L, rows);
    const int e0 = rows > 0 ? warp_search(w.ent_off + static_cast<size_t>(t) * npe,
                                          w.tile_nent[t], start)
                            : 0;
    if (lane == 0) {
      s_info[0] = t;
      s_info[1] = start;
      s_info[2] = min(start + L, rows);
      s_info[3] = e0;
      s_info[4] = w.item_base[t + 1] - w.item_base[t] > 1 ? w.part_base[t] + piece : -1;
    }
  }
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
  // this lane's column (lanes 0-15) or row (16-31) in the weight phase,
  // relative to the centre
  const int wcoord = (lane < kTile ? ts.tx0 + lane : ts.ty0 + lane - kTile) - h;

  float acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0f;

  for (int q0 = s_info[1]; q0 < end; q0 += kChunkRows) {
    const int n = min(kChunkRows, end - q0);
    // the chunk's rows span at most n listed spokes from e0 on, e0 the one
    // that holds its first row; one more tells where the next chunk starts
    if (tid <= n) {
      const int e = e0 + tid;
      s_off[tid] = e < nent ? off[e] : INT_MAX;
      s_ent[tid] = e < nent ? ent[e] : make_int2(0, 0);
    }
    __syncthreads();
    if (tid < n) {
      const int q = q0 + tid;
      int lo = 0, hi = min(n, nent - e0);  // largest i with s_off[i] <= q
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= q) lo = mid; else hi = mid;
      }
      const int p = s_ent[lo].x;
      const int row = s_ent[lo].y + (q - s_off[lo]);
      const size_t pr = static_cast<size_t>(p) * nR + row;  // the plane row
      const float* src = planes + pr * K + k0;
      for (int k = 0; k < kn; k += vec4 ? 4 : 2) {
        cp_async(&s_samp[tid][k], src + k, vec4);
      }
      cp_async(&s_hdr[tid], w.whdr + pr, true);
      const float* wt = w.wtab + pr * table_stride(W);
      for (int k = 0; k < 2 * W; k += 4) cp_async(&s_wt[tid][k], wt + k, true);
      if (tid == n - 1) s_info[5] = e0 + lo + (s_off[lo + 1] <= q + 1 ? 1 : 0);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::);
      // bit v of the row's mask: its nonzero y-weights reach warp v's tile
      // rows 2v, 2v + 1, and its nonzero x-weights reach the tile
      const int4 hd = s_hdr[tid];
      const int cx = hd.x - (ts.tx0 - h);
      const int ry = hd.y - (ts.ty0 - h);
      const int ylo = max(ry, 0);
      const int yhi = min(ry + hd.w, kTile) - 1;
      const bool hit = hd.z > 0 && cx < kTile && cx + hd.z > 0 && ylo <= yhi;
      s_mask[tid] = hit ? (2u << (yhi >> 1)) - (1u << (ylo >> 1)) : 0u;
    }
    __syncthreads();
    e0 = s_info[5];
    // the weights at the tile, one row per warp at a time: lanes 0-15 at its
    // 16 columns, lanes 16-31 at its 16 rows
#pragma unroll 4
    for (int j = warp; j < n; j += kWarps) {
      const int4 hd = s_hdr[j];
      const int i = wcoord - (lane < kTile ? hd.x : hd.y);
      const bool in = static_cast<unsigned>(i) < static_cast<unsigned>(lane < kTile ? hd.z : hd.w);
      const float wv = in ? s_wt[j][(lane < kTile ? 0 : W) + i] : 0.0f;
      if (lane < kTile) s_wx[j][lane] = wv; else s_wy[j][lane - kTile] = wv;
    }
    __syncthreads();
    // each warp walks, in order, only the rows that reach its tile rows
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int jl = r0 + lane;
      unsigned bits = __ballot_sync(0xffffffffu, jl < n && ((s_mask[jl] >> warp) & 1u));
      while (bits != 0u) {
        const int j = r0 + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float wt = s_wy[j][ty] * s_wx[j][tx];
        const float* sv = s_samp[j];
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if (k < kn) acc[k] = fmaf(wt, sv[k], acc[k]);
        }
      }
    }
    __syncthreads();  // the chunk's buffers are reused
  }

  const int x = ts.tx0 + tx;
  const int y = ts.ty0 + ty;
  if (slot < 0) {
    if (x < nxos && y < nxos) store<KP>(out, acc, k0, kn, nxos, x, y, scale);
  } else {
    float* dst = w.part + (static_cast<size_t>(slot) * K + k0) * kThreads + tid;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < kn) dst[static_cast<size_t>(k) * kThreads] = acc[k];
    }
  }
}

// Pass 4: each (split tile, complex channel) unit sums its partials in item
// order, scaled and stored; the blocks stride over the units.
__global__ void __launch_bounds__(kThreads)
grid_tile_reduce_kernel(float2* __restrict__ out, int nxos, int K, float scale,
                        Work w) {
  const int C = K / 2;
  const int units = w.head[2] * C;
  const int tid = threadIdx.x;
  const size_t stride = static_cast<size_t>(K) * kThreads;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int t = w.split[unit / C];
    const int c = unit % C;
    const int n = w.item_base[t + 1] - w.item_base[t];
    const TileSpan ts = tile_span(t, nxos);
    const int x = ts.tx0 + tid % kTile;
    const int y = ts.ty0 + tid / kTile;
    const float* src =
        w.part + (static_cast<size_t>(w.part_base[t]) * K + 2 * c) * kThreads + tid;
    float re = 0.0f, im = 0.0f;
    int i = 0;
    for (; i + 8 <= n; i += 8) {  // eight items' loads in flight, summed in order
      float a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j] = src[(i + j) * stride];
        b[j] = src[(i + j) * stride + kThreads];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        re += a[j];
        im += b[j];
      }
    }
    for (; i < n; ++i) {
      re += src[i * stride];
      im += src[i * stride + kThreads];
    }
    if (x < nxos && y < nxos) {
      out[(static_cast<size_t>(c) * nxos + y) * nxos + x] = make_float2(re * scale, im * scale);
    }
  }
}

template <int KP, bool LATTICE>
void launch_tiles(const float* planes, const float* ct, const float* st,
                  const float* rad, float2* out, int npe, int nR, int nxos,
                  int K, float kw, float beta, float scale, const Work& w,
                  cudaStream_t stream) {
  const int T = tiles_of(nxos);
  const int slots = slots_of(npe, nR);
  const int W = window_of(kw);
  const int rows_per_block = kThreads / (2 * W <= 16 ? 16 : 32);
  const int wblocks = min((npe * nR + rows_per_block - 1) / rows_per_block, kWeightBlocks);
  grid_tile_band_kernel<LATTICE><<<T + wblocks, kThreads, 0, stream>>>(
      ct, st, rad, npe, nR, nxos, kw, beta, W, T, w);
  grid_tile_items_kernel<<<1, kScanThreads, 0, stream>>>(T, slots, w);
  const dim3 grid(max_items(T, slots), (K + kMaxChannels - 1) / kMaxChannels);
  grid_tile_contract_kernel<KP><<<grid, kThreads, 0, stream>>>(
      planes, out, npe, nR, nxos, K, W, scale, T, w);
  const long long units = static_cast<long long>(min(T, (slots + 1) / 2)) * (K / 2);
  grid_tile_reduce_kernel<<<static_cast<int>(min(units, static_cast<long long>(kReduceBlocks))),
                            kThreads, 0, stream>>>(out, nxos, K, scale, w);
}

}  // namespace

extern "C" {

// Bytes of the workspace tron_grid_radial2d_planes needs for these shapes.
size_t tron_grid_radial2d_workspace_bytes(int npe, int nR, int nxos, int K,
                                          float kw) {
  return work_bytes(npe, nR, nxos, K, window_of(kw), nullptr, nullptr);
}

// planes: (npe, nR, K) f32, K = 2C even; ct, st: (npe,) f32; rad: null for
// integer radii (then nR == nxos), else (nR,) f32 row radii; out: (C, nxos,
// nxos) complex64; work: at least tron_grid_radial2d_workspace_bytes bytes,
// 256-byte aligned, overwritten.  npe * nR must fit an int and kw be below
// 7 (a weight window of at most 16 pixels).  Launches the four passes on
// `stream` and returns cudaGetLastError() after them (0 on success).
int tron_grid_radial2d_planes(const void* planes, const void* ct,
                              const void* st, const void* rad, void* out,
                              int npe, int nR, int nxos, int K, float kw,
                              float beta, float scale, void* work,
                              size_t work_size, void* stream) {
  if (bad_args(npe, nR, nxos, K, rad) || npe < 1 || !(kw > 0.0f) ||
      2 * window_of(kw) > 32 || static_cast<long long>(npe) * nR > INT_MAX ||
      reinterpret_cast<uintptr_t>(work) % kAlign != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Work w;
  if (work_bytes(npe, nR, nxos, K, window_of(kw), &w, static_cast<char*>(work)) >
      work_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  with_channel_block(K, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    const float* p = static_cast<const float*>(planes);
    const float* c = static_cast<const float*>(ct);
    const float* s = static_cast<const float*>(st);
    const float* r = static_cast<const float*>(rad);
    float2* o = static_cast<float2*>(out);
    cudaStream_t strm = static_cast<cudaStream_t>(stream);
    if (r == nullptr) {
      launch_tiles<KP, false>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, w, strm);
    } else {
      launch_tiles<KP, true>(p, c, s, r, o, npe, nR, nxos, K, kw, beta, scale, w, strm);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

const char* tron_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
