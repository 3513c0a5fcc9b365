// The tile machinery shared by the three gridding kernels (the contract is
// stated in grid_radial2d.cuh):
//   - grid_radial2d.cu (B1 _win_kernel, B2 _grid_kernel): tile bands, item
//     scan, FMA contraction at the precision class, reduce;
//   - grid_radial2d_batched.cu (B5 _win_kernel_batched): B1's bands, items
//     and reduce, its own tensor-core contraction;
//   - grid_seg_radial2d.cu (B4 _seg_kernel): static segments and wedge-
//     culled lists, the item scan, B1's FMA contraction over segments staged
//     by bulk async copies, the reduce.
// What lives here: the workspace layout (Work, work_bytes), pass 1's tile
// bands (tile_list) and weight table (weight_rows), pass 2's item scan,
// pass 3's staging of a chunk of listed rows (stage_rows), the expansion of
// their weight runs to the tile (expand_weights) and the FMA walk
// (fma_rows), and pass 4, the reduce of the split tiles.

#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include "grid_radial2d.cuh"
#include "precision.cuh"

namespace {

constexpr int kTile = kBlockX;       // output tile edge (kBlockX == kBlockY)
constexpr int kWarps = kThreads / 32;
constexpr int kItemRows = 256;       // L: rows per work item (at least)
constexpr int kChunkRows = 128;      // rows staged in shared memory at a time
constexpr int kScanThreads = 1024;   // the items pass: 32 warps
constexpr int kMaxSlots = 4096;      // partial slots at most
constexpr int kReduceBlocks = 1024;  // the reduce pass's grid, at most
constexpr int kWeightBlocks = 1024;  // pass 1's weight-table blocks, at most
constexpr size_t kAlign = 256;

// The workspace, carved from one buffer the caller allocates.
struct Work {
  int* head;       // [3]: L, number of items, number of split tiles
  int* tile_nent;  // [T] listed entries per tile
  int* tile_rows;  // [T] rows per tile
  int* item_base;  // [T + 1] first item of each tile
  int* part_base;  // [T] first partial slot of a split tile
  int* split;      // [T] the split tiles, ascending
  int2* ent;       // [T * ents] (spoke, first plane row) per listed entry
  int* ent_off;    // [T * ents] the entry's first row within the tile's rows (B1, B5)
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

// B1's partial slots: enough for 4 tile-rows per sample row at L =
// kItemRows (whole-body frames list ~1.8), at most kMaxSlots; pass 2
// lengthens the items of a frame that would need more.
inline int slots_of(int npe, int nR) {
  const long long s = (4LL * npe * nR + kItemRows - 1) / kItemRows;
  return static_cast<int>(s < 1 ? 1 : (s > kMaxSlots ? kMaxSlots : s));
}

// Items at most: every tile one, plus R / L <= slots / 2 (pass 2).
inline int max_items(int T, int slots) { return T + (slots + 1) / 2; }

// ents: entries a tile can list (B1 npe spokes, B4 2 npe segments); offs:
// whether the entries carry row offsets (B1's bands vary in length).
inline size_t work_bytes(int npe, int nR, int nxos, int K, int W, int ents, bool offs,
                         int slots, Work* w, char* base) {
  const size_t T = tiles_of(nxos);
  const size_t E = T * static_cast<size_t>(ents);
  const size_t Q = static_cast<size_t>(npe) * nR;
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
  v.ent_off = reinterpret_cast<int*>(take(offs ? E * sizeof(int) : 0));
  v.whdr = reinterpret_cast<int4*>(take(Q * sizeof(int4)));
  v.wtab = reinterpret_cast<float*>(take(Q * table_stride(W) * sizeof(float)));
  v.part = reinterpret_cast<float*>(
      take(static_cast<size_t>(slots) * K * kThreads * sizeof(float)));
  if (w != nullptr) *w = v;
  return o;
}

// B1's and B5's workspace.
inline size_t band_work_bytes(int npe, int nR, int nxos, int K, float kw, Work* w,
                              char* base) {
  return work_bytes(npe, nR, nxos, K, window_of(kw), npe, true, slots_of(npe, nR), w, base);
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

// Pass 1 (B1, B5), blocks [0, T): tile t's list of (spoke, first row, row
// offset), ascending in spoke index, and its row total.
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

// Pass 1, the weight-table blocks: the weight runs of kThreads / LP plane
// rows, LP = 16 lanes per row where 2W <= 16, else 32: the first half of a
// row's lanes its x-weights, the second half its y-weights.  Each axis
// keeps the run of its nonzero weights (KB is positive on all of its
// support), from its first pixel on: the row's header is (first column,
// first row, number of columns, number of rows), and its weights follow
// from there, zeros after the run.  RW: the weights rounded as kb_kernel
// rounds them (kb.cuh; the bf16 classes).
template <bool LATTICE, bool RW>
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
        wv = kb_weight<RW>(__fsub_rn(v, static_cast<float>(start + idx)), inv_kw, amp, beta);
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

// Weight-table blocks of pass 1 for npe * nR rows, at most kWeightBlocks.
inline int weight_blocks(int npe, int nR, int W) {
  const int rows_per_block = kThreads / (2 * W <= 16 ? 16 : 32);
  return min((npe * nR + rows_per_block - 1) / rows_per_block, kWeightBlocks);
}

// Pass 1 of B1 and B5: the tile bands, then the weight table.
template <bool LATTICE, bool RW>
__global__ void __launch_bounds__(kThreads)
grid_tile_band_kernel(const float* __restrict__ ct, const float* __restrict__ st,
                      const float* __restrict__ rad, int npe, int nR, int nxos,
                      float kw, float beta, int W, int ntiles, Work w) {
  if (static_cast<int>(blockIdx.x) < ntiles) {
    tile_list<LATTICE>(blockIdx.x, ct, st, npe, nR, nxos, kw, w);
  } else {
    weight_rows<LATTICE, RW>(blockIdx.x - ntiles, gridDim.x - ntiles, ct, st, rad, npe,
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
// the counts.  L is kItemRows unless the frame's rows would overflow the
// `slots` partial slots (2R / L <= slots bounds the split tiles' items,
// each of which has more than L rows); then it grows so that they fit.
// L is a multiple of `granule` (B4: whole segments; B1 and B5: 1).
__global__ void __launch_bounds__(kScanThreads)
grid_tile_items_kernel(int ntiles, int slots, int granule, Work w) {
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
  const long long need = (2 * R + slots - 1) / slots;
  const long long L0 = need > kItemRows ? need : kItemRows;
  const int L = static_cast<int>((L0 + granule - 1) / granule * granule);
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

// Pass 3, warp 0: the item's tile and its rows.  s_info[0] the tile, [1]
// its first row, [2] the row past its last, [3] (ENTRY: B1, B5) the listed
// entry that holds its first row, [4] its partial slot (-1 for a tile of
// one item).
template <bool ENTRY>
__device__ __forceinline__ void locate_item(int item, int ntiles, int npe, const Work& w,
                                            int* s_info) {
  const int lane = threadIdx.x & 31;
  const int t = warp_search(w.item_base, ntiles, item);
  const int piece = item - w.item_base[t];
  const int rows = w.tile_rows[t];
  const int L = w.head[0];
  const int start = min(piece * L, rows);
  int e0 = 0;
  if constexpr (ENTRY) {
    e0 = rows > 0 ? warp_search(w.ent_off + static_cast<size_t>(t) * npe, w.tile_nent[t], start)
                  : 0;
  }
  if (lane == 0) {
    s_info[0] = t;
    s_info[1] = start;
    s_info[2] = min(start + L, rows);
    s_info[3] = e0;
    s_info[4] = w.item_base[t + 1] - w.item_base[t] > 1 ? w.part_base[t] + piece : -1;
  }
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

// Bit v of a staged row's mask: its nonzero y-weights (the header's run)
// reach warp v's tile rows 2v, 2v + 1, and its nonzero x-weights reach the
// tile; 0 when they do not.
__device__ __forceinline__ unsigned row_mask(const int4& hd, const TileSpan& ts, int h) {
  const int cx = hd.x - (ts.tx0 - h);
  const int ry = hd.y - (ts.ty0 - h);
  const int ylo = max(ry, 0);
  const int yhi = min(ry + hd.w, kTile) - 1;
  const bool hit = hd.z > 0 && cx < kTile && cx + hd.z > 0 && ylo <= yhi;
  return hit ? (2u << (yhi >> 1)) - (1u << (ylo >> 1)) : 0u;
}

// Pass 3 of B1 and B5, all threads: stage rows [q0, q0 + n) of tile t's
// list (n <= kChunkRows; e0 the entry that holds row q0) into shared
// memory: their samples (channels k0 .. k0+kn-1), weight headers and runs
// by cp.async, and (MASK) each row's warp mask.  The rows span at most n
// listed entries from e0 on; one more tells where the next chunk starts,
// which lands in *s_next.  Ends with the block synchronised.
template <int KS, bool MASK>
__device__ __forceinline__ void stage_rows(
    const float* __restrict__ planes, int nR, int K, int k0, int kn, int W, bool vec4,
    const Work& w, const int2* __restrict__ ent, const int* __restrict__ off, int nent,
    int e0, int q0, int n, const TileSpan& ts, int h, float (*s_samp)[KS],
    float (*s_wt)[2 * kTile], int4* s_hdr, int* s_off, int2* s_ent, unsigned* s_mask,
    int* s_next) {
  const int tid = threadIdx.x;
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
    if (tid == n - 1) *s_next = e0 + lo + (s_off[lo + 1] <= q + 1 ? 1 : 0);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::);
    if constexpr (MASK) s_mask[tid] = row_mask(s_hdr[tid], ts, h);
  }
  __syncthreads();
}

// Pass 3, the consumer warps: the staged weight runs of rows [0, m) at the
// tile, one row per warp at a time: lanes 0-15 at its 16 columns (into
// s_wx, row stride WXS), lanes 16-31 at its 16 rows (into s_wy, stride
// kTile).  wcoord: this lane's column (lanes 0-15) or row (16-31) relative
// to the centre.  PAD (B5): rows [n, m) are the padded slots of a static
// unroll; each takes row n - 1's weights times 0 ("mask, do not perturb").
template <int WXS, bool PAD>
__device__ __forceinline__ void expand_weights(const int4* __restrict__ hdr,
                                               const float* __restrict__ wt, int wts,
                                               int W, int n, int m, int wcoord,
                                               float* __restrict__ s_wx,
                                               float* __restrict__ s_wy) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int j = warp; j < (PAD ? m : n); j += kWarps) {
    const int jr = PAD ? min(j, n - 1) : j;
    const int4 hd = hdr[jr];
    const int i = wcoord - (lane < kTile ? hd.x : hd.y);
    const bool in = static_cast<unsigned>(i) < static_cast<unsigned>(lane < kTile ? hd.z : hd.w);
    float wv = in ? wt[jr * wts + (lane < kTile ? 0 : W) + i] : 0.0f;
    if constexpr (PAD) wv *= j < n ? 1.0f : 0.0f;
    if (lane < kTile) s_wx[j * WXS + lane] = wv; else s_wy[j * kTile + lane - kTile] = wv;
  }
}

// Pass 3, the consumer warps (B1, B4): each thread owns pixel (tx, ty) and
// adds wy * wx * s over the rows [0, n) in order; a warp holds tile rows 2v
// and 2v + 1 and walks only the rows whose mask has bit v, so the skip is
// warp-uniform.  Sample row j at samp + j * ss.  CLS float32: one fp32 FMA
// of wt = wy * wx per channel.  A bf16 class takes JAX's operands (U =
// s * wy formed in fp32, A = wx, grid_pallas.py:106-144) and adds
// class_fma's terms of A and U; bf16x2's lo term is A's (Uh Al).
template <int KP, int WXS, int CLS>
__device__ __forceinline__ void fma_rows(int n, const unsigned* __restrict__ s_mask,
                                         const float* __restrict__ s_wx,
                                         const float* __restrict__ s_wy,
                                         const float* __restrict__ samp, int ss, int kn,
                                         int tx, int ty, float (&acc)[KP]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int jl = r0 + lane;
    unsigned bits = __ballot_sync(0xffffffffu, jl < n && ((s_mask[jl] >> warp) & 1u));
    while (bits != 0u) {
      const int j = r0 + __ffs(bits) - 1;
      bits &= bits - 1u;
      const float* sv = samp + j * ss;
      if constexpr (CLS == kF32) {
        const float wt = s_wy[j * kTile + ty] * s_wx[j * WXS + tx];
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if (k < kn) acc[k] = fmaf(wt, sv[k], acc[k]);
        }
      } else {
        const float wy = s_wy[j * kTile + ty];
        const float wx = s_wx[j * WXS + tx];
        const float ah = bf16r(wx);
        const float al = CLS == kBF16 ? 0.0f : bf16_lo(wx, ah);
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if (k < kn) acc[k] = class_fma<CLS, true>(ah, al, __fmul_rn(sv[k], wy), acc[k]);
        }
      }
    }
  }
}

// Pass 3's end (B1, B4): a one-item tile stores its scaled sums, a split
// tile's item its fp32 partials in slot `slot`.
template <int KP>
__device__ __forceinline__ void store_item(float2* __restrict__ out, const float (&acc)[KP],
                                           const Work& w, int slot, int K, int k0, int kn,
                                           int nxos, const TileSpan& ts, int tx, int ty,
                                           float scale) {
  const int x = ts.tx0 + tx;
  const int y = ts.ty0 + ty;
  if (slot < 0) {
    if (x < nxos && y < nxos) store<KP>(out, acc, k0, kn, nxos, x, y, scale);
  } else {
    float* dst = w.part + (static_cast<size_t>(slot) * K + k0) * kThreads + ty * kTile + tx;
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

inline void launch_reduce(float2* out, int nxos, int K, float scale, int slots, const Work& w,
                          cudaStream_t stream) {
  const long long units = static_cast<long long>(min(tiles_of(nxos), (slots + 1) / 2)) * (K / 2);
  grid_tile_reduce_kernel<<<static_cast<int>(min(units, static_cast<long long>(kReduceBlocks))),
                            kThreads, 0, stream>>>(out, nxos, K, scale, w);
}

// Passes 1, 2, then the caller's contraction `contract(grid)` on the item
// grid, then 4: the tile-band kernels (B1, B5).  RW as weight_rows.
template <bool LATTICE, bool RW, typename F>
void launch_band_passes(const float* ct, const float* st, const float* rad, float2* out,
                        int npe, int nR, int nxos, int K, float kw, float beta, float scale,
                        const Work& w, cudaStream_t stream, F&& contract) {
  const int T = tiles_of(nxos);
  const int slots = slots_of(npe, nR);
  const int W = window_of(kw);
  grid_tile_band_kernel<LATTICE, RW><<<T + weight_blocks(npe, nR, W), kThreads, 0, stream>>>(
      ct, st, rad, npe, nR, nxos, kw, beta, W, T, w);
  grid_tile_items_kernel<<<1, kScanThreads, 0, stream>>>(T, slots, 1, w);
  contract(dim3(max_items(T, slots), (K + kMaxChannels - 1) / kMaxChannels));
  launch_reduce(out, nxos, K, scale, slots, w, stream);
}

// The arguments of a tile-kernel entry point, checked.
inline bool bad_tile_args(int npe, int nR, int nxos, int K, float kw, const void* rad,
                          const void* work) {
  return bad_args(npe, nR, nxos, K, rad) || npe < 1 || !(kw > 0.0f) ||
         2 * window_of(kw) > 32 || static_cast<long long>(npe) * nR > INT_MAX ||
         reinterpret_cast<uintptr_t>(work) % kAlign != 0;
}

}  // namespace
