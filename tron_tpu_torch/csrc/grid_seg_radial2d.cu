// Adjoint radial gridding over static radius segments and wedge-culled
// spoke lists, as a load-balanced tile contraction fed by bulk async copies
// (the contract is stated in grid_radial2d.cuh).
//
// Replaces tron_tpu/ops/grid_pallas.py::_seg_kernel (reached with
// windowed=False): per (tile, radius sign) one static segment of the
// sample planes (_tile_segments, a start per (tile, sign) and one length
// for the grid), per frame the spokes whose angular wedge reaches the tile
// (_culling_tables, cull="geom"), one contraction per (sign, chunk), no
// short class.  Here, in four passes on the caller's stream:
//
//   1. lists (one block per 16 x 16 tile): each spoke is tested against
//      the tile's wedge for both signs, in the Cartesian form of JAX's
//      test (ops/cull.py:seg_hits, a superset of JAX's hits by the slacks
//      kCullSlack and kCullSlack2 that cover fp32 rounding), and the hits
//      are listed in ascending spoke index, the negative-radius segment
//      (lower rows) first, so the rows of each spoke ascend as in B1.  A
//      listed entry is one segment, (spoke, first plane row); the tile's
//      rows are its segments end to end.  The same launch's other blocks fill B1's weight table
//      (grid_tiles.cuh:weight_rows);
//   2. items (grid_tiles.cuh): the tiles' rows cut into items of L rows,
//      L a multiple of the segment length, so an item is whole segments and
//      a row's (spoke, row) follows by integer division, with no search;
//      the partial slots are sized from B4's own rows estimate (the wedge
//      geometry, by the caller), not B1's;
//   3. contract (one item per block, one channel block per blockIdx.y):
//      each segment is seg x K contiguous floats of the planes, and its
//      weight headers and runs are contiguous too.  A producer warp copies
//      whole segments with cp.async.bulk (the 1-D TMA copy) into a ring of
//      kStages shared-memory stages, each completing on its mbarrier, and
//      keeps the next stage in flight while the 8 consumer warps contract
//      the current one with B1's FMA walk at the precision class
//      (grid_tiles.cuh:fma_rows, its warp-uniform skip of rows that miss a
//      warp's tile rows; _seg_kernel's classes are B1's terms, bf16x2 taken
//      as bf16x3 by the wrapper as grid_pallas.py:737 takes it) and
//      release it on a second mbarrier.  When the samples are not 16-byte
//      aligned (an odd coil count: K * 4 = 8 mod 16) the producer copies
//      them with cp.async and an arrive-on of the same barrier instead;
//   4. reduce (grid_tiles.cuh): the split tiles' partials, in item order.
//
// A row of a segment outside a pixel's band adds exactly 0 (fmaf(0, s, acc)
// == acc; row 0 of the planes is never gridded), culled spokes add only
// zero terms, and each nonzero term lies in exactly one listed segment, so
// B4 sums B1's nonzero terms in B1's order, regrouped only at item
// boundaries.  No atomics.
//
// Bound: bytes, as B1 (17.6 MB per whole-body frame, 5.25 us at
// 3.35 TB/s).  At whole-body B4 lists 2.32x B1's rows (13,816 segments of
// 32 rows), most of them out of band and skipped by the walk's masks.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include "grid_tiles.cuh"

namespace {

constexpr int kStages = 2;             // the ring of shared-memory stages
constexpr float kCullSlack = 0.01f;    // pixels: the wedge test's slack on the projection
constexpr float kCullSlack2 = 0.1f;    // squared pixels: on its squares (ops/cull.py:seg_hits)
constexpr int kSegThreads = kThreads + 32;  // 8 consumer warps and the producer
constexpr size_t kMaxDynamic = 200 * 1024;  // bytes of stages at most

// Pass 1, blocks [0, T): tile t's list of segments (spoke, first row),
// spokes ascending, the negative-radius segment first, and its rows.
// seg_start[2 t + s]: the first row of sign s's segment (0: positive
// radii, 1: negative), -1 when the sign's band is empty.
__device__ void seg_list(int t, const float* __restrict__ ct, const float* __restrict__ st,
                         int npe, int nxos, int seg, float margin,
                         const int* __restrict__ seg_start, const Work& w) {
  __shared__ int s_cnt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntx = (nxos + kTile - 1) / kTile;
  const int h = nxos / 2;
  // the full tile's centre, as JAX's wedge takes it ((j + 0.5) tile - h)
  const float cx = static_cast<float>((t % ntx) * kTile + kTile / 2 - h);
  const float cy = static_cast<float>((t / ntx) * kTile + kTile / 2 - h);
  const float d2m = cx * cx + cy * cy - margin * margin;  // <= 0: every spoke
  const float lim = d2m - kCullSlack2;
  const int s_pos = seg_start[2 * t];
  const int s_neg = seg_start[2 * t + 1];
  int2* ent = w.ent + static_cast<size_t>(t) * 2 * npe;
  int nent = 0;
  for (int p0 = 0; p0 < npe; p0 += kThreads) {
    const int p = p0 + tid;
    bool pos = false, neg = false;
    if (p < npe) {
      const float proj = ct[p] * cx + st[p] * cy;  // the spoke's direction . centre
      const float a = proj + kCullSlack;
      const float b = kCullSlack - proj;
      pos = s_pos >= 0 && (d2m <= 0.0f || (a >= 0.0f && a * a >= lim));
      neg = s_neg >= 0 && (d2m <= 0.0f || (b >= 0.0f && b * b >= lim));
    }
    const int n = static_cast<int>(pos) + static_cast<int>(neg);
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_cnt[warp] = incl;
    __syncthreads();
    int base = 0, tot = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      base += v < warp ? s_cnt[v] : 0;
      tot += s_cnt[v];
    }
    int i = nent + base + incl - n;
    if (neg) ent[i++] = make_int2(p, s_neg);
    if (pos) ent[i] = make_int2(p, s_pos);
    nent += tot;
    __syncthreads();  // s_cnt is reused
  }
  if (tid == 0) {
    w.tile_nent[t] = nent;
    w.tile_rows[t] = nent * seg;
  }
}

template <bool LATTICE, bool RW>
__global__ void __launch_bounds__(kThreads)
grid_seg_list_kernel(const float* __restrict__ ct, const float* __restrict__ st,
                     const float* __restrict__ rad, int npe, int nR, int nxos, float kw,
                     float beta, int W, int seg, float margin,
                     const int* __restrict__ seg_start, int ntiles, Work w) {
  if (static_cast<int>(blockIdx.x) < ntiles) {
    seg_list(blockIdx.x, ct, st, npe, nxos, seg, margin, seg_start, w);
  } else {
    weight_rows<LATTICE, RW>(blockIdx.x - ntiles, gridDim.x - ntiles, ct, st, rad, npe, nR,
                             nxos, kw, beta, W, w);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The named barrier of the 8 consumer warps (the producer is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// A stage: G segments of seg rows each; samples (all K channels), weight
// headers and weight runs, each part 16-byte aligned.
struct Stage {
  size_t samp, hdr, wt, bytes;
};

__host__ __device__ inline Stage stage_layout(int rows, int K, int ws) {
  Stage s;
  s.samp = 0;
  s.hdr = (static_cast<size_t>(rows) * K * sizeof(float) + 127) / 128 * 128;
  s.wt = s.hdr + static_cast<size_t>(rows) * sizeof(int4);
  s.bytes = (s.wt + static_cast<size_t>(rows) * ws * sizeof(float) + 127) / 128 * 128;
  return s;
}

// Pass 3 of B4: warps 0-7 consume, warp 8 produces.  G segments per stage;
// CLS the precision class.
template <int KP, int CLS>
__global__ void __launch_bounds__(kSegThreads)
grid_seg_contract_kernel(const float* __restrict__ planes,  // (npe, nR, K)
                         float2* __restrict__ out,          // (K/2, nxos, nxos)
                         int npe, int nR, int nxos, int K, int W, float scale, int seg,
                         int G, bool bulk, int ntiles, Work w) {
  extern __shared__ __align__(128) unsigned char s_stage[];
  __shared__ float s_wx[kChunkRows][kTile];
  __shared__ float s_wy[kChunkRows][kTile];
  __shared__ unsigned s_mask[kChunkRows];
  __shared__ uint64_t s_full[kStages];
  __shared__ uint64_t s_empty[kStages];
  __shared__ int s_info[6];

  const int item = blockIdx.x;
  if (item >= w.head[1]) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (warp == 0) locate_item<false>(item, ntiles, npe, w, s_info);
  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) {
      mbar_init(&s_full[b], bulk ? 1 : 33);  // the producer's arrive (+ its lanes' cp.async)
      mbar_init(&s_empty[b], 1);             // the consumers' release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int t = s_info[0];
  const int sbeg = s_info[1] / seg;  // the item's segments [sbeg, send)
  const int send = s_info[2] / seg;
  const int slot = s_info[4];
  const int nst = (send - sbeg + G - 1) / G;
  const int2* __restrict__ ent = w.ent + static_cast<size_t>(t) * 2 * npe;
  const int ws = table_stride(W);
  const Stage lay = stage_layout(G * seg, K, ws);

  if (warp == kWarps) {  // the producer
    for (int i = 0; i < nst; ++i) {
      const int b = i % kStages;
      if (i >= kStages) mbar_wait(&s_empty[b], ((i / kStages) - 1) & 1);
      unsigned char* stage = s_stage + b * lay.bytes;
      const int e0 = sbeg + i * G;
      const int ne = min(G, send - e0);
      const unsigned rows = static_cast<unsigned>(ne * seg);
      if (lane == 0) {
        mbar_arrive_expect_tx(&s_full[b], rows * (static_cast<unsigned>(sizeof(int4)) +
                                                  ws * static_cast<unsigned>(sizeof(float)) +
                                                  (bulk ? K * static_cast<unsigned>(sizeof(float)) : 0u)));
      }
      __syncwarp();
      for (int j = lane; j < ne; j += 32) {  // more than 32 segments when seg < 4
        const int2 e = ent[e0 + j];
        const size_t pr = static_cast<size_t>(e.x) * nR + e.y;  // the segment's first plane row
        const int r = j * seg;
        bulk_copy(stage + lay.hdr + r * sizeof(int4), w.whdr + pr, seg * sizeof(int4), &s_full[b]);
        bulk_copy(stage + lay.wt + static_cast<size_t>(r) * ws * sizeof(float),
                  w.wtab + pr * ws, seg * ws * sizeof(float), &s_full[b]);
        if (bulk) {
          bulk_copy(stage + lay.samp + static_cast<size_t>(r) * K * sizeof(float),
                    planes + pr * K, seg * K * sizeof(float), &s_full[b]);
        }
      }
      if (!bulk) {  // 8-byte copies, channel pairs of every row of the stage
        float* dst = reinterpret_cast<float*>(stage + lay.samp);
        const int pairs = K / 2;
        for (int x = lane; x < static_cast<int>(rows) * pairs; x += 32) {
          const int j = x / pairs;
          const int k = 2 * (x - j * pairs);
          const int2 e = ent[e0 + j / seg];
          const size_t pr = static_cast<size_t>(e.x) * nR + e.y + j % seg;
          cp_async(dst + static_cast<size_t>(j) * K + k, planes + pr * K + k, false);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                         smem_addr(&s_full[b]))
                     : "memory");
      }
    }
    return;
  }

  const int k0 = blockIdx.y * kMaxChannels;
  const int kn = min(KP, K - k0);
  const TileSpan ts = tile_span(t, nxos);
  const int h = nxos / 2;
  const int tx = tid % kTile;
  const int ty = tid / kTile;  // warp v holds tile rows 2v and 2v + 1
  const int wcoord = (lane < kTile ? ts.tx0 + lane : ts.ty0 + lane - kTile) - h;
  float acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0f;

  for (int i = 0; i < nst; ++i) {
    const int b = i % kStages;
    const int e0 = sbeg + i * G;
    const int n = min(G, send - e0) * seg;
    const unsigned char* stage = s_stage + b * lay.bytes;
    const int4* hdr = reinterpret_cast<const int4*>(stage + lay.hdr);
    const float* wt = reinterpret_cast<const float*>(stage + lay.wt);
    mbar_wait(&s_full[b], (i / kStages) & 1);
    if (tid < n) {  // row j of the stage: segment j / seg, row j % seg of it
      const int2 e = ent[e0 + tid / seg];
      s_mask[tid] = e.y + tid % seg == 0 ? 0u : row_mask(hdr[tid], ts, h);
    }
    expand_weights<kTile, false>(hdr, wt, ws, W, n, n, wcoord, &s_wx[0][0], &s_wy[0][0]);
    consumers_sync();
    fma_rows<KP, kTile, CLS>(n, s_mask, &s_wx[0][0], &s_wy[0][0],
                        reinterpret_cast<const float*>(stage + lay.samp) + k0, K, kn, tx, ty,
                        acc);
    consumers_sync();  // the stage and s_wx, s_wy, s_mask are free
    if (tid == 0) mbar_arrive(&s_empty[b]);
  }
  store_item<KP>(out, acc, w, slot, K, k0, kn, nxos, ts, tx, ty, scale);
}

}  // namespace

extern "C" {

// Bytes of the workspace tron_grid_seg_radial2d_planes needs for these
// shapes and `slots` partial slots.
size_t tron_grid_seg_radial2d_workspace_bytes(int npe, int nR, int nxos, int K, float kw,
                                              int slots) {
  return work_bytes(npe, nR, nxos, K, window_of(kw), 2 * npe, false, slots, nullptr, nullptr);
}

// As tron_grid_radial2d_planes, with the static segments: seg_start (2T,)
// int32 on the device, T = ceil(nxos/16)^2, the first plane row of each
// (tile, sign)'s segment (sign 0 positive radii, 1 negative; -1: empty),
// seg the segment length (1 to 128 rows; every staged part stays 16-byte
// aligned, as table_stride and the bulk path's K % 4 == 0 keep each
// row's bytes a multiple of 16), margin the wedge
// test's reach beyond the tile centre (ops/cull.py:seg_hits), slots the
// partial slots the workspace holds (tron_grid_seg_radial2d_workspace_bytes),
// cls the precision class.
int tron_grid_seg_radial2d_planes(const void* planes, const void* ct, const void* st,
                                  const void* rad, void* out, int npe, int nR, int nxos,
                                  int K, float kw, float beta, float scale,
                                  const void* seg_start, int seg, float margin, int slots,
                                  int cls, void* work, size_t work_size, void* stream) {
  Work w;
  const int W = window_of(kw);
  if (bad_tile_args(npe, nR, nxos, K, kw, rad, work) || bad_class(cls) || seg < 1 ||
      seg > kChunkRows || seg > nR || slots < 1 || slots > kMaxSlots ||
      work_bytes(npe, nR, nxos, K, W, 2 * npe, false, slots, &w, static_cast<char*>(work)) >
          work_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ws = table_stride(W);
  int G = kChunkRows / seg;  // segments per stage
  while (G > 1 && kStages * stage_layout(G * seg, K, ws).bytes > kMaxDynamic) --G;
  const size_t dyn = kStages * stage_layout(G * seg, K, ws).bytes;
  if (dyn > kMaxDynamic) return static_cast<int>(cudaErrorInvalidValue);
  const bool bulk = (K & 3) == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  const float* p = static_cast<const float*>(planes);
  const float* c = static_cast<const float*>(ct);
  const float* s = static_cast<const float*>(st);
  const float* r = static_cast<const float*>(rad);
  const int* ss = static_cast<const int*>(seg_start);
  float2* o = static_cast<float2*>(out);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int T = tiles_of(nxos);
  const int blocks = T + weight_blocks(npe, nR, W);
  // a bf16 class takes the weights rounded as kb_kernel's (kb.cuh)
  auto list = [&](auto lattice, auto rw) {
    grid_seg_list_kernel<decltype(lattice)::value, decltype(rw)::value>
        <<<blocks, kThreads, 0, strm>>>(c, s, r, npe, nR, nxos, kw, beta, W, seg, margin, ss, T, w);
  };
  using F = std::false_type;
  using Tr = std::true_type;
  if (r == nullptr) {
    if (cls == kF32) list(F{}, F{}); else list(F{}, Tr{});
  } else {
    if (cls == kF32) list(Tr{}, F{}); else list(Tr{}, Tr{});
  }
  grid_tile_items_kernel<<<1, kScanThreads, 0, strm>>>(T, slots, seg, w);
  int code = 0;
  with_channel_block(K, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    with_class(cls, [&](auto c) {
      constexpr int CLS = decltype(c)::value;
      const cudaError_t e = cudaFuncSetAttribute(
          grid_seg_contract_kernel<KP, CLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dyn));
      if (e != cudaSuccess) {
        code = static_cast<int>(e);
        return;
      }
      const dim3 grid(max_items(T, slots), (K + kMaxChannels - 1) / kMaxChannels);
      grid_seg_contract_kernel<KP, CLS><<<grid, kSegThreads, dyn, strm>>>(
          p, o, npe, nR, nxos, K, W, scale, seg, G, bulk, T, w);
    });
  });
  if (code != 0) return code;
  launch_reduce(o, nxos, K, scale, slots, w, strm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
