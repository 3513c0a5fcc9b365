// Adjoint radial gridding as B1's tile contraction with its pass 3 a static
// unroll on tensor cores (the contract is stated in grid_radial2d.cuh).
//
// Replaces tron_tpu/ops/grid_pallas.py::_win_kernel_batched: B1's
// contraction with the per-hit dynamic loop replaced by a static unroll
// over hit slots, padded slots masked by a 0/1 multiply ("mask, do not
// perturb", grid_pallas.py:1250-1255), the slots' operands concatenated
// into one dot for the matrix unit.  On Hopper the matrix unit is
// mma.sync: passes 1, 2 and 4 are B1's (grid_tiles.cuh: tile bands and
// weight table, item scan, reduce of the split tiles) and pass 3 is this
// file's grid_tile_mma_kernel:
//
//   - an item's rows are staged as B1 stages them (cp.async of samples,
//     weight headers and runs, chunks of kChunkRows), then expanded to the
//     tile's 16 columns (A) and 16 rows (B), rows past the item's end
//     padded to a multiple of 32 with their weights times 0 and their
//     samples zeroed, so no stale value reaches a product;
//   - the contraction is the TPU kernel's own layout, out[c, y, x] =
//     sum_rows A[row, x] U[row, (y, c)], M = the tile's 16 columns, N =
//     (tile row, channel), 16 x 12 = 192 at whole-body, K = rows, with
//     U = s (x) y-weights formed in fp32 from shared memory.  N is ordered
//     y-major so that a thread's two accumulator columns are the real and
//     imaginary channel of one coil;
//   - every row is contracted, none skipped: 32-row groups, each a static
//     unroll of four m16n8k8 k-steps; a warp owns n-tiles warp, warp + 8,
//     ... of the 2 KP n-tiles (3 at 12 channels);
//   - the precision class is a template parameter, as the TPU kernel's
//     `passes` (grid_pallas.py:1219-1231).  The bf16 classes pack JAX's
//     operands with cvt.rn.bf16x2.f32, A = the x-weights, U = s * wy
//     formed in fp32, and run one, two or three bf16 MMAs per k-step
//     (m16n8k8.f32.bf16.bf16.f32, exact products, fp32 accumulation):
//     bfloat16 Uh Ah; bf16x2 Uh Ah + Uh Al; bf16x3 Uh Ah + Ul Ah + Uh Al,
//     with xh = bf16(x), xl = bf16(x - xh) (precision.cuh).  A thread's k
//     rows are j and j + 4 in every class, so its A loads stay free of bank
//     conflicts and its accumulators are the same four;
//   - float32 stays float32-grade as 3xTF32: x_hi = cvt.rna.tf32(x),
//     x_lo = cvt.rna.tf32(x - x_hi) for both operands, and the terms
//     hi*lo, lo*hi, hi*hi accumulated in fp32 in that order, each split
//     product good to about 2^-21.
// Deterministic: a fixed k-step order, partials summed in item order by
// pass 4, no atomics.  The sums regroup B1's terms, so the output is within
// the fp32 limit of B1's and of the plain version, not bitwise.
//
// Bound: bytes, as B1 (17.6 MB per whole-body frame, 5.25 us at
// 3.35 TB/s); its tensor-core work, 190,567 rows x 16 x 192 x 2 x 3 =
// 3.5 GFLOP of TF32 per frame at float32, would take 7 us at 495 TFLOP/s,
// and 1.2 GFLOP per bf16 pass 1.2 us per pass at 989 TFLOP/s.  wgmma
// needs 64-row M, which one 16-column tile does not fill; regrouping four
// tiles (or four items) per warpgroup for it is later work.
//
// Plain C interface, loaded with ctypes by tron_tpu_torch/_build.py.

#include "grid_tiles.cuh"

namespace {

constexpr int kWXS = 24;  // s_wx's row stride: conflict-free A fragments

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// (x0, x1) as two bfloat16 in one register, x0 in the low half (the lower
// k index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// x0, x1 = hi + lo, each half a bfloat16 pair: hi = bf16(x), lo = bf16(x -
// hi) (x - hi is exact).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(__fsub_rn(x0, __uint_as_float(hi << 16)),
                 __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u)));
}

// d += a b, one m16n8k8 bf16 product accumulated in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// d += a b, one m16n8k8 TF32 product accumulated in fp32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 3 of B5: one item per block, one channel block per blockIdx.y; CLS
// the precision class.
template <int KP, int CLS>
__global__ void __launch_bounds__(kThreads)
grid_tile_mma_kernel(const float* __restrict__ planes,  // (npe, nR, K)
                     float2* __restrict__ out,          // (K/2, nxos, nxos)
                     int npe, int nR, int nxos, int K, int W, float scale,
                     int ntiles, Work w) {
  constexpr int KS = (KP + 3) / 4 * 4;       // a staged row, 16-byte aligned
  constexpr int NT = 2 * KP;                 // n-tiles of 8 (y, channel) columns
  constexpr int TPW = (NT + kWarps - 1) / kWarps;  // n-tiles per warp
  __shared__ __align__(16) float s_samp[kChunkRows][KS];
  __shared__ __align__(16) float s_wt[kChunkRows][2 * kTile];
  __shared__ int4 s_hdr[kChunkRows];
  __shared__ float s_wx[kChunkRows][kWXS];  // A: the x-weights at the tile's columns
  __shared__ float s_wy[kChunkRows][kTile];  // the y-weights at its rows
  __shared__ int s_off[kChunkRows + 1];
  __shared__ int2 s_ent[kChunkRows + 1];
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
  const int wcoord = (lane < kTile ? ts.tx0 + lane : ts.ty0 + lane - kTile) - h;
  const int g = lane >> 2;  // the fragments' group and thread-in-group
  const int q = lane & 3;

  // this thread's B-fragment column of each of its n-tiles: n = 8 nt + g,
  // tile row n / KP, channel n % KP
  int by[TPW], bc[TPW];
  bool live[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int nt = warp + kWarps * i;
    const int n = 8 * nt + g;
    live[i] = nt < NT;
    by[i] = min(n / KP, kTile - 1);
    bc[i] = n % KP;
  }
  float acc[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.0f;
  }

  for (int q0 = s_info[1]; q0 < end; q0 += kChunkRows) {
    const int n = min(kChunkRows, end - q0);
    const int m = (n + 31) & ~31;  // the static unroll's slots
    stage_rows<KS, false>(planes, nR, K, k0, kn, W, vec4, w, ent, off, nent, e0, q0, n, ts, h,
                          s_samp, s_wt, s_hdr, s_off, s_ent, nullptr, &s_info[5]);
    e0 = s_info[5];
    // the padded slots' samples and the channels past kn are zeros
    for (int i = tid; i < m * KS; i += kThreads) {
      const int j = i / KS;
      const int k = i - j * KS;
      if (j >= n || k >= kn) s_samp[j][k] = 0.0f;
    }
    expand_weights<kWXS, true>(s_hdr, &s_wt[0][0], 2 * kTile, W, n, m, wcoord, &s_wx[0][0],
                               &s_wy[0][0]);
    __syncthreads();
    for (int r0 = 0; r0 < n; r0 += 32) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int j = r0 + 8 * ks + q;  // this thread's k rows j and j + 4
        if constexpr (CLS == kF32) {
          uint32_t ah[4], al[4];
          split(s_wx[j][g], ah[0], al[0]);
          split(s_wx[j][g + 8], ah[1], al[1]);
          split(s_wx[j + 4][g], ah[2], al[2]);
          split(s_wx[j + 4][g + 8], ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            if (!live[i]) continue;  // warp-uniform
            uint32_t bh0, bl0, bh1, bl1;
            split(s_samp[j][bc[i]] * s_wy[j][by[i]], bh0, bl0);
            split(s_samp[j + 4][bc[i]] * s_wy[j + 4][by[i]], bh1, bl1);
            mma_tf32(acc[i], ah, bl0, bl1);
            mma_tf32(acc[i], al, bh0, bh1);
            mma_tf32(acc[i], ah, bh0, bh1);
          }
        } else {
          // A: rows g and g + 8 of the fragment (tile columns), k rows j, j + 4
          uint32_t ah[2], al[2];
          split_bf16(s_wx[j][g], s_wx[j + 4][g], ah[0], al[0]);
          split_bf16(s_wx[j][g + 8], s_wx[j + 4][g + 8], ah[1], al[1]);
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            if (!live[i]) continue;  // warp-uniform
            uint32_t bh, bl;
            split_bf16(__fmul_rn(s_samp[j][bc[i]], s_wy[j][by[i]]),
                       __fmul_rn(s_samp[j + 4][bc[i]], s_wy[j + 4][by[i]]), bh, bl);
            mma_bf16(acc[i], ah, bh);                        // Uh Ah
            if constexpr (CLS == kBF16x3) mma_bf16(acc[i], ah, bl);  // + Ul Ah
            if constexpr (CLS != kBF16) mma_bf16(acc[i], al, bh);    // + Uh Al
          }
        }
      }
    }
    __syncthreads();  // the chunk's buffers are reused
  }

  // accumulator r of n-tile nt: column x = g + 8 (r >> 1), n = 8 nt + 2q +
  // (r & 1): tile row n / KP, channel n % KP (even: a coil's real part)
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int n = 8 * (warp + kWarps * i) + 2 * q;
    const int c = n % KP;
    if (!live[i] || c >= kn) continue;
    const int y = ts.ty0 + n / KP;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = ts.tx0 + g + 8 * half;
      const float re = acc[i][2 * half];
      const float im = acc[i][2 * half + 1];
      if (slot < 0) {
        if (x < nxos && y < nxos) {
          out[(static_cast<size_t>((k0 + c) / 2) * nxos + y) * nxos + x] =
              make_float2(re * scale, im * scale);
        }
      } else {
        float* dst = w.part + (static_cast<size_t>(slot) * K + k0 + c) * kThreads +
                     (y - ts.ty0) * kTile + (x - ts.tx0);
        dst[0] = re;
        dst[kThreads] = im;
      }
    }
  }
}

}  // namespace

extern "C" {

// As tron_grid_radial2d_planes (the same arguments, class codes and
// workspace, from tron_grid_radial2d_workspace_bytes).
int tron_grid_radial2d_batched_planes(const void* planes, const void* ct,
                                      const void* st, const void* rad,
                                      void* out, int npe, int nR, int nxos,
                                      int K, float kw, float beta, float scale, int cls,
                                      void* work, size_t work_size, void* stream) {
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
        grid_tile_mma_kernel<KP, CLS><<<grid, kThreads, 0, strm>>>(p, o, npe, nR, nxos, K, W, scale,
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

}  // extern "C"
