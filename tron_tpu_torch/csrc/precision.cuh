// The precision classes of the JAX kernels (tron_tpu/ops/grid_pallas.py
// `matmul_dtype`), shared by every kernel of csrc/.  A class says which
// operands of a contraction term are rounded to bfloat16 and which split
// products put the rounding loss back:
//
//   bfloat16  ah * bh
//   bf16x2    ah * bh + (one lo term: al * bh or ah * bl, per kernel)
//   bf16x3    ah * bh + ah * bl + al * bh
//   float32   a * b in fp32 (each kernel's own fp32 code)
//
// with xh = bf16(x) (round to nearest, ties to even, as jnp.astype and
// torch's .to(torch.bfloat16) round) and xl = bf16(x - xh).  A product of
// two bfloat16 values is exact in fp32, and every sum is fp32, so a term
// differs from the TPU's only in the order of the fp32 sums.  The codes
// are the order of ops/grid_cuda.py MATMUL_DTYPES.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace {

enum Class : int { kBF16 = 0, kBF16x2 = 1, kBF16x3 = 2, kF32 = 3 };

inline bool bad_class(int cls) { return cls < kBF16 || cls > kF32; }

// Calls f(std::integral_constant<int, CLS>{}) for the class code cls.
template <typename F>
void with_class(int cls, F&& f) {
  switch (cls) {
    case kBF16: f(std::integral_constant<int, kBF16>{}); break;
    case kBF16x2: f(std::integral_constant<int, kBF16x2>{}); break;
    case kBF16x3: f(std::integral_constant<int, kBF16x3>{}); break;
    default: f(std::integral_constant<int, kF32>{}); break;
  }
}

// x rounded to bfloat16, as a float.
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The lo half of x given its hi half: bf16(x - xh); x - xh is exact.
__device__ __forceinline__ float bf16_lo(float x, float xh) { return bf16r(__fsub_rn(x, xh)); }

// acc + a * b at a bf16 class CLS, a already split into ah, al (al is read
// only where the class uses it), b split here.  Terms in the table's order:
// ah bh, then bf16x2's lo term (al bh with A_LO, else ah bl), or bf16x3's
// ah bl and al bh; each an fmaf of an exact product.
template <int CLS, bool A_LO>
__device__ __forceinline__ float class_fma(float ah, float al, float b, float acc) {
  static_assert(CLS != kF32, "float32 terms are each kernel's own fp32 code");
  const float bh = bf16r(b);
  acc = fmaf(ah, bh, acc);
  if constexpr (CLS == kBF16x3 || (CLS == kBF16x2 && !A_LO)) acc = fmaf(ah, bf16_lo(b, bh), acc);
  if constexpr (CLS == kBF16x3 || (CLS == kBF16x2 && A_LO)) acc = fmaf(al, bh, acc);
  return acc;
}

}  // namespace
