// Kaiser-Bessel weight shared by the gridding and degridding kernels.
//
// kb_kernel of kernels/kb.py: 0.5/kw * I0(beta*sqrt(1-(x/kw)^2)) for
// |x| < kw, else 0, with the same rational I0 (Blair & Edwards,
// src/tron.cu:304-349).  The support test uses the same rounded x/kw
// product as the plain version, so a term at |x| ~ kw is kept or dropped
// exactly as kernels/kb.py keeps or drops it.  The weight is even in d
// (it reads only |u| and u*u).

#pragma once

// ROUNDED = false: the kernels' float32 weight, its Horner steps contracted
// into FMAs.  ROUNDED = true: every operation rounded on its own as torch
// rounds kb_kernel's (no contraction; the constants rounded to double and
// then to float as Python's are), so the weight is kb_kernel's bit for bit
// on the same argument.  The bf16 classes take it: a weight one ulp away
// can round to another bfloat16, and each such flip moves its terms by a
// bfloat16 ulp, far above the kernels' fp32 tolerance against their plain
// versions.
template <bool ROUNDED = false>
__device__ __forceinline__ float kb_weight(float d, float inv_kw, float amp,
                                           float beta) {
  const float u = __fmul_rn(d, inv_kw);
  if (!(fabsf(u) < 1.0f)) return 0.0f;
  if constexpr (ROUNDED) {
    const float f = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(u, u)), 0.0f));
    const float x = __fmul_rn(beta, f);
    const float z = __fmul_rn(x, x);
    // num = num * z + c, each coefficient a double literal rounded to float
    auto step = [z](float acc, double c) {
      return __fadd_rn(__fmul_rn(acc, z), static_cast<float>(c));
    };
    float num = static_cast<float>(0.210580722890567e-22);
    num = step(num, 0.380715242345326e-19);
    num = step(num, 0.479440257548300e-16);
    num = step(num, 0.435125971262668e-13);
    num = step(num, 0.300931127112960e-10);
    num = step(num, 0.160224679395361e-7);
    num = step(num, 0.654858370096785e-5);
    num = step(num, 0.202591084143397e-2);
    num = step(num, 0.463076284721000e0);
    num = step(num, 0.754337328948189e2);
    num = step(num, 0.830792541809429e4);
    num = step(num, 0.571661130563785e6);
    num = step(num, 0.216415572361227e8);
    num = step(num, 0.356644482244025e9);
    num = step(num, 0.144048298227235e10);
    float den = __fadd_rn(z, static_cast<float>(-0.307646912682801e4));
    den = step(den, 0.347626332405882e7);
    den = step(den, -0.144048298227235e10);
    return __fmul_rn(amp, __fdiv_rn(-num, den));
  } else {
    const float f = sqrtf(fmaxf(1.0f - u * u, 0.0f));
    const float x = beta * f;
    const float z = x * x;
    float num = 0.210580722890567e-22f;
    num = num * z + 0.380715242345326e-19f;
    num = num * z + 0.479440257548300e-16f;
    num = num * z + 0.435125971262668e-13f;
    num = num * z + 0.300931127112960e-10f;
    num = num * z + 0.160224679395361e-7f;
    num = num * z + 0.654858370096785e-5f;
    num = num * z + 0.202591084143397e-2f;
    num = num * z + 0.463076284721000e0f;
    num = num * z + 0.754337328948189e2f;
    num = num * z + 0.830792541809429e4f;
    num = num * z + 0.571661130563785e6f;
    num = num * z + 0.216415572361227e8f;
    num = num * z + 0.356644482244025e9f;
    num = num * z + 0.144048298227235e10f;
    float den = z - 0.307646912682801e4f;
    den = den * z + 0.347626332405882e7f;
    den = den * z - 0.144048298227235e10f;
    return amp * (-num / den);
  }
}
