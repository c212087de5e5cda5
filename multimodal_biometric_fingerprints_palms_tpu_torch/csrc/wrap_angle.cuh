// The matcher's angle wrap, torch.remainder(x + pi, 2 pi) - pi in float32
// bit for bit, for the kernels that take an orientation difference (D,
// match.cu, and H, finish.cu, gate on its absolute value; I, sample.cu,
// keeps the sampled angle).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

static __device__ __forceinline__ float wrap_angle(float x) {
  // torch.remainder(x + pi, 2 pi) - pi. The remainder's fmod by hand
  // where its quotient is 0 or 1, which a sum of three angles in [-pi, pi]
  // always gives: v itself below 2 pi, v -+ 2 pi below 4 pi (exact: the
  // difference of two floats within a factor of two of each other is a
  // float); fmodf beyond.
  const float v = __fadd_rn(x, kPi);
  const float av = fabsf(v);
  float r;
  if (av < kTwoPi) r = v;
  else if (av < 2.0f * kTwoPi) r = copysignf(__fsub_rn(av, kTwoPi), v);
  else r = fmodf(v, kTwoPi);
  if (r < 0.0f) r = __fadd_rn(r, kTwoPi);   // the divisor's sign
  return __fsub_rn(r, kPi);
}

static __device__ __forceinline__ float wrap_abs(float x) {
  // |torch.remainder(x + pi, 2 pi) - pi|
  return fabsf(wrap_angle(x));
}
