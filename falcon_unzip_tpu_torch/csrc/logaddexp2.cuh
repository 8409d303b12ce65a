// The base-2 logaddexp on the SFU, shared by the log-space kernels
// (pairhmm.cu, arrow_splice.cu, pairhmm_ablate.cu).
//
// Values are carried in log2 units: natural-log inputs are scaled by
// log2(e) as they are read and the results by ln(2) as they are stored
// (to_ln).  NEG = -1e30 marks "no path" in either unit: scaled it stays
// below -1e29, and to_ln maps everything below -1e29 back to NEG exactly.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// logaddexp of two and of three terms in log2 units, on the SFU:
// max + lg2(1 + ex2(-|a - b|)), and for three terms max + lg2(1 + ex2 +
// ex2) of the other two (3 SFU operations, not 4).  NEG + NEG stays NEG:
// ex2(0) = 1 and NEG + lg2(2) == NEG in float32.
__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + lg2(1.0f + ex2(-fabsf(a - b)));
}

__device__ __forceinline__ float lae3(float a, float b, float c) {
  const float hi_ab = fmaxf(a, b), lo_ab = fminf(a, b);
  const float hi = fmaxf(hi_ab, c);
  const float lo = fminf(lo_ab, c);
  const float mid = fmaxf(lo_ab, fminf(hi_ab, c));
  return hi + lg2(1.0f + ex2(mid - hi) + ex2(lo - hi));
}

// A value in log2 units back in natural-log units; NEG stays NEG.
__device__ __forceinline__ float to_ln(float v) {
  return v < -1e29f ? kNeg : v * kLn2;
}

}  // namespace
