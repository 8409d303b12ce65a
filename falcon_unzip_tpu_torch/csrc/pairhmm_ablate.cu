// Ablation of the pair-HMM antidiagonal step for Hopper (sm_90a).
//
// pairhmm_ablate_kernel replaces the TPU diagnostic kernel
// scripts/ablate_pallas.py::make.kern (launched by its pallas_call): the
// antidiagonal step of the banded pair-HMM forward (csrc/pairhmm.cu)
// reduced to its three parts, each switched on or off at compile time so
// each can be timed alone:
//   SHIFT  the +-1 band shift: the d-1 and d-2 M planes shifted by one
//          cell (NEG at w = 0) when s1 = lo(d) - lo(d-1) is 0;
//   LOAD   the windowed base load qg[row, lo(d) + w] (what the TPU kernel
//          rolls out of a 128-aligned window of W + 128 columns) and the
//          emission chosen from it;
//   LSE    the three logaddexps of the step, in the TPU kernel's nesting
//          M = em + lae(lae(Md - 0.1, I2 - 3), D2 - 3),
//          I = lae(Mu - 3, I1 - 1.6), D = lae(M1 - 3, D1 - 1.6),
//          lae(a, b) = max(a, b) + log1p(exp(-|a - b|)); with the bit off
//          the same step in plain max.
// Every step folds M into out = max(out, M) and runs to d = Dmax - 1, so
// no step can be dropped.  out starts at NEG = -1e30 and the shift fills
// NEG, as in the TPU kernel; the six state planes start from the input
// plane init (P, W).  With init = NEG everywhere this is the TPU kernel,
// whose out is then NEG everywhere (NEG + small rounds back to NEG); a
// finite seeded init makes the shift, the window and the logaddexps each
// show in out, which is what the parity checks run at.
//
//   Layout: the first design of csrc/pairhmm.cu, which that kernel has
//   since left (it now runs a block a pair, pushes values to their one
//   successor cell, has constant shifts and an unmasked steady phase, and
//   a base-2 logaddexp on the SFU).  One warp per row, four rows a block,
//   lane L holds the C = W/32 contiguous cells w = L*C .. L*C + C-1 of
//   M/I/D on the antidiagonals d-1 and d-2 in registers; the shift crosses
//   lanes with one __shfl_up_sync of the edge cell.  The block's rows of qg are
//   copied into shared memory first in every variant, as the TPU kernel's
//   BlockSpec copies its block into VMEM; LOAD reads the window from there
//   (lane stride C words: a C-way bank conflict per read).
//
//   What bounds it: a chain of Dmax dependent steps per row, each a few
//   SFU ops (LSE), shuffles (SHIFT) and shared-memory reads (LOAD); no
//   device-memory traffic after the first copy, so latency per step times
//   Dmax, hidden only by the other warps in flight.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kShift = 1, kLoad = 2, kLse = 4;

__device__ __forceinline__ int band_lo(int d, int W) {
  const int x = (d + 1) / 2 - W / 2;
  return x > 0 ? x : 0;
}

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

template <int C, bool SHIFT, bool LOAD, bool LSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pairhmm_ablate_kernel(const int32_t* __restrict__ qg,
                      const float* __restrict__ init, int P, int LQG,
                      int Dmax, float* __restrict__ out) {
  constexpr int W = 32 * C;
  extern __shared__ int32_t rows[];  // kWarpsPerBlock x LQG
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= P) return;  // whole warp leaves together; no block barrier below
  int32_t* row = rows + static_cast<size_t>(warp) * LQG;
  const int32_t* src = qg + static_cast<size_t>(p) * LQG;
  for (int k = lane; k < LQG; k += 32) row[k] = src[k];
  __syncwarp();
  const int w0 = lane * C;

  const float* seed = init + static_cast<size_t>(p) * W + w0;
  float M1[C], I1[C], D1[C], M2[C], I2[C], D2[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    M1[c] = I1[c] = D1[c] = seed[c];
    M2[c] = I2[c] = D2[c] = seed[c];
    acc[c] = kNeg;
  }

  for (int d = 0; d < Dmax; ++d) {
    const int lo = band_lo(d, W);
    const int s1 = lo - band_lo(d - 1, W);
    float m1_prev = kNeg, m2_prev = kNeg;
    if (SHIFT) {
      m1_prev = __shfl_up_sync(kFull, M1[C - 1], 1);
      m2_prev = __shfl_up_sync(kFull, M2[C - 1], 1);
      if (lane == 0) m1_prev = m2_prev = kNeg;
    }
    float M[C], I[C], D[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float Md = M2[c], Mu = M1[c];
      if (SHIFT && s1 == 0) {
        Md = c == 0 ? m2_prev : M2[c - 1];
        Mu = c == 0 ? m1_prev : M1[c - 1];
      }
      float em = -0.1f;
      if (LOAD) em = row[lo + w0 + c] < 4 ? -0.1f : -3.0f;
      if (LSE) {
        M[c] = em + lae(lae(Md - 0.1f, I2[c] - 3.0f), D2[c] - 3.0f);
        I[c] = lae(Mu - 3.0f, I1[c] - 1.6f);
        D[c] = lae(M1[c] - 3.0f, D1[c] - 1.6f);
      } else {
        M[c] = em + fmaxf(fmaxf(Md, I2[c]), D2[c]);
        I[c] = fmaxf(Mu, I1[c]);
        D[c] = fmaxf(M1[c], D1[c]);
      }
      acc[c] = fmaxf(acc[c], M[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      M2[c] = M1[c];
      I2[c] = I1[c];
      D2[c] = D1[c];
      M1[c] = M[c];
      I1[c] = I[c];
      D1[c] = D[c];
    }
  }
  float* dst = out + static_cast<size_t>(p) * W + w0;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = acc[c];
}

template <bool SHIFT, bool LOAD, bool LSE>
cudaError_t launch(const int32_t* qg, const float* init, int P, int LQG,
                   int Dmax, float* out, cudaStream_t stream) {
  constexpr int C = 4;  // W = 128, the TPU kernel's band
  const size_t smem = sizeof(int32_t) * kWarpsPerBlock * LQG;
  auto* kern = pairhmm_ablate_kernel<C, SHIFT, LOAD, LSE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  kern<<<grid, block, smem, stream>>>(qg, init, P, LQG, Dmax, out);
  return cudaGetLastError();
}

}  // namespace

// feats: a bit set of kShift | kLoad | kLse; the five sets of the TPU
// ablation are built: {}, {shift}, {load}, {lse} and all three.
// qg (P, LQG) int32, init (P, W) float32 -> out (P, W) float32.
extern "C" int fu_pairhmm_ablate(const void* qg, const void* init, int P,
                                 int LQG, int Dmax, int W, int feats,
                                 void* out, void* stream) {
  const auto* q = static_cast<const int32_t*>(qg);
  const auto* i0 = static_cast<const float*>(init);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (W != 128) return cudaErrorInvalidValue;
  switch (feats) {
    case 0:
      return launch<false, false, false>(q, i0, P, LQG, Dmax, o, s);
    case kShift:
      return launch<true, false, false>(q, i0, P, LQG, Dmax, o, s);
    case kLoad:
      return launch<false, true, false>(q, i0, P, LQG, Dmax, o, s);
    case kLse:
      return launch<false, false, true>(q, i0, P, LQG, Dmax, o, s);
    case kShift | kLoad | kLse:
      return launch<true, true, true>(q, i0, P, LQG, Dmax, o, s);
    default:
      return cudaErrorInvalidValue;
  }
}
