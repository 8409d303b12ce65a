// Ablation of the pair-HMM antidiagonal step for Hopper (sm_90a).
//
// pairhmm_ablate_kernel replaces the TPU diagnostic kernel
// scripts/ablate_pallas.py:17 (kern, launched by the pallas_call at :65):
// the antidiagonal step of the banded pair-HMM forward (csrc/pairhmm.cu)
// reduced to its three parts, each switched on or off at compile time so
// each can be timed alone:
//   SHIFT  the +-1 band shift: the d-1 and d-2 M planes shifted by one
//          cell (NEG at w = 0) when s1 = lo(d) - lo(d-1) is 0;
//   LOAD   the windowed base load qg[row, lo(d) + w] (what the TPU kernel
//          rolls out of a 128-aligned window of W + 128 columns) and the
//          emission chosen from it;
//   LSE    the step's logaddexps, M = em + lae(Md - 0.1, I2 - 3, D2 - 3),
//          I = lae(Mu - 3, I1 - 1.6), D = lae(M1 - 3, D1 - 1.6), lae the
//          log of the sum of the exps (the TPU kernel nests M's as two
//          two-term ones); with the bit off the same step in plain max.
// Every step folds M into out = max(out, M) and runs to d = Dmax - 1, so
// no step can be dropped.  out starts at NEG = -1e30 and the shift fills
// NEG, as in the TPU kernel; the six state planes start from the input
// plane init (P, W).  With init = NEG everywhere this is the TPU kernel,
// whose out is then NEG everywhere (NEG + small rounds back to NEG); a
// finite seeded init makes the shift, the window and the logaddexps each
// show in out, which is what the parity checks run at.
//
//   Layout: that of csrc/pairhmm.cu at W = 128, so that the sets' times
//   split what the forward's step pays.  One block a row, 4 warps, one
//   band cell a lane: lane w of the block holds cell w's M/I/D on the
//   antidiagonals d-1 and d-2 and its out in registers, so P = 256 rows
//   are 256 blocks over the card's 132 SMs.
//   * The band shifts are constants of each phase: s1 = 0 for every d <=
//     W (lo = 0), then s1 = d & 1, so from d = W + 1 on the loop runs two
//     steps at a time, the odd one without the shift and the even one
//     with it.
//   * The shift's exchange: after every step each cell hands its new M
//     to the cell above (w + 1), which keeps the last two it received as
//     its shifted M planes.  Within a warp one shuffle; across warps one
//     shared-memory word a warp, double-buffered by exchange parity, so
//     one barrier a step serves.  Lane 0 of warp 0 takes NEG.  The sets
//     without SHIFT have no cross-lane traffic and no barrier in the loop.
//   * The row of qg is copied into shared memory once (4 KB at LQG =
//     1024), in every set, as the TPU kernel's BlockSpec copies its block
//     into VMEM; LOAD reads row[lo + w]: consecutive words, no bank
//     conflict, and the compiler keeps the word in a register over the
//     steps where lo stands.  A base kept in a register and slid across
//     lanes where lo moves, as the forward does, would put a shuffle on
//     those steps for what one shared read does.
//   * The logaddexp is the forward's (logaddexp2.cuh): base 2 on the SFU
//     (ex2.approx, lg2.approx), M's three terms in one (7 SFU operations a
//     cell, not the nesting's 8), in log2 units: the lse sets scale the
//     start and the step's constants by log2(e) as they are read and out
//     by ln(2) as it is stored, so that their chain is the forward's.  NEG
//     stays NEG exactly: scaled it stays below -1e29, NEG + lg2(3) rounds
//     to NEG, and to_ln maps out back to NEG.  The sets without the
//     logaddexps keep natural units (a scale of 1) and are bit-exact.
//   * out stays in a register and is stored once, coalesced.
//
//   What bounds it (scripts/ablate_pairhmm.py on an NVIDIA H100 80GB HBM3
//   at 700 W, P = 256, Dmax 1025; no profiler): with the logaddexps the
//   SFU, 7 operations a cell at 16 a clock an SM: 0.056 ms over 132 SMs
//   (0.058 as 256 blocks fall, two an SM on 124).  lse runs at
//   0.0721-0.0722 ms (1.28x that floor), all three parts at 0.0915-0.0916
//   (1.63x); the rest is the exchange's shuffle, shared word and barrier
//   on the step's chain (the shift set alone 0.0341, ~38 cycles a step
//   over the 0.0145 of the bare loop) and the window (load 0.0216).
//
//   Measured (ms for none / shift / load / lse / all, NEG and seeded
//   starts alike), each step against the parent in the same call (PR 2's
//   layout: a warp a row, four rows a block, four cells a lane, run-time
//   shifts, expf/log1pf: 0.0220 / 0.0436-0.0439 / 0.0519-0.0523 /
//   0.799-0.805 / 1.039-1.047): a block a row with the phase shifts and
//   one exchange a step, expf/log1pf: 0.0148 / 0.0345 / 0.0219 / 0.2173 /
//   0.2579, exact to the plain version at the probe; the base-2
//   logaddexp, M's three terms in one, first in natural-log units with
//   the scale inside (its own copy of the logaddexp): lse 0.0729-0.0737,
//   all 0.0893-0.0901; then the forward's log2 units (logaddexp2.cuh),
//   against that in the same call: lse 0.0721-0.0722 (0.0730), all
//   0.0915-0.0916 (0.0893-0.0894), kept so that the lse sets time the
//   forward's chain.  Dropped: two values and one barrier every second step
//   in the steady phase (M of d-1 and d-2 handed on together before the
//   even step: shift 0.0383, all 0.2683 with expf/log1pf, 0.0941 in base
//   2), since the value of d-2 then crosses on the chain beside that of
//   d-1 instead of a step early and the barriers saved buy nothing; the
//   base-2 logaddexp in the TPU kernel's nesting (8 SFU operations a
//   cell: lse 0.0831, all 0.1093-0.1112, 7.4e-7 relative at the probe).
//
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "logaddexp2.cuh"

namespace {

constexpr int kW = 128;            // the band of the TPU script
constexpr int kWarps = kW / 32;    // one cell a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kShift = 1, kLoad = 2, kLse = 4;
template <bool SHIFT, bool LOAD, bool LSE>
__global__ void __launch_bounds__(kW)
pairhmm_ablate_kernel(const int32_t* __restrict__ qg,
                      const float* __restrict__ init, int LQG, int Dmax,
                      float* __restrict__ out) {
  extern __shared__ int32_t row[];     // the block's row of qg
  __shared__ float s_edge[2][kWarps];  // lane 31's new M, by parity
  const int w = threadIdx.x;
  const int lane = w & 31;
  const int warp = w >> 5;
  const int32_t* src = qg + static_cast<size_t>(blockIdx.x) * LQG;
  for (int k = w; k < LQG; k += kW) row[k] = src[k];

  // the sets with the logaddexps carry log2 units, as the forward does:
  // the start and the step's constants scaled by log2(e) as they are read,
  // out by ln(2) as it is stored; the others natural units (kS = 1)
  constexpr float kS = LSE ? kLog2e : 1.0f;
  const float* seed = init + static_cast<size_t>(blockIdx.x) * kW;
  float M1 = seed[w] * kS, I1 = M1, D1 = M1, M2 = M1, I2 = M1, D2 = M1;
  // the shifted M planes, M[w - 1] on d-1 and d-2 (NEG at w = 0)
  float uM1 = w > 0 ? seed[w - 1] * kS : kNeg;
  float uM2 = uM1;
  float acc = kNeg;
  __syncthreads();

  int par = 0;
  // hand the step's M to the cell above: uM2 <- uM1 <- M[w - 1]
  auto exchange = [&]() {
    float u = __shfl_up_sync(kFull, M1, 1);
    if (lane == 31) s_edge[par][warp] = M1;
    __syncthreads();
    if (lane == 0) u = warp > 0 ? s_edge[par][warp - 1] : kNeg;
    uM2 = uM1;
    uM1 = u;
    par ^= 1;
  };
  // one antidiagonal at band offset lo, shifted if S (a phase constant)
  auto step = [&](int lo, auto s_tag) {
    constexpr bool S = SHIFT && decltype(s_tag)::value;
    const float Md = S ? uM2 : M2;
    const float Mu = S ? uM1 : M1;
    float em = -0.1f * kS;
    if (LOAD) em = row[lo + w] < 4 ? -0.1f * kS : -3.0f * kS;
    float M, I, D;
    if (LSE) {
      M = em + lae3(Md - 0.1f * kS, I2 - 3.0f * kS, D2 - 3.0f * kS);
      I = lae(Mu - 3.0f * kS, I1 - 1.6f * kS);
      D = lae(M1 - 3.0f * kS, D1 - 1.6f * kS);
    } else {
      M = em + fmaxf(fmaxf(Md, I2), D2);
      I = fmaxf(Mu, I1);
      D = fmaxf(M1, D1);
    }
    acc = fmaxf(acc, M);
    M2 = M1;
    I2 = I1;
    D2 = D1;
    M1 = M;
    I1 = I;
    D1 = D;
    if (SHIFT) exchange();
  };

  using Shift = std::true_type;
  using Keep = std::false_type;
  // the prologue: lo = 0 and s1 = 0 up to d = W
  int d = 0;
  for (; d <= min(kW, Dmax - 1); ++d) step(0, Shift{});
  // from d = W + 1 (odd): s1 = 1 on the odd step, 0 on the even one
  for (; d + 1 < Dmax; d += 2) {
    const int lo = (d + 1) / 2 - kW / 2;
    step(lo, Keep{});
    step(lo, Shift{});
  }
  if (d < Dmax) step((d + 1) / 2 - kW / 2, Keep{});

  out[static_cast<size_t>(blockIdx.x) * kW + w] = LSE ? to_ln(acc) : acc;
}

template <bool SHIFT, bool LOAD, bool LSE>
cudaError_t launch(const int32_t* qg, const float* init, int P, int LQG,
                   int Dmax, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * LQG;
  auto* kern = pairhmm_ablate_kernel<SHIFT, LOAD, LSE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<P, kW, smem, stream>>>(qg, init, LQG, Dmax, out);
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
  if (W != kW) return cudaErrorInvalidValue;
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
