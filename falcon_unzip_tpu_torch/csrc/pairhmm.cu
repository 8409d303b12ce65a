// Banded pair-HMM forward for Hopper (sm_90a).
//
// pairhmm_forward_kernel replaces the TPU kernel
// falcon_unzip_tpu/ops/pallas_pairhmm.py::_kernel (launched by
// _pallas_forward).  It computes the same banded 3-state M/I/D log-space
// forward as falcon_unzip_tpu/ops/pairhmm.py::forward_core: the band
// schedule lo(d) = max(0, (d+1)/2 - W/2) of the edit-distance wavefront,
// float32 state, NEG = -1e30 for "no path", the reference's logaddexp
// nesting
//   M = em + lae(lae(Md + tMM, Id + tIM), Dd + tDM)
//   I = em_ins + lae(Mu + tMI, Iu + tII)
//   D = lae(Ml + tMD, Dl + tDD)
// and its masks (valid, origin, can_m/i/d).  The (n, m) corner's M, I
// and D are captured with selects on the antidiagonal d = n + m and
// combined once after the loop, then reduced over the band with a max,
// as pallas_pairhmm.py:154-157,182-183 do.  logaddexp is written
// max + log1p(exp(-|a - b|)), so NEG + NEG stays NEG.
//
//   Layout: one warp per (read, template) pair; lane L holds the C = W/32
//   contiguous band cells w = L*C .. L*C + C-1 of antidiagonals d-1 and
//   d-2 for each of M, I and D in registers.  The +-1 band shift (lo(d) -
//   lo(d-1) in {0, 1}) crosses lanes with one __shfl_up_sync /
//   __shfl_down_sync of the edge cell, NEG-filled at w = 0 and w = W-1.
//   Bases are int8 guarded rows from prepare_batch (every read lies
//   inside LQG / LTG; the wrapper checks the bounds) and stay in L1.  The
//   ten log-params are by-value arguments.  The loop stops at d = n + m:
//   nothing after the corner is read.
//
//   What bounds it: each antidiagonal depends on the two before it, so a
//   pair is latency-bound on its chain of three logaddexps (exp + log1p
//   on the SFU) and shuffles; throughput comes from many pairs (warps) in
//   flight.  The state never leaves registers; device-memory traffic is
//   the base reads and one float per pair.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

struct HmmParams {
  float em_match, em_mis, em_ins, tMM, tMI, tMD, tIM, tII, tDM, tDD;
};

__device__ __forceinline__ int band_lo(int d, int W) {
  const int x = (d + 1) / 2 - W / 2;
  return x > 0 ? x : 0;
}

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pairhmm_forward_kernel(const int8_t* __restrict__ qg,
                       const int8_t* __restrict__ trg,
                       const int32_t* __restrict__ n_arr,
                       const int32_t* __restrict__ m_arr, int P, int LQG,
                       int LTG, int Lt, int G, int Dmax, HmmParams hp,
                       float* __restrict__ ll) {
  constexpr int W = 32 * C;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // whole warp leaves together
  const int n = n_arr[p];
  const int m = m_arr[p];
  const int8_t* q = qg + static_cast<size_t>(p) * LQG;
  const int8_t* t = trg + static_cast<size_t>(p) * LTG;
  const int w0 = lane * C;

  float M1[C], I1[C], D1[C], M2[C], I2[C], D2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    M1[c] = I1[c] = D1[c] = kNeg;
    M2[c] = I2[c] = D2[c] = kNeg;
  }
  // corner (n, m) state, captured on d == n + m
  float cM = kNeg, cI = kNeg, cD = kNeg;

  const int d_end = min(Dmax - 1, n + m);
  for (int d = 0; d <= d_end; ++d) {
    const int lo = band_lo(d, W);
    const int s1 = lo - band_lo(d - 1, W);
    const int s2 = lo - band_lo(d - 2, W);
    float m1_prev = __shfl_up_sync(kFull, M1[C - 1], 1);
    float i1_prev = __shfl_up_sync(kFull, I1[C - 1], 1);
    float m1_next = __shfl_down_sync(kFull, M1[0], 1);
    float d1_next = __shfl_down_sync(kFull, D1[0], 1);
    float m2_prev = __shfl_up_sync(kFull, M2[C - 1], 1);
    float i2_prev = __shfl_up_sync(kFull, I2[C - 1], 1);
    float d2_prev = __shfl_up_sync(kFull, D2[C - 1], 1);
    if (lane == 0) {
      m1_prev = i1_prev = kNeg;
      m2_prev = i2_prev = d2_prev = kNeg;
    }
    if (lane == 31) m1_next = d1_next = kNeg;
    const int8_t* qrow = q + lo + w0;
    const int8_t* trow = t + (G + Lt - d + lo + w0);
    const bool hit = d == n + m;  // warp-uniform
    float M[C], I[C], D[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // d-1 cell w-1 / w+1 and d-2 cell w-1 (NEG past the band's ends)
      const float m1m = c == 0 ? m1_prev : M1[c - 1];
      const float i1m = c == 0 ? i1_prev : I1[c - 1];
      const float m1p = c == C - 1 ? m1_next : M1[c + 1];
      const float d1p = c == C - 1 ? d1_next : D1[c + 1];
      const float m2m = c == 0 ? m2_prev : M2[c - 1];
      const float i2m = c == 0 ? i2_prev : I2[c - 1];
      const float d2m = c == 0 ? d2_prev : D2[c - 1];
      // up (i-1, j): d-1 at w + s1 - 1; left (i, j-1): d-1 at w + s1;
      // diag (i-1, j-1): d-2 at w + s2 - 1
      const float Mu = s1 == 0 ? m1m : M1[c];
      const float Iu = s1 == 0 ? i1m : I1[c];
      const float Ml = s1 == 0 ? M1[c] : m1p;
      const float Dl = s1 == 0 ? D1[c] : d1p;
      const float Md = s2 == 0 ? m2m : M2[c];
      const float Id = s2 == 0 ? i2m : I2[c];
      const float Dd = s2 == 0 ? d2m : D2[c];
      const int i = lo + w0 + c;
      const int j = d - i;
      const int qi = __ldg(qrow + c);
      const int tj = __ldg(trow + c);
      const float em = (qi == tj && qi < 4) ? hp.em_match : hp.em_mis;
      float vm = em + lae(lae(Md + hp.tMM, Id + hp.tIM), Dd + hp.tDM);
      float vi = hp.em_ins + lae(Mu + hp.tMI, Iu + hp.tII);
      float vd = lae(Ml + hp.tMD, Dl + hp.tDD);
      const bool valid = i >= 0 && i <= n && j >= 0 && j <= m;
      vm = (valid && i >= 1 && j >= 1) ? vm : kNeg;
      if (i == 0 && j == 0) vm = 0.0f;
      vi = (valid && i >= 1) ? vi : kNeg;
      vd = (valid && j >= 1) ? vd : kNeg;
      if (hit && valid && i == n) {  // j == m follows from d == n + m
        cM = vm;
        cI = vi;
        cD = vd;
      }
      M[c] = vm;
      I[c] = vi;
      D[c] = vd;
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

  // combine the captured corner once; cells that never held it are NEG
  float v = lae(lae(cM, cI), cD);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) ll[p] = v;
}

template <int C>
cudaError_t launch_forward(const int8_t* qg, const int8_t* trg,
                           const int32_t* n, const int32_t* m, int P,
                           int LQG, int LTG, int Lt, int G, int Dmax,
                           const HmmParams& hp, float* ll,
                           cudaStream_t stream) {
  const dim3 grid((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  pairhmm_forward_kernel<C><<<grid, block, 0, stream>>>(
      qg, trg, n, m, P, LQG, LTG, Lt, G, Dmax, hp, ll);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fu_pairhmm_forward(const void* qg, const void* trg,
                                  const void* n, const void* m, int P,
                                  int LQG, int LTG, int Lt, int G, int Dmax,
                                  int W, float em_match, float em_mis,
                                  float em_ins, float tMM, float tMI,
                                  float tMD, float tIM, float tII, float tDM,
                                  float tDD, void* ll, void* stream) {
  const HmmParams hp{em_match, em_mis, em_ins, tMM, tMI,
                     tMD,      tIM,    tII,    tDM, tDD};
  const auto* q8 = static_cast<const int8_t*>(qg);
  const auto* t8 = static_cast<const int8_t*>(trg);
  const auto* n32 = static_cast<const int32_t*>(n);
  const auto* m32 = static_cast<const int32_t*>(m);
  auto* out = static_cast<float*>(ll);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 32:
      return launch_forward<1>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                               hp, out, s);
    case 64:
      return launch_forward<2>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                               hp, out, s);
    case 128:
      return launch_forward<4>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                               hp, out, s);
    case 256:
      return launch_forward<8>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                               hp, out, s);
    case 512:
      return launch_forward<16>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                                hp, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
