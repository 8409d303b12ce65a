// Arrow splice forward and backward row sweeps for Hopper (sm_90a).
//
// arrow_sweep_kernel replaces the two lax.scan row sweeps of
// falcon_unzip_tpu/ops/arrow.py::arrow_splice_core (fstep, :154-176, and
// bstep, :185-210; XLA loops, not Pallas).  For every (read, template)
// pair it runs the 3-state log-space pair-HMM forward over rows
// i = 0..Lq and the backward over rows Lq..0, each row spanning the LJ
// template columns, and writes only what the splice assembly reads:
//   forward:  M, I, D at the <= C candidate columns     -> (P, C, R)
//   backward: BM, BD at the <= 3C columns cand + 0..2   -> (P, 3, C, R)
//             BM[0, 0], the pair's unmutated log-likelihood
// (R = Lq + 1).  Masks, logaddexp nesting, NEG = -1e30 and the per-base
// tier mode follow arrow.py:113-210 exactly: a forward row takes base
// i-1's tier (qt_m1), a backward row takes base i's tier for its M/I
// edges and base i-1's for the within-row D edges (tMD, tDD).
// logaddexp is max + log1p(exp(-|a - b|)), so NEG + NEG stays NEG.
//
//   Layout: grid (P, 2); block (p, 0) runs the forward sweep of pair p and
//   block (p, 1) its backward sweep, so a pair's score depends on no other
//   pair of the batch.  The block's 128 threads split the row into
//   contiguous chunks of cpt = ceil(LJ / 128) columns.  Rows live in
//   shared memory, double-buffered (row i reads row i-1 / i+1); the read,
//   template and tier ids are staged there as int8, and the (T, 10) tier
//   table (or the pair's 10 params) as floats.
//
//   The within-row D recurrence D[j] = lae(u[j], D[j-1] + tDD) (backward:
//   from j+1) is a linear scan in the log semiring with a constant decay
//   per row.  It replaces the Hillis-Steele ladder of _scan_lse_right /
//   _scan_lse_left (arrow.py:60-81): each thread scans its chunk
//   sequentially, the chunk totals are scanned across the warp with
//   shuffles (decay cpt * tDD per lane), the four warp totals are
//   combined through shared memory, and each thread folds the carry into
//   its chunk.  Rows past the read's end (i > n) are NEG in the reference;
//   the kernel writes NEG there without computing them.
//
//   What bounds it: the rows are a dependent chain (two or three block
//   barriers per row), so a block is latency-bound; throughput comes from
//   2P blocks in flight (P = 512 at production: 1024 blocks on 132 SMs).
//   The DP never leaves shared memory; device-memory traffic is the
//   inputs once and 3C + 6C floats per row.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPad = 4;  // seq.PAD: never matches

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// In-place inclusive log-semiring scan of the shared row x[0, LJ) with the
// constant decay c: x[j] = lae(u[j], x[j-1] + c), or from x[j+1] when
// kRev.  Thread t owns [t*cpt, t*cpt + cpt) clipped to LJ.  Afterwards
// columns outside [keep_lo, keep_hi] are set to NEG.  Ends with a block
// barrier.
template <bool kRev>
__device__ void block_scan(float* x, int LJ, int cpt, float c, int keep_lo,
                           int keep_hi, float* wtot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // positions in scan order
  const int lp = kRev ? 31 - lane : lane;
  const int wp = kRev ? kWarps - 1 - warp : warp;
  const int j0 = tid * cpt;
  float s = kNeg;
  for (int k = 0; k < cpt; ++k) {
    const int j = kRev ? j0 + cpt - 1 - k : j0 + k;
    if (j < LJ) {
      s = lae(x[j], s + c);
      x[j] = s;
    }
  }
  // chunk totals: inclusive scan over the warp, decay dc per chunk
  const float dc = static_cast<float>(cpt) * c;
  float X = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = kRev ? __shfl_down_sync(kFull, X, off)
                         : __shfl_up_sync(kFull, X, off);
    if (lp >= off) X = lae(X, y + static_cast<float>(off) * dc);
  }
  const float Xprev = kRev ? __shfl_down_sync(kFull, X, 1)
                           : __shfl_up_sync(kFull, X, 1);
  if (lp == 31) wtot[wp] = X;
  __syncthreads();
  float carry = kNeg;  // inclusive value at the end of the previous warp
  for (int w = 0; w < wp; ++w) carry = lae(wtot[w], carry + 32.0f * dc);
  // inclusive value at the end of the previous chunk
  const float E = lp == 0 ? carry
                          : lae(Xprev, carry + static_cast<float>(lp) * dc);
  for (int k = 0; k < cpt; ++k) {
    const int j = j0 + k;
    if (j >= LJ) break;
    const float dist = kRev ? static_cast<float>(cpt - k)
                            : static_cast<float>(k + 1);
    const float v = lae(x[j], E + dist * c);
    x[j] = (j >= keep_lo && j <= keep_hi) ? v : kNeg;
  }
  __syncthreads();
}

__device__ __forceinline__ const float* tier_row(const float* tp,
                                                 const int8_t* sqt, int idx,
                                                 int T) {
  if (sqt == nullptr) return tp;  // per-pair params
  int k = sqt[idx];
  k = k < 0 ? 0 : (k > T - 1 ? T - 1 : k);  // a gather clamps its index
  return tp + 10 * k;
}

__device__ void forward_sweep(float* rows, float* wtot, const float* tp,
                              const int8_t* sq, const int8_t* st,
                              const int8_t* sqt, int T, int n, int m,
                              int Lq, int LJ, int C, const int32_t* cand,
                              float* afM, float* afI, float* afD, int p) {
  const int tid = threadIdx.x;
  const int cpt = (LJ + kThreads - 1) / kThreads;
  const int j0 = tid * cpt;
  const int j1 = min(j0 + cpt, LJ);
  const int R = Lq + 1;
  float* Mp = rows;
  float* Ip = rows + LJ;
  float* Dp = rows + 2 * LJ;
  float* Mc = rows + 3 * LJ;
  float* Ic = rows + 4 * LJ;
  float* Dc = rows + 5 * LJ;
  for (int j = tid; j < LJ; j += kThreads) Mp[j] = Ip[j] = Dp[j] = kNeg;
  const int my_c = tid < C ? tid : -1;
  int col = 0;
  if (my_c >= 0) {
    col = cand[static_cast<size_t>(p) * C + my_c];
    col = col < 0 ? 0 : (col > LJ - 1 ? LJ - 1 : col);
  }
  __syncthreads();
  const int i_end = min(n, Lq);  // rows past n are NEG
  for (int i = 0; i <= i_end; ++i) {
    // every edge into row i consumes q[i-1]: base i-1's tier (clip 0)
    const float* pr = tier_row(tp, sqt, i == 0 ? 0 : i - 1, T);
    const float em_match = pr[0], em_mis = pr[1], em_ins = pr[2];
    const float tMM = pr[3], tMI = pr[4], tMD = pr[5];
    const float tIM = pr[6], tII = pr[7], tDM = pr[8], tDD = pr[9];
    const int qc = i >= 1 ? sq[i - 1] : kPad;
    for (int j = j0; j < j1; ++j) {
      const int tg = j >= 1 ? st[j - 1] : kPad;
      const float em = (qc == tg && qc < 4) ? em_match : em_mis;
      const float Md = j >= 1 ? Mp[j - 1] : kNeg;
      const float Id = j >= 1 ? Ip[j - 1] : kNeg;
      const float Dd = j >= 1 ? Dp[j - 1] : kNeg;
      const bool jm = j <= m;
      float M = em + lae(lae(Md + tMM, Id + tIM), Dd + tDM);
      M = (i >= 1 && j >= 1 && jm) ? M : kNeg;
      if (i == 0 && j == 0) M = 0.0f;
      float I = em_ins + lae(Mp[j] + tMI, Ip[j] + tII);
      I = (i >= 1 && jm) ? I : kNeg;
      Mc[j] = M;
      Ic[j] = I;
    }
    __syncthreads();
    for (int j = j0; j < j1; ++j)
      Dc[j] = (j >= 1 && j <= m) ? Mc[j - 1] + tMD : kNeg;
    block_scan<false>(Dc, LJ, cpt, tDD, 1, m, wtot);
    if (my_c >= 0) {
      const size_t o = (static_cast<size_t>(p) * C + my_c) * R + i;
      afM[o] = Mc[col];
      afI[o] = Ic[col];
      afD[o] = Dc[col];
    }
    float* x;
    x = Mp; Mp = Mc; Mc = x;
    x = Ip; Ip = Ic; Ic = x;
    x = Dp; Dp = Dc; Dc = x;
  }
  const int rest = R - 1 - i_end;
  for (int k = tid; k < C * rest; k += kThreads) {
    const size_t o = (static_cast<size_t>(p) * C + k / rest) * R +
                     (i_end + 1 + k % rest);
    afM[o] = afI[o] = afD[o] = kNeg;
  }
}

__device__ void backward_sweep(float* rows, float* wtot, const float* tp,
                               const int8_t* sq, const int8_t* st,
                               const int8_t* sqt, int T, int n, int m,
                               int Lq, int LJ, int C, const int32_t* cand,
                               float* bM, float* bD, float* ll_cur, int p) {
  const int tid = threadIdx.x;
  const int cpt = (LJ + kThreads - 1) / kThreads;
  const int j0 = tid * cpt;
  const int j1 = min(j0 + cpt, LJ);
  const int R = Lq + 1;
  float* BMp = rows;
  float* BIp = rows + LJ;
  float* BMc = rows + 2 * LJ;
  float* BIc = rows + 3 * LJ;
  float* BDc = rows + 4 * LJ;
  float* BDo = rows + 5 * LJ;
  float* GM = rows + 6 * LJ;
  float* GI = rows + 7 * LJ;
  for (int j = tid; j < LJ; j += kThreads) BMp[j] = BIp[j] = kNeg;
  // writer threads: slot (s, c) reads column clip(cand[c] + s)
  const int my_sc = tid < 3 * C ? tid : -1;
  int col = 0;
  if (my_sc >= 0) {
    col = cand[static_cast<size_t>(p) * C + my_sc % C] + my_sc / C;
    col = col < 0 ? 0 : (col > LJ - 1 ? LJ - 1 : col);
  }
  const int i_start = min(n, Lq);  // rows past n are NEG
  const int rest = R - 1 - i_start;
  for (int k = tid; k < 3 * C * rest; k += kThreads) {
    const size_t o = (static_cast<size_t>(p) * 3 * C + k / rest) * R +
                     (i_start + 1 + k % rest);
    bM[o] = bD[o] = kNeg;
  }
  __syncthreads();
  for (int i = i_start; i >= 0; --i) {
    // M/I edges out of row i consume q[i]; the within-row D edges
    // (tMD, tDD) stay on base i-1, mirroring the forward
    const float* pb = tier_row(tp, sqt, i, T);
    const float* pf = tier_row(tp, sqt, i == 0 ? 0 : i - 1, T);
    const float em_match = pb[0], em_mis = pb[1], em_ins = pb[2];
    const float tMM = pb[3], tMI = pb[4], tIM = pb[6], tII = pb[7];
    const float tDM = pb[8];
    const float tMD = pf[5], tDD = pf[9];
    const int qc = i < Lq ? sq[i] : kPad;
    const bool rin = i <= n - 1;
    for (int j = j0; j < j1; ++j) {
      const float emB = (qc == st[j] && qc < 4) ? em_match : em_mis;
      float gm = emB + (j + 1 < LJ ? BMp[j + 1] : kNeg);
      gm = (rin && j <= m - 1) ? gm : kNeg;
      float gi = em_ins + BIp[j];
      gi = (rin && j <= m) ? gi : kNeg;
      const float term = (i == n && j == m) ? 0.0f : kNeg;
      GM[j] = gm;
      GI[j] = gi;
      BDc[j] = lae(tDM + gm, term);
    }
    block_scan<true>(BDc, LJ, cpt, tDD, 0, m, wtot);
    for (int j = j0; j < j1; ++j) {
      const float gm = GM[j];
      const float gi = GI[j];
      const float term = (i == n && j == m) ? 0.0f : kNeg;
      const float bdn = j + 1 < LJ ? BDc[j + 1] : kNeg;
      const float BM =
          lae(lae(lae(tMM + gm, tMI + gi), tMD + bdn), term);
      const float BI = lae(lae(tIM + gm, tII + gi), term);
      const bool jm = j <= m;
      BMc[j] = jm ? BM : kNeg;
      BIc[j] = jm ? BI : kNeg;
    }
    __syncthreads();
    if (my_sc >= 0) {
      const size_t o = (static_cast<size_t>(p) * 3 * C + my_sc) * R + i;
      bM[o] = BMc[col];
      bD[o] = BDc[col];
    }
    if (i == 0 && tid == 0) ll_cur[p] = BMc[0];
    float* x;
    x = BMp; BMp = BMc; BMc = x;
    x = BIp; BIp = BIc; BIc = x;
    x = BDo; BDo = BDc; BDc = x;
  }
}

__global__ void __launch_bounds__(kThreads)
arrow_sweep_kernel(const int8_t* __restrict__ q,
                   const int8_t* __restrict__ t,
                   const int32_t* __restrict__ n_arr,
                   const int32_t* __restrict__ m_arr,
                   const int32_t* __restrict__ cand,
                   const float* __restrict__ pvec,
                   const int8_t* __restrict__ qt,
                   const float* __restrict__ tiers, int T, int Lq, int LJ,
                   int C, float* __restrict__ afM, float* __restrict__ afI,
                   float* __restrict__ afD, float* __restrict__ bM,
                   float* __restrict__ bD, float* __restrict__ ll_cur) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = Lq + 1;
  const bool tiered = qt != nullptr;
  const int np = tiered ? 10 * T : 10;
  float* rows = smem;                 // 8 rows of LJ floats
  float* wtot = rows + 8 * LJ;        // kWarps warp totals
  float* tp = wtot + kWarps;          // tier table or the pair's params
  int8_t* sq = reinterpret_cast<int8_t*>(tp + np);
  int8_t* st = sq + Lq;
  int8_t* sqt = tiered ? st + LJ : nullptr;
  for (int k = tid; k < np; k += kThreads)
    tp[k] = tiered ? tiers[k] : pvec[static_cast<size_t>(p) * 10 + k];
  for (int k = tid; k < Lq; k += kThreads)
    sq[k] = q[static_cast<size_t>(p) * Lq + k];
  for (int k = tid; k < LJ; k += kThreads)
    st[k] = t[static_cast<size_t>(p) * LJ + k];
  if (tiered)
    for (int k = tid; k < R; k += kThreads)
      sqt[k] = qt[static_cast<size_t>(p) * R + k];
  __syncthreads();
  const int n = n_arr[p];
  const int m = m_arr[p];
  if (blockIdx.y == 0)
    forward_sweep(rows, wtot, tp, sq, st, sqt, T, n, m, Lq, LJ, C, cand,
                  afM, afI, afD, p);
  else
    backward_sweep(rows, wtot, tp, sq, st, sqt, T, n, m, Lq, LJ, C, cand,
                   bM, bD, ll_cur, p);
}

}  // namespace

extern "C" int fu_arrow_sweeps(const void* q, const void* t, const void* n,
                               const void* m, const void* cand,
                               const void* pvec, const void* qt,
                               const void* tiers, int T, int P, int Lq,
                               int LJ, int C, void* afM, void* afI,
                               void* afD, void* bM, void* bD, void* ll_cur,
                               void* stream) {
  const int np = qt != nullptr ? 10 * T : 10;
  const size_t smem = (8 * static_cast<size_t>(LJ) + kWarps + np) *
                          sizeof(float) +
                      static_cast<size_t>(Lq) + LJ +
                      (qt != nullptr ? Lq + 1 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        arrow_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(P, 2);
  arrow_sweep_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
      static_cast<const int32_t*>(cand), static_cast<const float*>(pvec),
      static_cast<const int8_t*>(qt), static_cast<const float*>(tiers), T,
      Lq, LJ, C, static_cast<float*>(afM), static_cast<float*>(afI),
      static_cast<float*>(afD), static_cast<float*>(bM),
      static_cast<float*>(bD), static_cast<float*>(ll_cur));
  return static_cast<int>(cudaGetLastError());
}
