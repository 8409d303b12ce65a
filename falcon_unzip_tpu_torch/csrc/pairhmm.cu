// Banded pair-HMM forward for Hopper (sm_90a).
//
// pairhmm_forward_kernel replaces the TPU kernel
// falcon_unzip_tpu/ops/pallas_pairhmm.py:41 (_kernel, launched by the
// pallas_call of _pallas_forward, :201).  It computes the same banded
// 3-state M/I/D log-space forward as falcon_unzip_tpu/ops/pairhmm.py::
// forward_core: the band schedule lo(d) = max(0, (d+1)/2 - W/2) of the
// edit-distance wavefront, float32 state, NEG = -1e30 for "no path", the
// reference's recurrence
//   M = em + lae(lae(Md + tMM, Id + tIM), Dd + tDM)
//   I = em_ins + lae(Mu + tMI, Iu + tII)
//   D = lae(Ml + tMD, Dl + tDD)
// (d: the cell (i-1, j-1), u: (i-1, j), l: (i, j-1)), its masks (valid,
// origin, i >= 1, j >= 1), the result lae(lae(M, I), D) at the (n, m)
// corner, and exactly NEG where the corner leaves the band or lies past
// Dmax - 1.
//
//   Layout: one block a pair, NW warps, C = W / (32 NW) neighbouring band
//   cells a lane, the pair's values on antidiagonal d-1 in registers.  C
//   is chosen by the launch: W = 128 takes one cell a lane (4 warps) while
//   the batch fits three blocks an SM, else two (2 warps); W = 32 one, W =
//   64, 256 and 512 two (1, 4 and 8 warps).  The guarded rows are staged in
//   shared memory once (ACGT kept, every other code mapped to one that
//   never matches), unless they are too long, and each lane keeps its
//   cells' two bases in registers: one of the two windows slides by one
//   base a step.
//   * Push, not pull: each of I, D and M has exactly one predecessor cell
//     ((i-1, j), (i, j-1), (i-1, j-1)), so a cell computes from its own
//     values the I of the cell below, the D of the cell to its right and
//     the logaddexp part of the M diagonally below, and hands them on.  The
//     same operations on the same values as the pull form; but only one
//     value a step crosses to a neighbour lane in the band's steady state
//     (I up or D down), after the logaddexp instead of before it.
//   * The band shifts are constants of each phase: s1 = lo(d) - lo(d-1)
//     and s2 = lo(d) - lo(d-2) are (0, 0) up to d = W (lo = 0) and
//     (d & 1, 1) from d = W + 1 on.  Within a warp a shift is one shuffle;
//     across warps one shared-memory word a warp and step, double-buffered
//     by step parity, with one barrier a step.
//   * No masks from d = W + 2 on (the steady phase, two steps at a time).
//     There every band cell has i >= lo(d) >= 1 and j >= d/2 - W/2 + 1 >=
//     1, so the origin, row-0 and column-0 masks are false.  The valid
//     mask (i <= n, j <= m) is not needed either: a cell past row n or
//     column m never feeds the (n, m) corner, since M reads (i-1, j-1), I
//     (i-1, j) and D (i, j-1), all with i' <= i and j' <= j; such cells
//     feed only cells that are themselves past row n or column m.  Their
//     values are sums of log-params and logaddexps of such sums over the
//     guard bases, finite and bounded by the pair's length, so nothing
//     overflows.  The corner therefore comes out of the same operations on
//     the same inputs with or without those masks.
//   * The logaddexp works in base 2 on the SFU (ex2.approx, lg2.approx;
//     logaddexp2.cuh): the params are scaled by log2(e) as they are read
//     and the result by ln(2) as it is stored; M's three terms in one max
//     + lg2(1 + ex2 + ex2), 7 SFU operations a cell.  Against the plain
//     version (natural log, expf/log1pf) the log-likelihoods stay within
//     1.8e-5 relative.
//   * Each block stops at its own pair's d = min(Dmax - 1, n + m); the
//     corner is read once after the loop, from the lane holding w = n -
//     lo(n + m).
//   * Any band width W from 1 to 4096, as the JAX package runs any W.
//     14 layouts are built, exact (pairhmm_forward_kernel, the layout's
//     width a constant) and ragged (pairhmm_forward_ragged_kernel, W at
//     run time): 32 (1 cell a lane), 64 to 1024 by 128 steps from 128 on
//     (2 cells, 1 to 16 warps; 128 also 1 cell), 1536 / 2048 / 3072 /
//     4096 (3 / 4 / 6 / 8 cells, 16 warps).  A W that is no layout's
//     width runs on the narrowest wider one: the cells w >= W are held at
//     NEG on every step (a read past the band's top is NEG, as in the TPU
//     kernel), their lanes' base reads are clamped into the rows, and the
//     phases start where W's schedule puts them (lo depends on W / 2: an
//     odd W has the phases of W - 1).  The exact kernels keep their
//     earlier signature: with the band width as one more argument of a
//     shared kernel the old widths ran 2-5% slower (scripts/
//     tune_pairhmm.py, parent and change in turns in one call).
//
//   What bounds it (scripts/tune_pairhmm.py on an NVIDIA H100 80GB HBM3 at
//   700 W, 512-base windows, n + m ~ 900; no profiler): for a lone pair
//   the chain of a step, once the card is full the SFU.  A step's chain is
//   the handed-on logaddexp (two dependent MUFU operations and ~6 FP32
//   ones), a shuffle and a shared word, the barrier and the next step's
//   add: ~190 cycles, 0.094 ms at W = 128 and P = 16, nearly flat to P =
//   256 (0.106 ms, 2.2x the SFU floor of 0.049 ms).  A full card runs near
//   the SFU floor (7 MUFU operations a cell at 16 a clock an SM): 0.962 ms
//   against 0.790 at P = 4096.  The SASS of a steady step at one cell a
//   lane is ~70 instructions, 7 of them MUFU.
//
//   Measured at W = 128, P = 16 / 256 / 4096 (ms), each step against the
//   earlier kernel in the same call (a warp a pair, four pairs a block, C
//   = W/32 cells a lane, run-time shifts, per-cell loads, masks and corner
//   tests on every step, expf/log1pf: 1.357-1.368 / 1.373-1.384 /
//   4.03-4.04): a block a pair, values pushed, masks on every step,
//   expf/log1pf: 0.363-0.366 / 0.394-0.397 / 3.04-3.07; no masks in the
//   steady phase: 0.306-0.309 / 0.336-0.339 / 2.80-2.82 (both exact to the
//   plain version); the base-2 logaddexp: 0.094-0.098 / 0.110-0.116 /
//   1.10; the cells a lane chosen by P and the edge words indexed directly
//   (no shared window base rebuilt in the loop): 0.094-0.097 / 0.106-0.108
//   / 0.962-0.971.  The shared-memory stage of the rows, against reading
//   them from device memory in every build: at P = 16 0.084-0.086 /
//   0.092-0.093 / 0.125 against 0.101-0.104 / 0.122 / 0.139-0.141 (W = 64
//   / 128 / 256), at P = 4096 0.482 / 0.960-0.962 / 1.890-1.895 against
//   0.496 / 1.029-1.030 / 1.982-1.986, at the re-forward polish's launch
//   (P = 7095, W = 128) 1.696-1.697 against 1.801-1.802.  W = 128's cells a
//   lane, at k blocks an SM: a block of 4 warps puts one warp on each of
//   the SM's 4 schedulers, blocks of 2 warps pair up, so a scheduler runs
//   k one-cell warps or ceil(k / 2) two-cell ones.  One cell wins at k <=
//   3 (P = 256 / 384: 0.104 / 0.137 against 0.114 / 0.159), two at k = 4
//   (P = 448 / 528: 0.158 / 0.159 against 0.171 / 0.172) and at k >= 6 (P
//   = 768 / 1024 / 4096: 0.222 / 0.276 / 0.970 against 0.244 / 0.295 /
//   1.039); at k = 5 one cell is 6% faster (P = 640: 0.209 against 0.222)
//   and the launch takes two all the same.  Dropped: one cell a lane at W
//   = 64 (0.093 / 0.097 / 0.582 against two cells' 0.085-0.091 /
//   0.082-0.086 / 0.490) and at W = 256 (0.126 / 0.185 / 2.21 against 0.116
//   / 0.160 / 1.92); a warp a pair, four cells a lane at W = 128 (0.169 /
//   0.171 / 0.983) and eight at W = 256 (0.441 / 0.368 / 1.94); at W = 512
//   one cell (16 warps) or four (4 warps) a lane (0.336 and 0.368 against
//   0.329 ms at P = 256; four cells 3% faster at P = 4096 only, 4.26
//   against 4.39).
//
// The C entry points launch on the given stream and return
// cudaGetLastError(), or report the cells a lane a launch takes.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "logaddexp2.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageLimit = 96 * 1024;  // rows longer than this stay global

struct HmmParams {
  float em_match, em_mis, em_ins, tMM, tMI, tMD, tIM, tII, tDM, tDD;
};

__device__ __forceinline__ int band_lo(int d, int W) {
  const int x = (d + 1) / 2 - W / 2;
  return x > 0 ? x : 0;
}

// A base for the match test: A C G T stay, every other code becomes
// `other` (0xff in the query, 0xfe in the target: they never match).
__device__ __forceinline__ int base_code(int b, int other) {
  return (b & 0xff) > 3 ? other : (b & 0xff);
}

// C cells a lane, NW warps a pair: the layout's width is 32 C NW.  The
// band is that wide, or with kRagged W_run <= 32 C NW wide: then the cells
// w >= W are held at NEG on every step (a read past the band's top is NEG,
// as in the TPU kernel), their lanes' base reads are clamped into the rows,
// and the phases start where W's own schedule puts them.
template <int C, int NW, bool kStaged, bool kRagged>
__device__ __forceinline__ void pairhmm_forward_body(
    const int8_t* __restrict__ qg, const int8_t* __restrict__ trg,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int LQG, int LTG, int Lt, int G, int Dmax, int W_run, HmmParams hp_ln,
    float* __restrict__ ll) {
  constexpr int WP = 32 * C * NW;
  const int W = kRagged ? W_run : WP;
  // lo(d) depends on W / 2 only: an odd W has the schedule of W - 1
  const int W_even = kRagged ? W & ~1 : WP;
  constexpr int T = 32 * NW;
  extern __shared__ uint8_t s_rows[];
  // a warp's values for its neighbours, by step parity: I and M going up
  // (from lane 31), D going down (from lane 0)
  __shared__ float s_edge[2][NW][3];

  // the params in log2 units
  const HmmParams hp{hp_ln.em_match * kLog2e, hp_ln.em_mis * kLog2e,
                     hp_ln.em_ins * kLog2e,   hp_ln.tMM * kLog2e,
                     hp_ln.tMI * kLog2e,      hp_ln.tMD * kLog2e,
                     hp_ln.tIM * kLog2e,      hp_ln.tII * kLog2e,
                     hp_ln.tDM * kLog2e,      hp_ln.tDD * kLog2e};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.x;
  const int n = n_arr[p];
  const int m = m_arr[p];
  const int8_t* gq = qg + static_cast<size_t>(p) * LQG;
  const int8_t* gt = trg + static_cast<size_t>(p) * LTG;
  uint8_t* sq = s_rows;
  uint8_t* st = s_rows + ((LQG + 15) & ~15);
  if (kStaged) {
    for (int k = tid; k < LQG; k += T) sq[k] = base_code(gq[k], 0xff);
    for (int k = tid; k < LTG; k += T) st[k] = base_code(gt[k], 0xfe);
    __syncthreads();
  }
  auto qbase = [&](int k) -> int {
    if (kRagged) k = min(k, LQG - 1);
    return kStaged ? sq[k] : base_code(__ldg(gq + k), 0xff);
  };
  auto tbase = [&](int k) -> int {
    if (kRagged) k = min(max(k, 0), LTG - 1);
    return kStaged ? st[k] : base_code(__ldg(gt + k), 0xfe);
  };

  const int w0 = tid * C;         // band index of the lane's first cell
  const int t_top = G + Lt;       // target index of band cell 0 at d = 0
  const int d_end = min(Dmax - 1, n + m);

  float M[C], I[C], D[C];         // antidiagonal d-1 (start: all NEG)
  float Md[C];                    // M's logaddexp part for d, from d-2
  int qb[C], tb[C];               // the cells' bases (tb: d-1's window)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    M[c] = I[c] = D[c] = Md[c] = kNeg;
    qb[c] = qbase(w0 + c);
    // the window of "d = -1" one to the right: tb[c] = t at d = 0 for c >= 1
    tb[c] = c + 1 < C ? tbase(t_top + w0 + c + 1) : 0;
  }

  const int wu = warp > 0 ? warp - 1 : 0;        // the neighbour warps
  const int wd = warp < NW - 1 ? warp + 1 : 0;
  // One antidiagonal d (of parity par) with shifts s1 = lo(d) - lo(d-1)
  // and s2 of d + 1 (where the M part handed on now lands), masks if MASK.
  auto step = [&](int d, int par, int lo, auto s1_tag, auto s2n_tag,
                  auto mask_tag) {
    constexpr int S1 = decltype(s1_tag)::value;
    constexpr int S2N = decltype(s2n_tag)::value;
    constexpr bool MASK = decltype(mask_tag)::value;
    float Io[C], Do[C], Mo[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Io[c] = hp.em_ins + lae(M[c] + hp.tMI, I[c] + hp.tII);
      Do[c] = lae(M[c] + hp.tMD, D[c] + hp.tDD);
      Mo[c] = lae3(M[c] + hp.tMM, I[c] + hp.tIM, D[c] + hp.tDM);
    }
    // the neighbour lanes' values: I (s1 = 0) and M (s2 = 0) from the cell
    // below in band order, D (s1 = 1) from the cell above
    float uI = 0.0f, uM = 0.0f, dD = 0.0f;
    if (S1 == 0) {
      uI = __shfl_up_sync(kFull, Io[C - 1], 1);
      if (NW > 1 && lane == 31) s_edge[par][warp][0] = Io[C - 1];
    } else {
      dD = __shfl_down_sync(kFull, Do[0], 1);
      if (NW > 1 && lane == 0) s_edge[par][warp][2] = Do[0];
    }
    if (S2N == 0) {
      uM = __shfl_up_sync(kFull, Mo[C - 1], 1);
      if (NW > 1 && lane == 31) s_edge[par][warp][1] = Mo[C - 1];
    }
    if (NW > 1) __syncthreads();
    if (S1 == 0 && lane == 0) uI = warp > 0 ? s_edge[par][wu][0] : kNeg;
    if (S2N == 0 && lane == 0) uM = warp > 0 ? s_edge[par][wu][1] : kNeg;
    if (S1 == 1 && lane == 31) dD = warp < NW - 1 ? s_edge[par][wd][2] : kNeg;
    // the bases of d: the query window slides when lo grows, else the
    // target's
    if (S1 == 1) {
#pragma unroll
      for (int c = 0; c + 1 < C; ++c) qb[c] = qb[c + 1];
      qb[C - 1] = qbase(lo + w0 + C - 1);
    } else {
#pragma unroll
      for (int c = C - 1; c > 0; --c) tb[c] = tb[c - 1];
      tb[0] = tbase(t_top - d + lo + w0);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float em = qb[c] == tb[c] ? hp.em_match : hp.em_mis;
      float vm = em + Md[c];
      float vi = S1 == 0 ? (c == 0 ? uI : Io[c - 1]) : Io[c];
      float vd = S1 == 0 ? Do[c] : (c == C - 1 ? dD : Do[c + 1]);
      if (MASK) {
        const int i = lo + w0 + c;
        const int j = d - i;
        const bool valid = i <= n && j >= 0 && j <= m;
        vm = (valid && i >= 1 && j >= 1) ? vm
                                         : (i == 0 && j == 0 ? 0.0f : kNeg);
        vi = (valid && i >= 1) ? vi : kNeg;
        vd = (valid && j >= 1) ? vd : kNeg;
      }
      if (kRagged && w0 + c >= W) vm = vi = vd = kNeg;
      M[c] = vm;
      I[c] = vi;
      D[c] = vd;
      Md[c] = S2N == 0 ? (c == 0 ? uM : Mo[c - 1]) : Mo[c];
    }
  };

  using Z = std::integral_constant<int, 0>;
  using O = std::integral_constant<int, 1>;
  using Masked = std::true_type;
  using Unmasked = std::false_type;
  // the prologue (lo = 0 up to d = W, then d = W + 1; W_even for W), masked
  int d = 0;
  for (; d <= min(d_end, W_even - 1); ++d)
    step(d, d & 1, 0, Z{}, Z{}, Masked{});
  if (d <= d_end) step(d++, 0, 0, Z{}, O{}, Masked{});      // d = W
  if (d <= d_end) step(d++, 1, 1, O{}, O{}, Masked{});      // d = W + 1
  // the steady phase from d = W + 2 (even), two steps at a time, unmasked
  for (; d + 1 <= d_end; d += 2) {
    const int lo = (d + 1) / 2 - W / 2;
    step(d, 0, lo, Z{}, O{}, Unmasked{});
    step(d + 1, 1, lo + 1, O{}, O{}, Unmasked{});
  }
  if (d <= d_end) step(d, 0, (d + 1) / 2 - W / 2, Z{}, O{}, Unmasked{});

  // the corner (n, m), once: lae(lae(M, I), D) of the lane holding it, in
  // natural-log units (NEG stays NEG)
  const int wc = n - band_lo(d_end, W);
  const bool hit = d_end == n + m && wc >= 0 && wc < W;
  float v = kNeg;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (w0 + c == wc) v = lae(lae(M[c], I[c]), D[c]);
  if (tid == (hit ? wc / C : 0)) ll[p] = hit ? to_ln(v) : kNeg;
}

// The layout exactly 32 C NW wide.
template <int C, int NW, bool kStaged>
__global__ void __launch_bounds__(32 * NW)
pairhmm_forward_kernel(const int8_t* __restrict__ qg,
                       const int8_t* __restrict__ trg,
                       const int32_t* __restrict__ n_arr,
                       const int32_t* __restrict__ m_arr, int LQG, int LTG,
                       int Lt, int G, int Dmax, HmmParams hp_ln,
                       float* __restrict__ ll) {
  pairhmm_forward_body<C, NW, kStaged, false>(qg, trg, n_arr, m_arr, LQG,
                                              LTG, Lt, G, Dmax, 32 * C * NW,
                                              hp_ln, ll);
}

// Its ragged build: a band W <= 32 C NW wide.
template <int C, int NW, bool kStaged>
__global__ void __launch_bounds__(32 * NW)
pairhmm_forward_ragged_kernel(const int8_t* __restrict__ qg,
                              const int8_t* __restrict__ trg,
                              const int32_t* __restrict__ n_arr,
                              const int32_t* __restrict__ m_arr, int LQG,
                              int LTG, int Lt, int G, int Dmax, int W,
                              HmmParams hp_ln, float* __restrict__ ll) {
  pairhmm_forward_body<C, NW, kStaged, true>(qg, trg, n_arr, m_arr, LQG, LTG,
                                             Lt, G, Dmax, W, hp_ln, ll);
}

// One launch of the staged or unstaged build, exact or ragged; smem: the
// staged rows' bytes (0 unstaged).
template <int C, int NW, bool kStaged, bool kRagged>
cudaError_t launch_kernel(const int8_t* qg, const int8_t* trg,
                          const int32_t* n, const int32_t* m, int P, int LQG,
                          int LTG, int Lt, int G, int Dmax, int W,
                          const HmmParams& hp, float* ll, size_t smem,
                          cudaStream_t stream) {
  auto set_smem = [&](auto* k) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  };
  cudaError_t e;
  if constexpr (kRagged) {
    auto* k = pairhmm_forward_ragged_kernel<C, NW, kStaged>;
    if ((e = set_smem(k)) != cudaSuccess) return e;
    k<<<P, 32 * NW, smem, stream>>>(qg, trg, n, m, LQG, LTG, Lt, G, Dmax, W,
                                    hp, ll);
  } else {
    auto* k = pairhmm_forward_kernel<C, NW, kStaged>;
    if ((e = set_smem(k)) != cudaSuccess) return e;
    k<<<P, 32 * NW, smem, stream>>>(qg, trg, n, m, LQG, LTG, Lt, G, Dmax, hp,
                                    ll);
  }
  return cudaGetLastError();
}

template <int C, int NW, bool kRagged>
cudaError_t launch_forward(const int8_t* qg, const int8_t* trg,
                           const int32_t* n, const int32_t* m, int P,
                           int LQG, int LTG, int Lt, int G, int Dmax, int W,
                           const HmmParams& hp, float* ll,
                           cudaStream_t stream) {
  const size_t rows = ((LQG + 15) & ~15) + static_cast<size_t>(LTG);
  if (rows <= kStageLimit)
    return launch_kernel<C, NW, true, kRagged>(qg, trg, n, m, P, LQG, LTG, Lt,
                                               G, Dmax, W, hp, ll, rows,
                                               stream);
  return launch_kernel<C, NW, false, kRagged>(qg, trg, n, m, P, LQG, LTG, Lt,
                                              G, Dmax, W, hp, ll, 0, stream);
}

// The SMs of each device, read once.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

// The built layouts' widths: a band width W runs on the narrowest at least
// W wide, exactly or in its ragged build.
constexpr int kWidths[] = {32,  64,  128, 256,  384,  512,  640,
                           768, 896, 1024, 1536, 2048, 3072, 4096};

int layout_width(int W) {
  for (int wp : kWidths)
    if (W >= 1 && W <= wp) return wp;
  return 0;
}

// Cells a lane of the launch for band width W and a batch of P pairs on
// the current device ((layout width) / (32 cells) warps a block): at the
// layout width 128 one (4 warps) while the batch fits three blocks an SM
// (P <= 396 on an H100), else two (2 warps); 32 one; 64 to 1024 two (1 to
// 16 warps); 1536, 2048, 3072 and 4096 three, four, six and eight (16
// warps).  0 for a width with no build.
int cells_for(int W, int P, int* c) {
  const int wp = layout_width(W);
  *c = wp == 0 ? 0 : (wp == 32 ? 1 : (wp <= 1024 ? 2 : wp / 512));
  if (wp != 128) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sms[dev] = sms;
  }
  if (P <= 3L * g_sms[dev]) *c = 1;
  return 0;
}

}  // namespace

// The width of the layout band width W runs on, 0 for a width with none.
extern "C" int fu_pairhmm_layout_width(int W) { return layout_width(W); }

// The cells a lane the launch of a batch of P pairs at band width W takes,
// 0 for a width with no build, or a negated CUDA error.
extern "C" int fu_pairhmm_cells(int W, int P) {
  int c = 0;
  const int e = cells_for(W, P, &c);
  return e != 0 ? -e : c;
}

// The forward with `cells` cells a lane: 0 for the build fu_pairhmm_cells
// names, else that build's cells or, at the layout width 128, 1 or 2 (for
// timing them against each other).
extern "C" int fu_pairhmm_forward_cells(
    int cells, const void* qg, const void* trg, const void* n, const void* m,
    int P, int LQG, int LTG, int Lt, int G, int Dmax, int W, float em_match,
    float em_mis, float em_ins, float tMM, float tMI, float tMD, float tIM,
    float tII, float tDM, float tDD, void* ll, void* stream) {
  const HmmParams hp{em_match, em_mis, em_ins, tMM, tMI,
                     tMD,      tIM,    tII,    tDM, tDD};
  const auto* q8 = static_cast<const int8_t*>(qg);
  const auto* t8 = static_cast<const int8_t*>(trg);
  const auto* n32 = static_cast<const int32_t*>(n);
  const auto* m32 = static_cast<const int32_t*>(m);
  auto* out = static_cast<float*>(ll);
  auto s = static_cast<cudaStream_t>(stream);
  int c = cells;
  if (c == 0) {
    const int e = cells_for(W, P, &c);
    if (e != 0) return e;
  }
  const int wp = layout_width(W);
  const bool ragged = W != wp;
#define FU_HMM(C, NW)                                                      \
  return ragged ? launch_forward<C, NW, true>(q8, t8, n32, m32, P, LQG,    \
                                              LTG, Lt, G, Dmax, W, hp,     \
                                              out, s)                      \
                : launch_forward<C, NW, false>(q8, t8, n32, m32, P, LQG,   \
                                               LTG, Lt, G, Dmax, W, hp,    \
                                               out, s)
  switch (wp * 16 + c) {
    case 32 * 16 + 1: FU_HMM(1, 1);
    case 64 * 16 + 2: FU_HMM(2, 1);
    case 128 * 16 + 1: FU_HMM(1, 4);
    case 128 * 16 + 2: FU_HMM(2, 2);
    case 256 * 16 + 2: FU_HMM(2, 4);
    case 384 * 16 + 2: FU_HMM(2, 6);
    case 512 * 16 + 2: FU_HMM(2, 8);
    case 640 * 16 + 2: FU_HMM(2, 10);
    case 768 * 16 + 2: FU_HMM(2, 12);
    case 896 * 16 + 2: FU_HMM(2, 14);
    case 1024 * 16 + 2: FU_HMM(2, 16);
    case 1536 * 16 + 3: FU_HMM(3, 16);
    case 2048 * 16 + 4: FU_HMM(4, 16);
    case 3072 * 16 + 6: FU_HMM(6, 16);
    case 4096 * 16 + 8: FU_HMM(8, 16);
    default:
      return cudaErrorInvalidValue;
  }
#undef FU_HMM
}

extern "C" int fu_pairhmm_forward(const void* qg, const void* trg,
                                  const void* n, const void* m, int P,
                                  int LQG, int LTG, int Lt, int G, int Dmax,
                                  int W, float em_match, float em_mis,
                                  float em_ins, float tMM, float tMI,
                                  float tMD, float tIM, float tII, float tDM,
                                  float tDD, void* ll, void* stream) {
  return fu_pairhmm_forward_cells(0, qg, trg, n, m, P, LQG, LTG, Lt, G, Dmax,
                                  W, em_match, em_mis, em_ins, tMM, tMI, tMD,
                                  tIM, tII, tDM, tDD, ll, stream);
}
