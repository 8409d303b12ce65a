// Arrow splice forward and backward sweeps for Hopper (sm_90a).
//
// arrow_sweep_kernel replaces the two lax.scan row sweeps of
// falcon_unzip_tpu/ops/arrow.py::arrow_splice_core (fstep, :154-176, and
// bstep, :185-210; XLA loops, not Pallas).  For every (read, template)
// pair it runs the 3-state log-space pair-HMM forward over rows
// i = 0..min(n, Lq) and the backward from that row down to 0, each over
// the template columns j = 0..min(m, LJ - 1), and writes only what the
// splice assembly reads:
//   forward:  M, I, D at the <= C candidate columns     -> (P, C, R)
//   backward: BM, BD at the <= 3C columns cand + 0..2   -> (P, 3, C, R)
//             BM[0, 0], the pair's unmutated log-likelihood
// (R = Lq + 1).  Masks, NEG = -1e30 and the per-base tier mode
// follow arrow.py:113-210: a forward row takes base i-1's tier (qt_m1), a
// backward row takes base i's tier for its M/I edges and base i-1's for
// the within-row D edges (tMD, tDD).  Rows past n and columns past m are
// NEG in the reference; the kernel writes NEG there without computing
// them.  A candidate column is clipped into [0, LJ) first and then read,
// as the reference's gather does.
//
//   Layout: grid (P, 2); block (p, 0) runs the forward sweep of pair p and
//   block (p, 1) its backward sweep, so a pair's score depends on no other
//   pair of the batch.  The block's NW warps take a stripe of 32 NW
//   consecutive rows, a lane a row, and walk it by antidiagonals: at step
//   s the lane of stripe row r computes column s - r (backward: mc - s +
//   r).  So the in-row recurrence (D from column j-1, or BD from j+1) is
//   the lane's own register chain, with no scan and no barrier a row; the
//   previous row comes from the lane above by shuffle: its newest values
//   (column j) and the ones it passed down one step earlier (column
//   j -+ 1).  Across warps the edge is one shared-memory word a warp and
//   step, double-buffered by step parity, with one barrier a step; across
//   stripes the stripe's last row goes through a shared-memory row,
//   double-buffered by stripe parity.  Each lane keeps its row's read base
//   and its params in registers; one shared word a column carries the
//   template base and the bits of the first 24 output slots that read the
//   column (a direction with more slots, backward at C > 8 or forward at
//   C > 24, keeps the rest in further words a column, 32 slots each).  The
//   steps between a stripe's fill and drain run without masks.  NW is
//   chosen by the launch: 8 while the 2P sweeps' warps fit four a
//   scheduler (P <= 132 on an H100), else 2.
//
//   The logaddexp works in base 2 on the SFU (ex2.approx, lg2.approx;
//   logaddexp2.cuh): the params are scaled by log2(e) as they are staged
//   and the outputs by ln(2) as they are stored; 7 SFU operations a cell.
//   Against the plain version (natural log, full-precision expf/log1pf)
//   the raw outputs stay within 1.7e-5 relative at the polish's shape.
//
//   What bounds it (measured with scripts/tune_arrow.py on an H100, no
//   profiler): the step's dependent chain and its instruction stream, not
//   the SFU and not the warps in flight.  A lone warp takes ~260 cycles a
//   step where the shuffle -> logaddexp chain is ~90 (read from the
//   SASS); at P = 512 the time is flat from 2 to 8 warps a scheduler
//   (1.07-1.23 ms), and moving the lg2 of the logaddexps to a degree-7
//   polynomial on the FMA pipe (5 or 4 SFU operations a cell instead of
//   7) made it 5-11% slower.  Measured and dropped: 1 warp a block, 4
//   warps a block for P = 133..264 (0.71-0.74 ms at P = 256 against 2
//   warps' 0.74, inside the spread of two runs), the further slot words
//   compiled into every build (3-8% slower at C = 4; they are built only
//   for C > 8), the accurate expf/log1pf logaddexp (1.9x slower), warps
//   pipelined over stripes without a barrier (a shared counter a stripe,
//   the M/I terms precombined by the row above: 1.6x slower), one block
//   running both sweeps of its pair interleaved (twice the work took twice
//   the time), and the polynomial lg2.  Device-memory traffic is the
//   inputs once and the outputs (3C + 6C floats a row).
//
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "logaddexp2.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPad = 4;          // seq.PAD: never matches
constexpr int kMaxWarps = 8;     // the edge buffer's size
constexpr unsigned kSlotBits = 0xffffffu;  // a column word: 24 slot bits,
constexpr int kBaseShift = 24;             // then the template base

// The block's dynamic shared memory, indexed directly so that every access
// is a shared-memory load with a known window:
//   [0, np)                 the tier table or the pair's params, in log2 units
//   [o_rows, + 6 LJ)        two sets of the stripe's edge row: M, I, D (or
//                           BM, BI), LJ floats each
//   [o_edge, + 6 kMaxWarps) the cross-warp words, by step parity
//   [o_col, + LJ)           a word a column: output slot bits, template base
//   [o_ext, + nxw LJ)       the further slot words (slots 24 + 32 x ..), by x
//   then bytes: the read (Lq) and its tier ids (R, per-base mode)
extern __shared__ float smem[];

// The ten params of a row: tier k of the table (clamped like a gather), or
// the pair's own.
struct Params {
  float em_match, em_mis, em_ins, tMM, tMI, tMD, tIM, tII, tDM, tDD;
};

__device__ __forceinline__ Params params_of(const int8_t* sqt, int idx,
                                            int T) {
  int k = 0;
  if (sqt != nullptr) {
    k = sqt[idx];
    k = k < 0 ? 0 : (k > T - 1 ? T - 1 : k);
  }
  const float* pr = smem + 10 * k;
  return {pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8],
          pr[9]};
}

// One direction's shared-memory region: its two sets of stripe-edge rows,
// its cross-warp words, its column words and its nxw further slot words a
// column.
struct Region {
  int o_rows, o_edge, o_col, o_ext, nxw;
};

// The slot words a column needs beyond the first for n_slots slots.
__host__ __device__ constexpr int ext_words(int n_slots) {
  return n_slots > 24 ? (n_slots - 24 + 31) / 32 : 0;
}

__host__ __device__ constexpr int region_floats(int LJ, int nxw) {
  return (7 + nxw) * LJ + 6 * kMaxWarps;
}

// The further slot bits of column j (word x: slots 24 + 32 x ..).
__device__ __forceinline__ unsigned ext_bits(const Region& g, int x, int j,
                                             int LJ) {
  return reinterpret_cast<const unsigned*>(smem)[g.o_ext + x * LJ + j];
}

// The forward sweep of one pair, a stripe of 32 NW rows at a time: begin
// a stripe, step it (a lane a row, column s - r at step s), end it.
template <int NW, bool kWide>
struct Forward {
  static constexpr int kRows = 32 * NW;
  const Region g;
  const int8_t* sq;
  const int8_t* sqt;
  const int T, m, LJ, C, p, R, i_end, mc, r, lane, warp;
  float* const afM;
  float* const afI;
  float* const afD;
  int rin, rout;                 // the row above the stripe: M, I, D
  // the stripe's row
  int i, q4;
  bool live, row0, last;
  unsigned live_bits;
  Params P;
  float Mc, Ic, Dc;              // own values at column j-1
  float dM, dI, dD;              // the row above at column j-1

  __device__ Forward(const Region& g_, const int8_t* sq_, const int8_t* sqt_,
                     int T_, int n_, int m_, int Lq_, int LJ_, int C_, int p_,
                     float* afM_, float* afI_, float* afD_)
      : g(g_), sq(sq_), sqt(sqt_), T(T_), m(m_), LJ(LJ_), C(C_), p(p_),
        R(Lq_ + 1), i_end(min(n_, Lq_)), mc(min(m_, LJ_ - 1)),
        r(threadIdx.x), lane(threadIdx.x & 31), warp(threadIdx.x >> 5),
        afM(afM_), afI(afI_), afD(afD_), rin(g_.o_rows),
        rout(g_.o_rows + 3 * LJ_) {}

  __device__ void init_rows() {
    for (int j = r; j <= mc; j += kRows)
      smem[rin + j] = smem[rin + LJ + j] = smem[rin + 2 * LJ + j] = kNeg;
  }

  __device__ void begin(int k) {
    i = kRows * k + r;
    live = i <= i_end;
    // every edge into row i consumes q[i-1]: base i-1's tier (clip 0)
    const int ib = live && i >= 1 ? i - 1 : 0;
    P = params_of(sqt, ib, T);
    q4 = live && i >= 1 && sq[ib] < 4 ? sq[ib] : -1;
    row0 = i == 0;
    last = r == kRows - 1;
    live_bits = live ? kSlotBits : 0u;
    Mc = Ic = Dc = dM = dI = dD = kNeg;
  }

  // the row's M, I, D into output slot c
  __device__ __forceinline__ void put(int c, float M, float I, float D) {
    const size_t o = (static_cast<size_t>(p) * C + c) * R + i;
    afM[o] = to_ln(M);
    afI[o] = to_ln(I);
    afD[o] = to_ln(D);
  }

  template <bool kMask>
  __device__ __forceinline__ void step(int s) {
    const int j = s - r;
    const bool in =
        !kMask || static_cast<unsigned>(j) <= static_cast<unsigned>(mc);
    const int jc = in ? j : 0;
    const unsigned w = reinterpret_cast<const unsigned*>(smem)[g.o_col + jc];
    // the row above at column j: the lane above's newest values, or for
    // lane 0 the stripe's edge row (warp 0) or the warp above's word
    float uM = __shfl_up_sync(kFull, Mc, 1);
    float uI = __shfl_up_sync(kFull, Ic, 1);
    float uD = __shfl_up_sync(kFull, Dc, 1);
    int e = rin + jc, es = LJ;
    if (NW > 1 && warp > 0) {
      e = g.o_edge + ((s - 1) & 1) * 3 * kMaxWarps + 3 * (warp - 1);
      es = 1;
    }
    const float eM = smem[e], eI = smem[e + es], eD = smem[e + 2 * es];
    if (lane == 0) {
      uM = in ? eM : kNeg;
      uI = in ? eI : kNeg;
      uD = in ? eD : kNeg;
    }
    const int tg = static_cast<int>(w >> kBaseShift);
    const float em = q4 == tg ? P.em_match : P.em_mis;
    float M = em + lae3(dM + P.tMM, dI + P.tIM, dD + P.tDM);
    float I = P.em_ins + lae(uM + P.tMI, uI + P.tII);
    float D = lae(Mc + P.tMD, Dc + P.tDD);
    bool act = live;
    if (kMask) {
      M = j >= 1 && !row0 ? M : (row0 && j == 0 ? 0.0f : kNeg);
      I = row0 ? kNeg : I;                        // row 0 has no I
      D = j >= 1 ? D : kNeg;
      act = live && in;
    }
    if (!kMask || act) {
      Mc = M;
      Ic = I;
      Dc = D;
    }
    for (unsigned mk = act ? w & live_bits : 0u; mk != 0; mk &= mk - 1)
      put(__ffs(mk) - 1, M, I, D);
    for (int x = 0; kWide && act && x < g.nxw; ++x)
      for (unsigned mk = ext_bits(g, x, jc, LJ); mk != 0; mk &= mk - 1)
        put(24 + 32 * x + __ffs(mk) - 1, M, I, D);
    if (last && (!kMask || act)) {
      smem[rout + jc] = M;
      smem[rout + LJ + jc] = I;
      smem[rout + 2 * LJ + jc] = D;
    }
    dM = uM;
    dI = uI;
    dD = uD;
    if (NW > 1 && lane == 31) {
      const int o = g.o_edge + (s & 1) * 3 * kMaxWarps + 3 * warp;
      smem[o] = Mc;
      smem[o + 1] = Ic;
      smem[o + 2] = Dc;
    }
  }

  __device__ void end() {
    const int x = rin;
    rin = rout;
    rout = x;
  }
};

// The backward sweep of one pair, from row min(n, Lq) down: the stripe's
// lane r holds row i0 - r and computes column mc - s + r at step s.
template <int NW, bool kWide>
struct Backward {
  static constexpr int kRows = 32 * NW;
  const Region g;
  const int8_t* sq;
  const int8_t* sqt;
  const int T, n, m, Lq, LJ, C, p, R, i_start, mc, r, lane, warp;
  float* const bM;
  float* const bD;
  float* const ll_cur;
  int rin, rout;                 // the row below the stripe: BM, BI
  // the stripe's row
  int i, q4, term_j;
  bool live, rin_q, last;
  unsigned live_bits;
  Params Pb;
  float tMD, tDD;
  float BMc, BIc, BDc;           // own values at column j+1
  float dBM;                     // the row below's BM at column j+1

  __device__ Backward(const Region& g_, const int8_t* sq_,
                      const int8_t* sqt_, int T_, int n_, int m_, int Lq_,
                      int LJ_, int C_, int p_, float* bM_, float* bD_,
                      float* ll_cur_)
      : g(g_), sq(sq_), sqt(sqt_), T(T_), n(n_), m(m_), Lq(Lq_), LJ(LJ_),
        C(C_), p(p_), R(Lq_ + 1), i_start(min(n_, Lq_)),
        mc(min(m_, LJ_ - 1)), r(threadIdx.x), lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5), bM(bM_), bD(bD_), ll_cur(ll_cur_),
        rin(g_.o_rows), rout(g_.o_rows + 3 * LJ_) {}

  __device__ void init_rows() {
    for (int j = r; j <= mc; j += kRows)
      smem[rin + j] = smem[rin + LJ + j] = kNeg;
  }

  __device__ void begin(int k) {
    i = i_start - kRows * k - r;
    live = i >= 0;
    // M/I edges out of row i consume q[i]; the within-row D edges (tMD,
    // tDD) stay on base i-1, mirroring the forward
    const int ib = live ? i : 0;
    Pb = params_of(sqt, ib, T);
    const Params Pf = params_of(sqt, ib >= 1 ? ib - 1 : 0, T);
    tMD = Pf.tMD;
    tDD = Pf.tDD;
    q4 = live && i < Lq && sq[ib] < 4 ? sq[ib] : -1;
    rin_q = i <= n - 1;          // row i still consumes a read base
    term_j = i == n ? m : -1;    // the terminal cell's column
    last = r == kRows - 1;
    live_bits = live ? kSlotBits : 0u;
    BMc = BIc = BDc = dBM = kNeg;
  }

  // the row's BM, BD into output slot sc = s C + c
  __device__ __forceinline__ void put(int sc, float BM, float BD) {
    const size_t o = (static_cast<size_t>(p) * 3 * C + sc) * R + i;
    bM[o] = to_ln(BM);
    bD[o] = to_ln(BD);
  }

  template <bool kMask>
  __device__ __forceinline__ void step(int s) {
    const int j = mc - s + r;
    const bool in =
        !kMask || static_cast<unsigned>(j) <= static_cast<unsigned>(mc);
    const int jc = in ? j : 0;
    const unsigned w = reinterpret_cast<const unsigned*>(smem)[g.o_col + jc];
    float uBM = __shfl_up_sync(kFull, BMc, 1);
    float uBI = __shfl_up_sync(kFull, BIc, 1);
    int e = rin + jc, es = LJ;
    if (NW > 1 && warp > 0) {
      e = g.o_edge + ((s - 1) & 1) * 3 * kMaxWarps + 3 * (warp - 1);
      es = 1;
    }
    const float eBM = smem[e], eBI = smem[e + es];
    if (lane == 0) {
      uBM = in ? eBM : kNeg;
      uBI = in ? eBI : kNeg;
    }
    const int tb = static_cast<int>(w >> kBaseShift);
    const float emB = q4 == tb ? Pb.em_match : Pb.em_mis;
    const bool gm = kMask ? rin_q && j <= m - 1 : rin_q;
    const float go_m = gm ? emB + dBM : kNeg;
    const float go_i = rin_q ? Pb.em_ins + uBI : kNeg;
    float BD = lae(Pb.tDM + go_m, BDc + tDD);
    float BM = lae3(Pb.tMM + go_m, Pb.tMI + go_i, tMD + BDc);
    float BI = lae(Pb.tIM + go_m, Pb.tII + go_i);
    bool act = live;
    if (kMask) {
      if (j == term_j) BM = BI = BD = 0.0f;     // the terminal cell
      act = live && in;
    }
    if (!kMask || act) {
      BMc = BM;
      BIc = BI;
      BDc = BD;
    }
    for (unsigned mk = act ? w & live_bits : 0u; mk != 0; mk &= mk - 1)
      put(__ffs(mk) - 1, BM, BD);
    for (int x = 0; kWide && act && x < g.nxw; ++x)
      for (unsigned mk = ext_bits(g, x, jc, LJ); mk != 0; mk &= mk - 1)
        put(24 + 32 * x + __ffs(mk) - 1, BM, BD);
    if (kMask && act && i == 0 && j == 0) ll_cur[p] = to_ln(BM);
    if (last && (!kMask || act)) {
      smem[rout + jc] = BM;
      smem[rout + LJ + jc] = BI;
    }
    dBM = uBM;
    if (NW > 1 && lane == 31) {
      const int o = g.o_edge + (s & 1) * 3 * kMaxWarps + 3 * warp;
      smem[o] = BMc;
      smem[o + 1] = BIc;
    }
  }

  __device__ void end() {
    const int x = rin;
    rin = rout;
    rout = x;
  }
};

// Output slots and column words of one direction: forward slot c reads
// column clip(cand[c]) and a column's base is t[j-1]; backward slot (s, c)
// reads clip(cand[c] + s) and a column's base is t[j].  A slot whose
// column is past m, and every slot's rows past n, are NEG.
template <int kThreads>
__device__ void setup_direction(bool fwd, const Region& g,
                                const int8_t* __restrict__ t,
                                const int32_t* __restrict__ cand, int p,
                                int Lq, int LJ, int C, int i_last, int mc,
                                float* o0, float* o1, float* o2) {
  const int tid = threadIdx.x;
  const int R = Lq + 1;
  unsigned* colw = reinterpret_cast<unsigned*>(smem) + g.o_col;
  unsigned* extw = reinterpret_cast<unsigned*>(smem) + g.o_ext;
  for (int k = tid; k < LJ; k += kThreads) {
    const int jb = fwd ? k - 1 : k;
    const int b = jb >= 0 ? t[static_cast<size_t>(p) * LJ + jb] : kPad;
    colw[k] = static_cast<unsigned>(b & 0xff) << kBaseShift;
  }
  for (int k = tid; k < g.nxw * LJ; k += kThreads) extw[k] = 0u;
  __syncthreads();
  const int n_slots = fwd ? C : 3 * C;
  for (int sc = tid; sc < n_slots; sc += kThreads) {
    int c = cand[static_cast<size_t>(p) * C + sc % C] + sc / C;
    c = c < 0 ? 0 : (c > LJ - 1 ? LJ - 1 : c);
    if (c > mc) continue;
    if (sc < 24)
      atomicOr(&colw[c], 1u << sc);
    else
      atomicOr(&extw[((sc - 24) >> 5) * LJ + c], 1u << ((sc - 24) & 31));
  }
  for (int k = tid; k < n_slots * R; k += kThreads) {
    const int sc = k / R;
    const int i = k % R;
    int c = cand[static_cast<size_t>(p) * C + sc % C] + sc / C;
    c = c < 0 ? 0 : (c > LJ - 1 ? LJ - 1 : c);
    if (i <= i_last && c <= mc) continue;
    const size_t o = static_cast<size_t>(p) * n_slots * R + k;
    o0[o] = o1[o] = kNeg;
    if (o2 != nullptr) o2[o] = kNeg;
  }
}

// One sweep (a Forward or a Backward), a stripe of 32 NW rows at a time.
// A stripe's steps run in three phases: the fill (s < 32 NW) and the
// drain (s >= mc) test each lane's column; between them every lane's
// column lies in [1, mc - 1], so a step needs no mask at all (a NEG input
// gives NEG: NEG plus a param, or plus lg2 of at most 3, is NEG in
// float32).
template <int NW, typename Sweep>
__device__ void run_sweep(Sweep& w, int i_last, int mc) {
  constexpr int kRows = 32 * NW;
  w.init_rows();
  __syncthreads();
  for (int k = 0; kRows * k <= i_last; ++k) {
    w.begin(k);
    const int steps = mc + min(kRows, i_last - kRows * k + 1);
    const int s1 = min(kRows, steps);
    const int s2 = s1 == kRows ? max(s1, min(mc, steps)) : s1;
    int s = 0;
    for (; s < s1; ++s) {
      w.template step<true>(s);
      if (NW > 1) __syncthreads();
    }
    for (; s < s2; ++s) {
      w.template step<false>(s);
      if (NW > 1) __syncthreads();
    }
    for (; s < steps; ++s) {
      w.template step<true>(s);
      if (NW > 1) __syncthreads();
    }
    w.end();
    __syncthreads();
  }
}

template <int NW, bool kWide>
__global__ void __launch_bounds__(32 * NW)
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
  constexpr int kThreads = 32 * NW;
  const int p = blockIdx.x;
  const bool fwd = blockIdx.y == 0;
  const int tid = threadIdx.x;
  const int R = Lq + 1;
  const bool tiered = qt != nullptr;
  const int np = tiered ? 10 * T : 10;
  const int o_col = np + 6 * LJ + 6 * kMaxWarps;
  const Region g{np, np + 6 * LJ, o_col, o_col + LJ,
                 ext_words(fwd ? C : 3 * C)};
  int8_t* sq = reinterpret_cast<int8_t*>(
      smem + np + region_floats(LJ, ext_words(3 * C)));
  int8_t* sqt = tiered ? sq + Lq : nullptr;
  for (int k = tid; k < np; k += kThreads)
    smem[k] = kLog2e *
              (tiered ? tiers[k] : pvec[static_cast<size_t>(p) * 10 + k]);
  for (int k = tid; k < Lq; k += kThreads)
    sq[k] = q[static_cast<size_t>(p) * Lq + k];
  if (tiered)
    for (int k = tid; k < R; k += kThreads)
      sqt[k] = qt[static_cast<size_t>(p) * R + k];
  const int n = n_arr[p];
  const int m = m_arr[p];
  const int i_last = min(n, Lq);
  const int mc = min(m, LJ - 1);
  if (fwd)
    setup_direction<kThreads>(true, g, t, cand, p, Lq, LJ, C, i_last, mc,
                              afM, afI, afD);
  else
    setup_direction<kThreads>(false, g, t, cand, p, Lq, LJ, C, i_last, mc,
                              bM, bD, nullptr);
  __syncthreads();
  if (fwd) {
    Forward<NW, kWide> f(g, sq, sqt, T, n, m, Lq, LJ, C, p, afM, afI, afD);
    run_sweep<NW>(f, i_last, mc);
  } else {
    Backward<NW, kWide> b(g, sq, sqt, T, n, m, Lq, LJ, C, p, bM, bD, ll_cur);
    run_sweep<NW>(b, i_last, mc);
  }
}

template <int NW, bool kWide>
int launch_build(const void* q, const void* t, const void* n,
                 const void* m, const void* cand, const void* pvec,
                 const void* qt, const void* tiers, int T, int P, int Lq,
                 int LJ, int C, void* afM, void* afI, void* afD, void* bM,
                 void* bD, void* ll_cur, cudaStream_t stream) {
  const int np = qt != nullptr ? 10 * T : 10;
  const size_t smem_bytes =
      (static_cast<size_t>(np) + region_floats(LJ, ext_words(3 * C))) *
          sizeof(float) +
      static_cast<size_t>(Lq) + (qt != nullptr ? Lq + 1 : 0);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        arrow_sweep_kernel<NW, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  arrow_sweep_kernel<NW, kWide><<<dim3(P, 2), 32 * NW, smem_bytes, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
      static_cast<const int32_t*>(cand), static_cast<const float*>(pvec),
      static_cast<const int8_t*>(qt), static_cast<const float*>(tiers), T,
      Lq, LJ, C, static_cast<float*>(afM), static_cast<float*>(afI),
      static_cast<float*>(afD), static_cast<float*>(bM),
      static_cast<float*>(bD), static_cast<float*>(ll_cur));
  return static_cast<int>(cudaGetLastError());
}

// The build of NW warps a block, with the further slot words compiled in
// only where the backward's 3C slots need them (C > 8).
template <int NW>
int launch(const void* q, const void* t, const void* n, const void* m,
           const void* cand, const void* pvec, const void* qt,
           const void* tiers, int T, int P, int Lq, int LJ, int C,
           void* afM, void* afI, void* afD, void* bM, void* bD,
           void* ll_cur, cudaStream_t stream) {
  if (ext_words(3 * C) > 0)
    return launch_build<NW, true>(q, t, n, m, cand, pvec, qt, tiers, T, P,
                                  Lq, LJ, C, afM, afI, afD, bM, bD, ll_cur,
                                  stream);
  return launch_build<NW, false>(q, t, n, m, cand, pvec, qt, tiers, T, P, Lq,
                                 LJ, C, afM, afI, afD, bM, bD, ll_cur,
                                 stream);
}

// The SMs of each device, read once.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

// Warps a block for a batch of P pairs on the current device: 8 while the
// 2P sweeps' warps fit four a scheduler (P <= 132 on an H100), else 2.
int warps_for(int P, int* nw) {
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
  const long warps = 16L * g_sms[dev];   // 4 schedulers x 4 warps an SM
  *nw = 2L * P * 8 <= warps ? 8 : 2;
  return 0;
}

}  // namespace

// The warps a block the launch of a batch of P pairs takes (8 or 2), or a
// negated CUDA error.
extern "C" int fu_arrow_warps(int P) {
  int nw = 0;
  const int e = warps_for(P, &nw);
  return e != 0 ? -e : nw;
}

extern "C" int fu_arrow_sweeps(const void* q, const void* t, const void* n,
                               const void* m, const void* cand,
                               const void* pvec, const void* qt,
                               const void* tiers, int T, int P, int Lq,
                               int LJ, int C, void* afM, void* afI,
                               void* afD, void* bM, void* bD, void* ll_cur,
                               void* stream) {
  int nw = 0;
  const int e = warps_for(P, &nw);
  if (e != 0) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nw == 8)
    return launch<8>(q, t, n, m, cand, pvec, qt, tiers, T, P, Lq, LJ, C,
                     afM, afI, afD, bM, bD, ll_cur, s);
  return launch<2>(q, t, n, m, cand, pvec, qt, tiers, T, P, Lq, LJ, C, afM,
                   afI, afD, bM, bD, ll_cur, s);
}
