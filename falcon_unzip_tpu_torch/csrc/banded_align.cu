// Banded edit-distance wavefront and traceback for Hopper (sm_90a).
//
// Kernel 1, banded_wavefront, replaces the TPU kernel
// falcon_unzip_tpu/ops/pallas_align.py::_kernel (launched by
// pallas_banded_align).  It is bit-exact to the scan path
// falcon_unzip_tpu/ops/banded_align.py::banded_align_batch: the same
// fixed-width slope-1/2 band, lo(d) = max(0, (d+1)/2 - W/2), unit costs,
// an N/pad base never matches (q < 4), ties diag < up < left, modes
// global / qglocal / tglocal, INF = 1 << 20, moves packed 2 bits a cell
// as bp[d / 16][p][w], bits 2*(d % 16).
//
//   What bounds it: every antidiagonal depends on the two before it, so a
//   pair is a chain of up to Dmax dependent steps, and a main-path launch
//   has only 256 pairs.  The work is int32: the memory rate and the tensor
//   cores do not enter.  An SM sub-partition starts an int32 warp
//   operation every other cycle (16 INT32 lanes), so what counts is the
//   number of machine operations a step costs and whether each of the
//   card's 528 schedulers has a second warp to run while the first waits
//   on its shuffle and barrier.
//
//   Layout: one block per pair, NW warps of 32 lanes, C = W / (32 NW)
//   (the layout's width: see the ragged builds below)
//   neighbouring band cells a lane, the antidiagonals d-1 and d-2 in
//   registers.  A 256-pair launch is 256 blocks of 4 warps (from W = 128
//   on; a lane a cell below), two warps a scheduler (the earlier kernel's 64 blocks of 4 pairs left
//   68 SMs idle and the others one warp a scheduler).
//   * The +-1 band shift is one shuffle a step (only the side that
//     s1 = lo(d) - lo(d-1) selects), and across warps one word in a
//     double-buffered edge array in shared memory with one barrier a step.
//   * No base loads in the cell loop: both guarded rows are staged in
//     shared memory once, each lane keeps its C query and C target bases
//     in registers (PAD/N mapped to two different codes so that the
//     substitution test is one compare), and each step exactly one of the
//     two windows slides by one base: one byte load a lane, whose address
//     depends on d only, so it is off the recurrence's chain.
//   * Masks only where they can be true.  A block row of 16 antidiagonals
//     in the band's steady state (lo >= 1: then s2 = 1, s1 = d & 1, and
//     i >= 1, j >= 1 everywhere) runs unrolled with constant shifts: with
//     no mask at all where every cell of the warp has i < n and j <= m,
//     else with the two tests i <= n, j <= m as one range test on the
//     cell index and the row-n minimum at its one cell.  Neither needs
//     the INF clamp or the MOVE_NONE test of a finite value: a valid
//     in-band cell is finite (by induction its diagonal predecessor is
//     valid and in the band).  Only the first W antidiagonals (lo == 0)
//     and the pair's last row run the general step, its masks thresholds
//     on the cell index.
//   * The loop stops at the pair's corner d = n + m; the packed moves
//     past it are MOVE_NONE and are stored without being computed.
//   * Any band width W from 1 to 4096, as the JAX package runs any W
//     (Pallas at W % 128 == 0, its scan otherwise).  14 layouts are built
//     (fu_wavefront_layout_width): 32, 64, 128 to 1024 by 128, 1536, 2048,
//     3072, 4096.  A W that is no layout's width runs on the narrowest
//     wider one in its ragged build, which takes W at run time: the cells
//     w >= W are held at INF on every step (the TPU kernel's edge rule: a
//     read past the band's top is INF), stay out of the row-n minimum,
//     are never stored (bp keeps its stride W), and their lanes' base
//     reads are clamped into the rows (which are sized for W).  lo(d)
//     depends on W / 2 only, so an odd W has the schedule of W - 1 with
//     one cell more on top; the steady rows' shifts and masks need no
//     change (at d = W, the one antidiagonal where an odd band's top cell
//     has j = 0, lo is still 0 at the row's start: a general row).  A
//     warp holding cells past W runs the unmasked rows with those cells
//     set to INF (one select a cell): with the masked rows instead W =
//     924 on the 1024 layout took 2.559 ms against the full band's 1.782
//     (1.44x), with the select 2.109 against 1.785 (1.18x; P=256,
//     tglocal, bq=2048; scripts/tune_banded.py --layouts).
//
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W, W=256 tglocal, P=256,
//   bq=2048, Dmax 4609 (scripts/tune_banded.py; the runs are in PERF.md):
//   this design 0.81 / 0.53 / 0.43 / 0.50 ms at 1 / 2 / 4 / 8 warps a pair
//   (other instantiations of this template; W=512: 2 warps 1.13 ms, 4
//   warps 0.70, 8 warps 0.75; W=128: 1 warp 0.37, 2 warps 0.36, 4 warps
//   0.32), so only the 4-warp ones are built; against 2.05-2.07 ms for the
//   earlier kernel (a warp a pair, four pairs a block, per-cell __ldg and
//   masks, all Dmax steps).  Lost: the same layout with the full per-cell
//   masks on every row that is not mask-free (0.56 ms at 4 warps: ~330
//   machine operations a masked step against ~50); no barrier inside a
//   block row, each warp recomputing 16 cells of either neighbour and
//   trading them once a row (0.59 ms at 4 warps with the same masked rows:
//   half as many operations again, and the schedulers are already
//   int32-bound).
//
//   Wide layouts (P=256, tglocal, bq=2048, Dmax 4609, the same card;
//   scripts/tune_banded.py --layouts, two calls): 768 6x4 1.127 against
//   3x8 1.124 ms (cells a lane x warps); 1024 8x4 1.836 / 1.794 against
//   4x8 1.559 / 1.532; 1536 6x8 2.754 / 2.751 against 3x16 3.300; 2048
//   8x8 4.579 / 4.577, 4x16 4.439 / 4.441, 2x32 5.117; 3072 6x16 7.850
//   against 3x32 8.574; 4096 8x16 10.163 against 4x32 10.945.
//
// Kernel 2, traceback, replaces the lax.scan traceback_batch of
// falcon_unzip_tpu/ops/banded_align.py (an XLA loop, not Pallas) and the
// XLA ops behind it, pack_moves2 / _combine_results and _summarize_moves.
//
//   What bounds it: a chain of one dependent move lookup a step, ~2000
//   steps a pair, 256 pairs: latency, not bytes.  One thread a pair paid a
//   device-memory round trip a step; and a lone warp starts a dependent
//   int32 operation every ~5 cycles, so the operations a step count.
//
//   Layout: one warp per pair.  For the block row d >> 4 the warp holds a
//   window of 64 packed words around the current w in registers (two
//   coalesced loads, two words a lane); on entering a row at w it loads
//   the next row's window with the same base, which covers both rows
//   whatever the path does (over 16 antidiagonals w moves by -16 .. +8).
//   In the band's steady state the walk runs row after row in a tight
//   loop: 32 of the 64 words re-centred on w, one __shfl_sync a lookup; a
//   run of diagonal moves (it stays in one cell, so its moves are fields
//   of one word) taken in one step with a bit scan; the row change a
//   re-centring of the words loaded a row ago.  Whenever (d >> 4, w) is
//   outside what it holds, d or w is clipped, or lo == 0, it takes the
//   general step (the scan's, clipping and all) and reloads, so the
//   result is the scan's in every case, also on pairs that did not align
//   and on arbitrary move words.  Moves are gathered 16 to a word in the
//   warp and leave coalesced; the MOVE_NONE tail is filled 16 bytes a
//   lane.  Three epilogues: the (P, steps) int8 moves in reverse order;
//   the packed (P, ceil(steps/16) + 3) int32 of
//   _combine_results(pack_moves2) written directly; or the (P, 7) int32
//   summary of _summarize_moves accumulated during the walk with no move
//   written.
//
//   It takes W at run time: any W from 1 to 4096.  Below W = 32 (the
//   NARROW build) a row has fewer words than a lane count, so lanes past
//   W load nothing; at W < 64 the 64-word window holds the whole row.  A
//   load guard in the one build for every W cost 3-5.5% at W = 128-512,
//   hence the two builds.
//
//   Measured at the same shape and card: moves 0.16, packed 0.15, summary
//   0.15 ms, against 0.98 ms for the thread-a-pair kernel plus 0.22-0.36
//   ms (packing) or 0.32-0.56 ms (summary) of torch ops behind it.  On the
//   way: the general step alone with the 64-word window 0.30 ms; a tight
//   loop per row that went back to the general step at every row change
//   0.39 ms (the row change cost more than the steps it saved), the same
//   with diagonal runs 0.39 ms, the walk across rows 0.37 ms while pairs
//   within 8 cells of the band's edge stayed on the general step, 0.16 ms
//   once they did not.  Prefetching rows further ahead towards the L2
//   cache changed nothing.
//
// All functions have a plain C interface (loaded with ctypes), launch on
// the stream they are given and return cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

enum : int { kInf = 1 << 20 };  // an enumerator: usable in device code by value only
constexpr int kMoveDiag = 0;
constexpr int kMoveUp = 1;
constexpr int kMoveLeft = 2;
constexpr int kMoveNone = 3;
constexpr int kModeGlobal = 0;
constexpr int kModeTglocal = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageLimit = 96 * 1024;  // rows larger than this stay global

__device__ __forceinline__ int band_lo(int d, int W) {
  const int x = (d + 1) / 2 - W / 2;
  return x > 0 ? x : 0;
}

// One arrival a warp and step, whichever branch the warp is in: bar.sync
// counts arrivals, not program locations.
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 0;" ::: "memory");
}

// A base for the substitution test: A C G T stay, everything else becomes
// `other` (0xff in the query, 0xfe in the target, so they never match).
__device__ __forceinline__ int base_code(const uint8_t* row, int idx,
                                         int other) {
  const int b = row[idx];
  return b > 3 ? other : b;
}

__device__ __forceinline__ void stage_row(uint8_t* dst, const int8_t* src,
                                          int len, int tid, int nthreads) {
  if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(len)) &
       15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int k = tid; k < len / 16; k += nthreads) d4[k] = __ldg(s4 + k);
  } else {
    for (int k = tid; k < len; k += nthreads)
      dst[k] = static_cast<uint8_t>(src[k]);
  }
}

__device__ __forceinline__ uint32_t low_bits(int nbits2) {
  // the low 2 * nbits2 bits set, nbits2 in 0..16
  return nbits2 >= 16 ? kFull : ((1u << (2 * nbits2)) - 1u);
}

enum : int { kNoCell = -(1 << 30) };  // no cell has this band index

template <int C>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&w)[C],
                                            uint32_t fill) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<uint4*>(dst + c) = make_uint4(
          w[c] | fill, w[c + 1] | fill, w[c + 2] | fill, w[c + 3] | fill);
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0] | fill, w[1] | fill);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = w[c] | fill;
  }
}

// the words of the lane's cells inside the band (`left` = W - g0 of them
// or more), one at a time: bp's rows are W words, so no vector alignment
template <int C>
__device__ __forceinline__ void store_words_ragged(uint32_t* dst,
                                                   const uint32_t (&w)[C],
                                                   uint32_t fill, int left) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < left) dst[c] = w[c] | fill;
}

// C cells a lane, NW warps a pair: the layout's width is 32 C NW.  The
// band is that wide, or with RAGGED W_run <= 32 C NW wide: then the cells
// w >= W are held at INF on every step (a read past the band's top is INF,
// as in the TPU kernel), never stored, out of the row-n minimum and the
// end-cell search, and their lanes' base reads are clamped into the rows.
template <int C, int NW, bool RAGGED>
__global__ void __launch_bounds__(32 * NW)
banded_wavefront_kernel(const int8_t* __restrict__ qg,
                        const int8_t* __restrict__ trg,
                        const int32_t* __restrict__ n_arr,
                        const int32_t* __restrict__ m_arr,
                        int P, int LQG, int LTG, int Lt, int G, int Dmax,
                        int W_run, int mode, int staged,
                        uint32_t* __restrict__ bp,
                        int32_t* __restrict__ dist,
                        int32_t* __restrict__ end_i,
                        int32_t* __restrict__ end_j) {
  constexpr int WP = 32 * C * NW;
  const int W = RAGGED ? W_run : WP;
  constexpr int T = 32 * NW;
  extern __shared__ uint4 smem4[];
  // the one cell a neighbour warp needs at the next step, by step parity
  __shared__ volatile int s_edge[2][NW];
  __shared__ int s_red[2][NW];
  __shared__ int s_final;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.x;
  const int n = n_arr[p];
  const int m = m_arr[p];

  // the pair's guarded rows: in shared memory when they fit, else where
  // they are
  const uint8_t* qrow =
      reinterpret_cast<const uint8_t*>(qg) + static_cast<size_t>(p) * LQG;
  const uint8_t* trow =
      reinterpret_cast<const uint8_t*>(trg) + static_cast<size_t>(p) * LTG;
  if (staged) {
    uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
    uint8_t* sq = smem;
    uint8_t* st = smem + ((LQG + 15) & ~15);
    stage_row(sq, reinterpret_cast<const int8_t*>(qrow), LQG, tid, T);
    stage_row(st, reinterpret_cast<const int8_t*>(trow), LTG, tid, T);
    qrow = sq;
    trow = st;
  }
  // a base of either row (a ragged build's lanes past the band clamped)
  auto q_code = [&](int idx) {
    if (RAGGED) idx = min(idx, LQG - 1);
    return base_code(qrow, idx, 0xff);
  };
  auto t_code = [&](int idx) {
    if (RAGGED) idx = min(max(idx, 0), LTG - 1);
    return base_code(trow, idx, 0xfe);
  };
  if (tid < 2 * NW) (&s_edge[0][0])[tid] = kInf;
  if (tid == 0) s_final = kInf;
  __syncthreads();

  const int g0 = tid * C;                // band index of the lane's first cell
  const int wa = warp * 32 * C;          // this warp's cells: wa .. wb
  const int wb = wa + 32 * C - 1;
  const int d_end = min(Dmax - 1, n + m);
  const int t_top = G + Lt;              // target window start at d = 0

  int V1[C], V2[C], qb[C], tb[C];
  uint32_t pack[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    V1[c] = kInf;
    V2[c] = kInf;
    pack[c] = 0u;
    qb[c] = q_code(g0 + c);
    tb[c] = t_code(t_top + g0 + c);
  }
  int v2_edge = kInf;  // V(d-2) of the cell before this warp's first
  int best = kInf;     // thread-local first strict minimum on row i == n
  int best_d = -1;
  uint32_t* bp_p =
      bp == nullptr ? nullptr : bp + static_cast<size_t>(p) * W + g0;
  const size_t bp_row = static_cast<size_t>(P) * W;

  // V(d-1) of the cell before (s1 == 0) or after (s1 == 1) the lane's own:
  // a shuffle, and across warps the word the neighbour left a step ago
  auto neighbour = [&](int s1, int d) {
    int nb;
    if (s1 == 0) {
      nb = __shfl_up_sync(kFull, V1[C - 1], 1);
      if (lane == 0) nb = warp > 0 ? s_edge[(d + 1) & 1][warp - 1] : kInf;
    } else {
      nb = __shfl_down_sync(kFull, V1[0], 1);
      if (lane == 31)
        nb = warp < NW - 1 ? s_edge[(d + 1) & 1][warp + 1] : kInf;
    }
    return nb;
  };
  // The end of step d: exactly one base window slides by one for step
  // d + 1 (the query's when lo grows, else the target's: one byte load a
  // lane, off the recurrence's chain), the cell the neighbour warp will
  // need is left in shared memory, one barrier, and the antidiagonals
  // shift.  CLAMP: the read for the step after the last stays in the row.
  auto end_step = [&](int d, int s1_next, int lo_next, const int (&V)[C],
                      auto clamp_tag) {
    constexpr bool CLAMP = decltype(clamp_tag)::value;
    if (s1_next != 0) {
#pragma unroll
      for (int c = 0; c + 1 < C; ++c) qb[c] = qb[c + 1];
      int idx = lo_next + g0 + C - 1;
      if (CLAMP) idx = min(idx, LQG - 1);
      qb[C - 1] = q_code(idx);
      if (NW > 1 && lane == 0) s_edge[d & 1][warp] = V[0];
    } else {
#pragma unroll
      for (int c = C - 1; c > 0; --c) tb[c] = tb[c - 1];
      int idx = t_top - (d + 1) + lo_next + g0;
      if (CLAMP) idx = max(idx, 0);
      tb[0] = t_code(idx);
      if (NW > 1 && lane == 31) s_edge[d & 1][warp] = V[C - 1];
    }
    if (NW > 1) block_barrier();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      V2[c] = V1[c];
      V1[c] = V[c];
    }
  };

  const int rows_run = (d_end >> 4) + 1;
  for (int r = 0; r < rows_run; ++r) {
    const int d0 = 16 * r;
    const int d1 = min(d0 + 15, d_end);
    const int lo_a = band_lo(d0, W);
    const int lo_b = band_lo(d0 + 15, W);
    // One block row in the band's steady state (d0 is even and lo >= 1, so
    // s2 = 1, s1 = k & 1, lo(d0 + k) = lo_a + (k + 1) / 2, and i >= 1 and
    // j >= 1 hold in every band cell), unrolled with constant shifts.
    // Unmasked: every cell of the warp is valid.  Masked: the cells with
    // i <= n and j <= m are v_lo <= g <= v_hi, the others INF and
    // MOVE_NONE, and row n's cell feeds the minimum.  A valid cell is
    // finite (its diagonal predecessor is valid and in the band), so
    // neither needs the INF clamp.  CUT (a ragged build's warp that holds
    // cells past W, otherwise unmasked): those cells are set to INF, one
    // select each, and their moves are never stored.
    auto steady_row = [&](auto masked_tag, auto cut_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
      constexpr bool CUT = decltype(cut_tag)::value;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int nb = neighbour(k & 1, d0 + k);
        const int lo_k = lo_a + (k + 1) / 2;
        const int g_n = n - lo_k;        // row n's cell
        const int g_hi = RAGGED ? min(g_n, W - 1) : g_n;
        const int v_lo = d0 + k - lo_k - m;
        int V[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          int up, left;
          if ((k & 1) == 0) {            // s1 = 0: up is V1[w - 1]
            up = c == 0 ? nb : V1[c - 1];
            left = V1[c];
          } else {                       // s1 = 1: left is V1[w + 1]
            up = V1[c];
            left = c == C - 1 ? nb : V1[c + 1];
          }
          const int cd = V2[c] + (qb[c] != tb[c] ? 1 : 0);
          const int cu = up + 1;
          const int cl = left + 1;
          int v = min(min(cd, cu), cl);
          uint32_t mv = cd <= v ? kMoveDiag : (cu <= v ? kMoveUp : kMoveLeft);
          if (MASKED) {
            const bool valid = g0 + c >= v_lo && g0 + c <= g_hi;
            v = valid ? v : kInf;
            mv = valid ? mv : kMoveNone;
            if (g0 + c == g_n && v < best) {
              best = v;
              best_d = d0 + k;
            }
          }
          if (CUT) v = c < W - g0 ? v : kInf;
          pack[c] |= mv << (2 * k);
          V[c] = v;
        }
        end_step(d0 + k, (k + 1) & 1, lo_a + (k + 2) / 2, V,
                 std::false_type{});
      }
    };
    if (d0 + 15 < d_end && lo_a >= 1) {
      // the pair's corner is not on this row.  Unmasked if every cell of
      // this warp in the band has i < n and j <= m on all 16 antidiagonals
      // (each test is monotone in d: its far end decides).
      const int w_top = RAGGED ? min(wb, W - 1) : wb;
      if (w_top < n - lo_b && wa >= d0 + 15 - lo_b - m) {
        if constexpr (RAGGED) {
          if (wb < W)
            steady_row(std::false_type{}, std::false_type{});
          else
            steady_row(std::false_type{}, std::true_type{});
        } else {
          steady_row(std::false_type{}, std::false_type{});
        }
      } else {
        steady_row(std::true_type{}, std::false_type{});
      }
    } else {
      // the general steps (the first W antidiagonals, where lo == 0, and
      // the pair's last row): any d, any mask, as thresholds on the cell
      for (int d = d0; d <= d1; ++d) {
        const int lo = band_lo(d, W);
        const int s1 = lo - band_lo(d - 1, W);
        const int s2 = lo - band_lo(d - 2, W);
        const int nb = neighbour(s1, d);
        int v2p = kInf;                  // V2[w - 1] of the lane's first cell
        if (s2 == 0) {
          v2p = __shfl_up_sync(kFull, V2[C - 1], 1);
          // across warps: the neighbour's edge as read one step ago
          // (s2 == 0 only while lo == 0, and then s1 was 0 there too)
          if (lane == 0) v2p = v2_edge;
        }
        if (s1 == 0) v2_edge = nb;
        const int dl = d - lo;           // j = dl - g
        const int i_lo = 1 - lo;         // i >= 1  <=>  g >= i_lo
        const int j_hi = dl - 1;         // j >= 1  <=>  g <= j_hi
        const int v_lo = dl - m;         // valid  <=>  v_lo <= g <= v_hi
        const int v_hi =
            RAGGED ? min(min(n - lo, dl), W - 1) : min(n - lo, dl);
        // the origin: i == 0 (g == 0 while lo == 0), any j in tglocal,
        // j == 0 otherwise
        const int g_org =
            (lo == 0 && (mode == kModeTglocal || d == 0)) ? 0 : kNoCell;
        const int g_n = n - lo;          // row n's cell
        const int shift = 2 * (d & 15);
        int V[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int v1m = c == 0 ? nb : V1[c - 1];      // used if s1 == 0
          const int v1p = c == C - 1 ? nb : V1[c + 1];  // used if s1 == 1
          const int v2m = c == 0 ? v2p : V2[c - 1];     // used if s2 == 0
          const int up = s1 == 0 ? v1m : V1[c];
          const int left = s1 == 0 ? V1[c] : v1p;
          const int diag = s2 == 0 ? v2m : V2[c];
          const int g = g0 + c;
          const bool i1 = g >= i_lo;
          const bool j1 = g <= j_hi;
          const int sub = qb[c] != tb[c] ? 1 : 0;
          const int cd = (i1 && j1) ? diag + sub : kInf;
          const int cu = i1 ? up + 1 : kInf;
          const int cl = j1 ? left + 1 : kInf;
          int v = min(min(cd, cu), cl);
          const int mv =
              cd <= v ? kMoveDiag : (cu <= v ? kMoveUp : kMoveLeft);
          const bool origin = g == g_org;
          const bool valid = g >= v_lo && g <= v_hi;
          if (origin) v = 0;
          if (!valid) v = kInf;
          v = min(v, kInf);
          const int b = (valid && !origin && v < kInf) ? mv : kMoveNone;
          pack[c] |= static_cast<uint32_t>(b) << shift;
          if (g == g_n && valid && v < best) {
            best = v;
            best_d = d;
          }
          V[c] = v;
        }
        if (mode == kModeGlobal && d == n + m) {
          int wnm = n - lo;  // the corner's cell, clipped as the scan does
          wnm = wnm < 0 ? 0 : (wnm > W - 1 ? W - 1 : wnm);
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (g0 + c == wnm) s_final = V[c];
        }
        const int lo_n = band_lo(d + 1, W);
        end_step(d, lo_n - lo, lo_n, V, std::true_type{});
      }
    }
    // the row's moves; on the pair's last row MOVE_NONE for the
    // antidiagonals past its corner
    if (bp_p != nullptr) {
      uint32_t fill = 0u;
      if (d1 == d_end)
        fill = low_bits(min(16, Dmax - d0)) & ~low_bits((d1 & 15) + 1);
      if (RAGGED)
        store_words_ragged<C>(bp_p + r * bp_row, pack, fill, W - g0);
      else
        store_words<C>(bp_p + r * bp_row, pack, fill);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) pack[c] = 0u;
  }

  // block rows past the pair's corner: all MOVE_NONE
  if (bp_p != nullptr) {
    const int rows = (Dmax + 15) >> 4;
    for (int r = rows_run; r < rows; ++r) {
      const uint32_t fill = low_bits(min(16, Dmax - 16 * r));
      if (RAGGED)
        store_words_ragged<C>(bp_p + r * bp_row, pack, fill, W - g0);
      else
        store_words<C>(bp_p + r * bp_row, pack, fill);
    }
  }

  // first antidiagonal with the strictly smallest V on row i == n:
  // smallest V, ties to the earliest d
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, off);
    const int od = __shfl_xor_sync(kFull, best_d, off);
    if (ob < best || (ob == best && od < best_d)) {
      best = ob;
      best_d = od;
    }
  }
  if (lane == 0) {
    s_red[0][warp] = best;
    s_red[1][warp] = best_d;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int k = 1; k < NW; ++k) {
      const int ob = s_red[0][k];
      const int od = s_red[1][k];
      if (ob < best || (ob == best && od < best_d)) {
        best = ob;
        best_d = od;
      }
    }
    end_i[p] = n;
    if (mode == kModeGlobal) {
      dist[p] = s_final;
      end_j[p] = m;
    } else {
      dist[p] = best;
      end_j[p] = best_d >= 0 ? best_d - n : -1;
    }
  }
}

constexpr int kEpiMoves = 0;
constexpr int kEpiPacked = 1;
constexpr int kEpiSummary = 2;

// `count` bytes of MOVE_NONE from dst, by one warp, 16 bytes a lane
__device__ __forceinline__ void fill_none(uint8_t* dst, int count, int lane) {
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  head = head < count ? head : count;
  if (lane < head) dst[lane] = kMoveNone;
  dst += head;
  count -= head;
  const int nvec = count >> 4;
  const uint32_t x = 0x03030303u;
  for (int v = lane; v < nvec; v += 32)
    reinterpret_cast<uint4*>(dst)[v] = make_uint4(x, x, x, x);
  dst += nvec << 4;
  count -= nvec << 4;
  if (lane < count) dst[lane] = kMoveNone;
}

// `count` moves (at most 512) held 16 to a word, word g in lane g, to dst
// as bytes: 32 neighbouring bytes a store
__device__ __forceinline__ void flush_moves(uint8_t* dst, uint32_t mine,
                                            int count, int lane) {
  for (int t = 0; 32 * t < count; ++t) {
    const int kk = 32 * t + lane;
    const uint32_t word = __shfl_sync(kFull, mine, kk >> 4);
    if (kk < count) dst[kk] = (word >> (2 * (kk & 15))) & 3u;
  }
}

// NARROW: a band narrower than a warp (W < 32), whose rows have fewer
// words than the window's first load reads: those lanes load nothing.
template <int EPI, bool NARROW>
__global__ void __launch_bounds__(32)
traceback_kernel(const uint32_t* __restrict__ bp, int P, int W, int Dmax,
                 const int32_t* __restrict__ end_i,
                 const int32_t* __restrict__ end_j,
                 const int32_t* __restrict__ dist, int steps,
                 void* __restrict__ out_v) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const int i0 = end_i[p];
  const int j0 = end_j[p];
  int i = i0;
  int j = j0;
  const int wb_max = W > 64 ? W - 64 : 0;
  const size_t row = static_cast<size_t>(P) * W;
  const uint32_t* bp_p = bp + static_cast<size_t>(p) * W;

  int r_cur = -1, wb_cur = 0, r_nxt = -1, wb_nxt = 0;
  uint32_t c0 = 0u, c1 = 0u, n0 = 0u, n1 = 0u;
  uint32_t acc = 0u, mine = 0u;          // 16 moves a word; word g in lane g
  int n_t = 0, n_up = 0, run = 0, trail = 0;
  bool all_up = true;

  uint8_t* out_moves = nullptr;
  uint32_t* out_words = nullptr;
  const int K = (steps + 15) >> 4;
  if constexpr (EPI == kEpiMoves)
    out_moves = static_cast<uint8_t*>(out_v) + static_cast<size_t>(p) * steps;
  if constexpr (EPI == kEpiPacked)
    out_words = static_cast<uint32_t*>(out_v) + static_cast<size_t>(p) * (K + 3);

  int k = 0;
  // one move taken at step k: into the summary's counts, or into the
  // 16-move word and, every 512 moves, out of the warp
  auto record = [&](int mv) {
    if constexpr (EPI == kEpiSummary) {
      const bool is_up = mv == kMoveUp;
      n_up += is_up ? 1 : 0;
      n_t += is_up ? 0 : 1;
      run = is_up ? run + 1 : 0;
      all_up = all_up && is_up;
      trail += all_up ? 1 : 0;
    } else {
      acc |= static_cast<uint32_t>(mv) << (2 * (k & 15));
      if ((k & 15) == 15) {
        if (lane == ((k >> 4) & 31)) mine = acc;
        acc = 0u;
        if ((k & 511) == 511) {
          if constexpr (EPI == kEpiMoves)
            flush_moves(out_moves + (k - 511), mine, 512, lane);
          else
            out_words[(k >> 4) - 31 + lane] = mine;
        }
      }
    }
    ++k;
  };

  // `cnt` (1 .. 8) diagonal moves at once: their bits are 0
  auto record_diags = [&](int cnt) {
    if constexpr (EPI == kEpiSummary) {
      n_t += cnt;
      run = 0;
      all_up = false;
      k += cnt;
    } else {
      const int k_new = k + cnt;
      if ((k >> 4) != (k_new >> 4)) {    // the 16-move word is complete
        if (lane == ((k >> 4) & 31)) mine = acc;
        acc = 0u;
        if (((k >> 4) & 31) == 31) {
          if constexpr (EPI == kEpiMoves)
            flush_moves(out_moves + (k & ~511), mine, 512, lane);
          else
            out_words[(k >> 4) - 31 + lane] = mine;
        }
      }
      k = k_new;
    }
  };

  // 32 of the 64 held words, lane 16 getting the word at `idx` (lanes
  // whose word would lie outside the 64 get one that is never looked at)
  auto window32 = [&](uint32_t lo_half, uint32_t hi_half, int idx) {
    const int from = idx - 16 + lane;
    const uint32_t v0 = __shfl_sync(kFull, lo_half, from & 31);
    const uint32_t v1 = __shfl_sync(kFull, hi_half, from & 31);
    return (from & 32) ? v1 : v0;
  };
  // the 64 words from `base` hold every band cell of w - 8 .. w + 8
  auto holds = [&](int base, int w) {
    return base <= max(w - 8, 0) && base + 63 >= min(w + 8, W - 1);
  };
  const int r_steady = (W + 16) / 16;    // the first row with lo >= 1

  bool stopped = false;
  while (k < steps && !stopped) {
    const int d = i + j;
    const int dc = d < 0 ? 0 : (d > Dmax - 1 ? Dmax - 1 : d);
    const int lo = band_lo(dc, W);
    int w = i - lo;
    w = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
    if (i <= 0 && j <= 0) break;         // MOVE_NONE from here on
    const int r = dc >> 4;
    if (r != r_cur || static_cast<unsigned>(w - wb_cur) >= 64u) {
      int base = w - 40;                 // covers w - 40 .. w + 23
      base = base < 0 ? 0 : (base > wb_max ? wb_max : base);
      if (r == r_nxt && static_cast<unsigned>(w - wb_nxt) < 64u) {
        c0 = n0;
        c1 = n1;
        wb_cur = wb_nxt;
      } else {
        const uint32_t* src = bp_p + r * row + base;
        c0 = !NARROW || lane < W ? __ldg(src + lane) : 0u;
        c1 = base + 32 + lane < W ? __ldg(src + 32 + lane) : 0u;
        wb_cur = base;
      }
      r_cur = r;
      r_nxt = r - 1;                     // the row the walk enters next
      wb_nxt = base;
      if (r_nxt >= 0) {
        const uint32_t* src = bp_p + r_nxt * row + base;
        n0 = !NARROW || lane < W ? __ldg(src + lane) : 0u;
        n1 = base + 32 + lane < W ? __ldg(src + 32 + lane) : 0u;
      }
    }
    const int idx = w - wb_cur;
    int kk = dc & 15;

    // The steady walk: block row after block row in one tight loop, as
    // long as nothing is clipped: d and w are as computed, lo >= 1 on
    // the whole row (so i >= 1, a diagonal move keeps w, and up / left
    // move w by (d & 1) - 1 / (d & 1), at most 8 either way over a row),
    // the band cells among w - 8 .. w + 8 are among the 64 words held (a
    // 32-word window is cut from them), and w stays in the band (looked at
    // after every move).  Anything else goes back to the general step.
    if (d == dc && w == i - lo && r >= r_steady && holds(wb_cur, w)) {
      int rr = r;                        // the walk's row; d = 16 rr + kk
      uint32_t cw = window32(c0, c1, idx);   // words w - 16 .. w + 15
      int pos = 16;                      // w's place in cw
      bool in_band = true;
      for (;;) {
        do {
          const uint32_t word = __shfl_sync(kFull, cw, pos);
          // a run of diagonal moves stays in this cell: its moves on the
          // antidiagonals kk, kk - 2, ... are fields of this one word.
          // The highest nonzero field of kk's parity at or below kk ends
          // the run.
          const uint32_t nonzero = (word | (word >> 1)) & 0x55555555u &
                                   ((kk & 1) ? 0x44444444u : 0x11111111u) &
                                   low_bits(kk + 1);
          const int t_stop =
              nonzero ? (31 - __clz(nonzero)) >> 1 : (kk & 1) - 2;
          int cnt = (kk - t_stop) >> 1;  // diagonal moves before it
          cnt = min(cnt, steps - k);
          if (cnt > 0) {
            record_diags(cnt);
            kk -= 2 * cnt;
            i -= cnt;
            j -= cnt;
            if (kk < 0 || k >= steps) break;
          }
          const int mv = (word >> (2 * kk)) & 3;
          if (mv == kMoveNone) {
            stopped = true;
            break;
          }
          record(mv);
          const int up = mv == kMoveUp ? 1 : 0;
          pos += (kk & 1) - up;          // kk & 1 is d & 1: 16 rr is even
          w += (kk & 1) - up;
          kk -= 1;
          i -= up;
          j -= 1 - up;
          in_band = static_cast<unsigned>(w) < static_cast<unsigned>(W);
        } while (kk >= 0 && k < steps && in_band);
        if (stopped || k >= steps || !in_band) break;
        // into the row below, whose window was asked for a row ago
        const int idx_n = w - wb_nxt;
        if (rr - 1 < r_steady || rr - 1 != r_nxt || !holds(wb_nxt, w)) break;
        rr -= 1;
        kk += 16;
        cw = window32(n0, n1, idx_n);
        pos = 16;
        c0 = n0;
        c1 = n1;
        wb_cur = wb_nxt;
        r_cur = rr;
        r_nxt = rr - 1;                  // >= 0: rr >= r_steady >= 1
        int base = w - 40;
        base = base < 0 ? 0 : (base > wb_max ? wb_max : base);
        wb_nxt = base;
        const uint32_t* src = bp_p + r_nxt * row + base;
        n0 = !NARROW || lane < W ? __ldg(src + lane) : 0u;
        n1 = base + 32 + lane < W ? __ldg(src + 32 + lane) : 0u;
      }
      continue;  // stopped, or on with the general step (which clips w)
    }

    const uint32_t word = __shfl_sync(kFull, idx < 32 ? c0 : c1, idx & 31);
    const int mv = (word >> (2 * kk)) & 3;
    // MOVE_NONE leaves (i, j) unchanged, so every later step repeats it
    if (mv == kMoveNone) break;
    record(mv);
    i -= mv <= kMoveUp ? 1 : 0;
    j -= (mv & 1) == 0 ? 1 : 0;
  }

  // k moves were taken; everything from k on is MOVE_NONE
  if constexpr (EPI == kEpiSummary) {
    if (lane == 0) {
      int32_t* o = static_cast<int32_t*>(out_v) + static_cast<size_t>(p) * 7;
      o[0] = dist[p];
      o[1] = j0;
      o[2] = n_t;
      o[3] = run;      // the up run that closes the valid prefix
      o[4] = trail;    // the up run that opens it
      o[5] = n_up;
      o[6] = i0;
    }
  } else {
    const int done = k & ~511;           // moves already flushed
    if ((k & 15) != 0) {
      if constexpr (EPI == kEpiPacked) acc |= ~low_bits(k & 15);
      if (lane == ((k >> 4) & 31)) mine = acc;
    }
    if constexpr (EPI == kEpiMoves) {
      flush_moves(out_moves + done, mine, k - done, lane);
      fill_none(out_moves + k, steps - k, lane);
    } else {
      const int kw = (k + 15) >> 4;      // words that hold a move
      if (lane < kw - (done >> 4)) out_words[(done >> 4) + lane] = mine;
      for (int g = kw + lane; g < K; g += 32) out_words[g] = kFull;
      if (lane == 0) out_words[K] = static_cast<uint32_t>(dist[p]);
      if (lane == 1) out_words[K + 1] = static_cast<uint32_t>(i0);
      if (lane == 2) out_words[K + 2] = static_cast<uint32_t>(j0);
    }
  }
}

template <int C, int NW, bool RAGGED>
cudaError_t launch_wavefront(const int8_t* qg, const int8_t* trg,
                             const int32_t* n, const int32_t* m, int P,
                             int LQG, int LTG, int Lt, int G, int Dmax, int W,
                             int mode, uint32_t* bp, int32_t* dist,
                             int32_t* end_i, int32_t* end_j,
                             cudaStream_t stream) {
  auto kernel = banded_wavefront_kernel<C, NW, RAGGED>;
  size_t smem = static_cast<size_t>((LQG + 15) & ~15) +
                static_cast<size_t>((LTG + 15) & ~15);
  const int staged = smem <= static_cast<size_t>(kStageLimit) ? 1 : 0;
  if (!staged) smem = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(P), dim3(32 * NW), smem, stream>>>(
      qg, trg, n, m, P, LQG, LTG, Lt, G, Dmax, W, mode, staged, bp, dist,
      end_i, end_j);
  return cudaGetLastError();
}

struct WavefrontArgs {
  const int8_t* qg;
  const int8_t* trg;
  const int32_t* n;
  const int32_t* m;
  int P, LQG, LTG, Lt, G, Dmax, W, mode;
  uint32_t* bp;
  int32_t* dist;
  int32_t* end_i;
  int32_t* end_j;
  cudaStream_t stream;
};

template <int C, int NW, bool RAGGED>
cudaError_t launch_args(const WavefrontArgs& a) {
  return launch_wavefront<C, NW, RAGGED>(a.qg, a.trg, a.n, a.m, a.P, a.LQG,
                                         a.LTG, a.Lt, a.G, a.Dmax, a.W,
                                         a.mode, a.bp, a.dist, a.end_i,
                                         a.end_j, a.stream);
}

// the layout (C, NW) exactly W wide
template <int C, int NW>
cudaError_t launch_exact(const WavefrontArgs& a) {
  if (a.W != 32 * C * NW) return cudaErrorInvalidValue;
  return launch_args<C, NW, false>(a);
}

// the layout (C, NW) exactly W wide, or its ragged build for a narrower band
template <int C, int NW>
cudaError_t launch_layout(const WavefrontArgs& a) {
  if (a.W < 1 || a.W > 32 * C * NW) return cudaErrorInvalidValue;
  if (a.W == 32 * C * NW) return launch_args<C, NW, false>(a);
  return launch_args<C, NW, true>(a);
}

}  // namespace

// The built layouts, each exact and ragged: a lane a cell below W = 128;
// 4 warps a pair and W / 128 cells a lane from 128 to 896 (at 256 and 512
// the fastest measured, see the note at the head; at 768 3 cells and 8
// warps tie with it); from 1024 on the fastest of the candidates of
// scripts/tune_banded.py --layouts, 4, 6, 4, 6 and 8 cells a lane on 8, 8,
// 16, 16 and 16 warps (1024 / 1536 / 2048 / 3072 / 4096; at 1024 four
// cells beat eight by 15%: 150 registers a thread at eight).  A band
// width W runs on the narrowest layout at least W wide.
extern "C" int fu_wavefront_layout_width(int W) {
  static const int kWidths[] = {32,  64,  128, 256,  384,  512,  640,
                                768, 896, 1024, 1536, 2048, 3072, 4096};
  for (int wp : kWidths)
    if (W >= 1 && W <= wp) return wp;
  return 0;
}

extern "C" int fu_banded_wavefront(const void* qg, const void* trg,
                                   const void* n, const void* m, int P,
                                   int LQG, int LTG, int Lt, int G,
                                   int Dmax, int W, int mode, void* bp,
                                   void* dist, void* end_i, void* end_j,
                                   void* stream) {
  const WavefrontArgs a{static_cast<const int8_t*>(qg),
                        static_cast<const int8_t*>(trg),
                        static_cast<const int32_t*>(n),
                        static_cast<const int32_t*>(m),
                        P, LQG, LTG, Lt, G, Dmax, W, mode,
                        static_cast<uint32_t*>(bp),
                        static_cast<int32_t*>(dist),
                        static_cast<int32_t*>(end_i),
                        static_cast<int32_t*>(end_j),
                        static_cast<cudaStream_t>(stream)};
  switch (fu_wavefront_layout_width(W)) {
    case 32: return launch_layout<1, 1>(a);
    case 64: return launch_layout<1, 2>(a);
    case 128: return launch_layout<1, 4>(a);
    case 256: return launch_layout<2, 4>(a);
    case 384: return launch_layout<3, 4>(a);
    case 512: return launch_layout<4, 4>(a);
    case 640: return launch_layout<5, 4>(a);
    case 768: return launch_layout<6, 4>(a);
    case 896: return launch_layout<7, 4>(a);
    case 1024: return launch_layout<4, 8>(a);
    case 1536: return launch_layout<6, 8>(a);
    case 2048: return launch_layout<4, 16>(a);
    case 3072: return launch_layout<6, 16>(a);
    case 4096: return launch_layout<8, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

#ifdef FU_WAVEFRONT_CANDIDATES
// Candidate layouts of the wide bands, for timing them against each other
// (scripts/tune_banded.py --layouts builds this source once more with
// -DFU_WAVEFRONT_CANDIDATES): W must equal 32 C NW.
extern "C" int fu_banded_wavefront_layout(int C, int NW, const void* qg,
                                          const void* trg, const void* n,
                                          const void* m, int P, int LQG,
                                          int LTG, int Lt, int G, int Dmax,
                                          int W, int mode, void* bp,
                                          void* dist, void* end_i,
                                          void* end_j, void* stream) {
  const WavefrontArgs a{static_cast<const int8_t*>(qg),
                        static_cast<const int8_t*>(trg),
                        static_cast<const int32_t*>(n),
                        static_cast<const int32_t*>(m),
                        P, LQG, LTG, Lt, G, Dmax, W, mode,
                        static_cast<uint32_t*>(bp),
                        static_cast<int32_t*>(dist),
                        static_cast<int32_t*>(end_i),
                        static_cast<int32_t*>(end_j),
                        static_cast<cudaStream_t>(stream)};
  switch (C * 100 + NW) {
    case 6 * 100 + 4: return launch_exact<6, 4>(a);    // 768
    case 3 * 100 + 8: return launch_exact<3, 8>(a);
    case 8 * 100 + 4: return launch_exact<8, 4>(a);    // 1024
    case 4 * 100 + 8: return launch_exact<4, 8>(a);
    case 6 * 100 + 8: return launch_exact<6, 8>(a);    // 1536
    case 3 * 100 + 16: return launch_exact<3, 16>(a);
    case 8 * 100 + 8: return launch_exact<8, 8>(a);    // 2048
    case 4 * 100 + 16: return launch_exact<4, 16>(a);
    case 2 * 100 + 32: return launch_exact<2, 32>(a);
    case 6 * 100 + 16: return launch_exact<6, 16>(a);  // 3072
    case 3 * 100 + 32: return launch_exact<3, 32>(a);
    case 8 * 100 + 16: return launch_exact<8, 16>(a);  // 4096
    case 4 * 100 + 32: return launch_exact<4, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}
#endif

// epilogue 0: out (P, steps) int8 moves in reverse order; 1: out
// (P, ceil(steps/16) + 3) int32, the packed moves then dist, end_i, end_j;
// 2: out (P, 7) int32 summary.  dist is read by epilogues 1 and 2 only.
extern "C" int fu_traceback(const void* bp, int P, int W, int Dmax,
                            const void* end_i, const void* end_j, int steps,
                            void* out, void* stream, int epilogue,
                            const void* dist) {
  const auto* bp32 = static_cast<const uint32_t*>(bp);
  const auto* ei = static_cast<const int32_t*>(end_i);
  const auto* ej = static_cast<const int32_t*>(end_j);
  const auto* d32 = static_cast<const int32_t*>(dist);
  auto s = static_cast<cudaStream_t>(stream);
  if (W < 1 || (epilogue != kEpiMoves && dist == nullptr))
    return cudaErrorInvalidValue;
#define FU_TRACEBACK(EPI)                                                \
  if (W < 32)                                                            \
    traceback_kernel<EPI, true><<<P, 32, 0, s>>>(bp32, P, W, Dmax, ei, ej, \
                                                d32, steps, out);        \
  else                                                                   \
    traceback_kernel<EPI, false><<<P, 32, 0, s>>>(bp32, P, W, Dmax, ei,  \
                                                 ej, d32, steps, out)
  switch (epilogue) {
    case kEpiMoves:
      FU_TRACEBACK(kEpiMoves);
      break;
    case kEpiPacked:
      FU_TRACEBACK(kEpiPacked);
      break;
    case kEpiSummary:
      FU_TRACEBACK(kEpiSummary);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef FU_TRACEBACK
  return static_cast<int>(cudaGetLastError());
}
