// Banded edit-distance wavefront and traceback for Hopper (sm_90a).
//
// Kernel 1, banded_wavefront, replaces the TPU kernel
// falcon_unzip_tpu/ops/pallas_align.py::_kernel (launched by
// pallas_banded_align).  It is bit-exact to the scan path
// falcon_unzip_tpu/ops/banded_align.py::banded_align_batch: the same
// fixed-width slope-1/2 band, lo(d) = max(0, (d+1)/2 - W/2), unit costs,
// an N/pad base never matches (q < 4), ties diag < up < left, modes
// global / qglocal / tglocal, INF = 1 << 20.
//
//   Layout: one warp per (query, target) pair; lane L holds the C = W/32
//   contiguous band cells w = L*C .. L*C + C-1 of antidiagonals d, d-1 and
//   d-2 in registers.  The +-1 band shifts cross lanes with
//   __shfl_up_sync / __shfl_down_sync, INF-filled at w = 0 and w = W-1.
//   Bases are read from the guarded rows built by prepare_batch (every
//   read lies inside LQG / LTG; the wrapper checks the bounds).  Moves
//   (2 bits per cell) accumulate in a register word per cell over 16
//   antidiagonals and are stored as one int32 per cell every 16 steps,
//   giving the packed layout bp[d / 16][p][w], bits 2*(d % 16).
//
//   What bounds it: each antidiagonal is a dependent step (the recurrence
//   needs d-1 and d-2), so one pair is latency-bound on its shuffle /
//   min chain; throughput comes from many pairs (warps) in flight.  The
//   DP state never leaves registers; the only device-memory traffic is
//   the base reads (L1-resident: the windows slide by at most one byte
//   per step) and the packed moves, W/4 bytes per antidiagonal per pair.
//
// Kernel 2, traceback, replaces the lax.scan traceback_batch of
// falcon_unzip_tpu/ops/banded_align.py (an XLA loop, not Pallas).  One
// thread per pair walks from (end_i, end_j) over the packed moves with
// the scan's clipping of d and w, writing moves in reverse order padded
// with MOVE_NONE.  It is bound by the latency of one dependent load per
// step; pairs run in parallel.
//
// Both functions have a plain C interface (loaded with ctypes), launch on
// the stream they are given and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kMoveDiag = 0;
constexpr int kMoveUp = 1;
constexpr int kMoveLeft = 2;
constexpr int kMoveNone = 3;
constexpr int kModeGlobal = 0;
constexpr int kModeTglocal = 2;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int band_lo(int d, int W) {
  const int x = (d + 1) / 2 - W / 2;
  return x > 0 ? x : 0;
}

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_wavefront_kernel(const int8_t* __restrict__ qg,
                        const int8_t* __restrict__ trg,
                        const int32_t* __restrict__ n_arr,
                        const int32_t* __restrict__ m_arr,
                        int P, int LQG, int LTG, int Lt, int G, int Dmax,
                        int mode, uint32_t* __restrict__ bp,
                        int32_t* __restrict__ dist,
                        int32_t* __restrict__ end_i,
                        int32_t* __restrict__ end_j) {
  constexpr int W = 32 * C;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // whole warp leaves together
  const int n = n_arr[p];
  const int m = m_arr[p];
  const int8_t* q = qg + static_cast<size_t>(p) * LQG;
  const int8_t* t = trg + static_cast<size_t>(p) * LTG;
  const int w0 = lane * C;

  int V1[C], V2[C], V[C];
  uint32_t pack[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    V1[c] = kInf;
    V2[c] = kInf;
    pack[c] = 0u;
  }
  int best = kInf;     // lane-local first strict minimum on row i == n
  int best_d = -1;
  int final_v = kInf;  // global mode: V at (n, m)

  for (int d = 0; d < Dmax; ++d) {
    const int lo = band_lo(d, W);
    const int s1 = lo - band_lo(d - 1, W);
    const int s2 = lo - band_lo(d - 2, W);
    int v1_prev = __shfl_up_sync(kFull, V1[C - 1], 1);
    int v1_next = __shfl_down_sync(kFull, V1[0], 1);
    int v2_prev = __shfl_up_sync(kFull, V2[C - 1], 1);
    if (lane == 0) {
      v1_prev = kInf;
      v2_prev = kInf;
    }
    if (lane == 31) v1_next = kInf;
    const int8_t* qrow = q + lo + w0;
    const int8_t* trow = t + (G + Lt - d + lo + w0);
    const int shift = 2 * (d & 15);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v1m = c == 0 ? v1_prev : V1[c - 1];
      const int v1p = c == C - 1 ? v1_next : V1[c + 1];
      const int v2m = c == 0 ? v2_prev : V2[c - 1];
      const int up = s1 == 0 ? v1m : V1[c];
      const int left = s1 == 0 ? V1[c] : v1p;
      const int diag = s2 == 0 ? v2m : V2[c];
      const int i = lo + w0 + c;
      const int j = d - i;
      const int qi = __ldg(qrow + c);
      const int tj = __ldg(trow + c);
      const int sub = (qi == tj && qi < 4) ? 0 : 1;
      const int cd = (i >= 1 && j >= 1) ? diag + sub : kInf;
      const int cu = i >= 1 ? up + 1 : kInf;
      const int cl = j >= 1 ? left + 1 : kInf;
      int v = min(min(cd, cu), cl);
      const int mv = cd <= v ? kMoveDiag : (cu <= v ? kMoveUp : kMoveLeft);
      const bool origin = mode == kModeTglocal ? (i == 0 && j >= 0)
                                               : (i == 0 && j == 0);
      const bool valid = i >= 0 && i <= n && j >= 0 && j <= m;
      if (origin) v = 0;
      if (!valid) v = kInf;
      v = min(v, kInf);
      const int b = (valid && !origin && v < kInf) ? mv : kMoveNone;
      pack[c] |= static_cast<uint32_t>(b) << shift;
      if (valid && i == n && v < best) {
        best = v;
        best_d = d;
      }
      V[c] = v;
    }
    if (d == n + m) {  // warp-uniform: capture V[clip(n - lo, 0, W-1)]
      int wnm = n - lo;
      wnm = wnm < 0 ? 0 : (wnm > W - 1 ? W - 1 : wnm);
      int mine = kInf;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (w0 + c == wnm) mine = V[c];
      final_v = __shfl_sync(kFull, mine, wnm / C);
    }
    if ((d & 15) == 15 || d == Dmax - 1) {
      if (bp != nullptr) {
        uint32_t* dst =
            bp + (static_cast<size_t>(d >> 4) * P + p) * W + w0;
        if constexpr (C % 4 == 0) {
#pragma unroll
          for (int c = 0; c < C; c += 4)
            *reinterpret_cast<uint4*>(dst + c) =
                make_uint4(pack[c], pack[c + 1], pack[c + 2], pack[c + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) dst[c] = pack[c];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) pack[c] = 0u;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      V2[c] = V1[c];
      V1[c] = V[c];
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
    end_i[p] = n;
    if (mode == kModeGlobal) {
      dist[p] = final_v;
      end_j[p] = m;
    } else {
      dist[p] = best;
      end_j[p] = best_d >= 0 ? best_d - n : -1;
    }
  }
}

__global__ void traceback_kernel(const uint32_t* __restrict__ bp, int P,
                                 int W, int Dmax,
                                 const int32_t* __restrict__ end_i,
                                 const int32_t* __restrict__ end_j,
                                 int steps, int8_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int i = end_i[p];
  int j = end_j[p];
  int8_t* o = out + static_cast<size_t>(p) * steps;
  int k = 0;
  for (; k < steps; ++k) {
    const int d = i + j;
    const int dc = d < 0 ? 0 : (d > Dmax - 1 ? Dmax - 1 : d);
    const int lo = band_lo(dc, W);
    int w = i - lo;
    w = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
    int mv = kMoveNone;
    if (!(i <= 0 && j <= 0))
      mv = (bp[(static_cast<size_t>(dc >> 4) * P + p) * W + w] >>
            (2 * (dc & 15))) & 3;
    o[k] = static_cast<int8_t>(mv);
    // MOVE_NONE leaves (i, j) unchanged, so every later step repeats it
    if (mv == kMoveNone) break;
    i -= (mv == kMoveDiag || mv == kMoveUp) ? 1 : 0;
    j -= (mv == kMoveDiag || mv == kMoveLeft) ? 1 : 0;
  }
  for (++k; k < steps; ++k) o[k] = static_cast<int8_t>(kMoveNone);
}

template <int C>
cudaError_t launch_wavefront(const int8_t* qg, const int8_t* trg,
                             const int32_t* n, const int32_t* m, int P,
                             int LQG, int LTG, int Lt, int G, int Dmax,
                             int mode, uint32_t* bp, int32_t* dist,
                             int32_t* end_i, int32_t* end_j,
                             cudaStream_t stream) {
  const dim3 grid((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  banded_wavefront_kernel<C><<<grid, block, 0, stream>>>(
      qg, trg, n, m, P, LQG, LTG, Lt, G, Dmax, mode, bp, dist, end_i,
      end_j);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fu_banded_wavefront(const void* qg, const void* trg,
                                   const void* n, const void* m, int P,
                                   int LQG, int LTG, int Lt, int G,
                                   int Dmax, int W, int mode, void* bp,
                                   void* dist, void* end_i, void* end_j,
                                   void* stream) {
  const auto* q8 = static_cast<const int8_t*>(qg);
  const auto* t8 = static_cast<const int8_t*>(trg);
  const auto* n32 = static_cast<const int32_t*>(n);
  const auto* m32 = static_cast<const int32_t*>(m);
  auto* bp32 = static_cast<uint32_t*>(bp);
  auto* d32 = static_cast<int32_t*>(dist);
  auto* ei = static_cast<int32_t*>(end_i);
  auto* ej = static_cast<int32_t*>(end_j);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 32:
      return launch_wavefront<1>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                                 mode, bp32, d32, ei, ej, s);
    case 64:
      return launch_wavefront<2>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                                 mode, bp32, d32, ei, ej, s);
    case 128:
      return launch_wavefront<4>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                                 mode, bp32, d32, ei, ej, s);
    case 256:
      return launch_wavefront<8>(q8, t8, n32, m32, P, LQG, LTG, Lt, G, Dmax,
                                 mode, bp32, d32, ei, ej, s);
    case 512:
      return launch_wavefront<16>(q8, t8, n32, m32, P, LQG, LTG, Lt, G,
                                  Dmax, mode, bp32, d32, ei, ej, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int fu_traceback(const void* bp, int P, int W, int Dmax,
                            const void* end_i, const void* end_j, int steps,
                            void* out, void* stream) {
  const int threads = 128;
  const dim3 grid((P + threads - 1) / threads);
  traceback_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bp), P, W, Dmax,
      static_cast<const int32_t*>(end_i), static_cast<const int32_t*>(end_j),
      steps, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
