// Row-form banded Smith-Waterman forward fill for Hopper (sm_90a).
//
// Replaces gam_ngs_tpu/ops/bsw_pallas.py::_build_kernel (:48, the exact
// row body, K3), _build_lean_kernel (:220, the lean suffix, K4) and the
// two-call driver pallas_forward_raw (:335) in one kernel.  The cell
// semantics are bsw_ref.fill_matrix (banded_smith_waterman.cc:70-214)
// with the reference's traceback tie-break stored as 2-bit directions;
// the per-lane cases and tie-breaks are K3's (:121-198) and K4's
// (:296-322) as they are written there.
//
// One block solves one problem, looping over rows i.  Thread t holds R
// consecutive band lanes j = t*R .. t*R+R-1 (2*band+1 lanes in all; R = 1
// up to band 511, 2 up to 1023, 4 up to 2047, 8 up to 4095, so a block
// never passes 1024 threads).  Cell (i, j) sits at A position
// begin_a - band + i + j; its diag and up neighbours are lanes j and j+1
// of row i-1, read from shared memory after a barrier.  The left
// neighbour (i, j-1) is in the same row:
//   row[j] = max(c[j], s[j] + row[j-1])
// with c the cell's best diag/up/fresh value and s its left gap (GAP, 0
// on row 0, or NEG where the left move is barred).  The maps
// f_j(x) = max(c_j, s_j + x) compose associatively,
//   (c_l, s_l) then (c, s) = (max(c, s + c_l), s_l + s),
// so a row is an inclusive scan.  A thread first composes its own R maps
// in order; warp shuffles scan those totals within 32 threads, then the
// warp totals in shared memory are scanned again by shuffles in every
// warp.  A thread then applies the composition of every thread before it
// to its R lanes in order.  Every composition clamps at NEG: blocked
// lanes carry slope NEG, and unclamped sums of them would wrap int32.
// R = 1 has a kernel of its own (row_forward_kernel), whose inclusive
// scan is the row itself: the R-lane template run at R = 1 took 14% more
// time at band 150 (tools/kernel_ab.py --row, B=64, XW 4096: 2.84 vs
// 2.45-2.50 ms on an H100, 700 W), and the default band is 150.
//
// Rows i <= band, or every row when begin_a < 0 (the reference's tail
// windows), run the exact body: row-0 starts, pos == 0 fresh and forced
// starts, force_start within FORCE_MAXGAP_LEN, and force_start lanes past
// a_len invalid.  Later rows of a begin_a >= 0 problem hold no pos <= 0
// lane, so the lean body runs there: every valid lane takes the left gap,
// and the scan is a plain prefix max of c[k] - GAP*k.  Invalid lanes hold
// 0 in the row.  A problem stops at its x_size rounded up to 16 rows; the
// wrapper zero-fills the outputs, so unwritten words read 0.
//
// Outputs:
//   dirs      (B, XW/16, 2*band+1) int32: row i of lane j at word i/16,
//             bits 2*(i & 15)
//   last_row  (B, 2*band+1) int32: row x_size-1
//   diag      (B, 2*band+1) int32: lane j holds the pos_a == end_a cell
//             of row end_a - begin_a + band - j
//
// Bound on this card: the dependent chain of a row, not bytes (the
// directions are 0.25 B per cell): two barriers, two shuffle scans of
// five levels and about 40 int32 operations per lane a thread holds, per
// row.  One block of up to 1024 threads per problem; the engine's
// max_batch of 64 fills at most 64 of the 132 SMs.
//
// TPU artefacts left behind: the 128-lane YP padding of the band, the
// aligned-superset lane_window + pltpu.roll character loads, the 0/1
// mk/sel mask arithmetic Mosaic required, the static tile_x unroll of
// 16 rows, and the carries (prev row, last row, diagonal) handed from
// the exact call to the lean call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0, kUp = 1, kLeft = 2;

// bsw_ref's scoring, passed in by the wrapper: SCORING_MATRIX's match,
// mismatch, N-N and N-other scores, GAP, FORCE_MAXGAP_LEN, and NEG (a
// value below every reachable cell score)
struct Scoring {
  int match, mismatch, nn, nx, gap, force_max_gap, neg;
};

__device__ __forceinline__ int nibble(const uint8_t* pk, int q) {
  return (__ldg(pk + (q >> 1)) >> ((q & 1) * 4)) & 15;
}

__device__ __forceinline__ int base_score(int ac, int bc, const Scoring& s) {
  const bool an = ac == 4, bn = bc == 4;
  if (an && bn) return s.nn;
  if (an || bn) return s.nx;
  return ac == bc ? s.match : s.mismatch;
}

// one band lane a thread (band <= 511)
__global__ void row_forward_kernel(
    const uint8_t* __restrict__ a_pk, const uint8_t* __restrict__ b_pk,
    const int* __restrict__ begin_a, const int* __restrict__ end_a,
    const int* __restrict__ a_len, const int* __restrict__ x_size,
    const int* __restrict__ force_start, int aw, int xw, int band, Scoring s,
    int* __restrict__ dirs, int* __restrict__ last_row,
    int* __restrict__ diag) {
  extern __shared__ int smem[];
  const int YS = 2 * band + 1, ymax = 2 * band;
  int* row_s = smem;           // YS + 1: the previous row, lane YS stays 0
  int* tot_c = smem + YS + 1;  // 32 warp totals (c part)
  int* tot_s = tot_c + 32;     // 32 warp totals (s part)
  const int b = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;
  const bool in_band = j < YS;
  const bool last = j == ymax, first = j == 0, mid = !first && !last;
  const unsigned full = 0xffffffffu;
  const int NEG = s.neg;

  const int ba = begin_a[b], ea = end_a[b], al = a_len[b], xs = x_size[b];
  const bool fs = force_start[b] != 0;
  const uint8_t* ap = a_pk + (size_t)b * (aw / 2);
  const uint8_t* bp = b_pk + (size_t)b * (xw / 2);
  int* dir_out = dirs + (size_t)b * (xw / 16) * YS;
  int* lr = last_row + (size_t)b * YS;
  int* dg = diag + (size_t)b * YS;

  const int stop = xs <= 0 ? 0 : min(xw, (xs + 15) / 16 * 16);
  const int exact_rows = ba < 0 ? stop : min(stop, band + 1);
  const int jd_base = ea - ba + band;  // diag lane of row i: jd_base - i
  for (int q = j; q < YS + 1; q += blockDim.x) row_s[q] = 0;
  __syncthreads();

  unsigned packed = 0;  // directions of up to 16 rows
  for (int i = 0; i < stop; ++i) {
    const bool exact = i < exact_rows;
    int prev = 0, prev_up = 0, sc = 0, pos = 0;
    if (in_band) {
      prev = row_s[j];
      prev_up = row_s[j + 1];
      sc = base_score(nibble(ap, i + j), nibble(bp, i), s);
      pos = ba - band + i + j;
    }
    const int up = last ? s.gap : prev_up + s.gap;
    const int diag_acc = prev + sc;
    const int base_gen = last ? diag_acc : max(diag_acc, up);
    // this lane's map (c, s) before the left dependency
    int c, sl;
    bool valid, pos0 = false;
    if (exact) {
      const bool valid_pos = pos >= 0 && pos < al;
      pos0 = pos == 0;
      int base;
      if (i == 0) {
        const bool cond_b = fs && pos > s.force_max_gap && pos < al;
        valid = (valid_pos && (!fs || pos <= s.force_max_gap)) || cond_b;
        base = cond_b ? sc : max(sc, s.gap);
        sl = (valid && pos > 0 && !first) ? 0 : NEG;
      } else {
        const bool fm_le = i <= s.force_max_gap;
        const bool fresh = pos0 && (!fs || fm_le);
        const bool forced = pos0 && fs && !fm_le;
        if (fresh)
          base = last ? max(sc, s.gap) : max(max(sc, up), s.gap);
        else if (forced)
          base = last ? sc : max(sc, up);
        else
          base = base_gen;
        valid = valid_pos;
        sl = (valid && !fresh && !forced && !first) ? s.gap : NEG;
      }
      valid = valid && in_band;
      c = valid ? base : 0;
      // warp level: inclusive composition over lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, c, d);
        const int s_l = __shfl_up_sync(full, sl, d);
        if (lane >= d) {
          c = max(c, max(sl + c_l, NEG));
          sl = max(s_l + sl, NEG);
        }
      }
      if (lane == 31) {
        tot_c[warp] = c;
        tot_s[warp] = sl;
      }
      __syncthreads();
      // block level: every warp scans the warp totals and applies the
      // composition of the warps before its own
      int tc = lane < nwarps ? tot_c[lane] : NEG;
      int ts = lane < nwarps ? tot_s[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, tc, d);
        const int s_l = __shfl_up_sync(full, ts, d);
        if (lane >= d) {
          tc = max(tc, max(ts + c_l, NEG));
          ts = max(s_l + ts, NEG);
        }
      }
      const int before = __shfl_sync(full, tc, (warp + 31) & 31);
      if (warp > 0) c = max(c, max(sl + before, NEG));
    } else {
      valid = in_band && pos < al;
      // prefix max of c[k] - GAP*k, then + GAP*j
      c = (valid ? base_gen : 0) - s.gap * j;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, c, d);
        if (lane >= d) c = max(c, c_l);
      }
      if (lane == 31) tot_c[warp] = c;
      __syncthreads();
      int tc = lane < nwarps ? tot_c[lane] : NEG;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, tc, d);
        if (lane >= d) tc = max(tc, c_l);
      }
      const int before = __shfl_sync(full, tc, (warp + 31) & 31);
      if (warp > 0) c = max(c, before);
      c += s.gap * j;
    }
    const int row = valid ? c : 0;

    int d;
    if (exact && pos0) {
      const bool left_blocked = fs && i > s.force_max_gap;
      d = row == sc ? kDiag
                    : ((last || (row == s.gap && !left_blocked)) ? kLeft
                                                                 : kUp);
    } else {
      int diag_t = diag_acc, up_t = up;
      if (exact && i == 0) {
        diag_t = sc;
        up_t = fs ? ((pos >= 0 && pos <= s.force_max_gap) ? s.gap : NEG)
                  : s.gap;
      }
      d = row == diag_t ? kDiag
                        : ((mid && row == up_t) ? kUp
                                                : (mid || last ? kLeft : kUp));
    }

    if (in_band) {
      if (j == jd_base - i) dg[j] = row;
      if (i == xs - 1) lr[j] = row;
      packed |= (unsigned)d << (2 * (i & 15));
      if ((i & 15) == 15) {
        dir_out[(size_t)(i >> 4) * YS + j] = (int)packed;
        packed = 0;
      }
      row_s[j] = row;  // every read of the previous row came before the
                       // barrier above
    }
    __syncthreads();
  }
}

// R = 2, 4 or 8 consecutive band lanes a thread; at most 1024 threads a
// block, so at most 64 registers a thread
template <int R>
__global__ void __launch_bounds__(1024) row_forward_lanes_kernel(
    const uint8_t* __restrict__ a_pk, const uint8_t* __restrict__ b_pk,
    const int* __restrict__ begin_a, const int* __restrict__ end_a,
    const int* __restrict__ a_len, const int* __restrict__ x_size,
    const int* __restrict__ force_start, int aw, int xw, int band, Scoring s,
    int* __restrict__ dirs, int* __restrict__ last_row,
    int* __restrict__ diag) {
  extern __shared__ int smem[];
  const int YS = 2 * band + 1, ymax = 2 * band;
  int* row_s = smem;           // YS + 1: the previous row, lane YS stays 0
  int* tot_c = smem + YS + 1;  // 32 warp totals (c part)
  int* tot_s = tot_c + 32;     // 32 warp totals (s part)
  const int b = blockIdx.x, t = threadIdx.x, j0 = t * R;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const unsigned full = 0xffffffffu;
  const int NEG = s.neg;

  const int ba = begin_a[b], ea = end_a[b], al = a_len[b], xs = x_size[b];
  const bool fs = force_start[b] != 0;
  const uint8_t* ap = a_pk + (size_t)b * (aw / 2);
  const uint8_t* bp = b_pk + (size_t)b * (xw / 2);
  int* dir_out = dirs + (size_t)b * (xw / 16) * YS;
  int* lr = last_row + (size_t)b * YS;
  int* dg = diag + (size_t)b * YS;

  const int stop = xs <= 0 ? 0 : min(xw, (xs + 15) / 16 * 16);
  const int exact_rows = ba < 0 ? stop : min(stop, band + 1);
  const int jd_base = ea - ba + band;  // diag lane of row i: jd_base - i
  for (int q = t; q < YS + 1; q += blockDim.x) row_s[q] = 0;
  __syncthreads();

  unsigned packed[R];  // each lane's directions of up to 16 rows
#pragma unroll
  for (int k = 0; k < R; ++k) packed[k] = 0;
  for (int i = 0; i < stop; ++i) {
    const bool exact = i < exact_rows;
    const int bc = nibble(bp, i);
    // the previous row at lanes j0 .. j0+R (lane j's diag, lane j-1's up)
    int prev[R + 1];
#pragma unroll
    for (int k = 0; k <= R; ++k) prev[k] = j0 + k < YS ? row_s[j0 + k] : 0;
    // each lane's map (c, s) before the left dependency, and what its
    // direction needs: its score, 4 bits a lane (the wrapper checks the
    // scores lie in [-8, 7]), its diag and up values, recomputed from the
    // previous row so that fewer registers live across the barriers
    int c[R], sl[R], row[R];
    bool valid[R];
    unsigned sc_pk = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = j0 + k;
      const int v = j < YS ? base_score(nibble(ap, i + j), bc, s) : 0;
      sc_pk |= (unsigned)(v + 8) << (4 * k);
    }
    const auto sc = [&](int k) { return (int)((sc_pk >> (4 * k)) & 15) - 8; };
    const auto dacc = [&](int k) { return prev[k] + sc(k); };
    const auto up = [&](int k) {
      return j0 + k == ymax ? s.gap : prev[k + 1] + s.gap;
    };
    if (exact) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int j = j0 + k;
        const bool in_band = j < YS, last = j == ymax, first = j == 0;
        const int pos = in_band ? ba - band + i + j : 0;
        const bool valid_pos = pos >= 0 && pos < al, pos0 = pos == 0;
        const int base_gen = last ? dacc(k) : max(dacc(k), up(k));
        int base;
        bool v;
        if (i == 0) {
          const bool cond_b = fs && pos > s.force_max_gap && pos < al;
          v = (valid_pos && (!fs || pos <= s.force_max_gap)) || cond_b;
          base = cond_b ? sc(k) : max(sc(k), s.gap);
          sl[k] = (v && pos > 0 && !first) ? 0 : NEG;
        } else {
          const bool fm_le = i <= s.force_max_gap;
          const bool fresh = pos0 && (!fs || fm_le);
          const bool forced = pos0 && fs && !fm_le;
          if (fresh)
            base = last ? max(sc(k), s.gap) : max(max(sc(k), up(k)), s.gap);
          else if (forced)
            base = last ? sc(k) : max(sc(k), up(k));
          else
            base = base_gen;
          v = valid_pos;
          sl[k] = (v && !fresh && !forced && !first) ? s.gap : NEG;
        }
        valid[k] = v && in_band;
        c[k] = valid[k] ? base : 0;
      }
      // this thread's R maps composed in order
      int C = c[0], S = sl[0];
#pragma unroll
      for (int k = 1; k < R; ++k) {
        C = max(c[k], max(sl[k] + C, NEG));
        S = max(S + sl[k], NEG);
      }
      // warp level: inclusive composition over threads
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, C, d);
        const int s_l = __shfl_up_sync(full, S, d);
        if (lane >= d) {
          C = max(C, max(S + c_l, NEG));
          S = max(s_l + S, NEG);
        }
      }
      if (lane == 31) {
        tot_c[warp] = C;
        tot_s[warp] = S;
      }
      __syncthreads();
      // block level: every warp scans the warp totals and applies the
      // composition of the warps before its own
      int tc = lane < nwarps ? tot_c[lane] : NEG;
      int ts = lane < nwarps ? tot_s[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, tc, d);
        const int s_l = __shfl_up_sync(full, ts, d);
        if (lane >= d) {
          tc = max(tc, max(ts + c_l, NEG));
          ts = max(s_l + ts, NEG);
        }
      }
      const int before = __shfl_sync(full, tc, (warp + 31) & 31);
      // the row at lane j0 - 1: the threads before this one, composed
      int x = __shfl_up_sync(full, C, 1), xs_l = __shfl_up_sync(full, S, 1);
      if (lane == 0) x = NEG, xs_l = 0;
      if (warp > 0) x = max(x, max(xs_l + before, NEG));
#pragma unroll
      for (int k = 0; k < R; ++k) {
        x = max(c[k], max(sl[k] + x, NEG));
        row[k] = valid[k] ? x : 0;
      }
    } else {
      // prefix max of c[k] - GAP*k, then + GAP*j
      int M = NEG;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int j = j0 + k;
        const bool last = j == ymax;
        valid[k] = j < YS && ba - band + i + j < al;
        c[k] = (valid[k] ? (last ? dacc(k) : max(dacc(k), up(k))) : 0) -
               s.gap * j;
        M = k == 0 ? c[k] : max(M, c[k]);
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, M, d);
        if (lane >= d) M = max(M, c_l);
      }
      if (lane == 31) tot_c[warp] = M;
      __syncthreads();
      int tc = lane < nwarps ? tot_c[lane] : NEG;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c_l = __shfl_up_sync(full, tc, d);
        if (lane >= d) tc = max(tc, c_l);
      }
      const int before = __shfl_sync(full, tc, (warp + 31) & 31);
      int x = __shfl_up_sync(full, M, 1);
      if (lane == 0) x = NEG;
      if (warp > 0) x = max(x, before);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        x = max(x, c[k]);
        row[k] = valid[k] ? x + s.gap * (j0 + k) : 0;
      }
    }

#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int j = j0 + k;
      const bool in_band = j < YS, last = j == ymax, first = j == 0;
      const bool mid = !first && !last;
      const int pos = in_band ? ba - band + i + j : 0;
      int d;
      if (exact && pos == 0) {
        const bool left_blocked = fs && i > s.force_max_gap;
        d = row[k] == sc(k)
                ? kDiag
                : ((last || (row[k] == s.gap && !left_blocked)) ? kLeft
                                                                : kUp);
      } else {
        int diag_t = dacc(k), up_t = up(k);
        if (exact && i == 0) {
          diag_t = sc(k);
          up_t = fs ? ((pos >= 0 && pos <= s.force_max_gap) ? s.gap : NEG)
                    : s.gap;
        }
        d = row[k] == diag_t
                ? kDiag
                : ((mid && row[k] == up_t) ? kUp
                                           : (mid || last ? kLeft : kUp));
      }
      if (in_band) {
        if (j == jd_base - i) dg[j] = row[k];
        if (i == xs - 1) lr[j] = row[k];
        packed[k] |= (unsigned)d << (2 * (i & 15));
        if ((i & 15) == 15) {
          dir_out[(size_t)(i >> 4) * YS + j] = (int)packed[k];
          packed[k] = 0;
        }
        row_s[j] = row[k];  // every read of the previous row came before
                            // the barrier above
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int bsw_row_forward(const void* a_pk, const void* b_pk,
                               const void* begin_a, const void* end_a,
                               const void* a_len, const void* x_size,
                               const void* force_start, int B, int aw,
                               int xw, int band, int match, int mismatch, int nn,
                               int nx, int gap, int force_max_gap, int neg,
                               void* dirs, void* last_row, void* diag,
                               void* stream) {
  if (band < 0 || band > 4095) return (int)cudaErrorInvalidValue;
  const int YS = 2 * band + 1;
  const Scoring s{match, mismatch, nn, nx, gap, force_max_gap, neg};
  // lanes a thread: the fewest that keep the block at 1024 threads
  const int R = band <= 511 ? 1 : band <= 1023 ? 2 : band <= 2047 ? 4 : 8;
  const int threads = ((YS + R - 1) / R + 31) / 32 * 32;
  const size_t shmem = (YS + 1 + 64) * sizeof(int);
  auto kernel = R == 1   ? row_forward_kernel
                : R == 2 ? row_forward_lanes_kernel<2>
                : R == 4 ? row_forward_lanes_kernel<4>
                         : row_forward_lanes_kernel<8>;
  kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      (const uint8_t*)a_pk, (const uint8_t*)b_pk, (const int*)begin_a,
      (const int*)end_a, (const int*)a_len, (const int*)x_size,
      (const int*)force_start, aw, xw, band, s, (int*)dirs, (int*)last_row,
      (int*)diag);
  return (int)cudaGetLastError();
}
