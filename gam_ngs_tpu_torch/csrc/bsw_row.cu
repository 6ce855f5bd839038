// Row-form banded Smith-Waterman forward fill for Hopper (sm_90a).
//
// Replaces gam_ngs_tpu/ops/bsw_pallas.py::_build_kernel (:48, the exact
// row body, K3), _build_lean_kernel (:220, the lean suffix, K4) and the
// two-call driver pallas_forward_raw (:335).  The cell semantics are
// bsw_ref.fill_matrix (banded_smith_waterman.cc:70-214) with the
// reference's traceback tie-break stored as 2-bit directions; the
// per-lane cases and tie-breaks are K3's (:121-198) and K4's (:296-322)
// as they are written there.
//
// A problem loops over rows i; row i has 2*band+1 band lanes j, and cell
// (i, j) sits at A position begin_a - band + i + j (a window code i + j).
// Its diag and up neighbours are lanes j and j+1 of row i-1.  The left
// neighbour (i, j-1) is in the same row:
//   row[j] = max(c[j], s[j] + row[j-1])
// with c the cell's best diag/up/fresh value and s its left gap (GAP, 0
// on row 0, or NEG where the left move is barred).  The maps
// f_j(x) = max(c_j, s_j + x) compose associatively,
//   (c_l, s_l) then (c, s) = (max(c, s + c_l), s_l + s),
// so a row is an inclusive scan.  Every composition clamps at NEG:
// blocked lanes carry slope NEG, and unclamped sums of them would wrap
// int32.
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
// Band <= 159: row_warp_kernel<R>, one warp per problem and one problem
// a block (a 64-problem chunk spreads over 64 of the 132 SMs, and the
// engine's 4 streams put a round's other chunks on the rest; two a block
// would leave a chunk on 32).  Thread t holds the R consecutive lanes
// j = t*R .. t*R+R-1 in registers, R = ceil((2*band+1)/32) rounded up to
// an instantiated width (10 at band 150); lanes past 2*band are padding
// that no band lane reads.  The previous row stays in registers: lane j's
// diag is its own previous value, its up the previous value of lane j+1,
// in the thread but for the top lane, which takes thread t+1's bottom
// lane by one shuffle; lane 2*band's up gap is NEG, so its up is never
// taken.  No barrier and no shared row sit in the row loop.
//
// Row 0 runs every case of the reference per lane, with the (c, s) scan:
// the thread's R maps in order, a 5-level shuffle scan of the thread
// totals, one shuffle for the exclusive prefix, the lanes again.  Every
// later row runs the lean recurrence, whose scan is a prefix max: the
// thread's lane maxima, an exclusive 6-shuffle max scan, the lanes.  For
// a row i >= 1 the exact body differs from the lean one only by lane
// position pos: the lanes at pos < 0 form a prefix that holds 0 and that
// the pos == 0 lane, which starts afresh, never lets through; the lanes
// at pos >= a_len form a suffix that holds 0 and that reaches no valid
// lane.  So a block of 16 rows that holds such a lane (rows up to
// band - begin_a, or from a_len - begin_a - band), the last row or a
// pos == end_a cell runs a checked copy with those cases and the records
// per lane; every other block runs without them.
//
// The rows run in blocks of 16, unrolled: at the start of a block a
// thread reads the R+15 a codes of its lanes (loaded a block ahead) and
// looks up each one's score vector, the scores against b codes 0-7,
// 4 bits each above the lowest score (the engine's b codes are 0-4); a
// cell's score is then a shift and a mask.
//
// Widths R: 1, 2, 4, 6, 8, 10 (up to bands 15, 31, 63, 95, 127, 159):
// steps of 2 keep the default band (150, R = 10) and its neighbours
// within one lane of the least R.  A thread keeps each lane's diag and
// up across the scan and takes its lane maximum by a tree; ptxas spills
// nothing (80 to 255 registers).
//
// Band 160 .. 511: row_forward_kernel, one block per problem and one
// lane a thread, the previous row in shared memory, the warp totals
// scanned again across the block, two barriers a row (a kernel of its
// own: the R-lane template below run at one lane took 14% more time at
// band 150, B=64, XW 4096, 2.84 against 2.45-2.50 ms).  Wider warp
// instances spilled at 255 registers, so this kernel keeps those bands
// (B=64, XW 4096, tools/kernel_ab.py --row on an NVIDIA H100 80GB HBM3,
// 700.00 W; warp ms, then this kernel's, from one call each): R = 12,
// 56 bytes spilled, band 160 1.4518, 1.4331 against 2.4538, 2.4545 and
// band 191 1.4133, 1.4285 against 2.4572, 2.4782; R = 16, 92 bytes,
// band 192 1.8755, 1.8986 against 2.6128, 2.6141 and band 255 2.0725,
// 2.0564 against 2.8847, 2.8724; R = 24, 120 bytes, band 256 3.0676,
// 3.0572 against 2.8840, 2.8575 and band 300 3.1422, 3.1561 against
// 2.9382, 2.9346; R = 32, 784 bytes, band 511 7.0884, 7.1411 against
// 4.0165, 4.0759.
// Band 512 .. 4095: row_forward_lanes_kernel<R>, the same with R = 2, 4
// or 8 lanes a thread (up to band 1023, 2047, 4095), so a block never
// passes 1024 threads.
//
// Outputs:
//   dirs      (B, XW/16, 2*band+1) int32: row i of lane j at word i/16,
//             bits 2*(i & 15)
//   last_row  (B, 2*band+1) int32: row x_size-1
//   diag      (B, 2*band+1) int32: lane j holds the pos_a == end_a cell
//             of row end_a - begin_a + band - j
//
// Bound on this card: the dependent chain of a row, not bytes (the
// directions are 0.25 B per cell).  In the warp kernel a lean row costs
// about 14 int32 operations per lane a thread holds (the lanes are
// independent, so they issue back to back) and a chain of 7 shuffles
// (the up lane, the scan's 6); one warp alone on its scheduler is
// latency-bound at that chain (~300 ns a row at R = 10).
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
constexpr unsigned kFull = 0xffffffffu;

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

// ---- band <= 159: a warp per problem --------------------------------------

// Per-thread constants of one problem.
template <int R>
struct WarpLanes {
  int t, j0, gj0;  // thread, its first lane, GAP * j0
  int ug[R];       // up gap of each lane: GAP, or NEG on lane 2*band
  int ba, band, al, xs1, jdb, YS;
  bool fs;
};

// Row 0: every case of the reference per lane.  prev is all 0 there, so
// a lane's diag is its score.  score(k): the cell score of lane k.
template <int R, typename Score>
__device__ __forceinline__ void first_row(int (&prev)[R],
                                          unsigned (&packed)[R], Score score,
                                          const WarpLanes<R>& L,
                                          const Scoring& s, int* lr,
                                          int* dg) {
  const int NEG = s.neg, ymax = L.YS - 1, pb = L.ba - L.band + L.j0;
  // each lane's map (c, s) before the left dependency: c, and s as a lane
  // mask (0; NEG otherwise); its score + 8, 4 bits a lane
  int c[R];
  unsigned sc_pk[(R + 7) / 8];
  unsigned sl_zero = 0, vmask = 0;
#pragma unroll
  for (int w = 0; w < (R + 7) / 8; ++w) sc_pk[w] = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = L.j0 + k;
    const bool in_band = j < L.YS;
    const int sc = in_band ? score(k) : 0;
    sc_pk[k >> 3] |= (unsigned)(sc + 8) << (4 * (k & 7));
    const int pos = in_band ? pb + k : 0;
    const bool valid_pos = pos >= 0 && pos < L.al;
    const bool cond_b = L.fs && pos > s.force_max_gap && pos < L.al;
    bool v = (valid_pos && (!L.fs || pos <= s.force_max_gap)) || cond_b;
    const int base = cond_b ? sc : max(sc, s.gap);
    sl_zero |= (unsigned)(v && pos > 0 && j != 0) << k;
    v = v && in_band;
    c[k] = v ? base : 0;
    vmask |= (unsigned)v << k;
  }
  const auto sl = [&](int k) { return ((sl_zero >> k) & 1u) ? 0 : NEG; };
  // this thread's R maps composed in order, then an inclusive scan of
  // the thread totals
  int C = c[0], S = sl(0);
#pragma unroll
  for (int k = 1; k < R; ++k) {
    C = max(c[k], max(sl(k) + C, NEG));
    S = max(S + sl(k), NEG);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int c_l = __shfl_up_sync(kFull, C, d);
    const int s_l = __shfl_up_sync(kFull, S, d);
    if (L.t >= d) {
      C = max(C, max(S + c_l, NEG));
      S = max(s_l + S, NEG);
    }
  }
  // the row at lane j0 - 1: the threads before this one, composed
  int x = __shfl_up_sync(kFull, C, 1);
  if (L.t == 0) x = NEG;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = L.j0 + k;
    const bool in_band = j < L.YS, last = j == ymax, first = j == 0;
    const bool mid = !first && !last;
    x = max(c[k], max(sl(k) + x, NEG));
    const int row = ((vmask >> k) & 1u) ? x : 0;
    const int sc = (int)((sc_pk[k >> 3] >> (4 * (k & 7))) & 15u) - 8;
    const int pos = in_band ? pb + k : 0;
    int d;
    if (pos == 0) {
      d = row == sc ? kDiag : ((last || row == s.gap) ? kLeft : kUp);
    } else {
      const int up_t =
          L.fs ? ((pos >= 0 && pos <= s.force_max_gap) ? s.gap : NEG) : s.gap;
      d = row == sc ? kDiag
                    : ((mid && row == up_t) ? kUp
                                            : (mid || last ? kLeft : kUp));
    }
    packed[k] |= (unsigned)d;
    if (in_band) {
      if (j == L.jdb) dg[j] = row;
      if (L.xs1 == 0) lr[j] = row;
    }
    prev[k] = row;
  }
}

// Row i >= 1 (r = i & 15): each lane's c = max(diag, up), and the row is
// the prefix max of c - GAP*j plus GAP*j.  The thread takes the max of
// its lanes (a tree) and hands it to an exclusive max scan over the
// threads, relative to j = 0; meanwhile it runs its lanes' prefix,
// relative to its first lane j0; then each lane applies both.  Lane
// 2*band's up gap is NEG, so its up is never taken.
// CHECK adds the reference's cases by lane position pos = begin_a - band
// + i + j: lanes at pos < 0 (a prefix of the row) hold 0 and are barred
// from the scan; the pos == 0 lane starts afresh (with the gap within
// FORCE_MAXGAP_LEN of a force_start problem's start or without one, else
// forced), so no lane before it reaches it; lanes at pos >= a_len (a
// suffix) hold 0; lane 0 has no left move; and the last row and the
// pos == end_a cell are recorded.  Rows without CHECK hold none of these
// (every lane at 0 < pos < a_len, no record).  score(k): the cell score
// of lane k.
template <int R, bool CHECK, typename Score>
__device__ __forceinline__ void lean_row(int (&prev)[R],
                                         unsigned (&packed)[R], Score score,
                                         const WarpLanes<R>& L,
                                         const Scoring& s, int i, int r,
                                         int* lr, int* dg) {
  const int nb = __shfl_down_sync(kFull, prev[0], 1);  // lane j0+R, row i-1
  const int pb = L.ba - L.band + i + L.j0;  // pos of lane k: pb + k
  const bool fresh = !L.fs || i <= s.force_max_gap;
  // each lane's diag and up, kept across the scan
  int dv[R], uv[R], pl[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int dk = prev[k] + score(k);
    const int uk = (k + 1 < R ? prev[k + 1] : nb) + L.ug[k];
    dv[k] = dk;
    uv[k] = uk;
    int base = max(dk, uk);
    if (CHECK) {
      const int pos = pb + k;
      if (pos == 0) {
        const int sc = dk - prev[k];
        base = fresh ? max(max(sc, uk), s.gap) : max(sc, uk);
      }
      if (pos < 0) base = s.neg;
    }
    pl[k] = base - s.gap * k;
  }
  // the thread's max by a tree (a shorter chain than the prefix), then
  // the max of c - GAP*j over the threads before this one
  int m[R];
#pragma unroll
  for (int k = 0; k < R; ++k) m[k] = pl[k];
#pragma unroll
  for (int w = 1; w < R; w <<= 1) {
#pragma unroll
    for (int k = 0; k + w < R; k += 2 * w) m[k] = max(m[k], m[k + w]);
  }
  int y = __shfl_up_sync(kFull, m[0] - L.gj0, 1);
  if (L.t == 0) y = s.neg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) y = max(y, __shfl_up_sync(kFull, y, d));
  const int x = y + L.gj0;
#pragma unroll
  for (int k = 1; k < R; ++k) pl[k] = max(pl[k - 1], pl[k]);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int dk = dv[k], uk = uv[k];
    int row = max(x, pl[k]) + s.gap * k;
    int d;
    if (CHECK) {
      const int pos = pb + k, j = L.j0 + k;
      if ((unsigned)pos >= (unsigned)L.al) row = 0;  // pos < 0, >= a_len
      if (pos == 0) {
        const int sc = dk - prev[k];
        d = row == sc ? kDiag
                      : ((j == L.YS - 1 || (row == s.gap && fresh)) ? kLeft
                                                                    : kUp);
      } else {
        d = row == dk ? kDiag : (row == uk ? kUp : kLeft);
        // an invalid lane 0 (not also lane 2*band) takes up, not left
        if (k == 0 && L.t == 0 && L.YS > 1 && d == kLeft) d = kUp;
      }
      if (j < L.YS) {
        if (j == L.jdb - i) dg[j] = row;
        if (i == L.xs1) lr[j] = row;
      }
    } else {
      d = row == dk ? kDiag : (row == uk ? kUp : kLeft);
    }
    packed[k] |= (unsigned)d << (2 * r);
    prev[k] = row;
  }
}

// Rows i0 .. i0+15, unrolled (row 0 runs first_row).  va: the score
// vectors of the a codes i0 + j0 .. i0 + j0 + R + 14; b0, b1: the
// block's 16 b codes.
template <int R, bool CHECK>
__device__ __forceinline__ void row_block(int (&prev)[R],
                                          unsigned (&packed)[R],
                                          const uint32_t (&va)[R + 15],
                                          uint32_t b0, uint32_t b1, int lo,
                                          const WarpLanes<R>& L,
                                          const Scoring& s, int i0, int* lr,
                                          int* dg) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int sh = (int)((((r < 8 ? b0 : b1) >> (4 * (r & 7))) & 15u) << 2);
    const auto score = [&](int k) {
      return (int)((va[r + k] >> sh) & 15u) + lo;
    };
    if (CHECK && r == 0 && i0 == 0)  // block 0 is always checked
      first_row<R>(prev, packed, score, L, s, lr, dg);
    else
      lean_row<R, CHECK>(prev, packed, score, L, s, i0 + r, r, lr, dg);
  }
}

template <int R>
__global__ void __launch_bounds__(32, 1) row_warp_kernel(
    const uint8_t* __restrict__ a_pk, const uint8_t* __restrict__ b_pk,
    const int* __restrict__ begin_a, const int* __restrict__ end_a,
    const int* __restrict__ a_len, const int* __restrict__ x_size,
    const int* __restrict__ force_start, int aw, int xw, int band, Scoring s,
    int* __restrict__ dirs, int* __restrict__ last_row,
    int* __restrict__ diag) {
  constexpr int NA = R + 15;          // a codes of a thread's 16 rows
  constexpr int AWDS = (NA + 7) / 8;  // their words, aligned
  __shared__ uint32_t vec_s[16];
  const int b = blockIdx.x, t = threadIdx.x;
  const int lo = min(min(s.match, s.mismatch), min(s.nn, s.nx));
  if (t < 16) {
    // score vector of a code: (score(a, b) - lo) << 4b for b codes 0-7
    uint32_t v = 0;
    for (int bc = 0; bc < 8; ++bc)
      v |= (uint32_t)(base_score(t, bc, s) - lo) << (4 * bc);
    vec_s[t] = v;
  }
  __syncwarp();

  const int YS = 2 * band + 1, ymax = 2 * band;
  WarpLanes<R> L;
  L.t = t;
  L.j0 = t * R;
  L.gj0 = s.gap * L.j0;
#pragma unroll
  for (int k = 0; k < R; ++k) L.ug[k] = L.j0 + k == ymax ? s.neg : s.gap;
  L.ba = begin_a[b];
  L.band = band;
  L.al = a_len[b];
  const int xs = x_size[b];
  L.xs1 = xs - 1;
  L.jdb = end_a[b] - L.ba + band;  // diag lane of row i: jdb - i
  L.YS = YS;
  L.fs = force_start[b] != 0;

  // whole words: a rows are 16-byte chunks, b rows XW/2 bytes, XW % 16 == 0
  const uint32_t* a32 =
      reinterpret_cast<const uint32_t*>(a_pk + (size_t)b * (aw / 2));
  const uint32_t* b32 =
      reinterpret_cast<const uint32_t*>(b_pk + (size_t)b * (xw / 2));
  int* dir_out = dirs + (size_t)b * (xw / 16) * YS;
  int* lr = last_row + (size_t)b * YS;
  int* dg = diag + (size_t)b * YS;

  const int stop = xs <= 0 ? 0 : min(xw, (xs + 15) / 16 * 16);
  const int nblk = stop >> 4;
  // rows up to pos0_rows hold a lane at pos <= 0; rows from ilim a lane
  // at pos >= a_len
  const int pos0_rows = band - L.ba, ilim = L.al - L.ba - band;
  // a codes of block n start at 16n + j0: the word offset and the in-word
  // shift of the thread's first code are loop invariant
  const int nwa = aw >> 3, wa0 = L.j0 >> 3, sha = 4 * (L.j0 & 7);
  const auto load_words = [&](int n, uint32_t (&w)[AWDS + 1],
                              uint32_t& w0, uint32_t& w1) {
#pragma unroll
    for (int q = 0; q <= AWDS; ++q) {
      const int wi = 2 * n + wa0 + q;  // padding lanes read past the row
      w[q] = wi < nwa ? __ldg(a32 + wi) : 0xffffffffu;
    }
    w0 = __ldg(b32 + 2 * n);
    w1 = __ldg(b32 + 2 * n + 1);
  };

  int prev[R];
#pragma unroll
  for (int k = 0; k < R; ++k) prev[k] = 0;
  uint32_t wa[AWDS + 1], wb0 = 0, wb1 = 0;
  if (nblk > 0) load_words(0, wa, wb0, wb1);
  for (int n = 0; n < nblk; ++n) {
    const int i0 = 16 * n;
    uint32_t nxt[AWDS + 1], nb0 = 0, nb1 = 0;
    if (n + 1 < nblk) load_words(n + 1, nxt, nb0, nb1);  // a block ahead
    uint32_t va[NA];
    {
      uint32_t al[AWDS];
#pragma unroll
      for (int q = 0; q < AWDS; ++q)
        al[q] = __funnelshift_r(wa[q], wa[q + 1], sha);
#pragma unroll
      for (int m = 0; m < NA; ++m)
        va[m] = vec_s[(al[m >> 3] >> (4 * (m & 7))) & 15u];
    }
    unsigned packed[R];
#pragma unroll
    for (int k = 0; k < R; ++k) packed[k] = 0;
    // a lane at pos <= 0 or >= a_len, the last row, or a pos == end_a
    // cell in this block?
    const bool check = n == 0 || i0 <= pos0_rows || i0 + 15 >= ilim ||
                       (L.xs1 >= i0 && L.xs1 <= i0 + 15) ||
                       (L.jdb >= i0 && L.jdb - ymax <= i0 + 15);
    if (check)
      row_block<R, true>(prev, packed, va, wb0, wb1, lo, L, s, i0, lr, dg);
    else
      row_block<R, false>(prev, packed, va, wb0, wb1, lo, L, s, i0, lr, dg);
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (L.j0 + k < YS) dir_out[(size_t)n * YS + L.j0 + k] = (int)packed[k];
    if (n + 1 < nblk) {
#pragma unroll
      for (int q = 0; q <= AWDS; ++q) wa[q] = nxt[q];
      wb0 = nb0;
      wb1 = nb1;
    }
  }
}

template <int R>
int launch_warp(const void* a_pk, const void* b_pk, const void* begin_a,
                const void* end_a, const void* a_len, const void* x_size,
                const void* force_start, int B, int aw, int xw, int band,
                const Scoring& s, void* dirs, void* last_row, void* diag,
                cudaStream_t stream) {
  row_warp_kernel<R><<<B, 32, 0, stream>>>(
      (const uint8_t*)a_pk, (const uint8_t*)b_pk, (const int*)begin_a,
      (const int*)end_a, (const int*)a_len, (const int*)x_size,
      (const int*)force_start, aw, xw, band, s, (int*)dirs, (int*)last_row,
      (int*)diag);
  return (int)cudaGetLastError();
}

// ---- band 160 .. 4095: a block per problem --------------------------------

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
  const cudaStream_t st = (cudaStream_t)stream;
  if (band <= 159) {
#define GAM_WARP(RR)                                                       \
  return launch_warp<RR>(a_pk, b_pk, begin_a, end_a, a_len, x_size,        \
                         force_start, B, aw, xw, band, s, dirs, last_row,  \
                         diag, st)
    // the narrowest instantiated R with 32 * R >= 2 * band + 1
    const int need = (YS + 31) / 32;
    if (need <= 1) GAM_WARP(1);
    if (need <= 2) GAM_WARP(2);
    if (need <= 4) GAM_WARP(4);
    if (need <= 6) GAM_WARP(6);
    if (need <= 8) GAM_WARP(8);
    GAM_WARP(10);
#undef GAM_WARP
  }
  // lanes a thread: the fewest that keep the block at 1024 threads
  const int R = band <= 511 ? 1 : band <= 1023 ? 2 : band <= 2047 ? 4 : 8;
  const int threads = ((YS + R - 1) / R + 31) / 32 * 32;
  const size_t shmem = (YS + 1 + 64) * sizeof(int);
  auto kernel = R == 1   ? row_forward_kernel
                : R == 2 ? row_forward_lanes_kernel<2>
                : R == 4 ? row_forward_lanes_kernel<4>
                         : row_forward_lanes_kernel<8>;
  kernel<<<B, threads, shmem, st>>>(
      (const uint8_t*)a_pk, (const uint8_t*)b_pk, (const int*)begin_a,
      (const int*)end_a, (const int*)a_len, (const int*)x_size,
      (const int*)force_start, aw, xw, band, s, (int*)dirs, (int*)last_row,
      (int*)diag);
  return (int)cudaGetLastError();
}
