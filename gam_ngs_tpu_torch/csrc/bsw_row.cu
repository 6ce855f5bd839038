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
// W warps per problem, in one block or in the C blocks of a thread-block
// cluster, and one problem a block or a cluster (a 64-problem chunk
// spreads over 64 of the 132 SMs, and the engine's 4 streams put a
// round's other chunks on the rest; two a block would leave a chunk on
// 32): row_warp_kernel<R>, one warp, up to band 159, and
// row_warps_kernel<R, W, C> for bands 160 .. 4095 (C = 1 up to band 767),
// built from the same row bodies.  Thread t of warp w in the block of
// cluster rank k holds the R consecutive lanes
// j = ((k*W + w)*32 + t)*R .. +R-1 in registers, the first instance with
// 32*C*W*R >= 2*band+1; lanes past 2*band are padding that no band lane
// reads.  The previous row stays in registers: lane j's diag is its own
// previous value, its up the previous value of lane j+1, in the thread
// but for the top lane, which takes thread t+1's bottom lane by one
// shuffle (lane 31 of a warp: see the exchange below); lane 2*band's up
// gap is NEG, so its up is never taken.  No shared row sits in the row
// loop, and no barrier for one warp.
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
// W > 1 warps meet once a row, at one __syncthreads, through a small
// exchange in shared memory (Exchange) with a slot a warp for each row
// parity.  Before the barrier of row i each warp publishes its total,
// the lean max of c - GAP*j (one __reduce_max_sync, issued beside the
// shuffle scan) or row 0's composed (c, s) (lane 31's scan), and its
// first lane's map (c, s): (c, GAP), (c, NEG) at pos == 0 and (0, NEG)
// where the lane holds 0.  After it, warp w folds the totals of the
// warps before it into its exclusive prefix, in order; both parts clamp
// at NEG, so no sum of blocked lanes wraps.  Lane 31 of warp w takes its
// top lane's up neighbour, warp w+1's first lane of row i, on row i+1 as
// max(c, s + its own last lane of row i) from warp w+1's slot of row
// i's parity, which no warp writes again before barrier i+1.  The barrier
// is block-wide, so the rows run and the choice of a checked block are
// the problem's, the same in every warp.
//
// C > 1 blocks of a cluster (bands 768 .. 4095) extend the exchange one
// level.  Past 1536 lanes one block cannot hold a row in registers (an
// SM has 65,536: 256 threads take at most 255 each, 512 at most 128;
// eight warps of 5 lanes take 255, sixteen of 3 take 128 and sixteen of
// 4 spill), so the lanes of one problem spread over the SMs of a
// cluster, which run together on one GPC, read and write each other's
// shared memory (DSMEM) and meet at one hardware barrier.  Every block
// keeps the exchange of all C*W warps of the problem (warp g = k*W + w),
// and a warp pushes what another block reads into that block's copy
// before the barrier: lanes 1 .. C-1 its total to the later ranks, lane 0
// of warp 0 its first lane's map to the rank before (remote stores, which
// the barrier's release orders).  So after the barrier every read is
// local: warp g folds the totals of warps 0 .. g-1, lane l reading those
// of warps l and l + 32 and one __reduce_max_sync taking their max (row 0
// composes them in order, rank by rank), and lane 31 of a block's last
// warp reads the next rank's first lane where the block's other warps
// read their neighbour's.  The one barrier of a row is the cluster
// barrier, split: arrive after the publish, wait after the warp's own
// scan.  Two row parities keep a row's pushes off values still being
// read, as in one block; a cluster barrier before the first row (every
// block of the cluster has started) and one after the last (a block's
// shared memory outlives every access to it; once a problem) close the
// loop, and a rank whose lanes are all padding runs it all the same.
// The exchange and the score vectors sit in dynamic shared memory, so
// that the host emulation (tests/cuda_emu) gives each block its own.
//
// The rows run in blocks of 16, unrolled: at the start of a block a
// thread reads the R+15 a codes of its lanes (loaded a block ahead) and
// looks up each one's score vector, the scores against b codes 0-7,
// 4 bits each above the lowest score (the engine's b codes are 0-4); a
// cell's score is then a shift and a mask.
//
// Instances (W, R) and ptxas' registers, none spills:
//   W = 1: R = 1, 2, 4, 6, 8, 10 (up to bands 15, 31, 63, 95, 127, 159):
//     80, 113, 239, 255, 223, 252 registers; steps of 2 keep the default
//     band (150, R = 10) and its neighbours within one lane of the least R;
//   W = 4: R = 3, 4, 5 (up to bands 191, 255, 319): 190, 146, 255;
//   W = 8: R = 3, 4, 5 (up to bands 383, 511, 639): 192, 232, 255;
//   W = 16: R = 3 (up to band 767): 128, the most at 512 threads (R = 4
//     spilled 4 bytes);
//   clusters (C, W, R) = (2, 8, 4), (2, 16, 3), (2, 16, 4), (8, 8, 3),
//     (8, 8, 4) (up to bands 1023, 1535, 2047, 3071, 4095): 125, 106,
//     112, 123, 127 (ptxas keeps the cluster instances lighter).
// A thread keeps each lane's diag and up across the scan and takes its
// lane maximum by a tree.  More warps of fewer lanes a thread win until
// the SM's four schedulers are full: at B=64, XW 4096 (tools/kernel_ab.py
// --row, NVIDIA H100 80GB HBM3, 700.00 W, in turns in one call) two warps
// of 6, 8 and 10 lanes took 0.869, 1.106 and 1.358 ms at bands 160, 255
// and 300 against four warps of 3, 4 and 5 lanes' 0.724, 0.799 and
// 0.862 (means of two turns); eight warps of 2 and 3 lanes took 0.913
// and 0.994 ms at bands 160 and 300, but 0.994 at band 383 against four
// warps of 6 lanes' 1.081; four warps of 8 lanes spilled 12 bytes at
// 255 registers.  Before, bands 160 .. 511 ran one lane a thread in a
// block, the previous row in shared memory and two barriers a row:
// 2.413, 2.902 and 4.049 ms at bands 160, 300 and 511, in turns with the
// two warps above; one warp of R = 12 .. 32 lanes spilled 56 .. 784
// bytes at 255 registers.
// The cluster barrier sets a cluster's row.  Alone (tools/cluster_floor.cu,
// B=64, 4096 rows, eight warps a block, the same card) the exchange took
// 77 ns a row in one block and 470, 741, 944 ns in clusters of 2, 4, 8
// pushing before the barrier, against 575, 819, 911 pulling after it,
// 498, 771, 1004 with a relaxed arrive behind the writers' fence, and
// 637, 800, 1250 with remote arrives on the receiver's mbarrier in place
// of the barrier.  So one block as wide as the registers allow wins where
// it fits: eight warps of 5 lanes took 1.334 ms at band 512 against a
// cluster of two blocks of eight warps of 3 lanes' 3.31, sixteen warps
// of 3 took 2.40 ms at bands 640-767 against 3.3.  And waves count: the
// card runs at once (cudaOccupancyMaxActiveClusters) 132 clusters of two
// blocks of eight warps (two blocks an SM at <= 128 registers), 62 of
// four, 30 of eight, so a 64-problem chunk takes one wave at C = 2, two
// at C = 4 and three at C = 8; two blocks of sixteen warps (one wave)
// took 3.57-4.02 ms at bands 1024-2047 against four blocks of eight
// warps' 5.40-6.08, while four blocks of sixteen warps (three waves)
// took 9.63-10.66 ms at 2048-4095 against eight blocks of eight warps'
// 9.20-9.86 (tools/kernel_ab.py --row, B=64, XW 4096, in turns).
// Before, bands 512 .. 4095 ran a block of R = 2, 4 or 8 lanes a thread
// (up to band 1023, 2047, 4095), at most 1024 threads, the previous row
// in shared memory, two barriers a row: 4.63, 5.51, 7.02, 12.31 and
// 29.28 ms at bands 512, 700, 1023, 2000 and 4095.
//
// Outputs:
//   dirs      (B, XW/16, 2*band+1) int32: row i of lane j at word i/16,
//             bits 2*(i & 15)
//   last_row  (B, 2*band+1) int32: row x_size-1
//   diag      (B, 2*band+1) int32: lane j holds the pos_a == end_a cell
//             of row end_a - begin_a + band - j
//
// Bound on this card: the dependent chain of a row, not bytes (the
// directions are 0.25 B per cell).  In the warp kernels a lean row costs
// about 14 int32 operations per lane a thread holds (the lanes are
// independent, so they issue back to back) and a chain of 7 shuffles
// (the up lane, the scan's 6), and for W > 1 the barrier and the shared
// loads after it; one warp alone on its scheduler is latency-bound at
// that chain (~300 ns a row at R = 10, ~180 ns for four warps of 3).
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

__device__ __forceinline__ int base_score(int ac, int bc, const Scoring& s) {
  const bool an = ac == 4, bn = bc == 4;
  if (an && bn) return s.nn;
  if (an || bn) return s.nx;
  return ac == bc ? s.match : s.mismatch;
}

// ---- W warps per problem, in C blocks of a cluster -------------------------

#ifdef __CUDACC__
// Thread-block clusters (tests/cuda_emu/cuda_runtime.h defines the host's
// stand-ins): the block's rank in its cluster; the address of a shared
// variable in the block of another rank; the cluster barrier's halves,
// arrive (releasing this thread's earlier writes, remote ones included)
// and wait (acquiring the other threads')
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int* cluster_peer(int* p, int rank) {
  uint64_t q;
  asm("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(p), "r"(rank));
  return reinterpret_cast<int*>(q);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
#endif

// What the W*C > 1 warps of one problem share: the warp's index w in
// the problem (k*W + its warp in the block of cluster rank k), and the
// block's exchange in shared memory, 4*C*W ints a row parity: field f of
// warp v at f*C*W + v, the warp's total (f = 0; for row 0 the c part,
// f = 1 its s part) and its first lane's map (c, s) (f = 2, 3); for
// C > 1, the exchange of the block this lane pushes to (nullptr: none).
template <int W, int C>
struct Exchange {
  int w;
  int* xch;
  int* push;
};
template <>
struct Exchange<1, 1> {};

// Per-thread constants of one problem.
template <int R, int W = 1, int C = 1>
struct WarpLanes : Exchange<W, C> {
  int t, j0, gj0;  // thread in its warp, its first lane, GAP * j0
  int ug[R];       // up gap of each lane: GAP, or NEG on lane 2*band
  int ba, band, al, xs1, jdb, YS;
  bool fs;
};

// Row 0: every case of the reference per lane.  prev is all 0 there, so
// a lane's diag is its score.  score(k): the cell score of lane k.
template <int R, typename Score, int W, int C>
__device__ __forceinline__ void first_row(int (&prev)[R],
                                          unsigned (&packed)[R], Score score,
                                          const WarpLanes<R, W, C>& L,
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
  int Ct = c[0], St = sl(0);
#pragma unroll
  for (int k = 1; k < R; ++k) {
    Ct = max(c[k], max(sl(k) + Ct, NEG));
    St = max(St + sl(k), NEG);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int c_l = __shfl_up_sync(kFull, Ct, d);
    const int s_l = __shfl_up_sync(kFull, St, d);
    if (L.t >= d) {
      Ct = max(Ct, max(St + c_l, NEG));
      St = max(s_l + St, NEG);
    }
  }
  // the row at lane j0 - 1: the threads before this one, composed
  int x = __shfl_up_sync(kFull, Ct, 1);
  if (L.t == 0) x = NEG;
  if constexpr (W * C > 1) {
    // and the warps before this one: each publishes its composed maps
    // (lane 31's scan) and its first lane's map; the earlier warps'
    // totals, composed in order, enter this warp's exclusive prefix
    constexpr int G = W * C;
    const int sx = __shfl_up_sync(kFull, St, 1);
    int* q = L.xch;  // row 0: parity 0
    if (L.t == 31) q[L.w] = Ct, q[G + L.w] = St;
    if (L.t == 0) q[2 * G + L.w] = c[0], q[3 * G + L.w] = sl(0);
    if constexpr (C > 1) {
      // the same into the blocks that read them: the composed maps to
      // the later ranks, warp 0's first lane to the rank before
      const int ct = __shfl_sync(kFull, Ct, 31);
      const int st = __shfl_sync(kFull, St, 31);
      if (L.push && L.t) L.push[L.w] = ct, L.push[G + L.w] = st;
      if (L.push && !L.t)
        L.push[2 * G + L.w] = c[0], L.push[3 * G + L.w] = sl(0);
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    int carry = NEG;
#pragma unroll
    for (int v = 0; v + 1 < G; ++v)
      if (v < L.w) carry = max(q[v], max(q[G + v] + carry, NEG));
    x = L.t == 0 ? carry : max(x, max(sx + carry, NEG));
  }
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
template <int R, bool CHECK, typename Score, int W, int C>
__device__ __forceinline__ void lean_row(int (&prev)[R],
                                         unsigned (&packed)[R], Score score,
                                         const WarpLanes<R, W, C>& L,
                                         const Scoring& s, int i, int r,
                                         int* lr, int* dg) {
  int nb = __shfl_down_sync(kFull, prev[0], 1);  // lane j0+R, row i-1
  constexpr int G = W * C;
  if constexpr (G > 1) {
    // lane 31's: the next warp's first lane, from the map (c, s) that
    // warp published (or, from the next rank, pushed here) on row i-1 and
    // this thread's last lane there
    if (L.t == 31 && L.w + 1 < G) {
      const int* q = L.xch + ((i - 1) & 1) * 4 * G + L.w + 1;
      nb = max(q[2 * G], q[3 * G] + prev[R - 1]);
    }
  }
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
  if constexpr (G > 1) {
    // publish the warp's max of c - GAP*j, and its first lane's map:
    // (c, GAP), (c, NEG) at pos == 0 (no left move into a fresh start),
    // (0, NEG) where the lane holds 0
    const int tot = __reduce_max_sync(kFull, m[0] - L.gj0);
    const bool out = CHECK && (unsigned)pb >= (unsigned)L.al;
    const int fc = out ? 0 : pl[0];
    const int fsl = out || (CHECK && pb == 0) ? s.neg : s.gap;
    if (L.t == 0) {
      int* q = L.xch + (i & 1) * 4 * G + L.w;
      q[0] = tot;
      q[2 * G] = fc;
      q[3 * G] = fsl;
    }
    if constexpr (C > 1) {
      // and into the blocks that read them: the total to the later
      // ranks (lanes 1 .. C-1), warp 0's first lane to the rank before
      // (lane 0); then this thread's half of the row's barrier
      if (L.push) {
        int* q = L.push + (i & 1) * 4 * G + L.w;
        if (L.t) q[0] = tot;
        if (!L.t) q[2 * G] = fc, q[3 * G] = fsl;
      }
      cluster_arrive();
    }
  }
  int y = __shfl_up_sync(kFull, m[0] - L.gj0, 1);
  if (L.t == 0) y = s.neg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) y = max(y, __shfl_up_sync(kFull, y, d));
  if constexpr (C > 1) {
    cluster_wait();  // the one barrier of the row, for the whole cluster
    // the warps before this one, in every rank: lane l takes warps l
    // and l + 32, the warp their max
    const int* q = L.xch + (i & 1) * 4 * G;
    int z = L.t < L.w ? q[L.t] : s.neg;
    if constexpr (G > 32) z = max(z, L.t + 32 < L.w ? q[L.t + 32] : s.neg);
    y = max(y, __reduce_max_sync(kFull, z));
  } else if constexpr (W > 1) {
    __syncthreads();  // the one barrier of the row
    const int* q = L.xch + (i & 1) * 4 * W;
#pragma unroll
    for (int v = 0; v + 1 < W; ++v)
      if (v < L.w) y = max(y, q[v]);  // the warps before this one
  }
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
        if (k == 0 && L.j0 == 0 && L.YS > 1 && d == kLeft) d = kUp;
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
template <int R, bool CHECK, int W, int C>
__device__ __forceinline__ void row_block(int (&prev)[R],
                                          unsigned (&packed)[R],
                                          const uint32_t (&va)[R + 15],
                                          uint32_t b0, uint32_t b1, int lo,
                                          const WarpLanes<R, W, C>& L,
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

// W warps of one problem in each of the C blocks of a cluster (C = 1:
// one block, bands 160 .. 767; C > 1: bands 768 .. 4095):
// row_warp_kernel's loop, the lanes of thread t of warp w in the block of
// cluster rank k from j0 = ((k*W + w)*32 + t)*R
template <int R, int W, int C>
__global__ void __launch_bounds__(32 * W, 1) row_warps_kernel(
    const uint8_t* __restrict__ a_pk, const uint8_t* __restrict__ b_pk,
    const int* __restrict__ begin_a, const int* __restrict__ end_a,
    const int* __restrict__ a_len, const int* __restrict__ x_size,
    const int* __restrict__ force_start, int aw, int xw, int band, Scoring s,
    int* __restrict__ dirs, int* __restrict__ last_row,
    int* __restrict__ diag) {
  constexpr int NA = R + 15;          // a codes of a thread's 16 rows
  constexpr int AWDS = (NA + 7) / 8;  // their words, aligned
  // the score vectors (16) and the exchange (8*C*W ints: two row
  // parities) in dynamic shared memory
  extern __shared__ int smem[];
  uint32_t* vec_s = reinterpret_cast<uint32_t*>(smem);
  int* xch = smem + 16;
  const int rank = C > 1 ? cluster_rank() : 0;
  const int b = blockIdx.x / C, t = threadIdx.x & 31;
  const int lo = min(min(s.match, s.mismatch), min(s.nn, s.nx));
  if (threadIdx.x < 16) {
    // score vector of a code: (score(a, b) - lo) << 4b for b codes 0-7
    uint32_t v = 0;
    for (int bc = 0; bc < 8; ++bc)
      v |= (uint32_t)(base_score(threadIdx.x, bc, s) - lo) << (4 * bc);
    vec_s[threadIdx.x] = v;
  }

  const int YS = 2 * band + 1, ymax = 2 * band;
  WarpLanes<R, W, C> L;
  L.t = t;
  L.w = rank * W + (threadIdx.x >> 5);
  L.xch = xch;
  if constexpr (C > 1) {
    // lane r >= 1 pushes to rank + r, lane 0 of warp 0 to rank - 1
    const int to = t ? rank + t : rank - 1;
    L.push = (t ? to < C : threadIdx.x == 0 && to >= 0)
                 ? cluster_peer(xch, to)
                 : nullptr;
    cluster_arrive();  // every block of the cluster has started
    cluster_wait();
  } else {
    __syncthreads();
  }
  L.j0 = (rank * 32 * W + threadIdx.x) * R;
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
  if constexpr (C > 1) {
    cluster_arrive();  // no block leaves while another may reach it
    cluster_wait();
  }
}

// One launch's arguments; with info set, the launch only reports its
// instance: C, W, R and the most clusters of it the card runs at once
struct Launch {
  const void *a_pk, *b_pk, *begin_a, *end_a, *a_len, *x_size, *force_start;
  int B, aw, xw, band;
  Scoring s;
  void *dirs, *last_row, *diag;
  cudaStream_t stream;
  int* info;
};

// W warps of R lanes a thread in clusters of C blocks (one warp:
// row_warp_kernel<R>, a block a problem)
template <int R, int W, int C>
int launch_warp(const Launch& p) {
  const auto* a_pk = (const uint8_t*)p.a_pk;
  const auto* b_pk = (const uint8_t*)p.b_pk;
  const auto* begin_a = (const int*)p.begin_a;
  const auto* end_a = (const int*)p.end_a;
  const auto* a_len = (const int*)p.a_len;
  const auto* x_size = (const int*)p.x_size;
  const auto* force_start = (const int*)p.force_start;
  if constexpr (W * C == 1) {
    if (p.info) {
      p.info[0] = 1, p.info[1] = 1, p.info[2] = R, p.info[3] = 0;
      return 0;
    }
    row_warp_kernel<R><<<p.B, 32, 0, p.stream>>>(
        a_pk, b_pk, begin_a, end_a, a_len, x_size, force_start, p.aw, p.xw,
        p.band, p.s, (int*)p.dirs, (int*)p.last_row, (int*)p.diag);
    return (int)cudaGetLastError();
  } else {
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = C;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.B * C);
    cfg.blockDim = dim3(32 * W);
    cfg.dynamicSmemBytes = (16 + 8 * C * W) * sizeof(int);
    cfg.stream = p.stream;
    cfg.attrs = cluster;
    cfg.numAttrs = C > 1 ? 1 : 0;
    const auto kernel = row_warps_kernel<R, W, C>;
    if (p.info) {
      p.info[0] = C, p.info[1] = W, p.info[2] = R;
      cfg.gridDim = dim3(C);
      cfg.numAttrs = 1;
      return (int)cudaOccupancyMaxActiveClusters(&p.info[3], kernel, &cfg);
    }
    const int err = (int)cudaLaunchKernelEx(
        &cfg, kernel, a_pk, b_pk, begin_a, end_a, a_len, x_size, force_start,
        p.aw, p.xw, p.band, p.s, (int*)p.dirs, (int*)p.last_row,
        (int*)p.diag);
    return err ? err : (int)cudaGetLastError();
  }
}

// The first instance with 32*C*W*R >= 2*band+1 lanes
int launch_row(const Launch& p) {
  if (p.band < 0 || p.band > 4095) return (int)cudaErrorInvalidValue;
  const int YS = 2 * p.band + 1;
  // W warps of R lanes a thread, one block a problem
#define GAM_WARP(WW, RR) \
  if (YS <= 32 * (WW) * (RR)) return launch_warp<RR, WW, 1>(p)
  // clusters of C blocks of W warps
#define GAM_CLUSTER(CC, WW, RR) \
  if (YS <= 32 * (CC) * (WW) * (RR)) return launch_warp<RR, WW, CC>(p)
  GAM_WARP(1, 1);
  GAM_WARP(1, 2);
  GAM_WARP(1, 4);
  GAM_WARP(1, 6);
  GAM_WARP(1, 8);
  GAM_WARP(1, 10);
  GAM_WARP(4, 3);
  GAM_WARP(4, 4);
  GAM_WARP(4, 5);
  GAM_WARP(8, 3);
  GAM_WARP(8, 4);
  GAM_WARP(8, 5);
  GAM_WARP(16, 3);
  GAM_CLUSTER(2, 8, 4);
  GAM_CLUSTER(2, 16, 3);
  GAM_CLUSTER(2, 16, 4);
  GAM_CLUSTER(8, 8, 3);
  GAM_CLUSTER(8, 8, 4);
#undef GAM_CLUSTER
#undef GAM_WARP
  return (int)cudaErrorInvalidValue;
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
  return launch_row({a_pk, b_pk, begin_a, end_a, a_len, x_size, force_start, B,
                 aw, xw, band,
                 Scoring{match, mismatch, nn, nx, gap, force_max_gap, neg},
                 dirs, last_row, diag, (cudaStream_t)stream, nullptr});
}

// The instance that takes `band`: info[0..3] = C, W, R and the most
// clusters of it that the card runs at once (cudaOccupancyMaxActiveClusters;
// 0 for the one-warp kernel, which runs no cluster)
extern "C" int bsw_row_instance(int band, int* info) {
  Launch p = {};
  p.band = band;
  p.info = info;
  return launch_row(p);
}
