// Anti-diagonal banded Smith-Waterman forward fill for Hopper (sm_90a).
//
// Replaces gam_ngs_tpu/ops/bsw_pallas.py::_build_antidiag_kernel, both its
// exact-mask prefix (lean=False, K1) and its lean suffix (lean=True, K2),
// in one kernel.  The cell semantics are bsw_ref.fill_matrix
// (banded_smith_waterman.cc:70-214) with the reference's traceback
// tie-break stored as 2-bit directions.
//
// Coordinates: step t = 2i + j; at step t lane k holds cell
// i = t/2 - k, j = (t & 1) + 2k, A-pos = begin_a - band + ceil(t/2) + k.
// Every dependency of step t lies in steps t-1 and t-2:
//   diag (i-1, j)   -> own lane of step t-2
//   up   (i-1, j+1) -> lane k (t even) / k+1 (t odd) of step t-1
//   left (i,   j-1) -> lane k-1 (t even) / k (t odd) of step t-1
// Lanes -1 and K = band+1 read as 0 (lane -1 is only read by lane 0 at
// even steps, where j = 0 ignores it).
//
// Design: W warps per problem, kWarps / W problems per block: one warp
// (W = 1) below band 64, and up to band 159 where the launch fills the
// card; several (the split instance, below) where it leaves the card's
// schedulers empty, and at every batch from band 160.  Each thread holds
// R consecutive lanes in registers, R = ceil((band+1)/32) rounded up to
// an instantiated width at W = 1 (5 at band 150); the P = 32WR - K
// padding lanes sit below lane 0, so
// lane K-1 is the last register of the problem's last thread.  A step's
// only cross-thread reads are one shuffle: the top lane of thread g-1
// (left, even steps) or the bottom lane of thread g+1 (up, odd steps; 0
// for the last thread).  With W = 1 no barrier and no shared row sit in
// the step loop.  Above band 511 (W = 4, R = 10: 128 registers and no
// spill, where ptxas spills R = 8 at W = 4) the boundary threads of
// neighbouring warps also swap
// that one value through shared memory under the problem's named
// barrier, one bar.sync a step.  Padding lanes compute values nobody
// reads except lane 0's left at even steps, which the j = 0 rule
// discards.
//
// The split instance (HALO; W = 4 at bands 64-511) spreads one
// problem's K lanes over W warps without a barrier in the step loop.
// Warp v holds a window of 32R lanes: its strip of owned lanes and
// kHalo = 8 lanes on each side of it that a neighbouring warp owns (the
// last warp's window ends at lane K-1, as above; warp 0 owns down to its
// window's first lane, the padding below lane 0).  A lane reads lane k-1
// only at even steps and lane k+1 only at odd ones, so the values that
// the window's edges read wrong (a shuffle past its warp) move at most 8
// lanes inward in a 16-step block: the owned strip stays exact.  After
// each block the warps swap p1 and p2 of their 8 lowest and 8 highest
// owned lanes through shared memory under the problem's named barrier,
// which makes the halos exact again.  Only owned lanes write direction
// words and records.  With R lanes a thread the strip is 32R - 16
// lanes (32R - 8 at the two ends), so W = 4 runs band 150 at R = 2
// where one warp takes R = 5.
//
// The steps run in blocks of 16, one direction word per lane, unrolled.
// In the lean body the band edges cost nothing per lane: lane 0's left
// gap at even steps and lane K-1's up gap at even steps are kNeg (a
// loop-invariant register each), which gives exactly the reference's
// j = 0 / j = 2*band cases, since no cell score comes near kNeg.
//
// Sequences: each warp stages its packed a and b windows in shared
// memory, in rings of kRingTiles tiles of 128 words (1024 codes), filled
// by 16-byte cp.async copies three tiles (6144 steps) ahead of use.  At
// the start of a 16-step block a thread reads the R+8 a codes and R+7 b
// codes its lanes need (the a and b offsets of its first lane are loop
// invariant mod 8, so two funnel shifts align them), and looks up each a
// code's score vector: the five scores against b codes 0-4, 6 bits each
// above the lowest score.  A cell's score is then a shift and a mask.
//
// Steps t < exact_steps(band) = 16*ceil((2*band+3)/16) (every step when
// begin_a < 0, the reference's tail windows) run the exact body: row-0,
// pos==0 fresh/forced starts and force_start gating as per-lane masks.
// Later steps of a begin_a >= 0 problem hold no such cell and run the
// lean body, without validity masks: an out-of-range cell is never read
// by an in-range one, and find-max and the walk read in-range cells only.
// The last row and the pos == end_a diagonal are recorded in a checked
// copy of the block, taken only when a thread's lanes can hold such a
// cell in that block.
//
// A problem runs its own steps: 2*(x_size-1) + 2*band + 1 (its last cell
// is (x_size-1, 2*band)); later direction bits and words are written 0.
//
// Outputs:
//   dirs      (B, NP, K) int32: 16 steps of 2-bit directions per word,
//             cell (x, y) at word (2x+y)/16, lane y/2, bits 2*((2x+y)&15)
//   last_row  (B, 2*band+1) int32: row x_size-1, by band diagonal j
//   diag      (B, 2*band+1) int32: the pos_a == end_a cell of diagonal j
//             (0 where that cell lies past the problem's last step)
//
// Bound on this card: each step is a dependent chain through one
// shuffle and ~12 int32 operations per lane, R lanes a thread; with one
// problem per warp and one warp per scheduler it is issue- and
// latency-bound, ~R*12 instructions a step.  Bytes are small: 0.25 B of
// direction per cell and the 4-bit windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 29);  // below every reachable cell score
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // warps per block
constexpr int kTileWords = 128;    // 32 lanes x 16 bytes
constexpr int kRingTiles = 8;      // tiles g-1 .. g+3 live during stage g
constexpr int kRingWords = kTileWords * kRingTiles;
constexpr int kRingMask = kRingWords - 1;
constexpr int kStageBlocks = kTileWords;  // 16-step blocks per tile of a
constexpr int kHalo = 8;  // halo lanes a side of the split instance's strips

// bsw_ref's scoring, passed in by the wrapper: SCORING_MATRIX's match,
// mismatch, N-N and N-other scores, GAP and FORCE_MAXGAP_LEN
struct Scoring {
  int match, mismatch, nn, nx, gap, force_max_gap;
};

__device__ __forceinline__ int base_score(int ac, int bc, const Scoring& s) {
  const bool an = ac == 4, bn = bc == 4;
  if (an && bn) return s.nn;
  if (an || bn) return s.nx;
  return ac == bc ? s.match : s.mismatch;
}

#ifdef __CUDACC__
// cp.async and named barriers (tests/cuda_emu/cuda_runtime.h defines the
// host's stand-ins)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Barrier `id` over the n threads of one problem's warps.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
#endif

// One lane's 16 bytes of tile g of a packed row of nw words: copied when
// inside the row, `fill` otherwise (rows are whole 16-byte chunks).
__device__ __forceinline__ void load_tile(uint32_t* ring, const uint8_t* row,
                                          int nw, int g, uint32_t fill,
                                          int tid) {
  const int gw = g * kTileWords + 4 * tid;
  uint32_t* dst = ring + (gw & kRingMask);
  if (gw >= 0 && gw + 4 <= nw)
    cp_async16(dst, row + 4 * (size_t)gw);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(fill, fill, fill, fill);
}

// The score of a codes at a index qa against b at row i, from the rings.
__device__ __forceinline__ int score_at(const uint32_t* ring_a,
                                        const uint32_t* ring_b, int qa, int i,
                                        const Scoring& s) {
  const int ac = (ring_a[(qa >> 3) & kRingMask] >> (4 * (qa & 7))) & 15;
  const int bc = (ring_b[(i >> 3) & kRingMask] >> (4 * (i & 7))) & 15;
  return base_score(ac, bc, s);
}

// Per-thread constants of one problem.
template <int R>
struct Lanes {
  int k0;             // first lane of this thread (negative: padding)
  int mtop;           // ~0, or 0 on the last thread: lane K reads as 0
  int ug_top;         // up gap of lane R-1 at even steps (kNeg on lane K-1)
  int lg_even[R];     // left gap at even steps (kNeg on lane 0)
  int lo;             // lowest score: a score is lo + its 6-bit field
  int ba, band, al, xs1, jdb, YS, steps;
  int own_lo, own_hi;  // the split instance: lanes [own_lo, own_hi) owned
  bool fs;
};

// Swap slots of the warps of a block (W > 1): [warp][step parity], the
// top lane of thread 31 at even steps, the bottom lane of thread 0 at odd.
__shared__ int xch_s[kWarps][2];

// Halo slots of the split instance: [block parity][warp][low or high
// side][lane][p1, p2], the warp's 8 lowest and 8 highest owned lanes.
// Two sets in turn, so a warp that runs ahead writes the next block's
// while its neighbour still reads this block's.
__shared__ int halo_s[2][kWarps][2][kHalo][2];

// The lane beside the thread's lanes that a step reads: the top lane of
// thread g-1 at even steps (left), the bottom lane of thread g+1 at odd
// steps (up; 0 past lane K-1).  Across a warp boundary it comes through
// the swap slots: written, one barrier (1 + the problem's index in the
// block), read.  The thread's place is read afresh from threadIdx, which
// keeps it out of the registers of the step loop.
template <int R, int W>
__device__ __forceinline__ int neighbour(const int (&p1)[R], int par,
                                         const Lanes<R>& L) {
  int nb = par ? (__shfl_down_sync(kFull, p1[0], 1) & L.mtop)
               : __shfl_up_sync(kFull, p1[R - 1], 1);
  if constexpr (W > 1) {
    const int tid = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int wsub = kWarps == W ? w : w % W;
    if (par ? tid == 0 : tid == 31) xch_s[w][par] = par ? p1[0] : p1[R - 1];
    bar_sync(kWarps == W ? 1 : 1 + w / W, 32 * W);
    if (par ? tid == 31 && wsub < W - 1 : tid == 0 && wsub > 0)
      nb = par ? xch_s[w + 1][1] : xch_s[w - 1][0];
  }
  return nb;
}

// Whether this warp writes lane k's words and records: every lane in
// range, or the split instance's owned lanes.
template <bool HALO, int R>
__device__ __forceinline__ bool owned(const Lanes<R>& L, int k) {
  if constexpr (HALO)
    return k >= L.own_lo && k < L.own_hi;
  else
    return true;
}

// The last-row and pos == end_a cells among this step's lanes (the
// split instance's owned lanes).
template <int R, bool HALO>
__device__ __forceinline__ void record_hits(const int (&row)[R],
                                            const Lanes<R>& L, int t,
                                            int* lr, int* dg) {
  if (t >= L.steps) return;
  const int par = t & 1, base = t >> 1, chalf = base + par;
  const int dd = L.jdb - chalf - L.k0;  // lane of the pos == end_a cell
  if ((unsigned)dd < (unsigned)R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = par + 2 * (L.k0 + r);
      if (r == dd && j >= 0 && j < L.YS && owned<HALO>(L, L.k0 + r))
        dg[j] = row[r];
    }
  }
  const int ll = base - L.xs1 - L.k0;  // lane of the last-row cell
  if ((unsigned)ll < (unsigned)R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = par + 2 * (L.k0 + r);
      if (r == ll && j >= 0 && j < L.YS && owned<HALO>(L, L.k0 + r))
        lr[j] = row[r];
    }
  }
}

// Lean steps t0 .. t0+15 (t0 a multiple of 16) of one problem, fully
// unrolled.  p1/p2: the thread's lanes at steps t-1 and t-2; packed: this
// block's words; va / bc6: the block's a score vectors and 6 * b codes.
template <int R, int W, bool HALO, bool CHECK>
__device__ __forceinline__ void run_lean_block(
    int (&p1)[R], int (&p2)[R], unsigned (&packed)[R],
    const uint32_t (&va)[R + 8], const int (&bc6)[R + 7], const Lanes<R>& L,
    const Scoring& s, int t0, int* lr, int* dg) {
#pragma unroll
  for (int st = 0; st < 16; ++st) {
    const int par = st & 1;
    const int nb = neighbour<R, HALO ? 1 : W>(p1, par, L);
    int row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int up = par ? (r + 1 < R ? p1[r + 1] : nb) : p1[r];
      const int left = par ? p1[r] : (r > 0 ? p1[r - 1] : nb);
      const int sc =
          (int)((va[(st + 1) / 2 + r] >> bc6[st / 2 - r + R - 1]) & 63u) +
          L.lo;
      const int dv = p2[r] + sc;
      const int uv = up + ((!par && r == R - 1) ? L.ug_top : s.gap);
      const int lv = left + (par ? s.gap : L.lg_even[r]);
      const int rw = max(dv, max(uv, lv));
      const int d = rw == dv ? kDiag : (rw == uv ? kUp : kLeft);
      packed[r] |= (unsigned)d << (2 * st);
      row[r] = rw;
    }
    if (CHECK) record_hits<R, HALO>(row, L, t0 + st, lr, dg);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p2[r] = p1[r];
      p1[r] = row[r];
    }
  }
}

// Exact steps t0 .. t0+15: every mask of the reference per lane, the
// characters read from the rings per lane (these blocks are few: the
// first exact_steps(band)/16, or every block when begin_a < 0).
template <int R, int W, bool HALO>
__device__ __forceinline__ void run_exact_block(
    int (&p1)[R], int (&p2)[R], unsigned (&packed)[R],
    const uint32_t* ring_a, const uint32_t* ring_b, const Lanes<R>& L,
    const Scoring& s, int t0, int* lr, int* dg) {
  const int ymax = L.YS - 1;
#pragma unroll 1
  for (int st2 = 0; st2 < 16; st2 += 2) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const int t = t0 + st2 + par, base = t >> 1, chalf = base + par;
      const int nb = neighbour<R, HALO ? 1 : W>(p1, par, L);
      int row[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int up_raw = par ? (r + 1 < R ? p1[r + 1] : nb) : p1[r];
        const int left_raw = par ? p1[r] : (r > 0 ? p1[r - 1] : nb);
        const int k = L.k0 + r, i = base - k, j = par + 2 * k;
        const int sc = score_at(ring_a, ring_b, chalf + k, i, s);
        const int dv = p2[r] + sc;
        const bool jmax = j == ymax, j0 = j == 0, mid = !j0 && !jmax;
        const int pos = L.ba - L.band + chalf + k;
        const bool valid =
            j < L.YS && i >= 0 && i <= L.xs1 && pos >= 0 && pos < L.al;
        const bool i0 = i == 0, pos0 = pos == 0;
        const bool i0b = i0 && L.fs && pos > s.force_max_gap;
        const bool forced = !i0 && pos0 && L.fs && i > s.force_max_gap;
        const bool fresh = !i0 && pos0 && !forced;
        const bool gen = !i0 && !pos0;
        const bool inc_up = (i0 && !i0b) || (!i0 && !jmax);
        const int uv = inc_up ? up_raw + s.gap : kNeg;
        // row 0 takes sw[0][j-1] unpenalised (the reference's quirk)
        const int lv =
            (i0 && pos > 0 && !j0)
                ? left_raw
                : (fresh ? s.gap : ((gen && !j0) ? left_raw + s.gap : kNeg));
        const int rw = valid ? max(dv, max(uv, lv)) : 0;
        const bool left_blocked = L.fs && i > s.force_max_gap;
        const int d_pos0 =
            rw == sc ? kDiag
                     : ((jmax || (rw == s.gap && !left_blocked)) ? kLeft
                                                                 : kUp);
        int up_t = (i > 0 && !jmax) ? up_raw + s.gap : s.gap;
        if (L.fs && i0)
          up_t = (pos >= 0 && pos <= s.force_max_gap) ? s.gap : kNeg;
        const int d_gen =
            rw == dv ? kDiag
                     : ((mid && rw == up_t)
                            ? kUp
                            : (mid ? kLeft : (!jmax ? kUp : kLeft)));
        const int d = pos0 ? d_pos0 : d_gen;
        packed[r] |= (unsigned)d << (2 * (st2 + par));
        row[r] = rw;
      }
      record_hits<R, HALO>(row, L, t, lr, dg);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p2[r] = p1[r];
        p1[r] = row[r];
      }
    }
  }
}

// The split instance's swap after 16-step block n: each warp posts p1
// and p2 of its 8 lowest and 8 highest owned lanes (window offsets
// [8, 16) and [32R-16, 32R-8)), meets the problem's other warps at its
// named barrier, and takes its halos (offsets [0, 8) and [32R-8, 32R))
// from the warps below and above.
template <int R, int W>
__device__ __forceinline__ void swap_halo(int (&p1)[R], int (&p2)[R],
                                          int n, int pw) {
  constexpr int kTop = 32 * R - 2 * kHalo;  // the 8 highest owned offsets
  const int tid = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wsub = kWarps == W ? w : w % W;
  int(*slot)[2][kHalo][2] = halo_s[n & 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = tid * R + r;
    if ((unsigned)(o - kHalo) < (unsigned)kHalo) {
      slot[w][0][o - kHalo][0] = p1[r];
      slot[w][0][o - kHalo][1] = p2[r];
    }
    if ((unsigned)(o - kTop) < (unsigned)kHalo) {
      slot[w][1][o - kTop][0] = p1[r];
      slot[w][1][o - kTop][1] = p2[r];
    }
  }
  bar_sync(1 + pw, 32 * W);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = tid * R + r;
    if (wsub > 0 && o < kHalo) {
      p1[r] = slot[w - 1][1][o][0];
      p2[r] = slot[w - 1][1][o][1];
    }
    if (wsub < W - 1 && o >= 32 * R - kHalo) {
      p1[r] = slot[w + 1][0][o - (32 * R - kHalo)][0];
      p2[r] = slot[w + 1][0][o - (32 * R - kHalo)][1];
    }
  }
}

template <int R, int W, bool HALO>
__global__ void __launch_bounds__(32 * kWarps) antidiag_forward_kernel(
    const uint8_t* __restrict__ a_pk, const uint8_t* __restrict__ b_pk,
    const int* __restrict__ begin_a, const int* __restrict__ end_a,
    const int* __restrict__ a_len, const int* __restrict__ x_size,
    const int* __restrict__ force_start, int B, int aw, int xw, int band,
    int T, int NP, Scoring s, int lo, int* __restrict__ dirs,
    int* __restrict__ last_row, int* __restrict__ diag) {
  __shared__ __align__(16) uint32_t rings[kWarps / W][2][kRingWords];
  __shared__ uint32_t vec_s[16];
  const int tid = threadIdx.x & 31, w = threadIdx.x >> 5;
  // problem of the block and its warp (constants when a block holds one)
  const int pw = kWarps == W ? 0 : w / W, wsub = kWarps == W ? w : w % W;
  const int g = 32 * wsub + tid;       // thread of the problem
  if (threadIdx.x < 16) {
    // score vector of a code: (score(a, b) - lo) << 6b for b codes 0-4
    uint32_t v = 0;
    for (int bc = 0; bc < 5; ++bc)
      v |= (uint32_t)(base_score(threadIdx.x, bc, s) - lo) << (6 * bc);
    vec_s[threadIdx.x] = v;
  }
  __syncthreads();  // the kernel's only block-wide barrier
  const int b = blockIdx.x * (kWarps / W) + pw;
  if (b >= B) return;  // every warp of the problem together

  const int K = band + 1, YS = 2 * band + 1, P = 32 * W * R - K;
  const bool last = g == 32 * W - 1;
  Lanes<R> L;
  L.k0 = g * R - P;
  if constexpr (HALO) {
    // warp wsub's window starts (W-1-wsub) strips of 32R - 16 lanes below
    // the last warp's, which ends at lane K-1
    const int base = K - 32 * R - (W - 1 - wsub) * (32 * R - 2 * kHalo);
    L.k0 = base + tid * R;
    L.own_lo = wsub == 0 ? 0 : max(0, base + kHalo);
    L.own_hi = wsub == W - 1 ? K : base + 32 * R - kHalo;
  }
  L.mtop = last ? 0 : ~0;
  L.ug_top = last ? kNeg : s.gap;
#pragma unroll
  for (int r = 0; r < R; ++r) L.lg_even[r] = L.k0 + r == 0 ? kNeg : s.gap;
  L.lo = lo;
  L.ba = begin_a[b];
  L.band = band;
  L.al = a_len[b];
  const int xs = x_size[b];
  L.xs1 = xs - 1;
  L.jdb = end_a[b] - L.ba + band;  // pos == end_a <=> k == jdb - ceil(t/2)
  L.YS = YS;
  L.steps = xs > 0 ? min(2 * (xs - 1) + 2 * band + 1, T) : 0;
  L.fs = force_start[b] != 0;

  const uint8_t* ap = a_pk + (size_t)b * (aw / 2);
  const uint8_t* bp = b_pk + (size_t)b * (xw / 2);
  int* dir_out = dirs + (size_t)b * NP * K;
  int* lr = last_row + (size_t)b * YS;
  int* dg = diag + (size_t)b * YS;
  uint32_t* ring_a = rings[pw][0];
  uint32_t* ring_b = rings[pw][1];
  const int nwa = aw / 8, nwb = xw / 8;
  // the problem's warps after the copies: one warp, or all W
  auto sync_problem = [&] {
    if constexpr (W > 1)
      bar_sync(1 + pw, 32 * W);
    else
      __syncwarp();
  };

  for (int q = g; q < YS; q += 32 * W) {
    lr[q] = 0;
    dg[q] = 0;
  }
  // tiles -1 .. 2 now; tile s+3 at the start of stage s (warp 0 copies)
  if (wsub == 0) {
    for (int tile = -1; tile <= 2; ++tile) {
      load_tile(ring_a, ap, nwa, tile, 0xffffffffu, tid);
      load_tile(ring_b, bp, nwb, tile, 0u, tid);
    }
  }
  cp_async_commit();
  sync_problem();

  const int nblk = (L.steps + 15) >> 4;
  const int exact_blk = (2 * band + 3 + 15) >> 4;
  const int n_exact = L.ba < 0 ? nblk : min(nblk, exact_blk);
  // a codes of this thread's block n start at 8n + k0, b codes at
  // 8n - k0 - R + 1: word offsets and in-word shifts are loop invariant
  const int qb0 = -L.k0 - R + 1;
  const int wa0 = L.k0 >> 3, sha = 4 * (L.k0 & 7);
  const int wb0 = qb0 >> 3, shb = 4 * (qb0 & 7);
  constexpr int NA = R + 8, NB = R + 7;
  constexpr int AWDS = (NA + 7) / 8, BWDS = (NB + 7) / 8;

  int p1[R], p2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) p1[r] = p2[r] = 0;

  for (int n = 0; n < nblk; ++n) {
    if (n % kStageBlocks == 0) {
      const int stage = n / kStageBlocks;
      if (wsub == 0) {
        load_tile(ring_a, ap, nwa, stage + 3, 0xffffffffu, tid);
        load_tile(ring_b, bp, nwb, stage + 3, 0u, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // tiles <= stage+2 have landed
      sync_problem();
    }
    unsigned packed[R];
#pragma unroll
    for (int r = 0; r < R; ++r) packed[r] = 0;
    const int t0 = 16 * n;
    if (n < n_exact) {
      run_exact_block<R, W, HALO>(p1, p2, packed, ring_a, ring_b, L, s, t0,
                                  lr, dg);
    } else {
      uint32_t va[NA];
      int bc6[NB];
      uint32_t wv[AWDS + 1], al[AWDS];
#pragma unroll
      for (int i = 0; i <= AWDS; ++i)
        wv[i] = ring_a[(n + wa0 + i) & kRingMask];
#pragma unroll
      for (int i = 0; i < AWDS; ++i)
        al[i] = __funnelshift_r(wv[i], wv[i + 1], sha);
#pragma unroll
      for (int m = 0; m < NA; ++m)
        va[m] = vec_s[(al[m >> 3] >> (4 * (m & 7))) & 15];
      uint32_t wb[BWDS + 1], bl[BWDS];
#pragma unroll
      for (int i = 0; i <= BWDS; ++i)
        wb[i] = ring_b[(n + wb0 + i) & kRingMask];
#pragma unroll
      for (int i = 0; i < BWDS; ++i)
        bl[i] = __funnelshift_r(wb[i], wb[i + 1], shb);
#pragma unroll
      for (int m = 0; m < NB; ++m)
        bc6[m] = 6 * (int)((bl[m >> 3] >> (4 * (m & 7))) & 15);
      // can a lane of this thread hold the diagonal or last-row cell in
      // this block?  (ceil(t/2) in [8n, 8n+8], t/2 in [8n, 8n+7])
      const int hd = L.jdb - 8 * n - L.k0, hl = 8 * n - L.xs1 - L.k0;
      const bool hit = (hd >= 0 && hd - 8 <= R - 1) ||
                       (hl + 7 >= 0 && hl <= R - 1);
      if (__any_sync(kFull, hit))
        run_lean_block<R, W, HALO, true>(p1, p2, packed, va, bc6, L, s, t0,
                                         lr, dg);
      else
        run_lean_block<R, W, HALO, false>(p1, p2, packed, va, bc6, L, s, t0,
                                          lr, dg);
    }
    const int left_steps = L.steps - t0;  // steps of the block the problem runs
    if (left_steps < 16) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        packed[r] &= (1u << (2 * left_steps)) - 1u;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (L.k0 + r >= 0 && owned<HALO>(L, L.k0 + r))
        dir_out[(size_t)n * K + L.k0 + r] = (int)packed[r];
    if constexpr (HALO)
      if (n + 1 < nblk) swap_halo<R, W>(p1, p2, n, pw);
  }
  for (int q = nblk * K + g; q < NP * K; q += 32 * W) dir_out[q] = 0;
  cp_async_wait<0>();
}

template <int R, int W, bool HALO>
int launch(const void* a_pk, const void* b_pk, const void* begin_a,
           const void* end_a, const void* a_len, const void* x_size,
           const void* force_start, int B, int aw, int xw, int band, int T,
           int NP, const Scoring& s, int lo, void* dirs, void* last_row,
           void* diag, cudaStream_t stream) {
  constexpr int per_block = kWarps / W;  // problems a block
  const int blocks = (B + per_block - 1) / per_block;
  antidiag_forward_kernel<R, W, HALO><<<blocks, 32 * kWarps, 0, stream>>>(
      (const uint8_t*)a_pk, (const uint8_t*)b_pk, (const int*)begin_a,
      (const int*)end_a, (const int*)a_len, (const int*)x_size,
      (const int*)force_start, B, aw, xw, band, T, NP, s, lo, (int*)dirs,
      (int*)last_row, (int*)diag);
  return (int)cudaGetLastError();
}

// An instance of the kernel: R lanes a thread, W warps a problem, and
// whether it is the split instance (halo strips) or, for W = 4 above
// band 511, the exchange a step.
struct Instance {
  int R, W;
  bool halo;
};

// (R, W, halo) of every instance built: one warp (up to 160 lanes); the
// split instance of four warps a problem; four warps a step apart.
#define GAM_INSTANCES(X)                                                    \
  X(1, 1, false) X(2, 1, false) X(5, 1, false)                              \
  X(1, 4, true) X(2, 4, true) X(3, 4, true) X(4, 4, true) X(5, 4, true)     \
  X(10, 4, false)

// The lanes an instance covers: 32R a warp, less the split instance's
// halos where its strips meet.
constexpr int lanes_of(int R, int W, bool halo) {
  return 32 * R * W - (halo ? 2 * kHalo * (W - 1) : 0);
}

// The narrowest instance built of W warps (halo or not) that covers K
// lanes; R = 0 when none does.
Instance narrowest(int K, int W, bool halo) {
  Instance best{0, W, halo};
#define GAM_FIT(RR, WW, HH)                                                 \
  if (WW == W && HH == halo && lanes_of(RR, WW, HH) >= K &&                 \
      (best.R == 0 || RR < best.R))                                         \
    best.R = RR;
  GAM_INSTANCES(GAM_FIT)
#undef GAM_FIT
  return best;
}

// The instance a launch of B problems at `band` takes on a card of
// `sms` SMs.  One warp a problem leaves the card's schedulers empty on
// small launches, where a problem's step chain on its lone warp sets the
// time; the split instance of four warps cuts a thread's lanes, so its
// chain, R1 = 5 -> R4 = 2 at band 150.  It pays where it takes at least
// two lanes a thread off (R4 + 2 <= R1: from band 64) and the batch
// leaves the card unfilled (B <= 2 SMs); elsewhere one warp a problem.
// From band 160 (more lanes than one warp's R = 5 holds) the split runs
// at every batch: one warp there (R 8-16) lost at every batch measured.
// Bands 512-1023 take four warps a step apart.  The A/B behind it (ms a
// launch, XW 4096, one warp / split; H100 SXM, 132 SMs, 700 W):
//   band 150: B 1 0.706 / 0.414, 8 0.802 / 0.462, 16 0.799 / 0.464,
//             32 0.808 / 0.468, 64 0.808 / 0.471, 128 0.808 / 0.460,
//             256 0.799 / 0.671, 384 0.825 / 0.933, 512 0.823 / 1.174;
//   band 63 (R 2 / 1): B 8 0.335 / 0.328, 64 0.348 / 0.347, 256 0.344 /
//             0.420; band 30 (R 1 / 1): B 8 0.291 / 0.326;
//   band 300: B 8 2.117 / 0.763, 256 2.336 / 1.130, 512 2.497 / 1.979;
//   band 511: B 8 4.939 / 1.611, 256 5.505 / 2.351, 2048 13.637 / 10.625.
Instance pick(int band, int B, int sms) {
  const int K = band + 1;
  if (K > 512) return {10, 4, false};
  const Instance one = narrowest(K, 1, false);
  const Instance split = narrowest(K, 4, true);
  if (one.R == 0) return split;
  return split.R + 2 <= one.R && B <= 2 * sms ? split : one;
}

// SMs of the current device (0 where the runtime cannot tell: then every
// launch below band 160 takes one warp a problem).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

int launch_instance(const Instance& in, const void* a_pk, const void* b_pk,
                    const void* begin_a, const void* end_a, const void* a_len,
                    const void* x_size, const void* force_start, int B,
                    int aw, int xw, int band, int T, int NP,
                    const Scoring& s, int lo, void* dirs, void* last_row,
                    void* diag, cudaStream_t stream) {
#define GAM_LAUNCH(RR, WW, HH)                                              \
  if (in.R == RR && in.W == WW && in.halo == HH)                            \
    return launch<RR, WW, HH>(a_pk, b_pk, begin_a, end_a, a_len, x_size,   \
                              force_start, B, aw, xw, band, T, NP, s, lo,   \
                              dirs, last_row, diag, stream);
  GAM_INSTANCES(GAM_LAUNCH)
#undef GAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The forward of B problems; taken (null or 3 ints) gets W, R and
// whether the instance launched is the split one.
extern "C" int bsw_antidiag_forward_taken(
    const void* a_pk, const void* b_pk, const void* begin_a,
    const void* end_a, const void* a_len, const void* x_size,
    const void* force_start, int B, int aw, int xw, int band, int T, int NP,
    int match, int mismatch, int nn, int nx, int gap, int force_max_gap,
    void* dirs, void* last_row, void* diag, void* stream, int* taken) {
  if (band < 0 || band > 1023) return (int)cudaErrorInvalidValue;
  const Scoring s{match, mismatch, nn, nx, gap, force_max_gap};
  const int lo = min(min(match, mismatch), min(nn, nx));
  const Instance in = pick(band, B, sm_count());
  if (taken) {
    taken[0] = in.W;
    taken[1] = in.R;
    taken[2] = in.halo;
  }
  return launch_instance(in, a_pk, b_pk, begin_a, end_a, a_len, x_size,
                         force_start, B, aw, xw, band, T, NP, s, lo, dirs,
                         last_row, diag, (cudaStream_t)stream);
}

// The same without the instance: the C interface every version of this
// file shares (tools/kernel_ab.py times one tree's against another's).
extern "C" int bsw_antidiag_forward(const void* a_pk, const void* b_pk,
                                    const void* begin_a, const void* end_a,
                                    const void* a_len, const void* x_size,
                                    const void* force_start, int B, int aw,
                                    int xw, int band, int T, int NP,
                                    int match, int mismatch, int nn, int nx,
                                    int gap, int force_max_gap, void* dirs,
                                    void* last_row, void* diag,
                                    void* stream) {
  return bsw_antidiag_forward_taken(a_pk, b_pk, begin_a, end_a, a_len,
                                    x_size, force_start, B, aw, xw, band, T,
                                    NP, match, mismatch, nn, nx, gap,
                                    force_max_gap, dirs, last_row, diag,
                                    stream, nullptr);
}

// info[0], info[1] = W, R of the instance bsw_antidiag_forward takes for
// B problems at `band` on the current device.
extern "C" int bsw_antidiag_instance(int band, int B, int* info) {
  if (band < 0 || band > 1023) return (int)cudaErrorInvalidValue;
  const Instance in = pick(band, B, sm_count());
  info[0] = in.W;
  info[1] = in.R;
  return 0;
}
