// Find-max and traceback walk over the forward kernels' direction words.
//
// Replaces gam_ngs_tpu/ops/bsw_batch.py::_find_max_builder and
// _device_traceback_raw (the lockstep lax.scan walk of LMAX steps; XLA in
// the JAX package, a hand kernel here because in torch ops every walk
// step would be its own launches).  One warp per problem, kWarps
// problems a block, the blocks spread over the SMs:
//   1. find-max as a warp reduction over the 2*(2*band+1) candidates: the
//      last row (j ascending, skipped under force_end) then the pos_a ==
//      end_a diagonal (i ascending; force_end keeps the trailing
//      FORCE_MAXGAP_LEN+1 rows, and none at all when x_size <=
//      FORCE_MAXGAP_LEN: the reference's unsigned underflow).  The first
//      maximum wins (banded_smith_waterman.cc:175-214), so the lanes
//      reduce (score, candidate order) as max of score, then min of order;
//   2. the walk from that cell, a dependent chain of iterations that every
//      lane of the warp follows in step, reading the 2-bit directions
//      from the forward kernel's words and the characters from the 4-bit
//      packed windows, until the walk leaves the band or the sequences.
//      layout 0 reads bsw_antidiag's step-major words (B, NP, band+1):
//      cell (x, y) at word (2x+y)/16, lane y/2, bits 2*((2x+y) & 15);
//      layout 1 reads bsw_row's row-major words (B, NP, 2*band+1): cell
//      (x, y) at word x/16, lane y, bits 2*(x & 15).
// It writes the 14-int summary (xf, yf, cnt, matches, gapa, gapb, hasm,
// fmx, fmy, lmx, lmy, score, found, iters), (14, B): the answer, then the
// chain's iterations; and, when `edits` is not null, the edit codes in
// walk order, (B, lmax) bytes.
//
// An iteration is one step or one diagonal run.  A diagonal step (x-1,
// y) reads the same column of the words, 2 fields further down in
// layout 0 (8 steps a word) and 1 in layout 1 (16 a word).  Where the
// walk stands on a diagonal step and every field of its word's column
// below it, on the step's parity, is diagonal too (one shift, one mask,
// one compare), the warp takes the run whole, 32 word rows an iteration
// (Run, run_steps, settle_run):
//   look: lane l loads the column word of word row cw-l (256 steps ahead
//     in layout 0, 512 in layout 1) straight from device memory, and the
//     a and b code words of its own steps; a ballot finds the first lane
//     whose word holds a field that is not diagonal, and so the run's
//     length D;
//   clip: the run takes L = min(D, lmax - s, x + 1, ba + x + y - band + 1)
//     steps, where the per-step chain would have stopped;
//   settle: each lane compares its steps' a and b codes as 4-bit nibbles
//     (XOR and a zero-nibble test; code 4, N, on either side matches); a
//     warp sum gives the matches, ballots the first and last of them, and
//     each lane stores its edit codes;
//   overlap: where the lookahead found neither a field that ends the run
//     nor a clip, the next lookahead's loads go out before the settle.
// Every other step takes the per-step chain: it reads its 2-bit
// direction from shared memory and moves (x, y); lane s - sb keeps step
// s's cell and direction, sb being the first step not yet settled.
// Every 32 steps, before a run and at the end, the warp settles those
// steps in parallel: each lane reads its cell's a and b codes, and
// ballots give the match and gap counts, the first and last match and,
// when asked for, one coalesced store of the edit codes.
//
// Staging of the per-step chain: it visits the word rows (2x+y)/16
// (layout 0) or x/16 (layout 1) in descending order.  Each warp
// keeps a ring of kGroups groups of kGroupRows whole word rows in shared
// memory (the Ring).  Entering group g the warp starts the copies of
// group g-kGroups+2, with the a and b code words its rows' cells can
// read, as one commit group, and waits for the group of g; a row change
// inside a group only moves a pointer.  After a run the chain steps the
// ring down to the run's end group by group where that group was already
// in flight, and fills the ring anew around it where the run went
// further.  The code rings are wide enough
// that the codes of the rows up to 3 above the walk's (the last 32
// steps) stay in place.  Two rings:
//   NarrowRing, layout 0 and layout 1 below kWideBand: four groups of
//   four rows (16 rows of band+1 or 2*band+1 words); a group's rows are
//   contiguous in dirs, so one loop of 4-byte cp.async copies brings it
//   in, one to two groups (32-128 steps in layout 0) ahead of the walk;
//   WideRing, layout 1 from kWideBand (band 1024) to 4095, where 16 rows
//   of 2*band+1 words would not fit past band ~1567: three groups of one
//   row (the row the walk is in, the row in flight, one spare; 98 KB at
//   band 4095, so two warps fit the card's 227 KB).  Each diag or up
//   step takes x one row down the 16 of a word row, so a row lasts at
//   least 16 steps, the time its successor's copy has to land.  A row is
//   copied as the 16-byte-aligned span that covers it (rows start at
//   4*KL*v bytes and KL is odd), with 16-byte cp.async.cg: a quarter of
//   the copy instructions the serial chain's lanes would otherwise issue.
//   The span's end chunks carry up to 3 words beside the row (at dirs'
//   ends, bytes past it in the same 16-byte chunk, so on the same page);
//   the walk reads none of them.
//
// Bound on this card: a per-step iteration is a shared-memory load and
// ~10 dependent int32 operations; a run iteration is one round trip to
// device memory (to L2 where the forward's words still are) for up to
// 256 (layout 0) or 512 (layout 1) steps, the next one's loads in flight
// under its settle.  The ring's copies run ahead of the chain.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0, kUp = 1, kLeft = 2;
// editops codes
constexpr uint8_t kGapA = 0, kGapB = 1, kMatch = 2, kMismatch = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;

// The word-row rings (see the note above): kGroups groups of kGroupRows
// rows, in slots of slot_words(KL) words; kSpan16 copies a row's 16-byte
// chunks; kBudget is the shared memory a block may take.
struct NarrowRing {
  static constexpr int kGroupRows = 4, kGroups = 4;
  static constexpr bool kSpan16 = false;
  static constexpr size_t kBudget = 200 * 1024;
};
struct WideRing {
  static constexpr int kGroupRows = 1, kGroups = 3;
  static constexpr bool kSpan16 = true;
  static constexpr size_t kBudget = 232448;  // 227 KB
};
constexpr int kWideBand = 1024;  // layout 1's first band on WideRing

#ifdef __CUDACC__
// cp.async (tests/cuda_emu/cuda_runtime.h defines the host's stand-ins)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

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
#endif

// One lane's part of a diagonal run's lookahead from cell (x, y) (see
// the note above).  Step k of the run is cell (x - k, y); a full word
// holds kSteps of them, kStride fields apart; the lane's steps k .. k +
// kSteps - 1 read the b codes lo .. lo + kSteps - 1 (lo = x - k -
// kSteps + 1, step j of the lane at code kSteps - 1 - j) and the a codes
// y above them, which lie in kWords code words each.
template <int LAYOUT>
struct Run {
  static constexpr int kStride = LAYOUT ? 1 : 2;
  static constexpr int kSteps = 16 / kStride;
  static constexpr int kWords = kSteps / 8 + 1;
  // the fields of a step's parity, shifted up to end in field 15
  static constexpr uint32_t kParity = LAYOUT ? 0xffffffffu : 0xccccccccu;
  int x;   // the run's first cell is (x, y), alike in every lane
  int c0;  // steps left in its word row, alike in every lane
  int k;   // this lane's first step: the first of word row cw - lane
  uint32_t w;  // this lane's column word
  uint32_t a[kWords], b[kWords];
};

// One warp's staging state: the word-row ring and the two code-word
// rings, and how far down the code words have been fetched.
template <int LAYOUT, class Ring>
struct Stage {
  static constexpr int kRows = Ring::kGroupRows * Ring::kGroups;
  uint32_t* rows;  // kRows slots of SW words
  uint32_t* ca;    // cmask+1 words of a codes, word q at q & cmask
  uint32_t* cb;    // the same for b
  const int* dp;   // this problem's direction words
  const uint32_t* ap;
  const uint32_t* bp;
  int KL, SW, NP, cmask, nwa, nwb, band, a_lo, b_lo, tid;

  // words a row's slot takes: the row, or the 16-byte chunks that cover
  // it at any of the 4 alignment phases
  __host__ __device__ static int slot_words(int KL) {
    return Ring::kSpan16 ? ((KL + 6) >> 2) * 4 : KL;
  }
  // the 4-byte phase of word row v's start in its first 16-byte chunk
  __device__ int phase(int v) const {
    return (int)((reinterpret_cast<uintptr_t>(dp + (size_t)v * KL) >> 2) &
                 3);
  }
  // word row v's words in the ring (v >= 0)
  __device__ const uint32_t* row_ptr(int v) const {
    const uint32_t* p = rows + (int)((unsigned)v % kRows) * SW;
    if constexpr (Ring::kSpan16) p += phase(v);
    return p;
  }

  // lowest a / b code words the cells of word row v can read
  __device__ int a_lo_word(int v) const {
    return LAYOUT ? 2 * v : v - 1;  // 16v ; 8v - 7
  }
  __device__ int b_lo_word(int v) const {
    return LAYOUT ? 2 * v : (8 * v - band) >> 3;  // 16v ; 8v - band
  }
  __device__ void fetch_codes(uint32_t* ring, const uint32_t* src, int nw,
                              int lo, int hi, uint32_t fill) {
    for (int q = lo + tid; q < hi; q += 32) {
      uint32_t* dst = ring + (q & cmask);
      if (q >= 0 && q < nw)
        cp_async4(dst, src + q);
      else
        *dst = fill;
    }
  }
  // copies for the word rows of group g (none below row 0 or from row
  // NP on), as one commit group
  __device__ void fetch(int g) {
    const int v = g * Ring::kGroupRows;
    if (v >= 0) {
      uint32_t* dst = rows + (int)((unsigned)v % kRows) * SW;
      const int* src = dp + (size_t)v * KL;
      if constexpr (Ring::kSpan16) {  // one row, 16 bytes a copy
        const int ph = phase(v);
        const uint4* s16 = reinterpret_cast<const uint4*>(src - ph);
        const int n = (ph + KL + 3) >> 2;
        for (int q = tid; q < n; q += 32) cp_async16(dst + 4 * q, s16 + q);
      } else {
        const int n = (min(v + Ring::kGroupRows, NP) - v) * KL;
        for (int q = tid; q < n; q += 32) cp_async4(dst + q, src + q);
      }
      const int al = a_lo_word(v), bl = b_lo_word(v);
      if (al < a_lo) {
        fetch_codes(ca, ap, nwa, al, a_lo, 0xffffffffu);
        a_lo = al;
      }
      if (bl < b_lo) {
        fetch_codes(cb, bp, nwb, bl, b_lo, 0u);
        b_lo = bl;
      }
    }
    cp_async_commit();
  }
  // this lane's part of the lookahead of a diagonal run from cell (x,
  // y): loads only, from device memory, so that they can fly while the
  // warp settles the run before
  __device__ void look(Run<LAYOUT>& r, int x, int y) const {
    using R = Run<LAYOUT>;
    const int t = LAYOUT ? x : 2 * x + y;
    r.x = x;
    r.c0 = ((t & 15) >> (R::kStride - 1)) + 1;
    r.k = tid ? r.c0 + R::kSteps * (tid - 1) : 0;
    const int v = (t >> 4) - tid;
    r.w = v >= 0 ? (uint32_t)__ldg(dp + (size_t)v * KL +
                                   (LAYOUT ? y : y >> 1))
                 : ~0u;
    const int lo = x - r.k - (R::kSteps - 1);
#pragma unroll
    for (int i = 0; i < R::kWords; ++i) {
      const int qb = (lo >> 3) + i, qa = ((lo + y) >> 3) + i;
      r.b[i] = qb >= 0 && qb < nwb ? __ldg(bp + qb) : 0u;
      r.a[i] = qa >= 0 && qa < nwa ? __ldg(ap + qa) : 0xffffffffu;
    }
  }
  __device__ int code_a(int q) const {
    return (ca[(q >> 3) & cmask] >> (4 * (q & 7))) & 15;
  }
  __device__ int code_b(int q) const {
    return (cb[(q >> 3) & cmask] >> (4 * (q & 7))) & 15;
  }
};

// The walk's counters, kept alike in every lane.
struct Tally {
  int matches = 0, gapa = 0, gapb = 0, hasm = 0;
  int fmx = 0, fmy = 0, lmx = 0, lmy = 0;
  // n > 0 more matches, the first of them seen at (lx, ly) and the last
  // at (fx, fy): walk order is reverse alignment order, so the last
  // match seen is the alignment's first, the first seen its last
  __device__ void matched(int n, int fx, int fy, int lx, int ly) {
    fmx = fx;
    fmy = fy;
    if (!hasm) {
      lmx = lx;
      lmy = ly;
    }
    hasm = 1;
    matches += n;
  }
};

// Settle the n (1..32) steps s0 .. s0+n-1 that lanes 0 .. n-1 recorded:
// cell (rx, ry), direction rd.
template <class S>
__device__ __forceinline__ void settle(const S& sg, Tally& tl,
                                       int n, int rx, int ry, int rd,
                                       uint8_t* ed, int s0) {
  const bool mine = sg.tid < n;
  const int ca = sg.code_a(rx + ry), cb = sg.code_b(rx);
  const bool is_match = ca == cb || ca == 4 || cb == 4;
  const unsigned m = __ballot_sync(kFull, mine && rd == kDiag && is_match);
  tl.gapa += __popc(__ballot_sync(kFull, mine && rd == kUp));
  tl.gapb += __popc(__ballot_sync(kFull, mine && rd == kLeft));
  if (ed && mine)
    ed[s0 + sg.tid] = rd == kDiag ? (is_match ? kMatch : kMismatch)
                                  : (rd == kUp ? kGapA : kGapB);
  if (m) {
    const int last = 31 - __clz(m), first = __ffs(m) - 1;
    const int fx = __shfl_sync(kFull, rx, last);
    const int fy = __shfl_sync(kFull, ry, last);
    const int lx = __shfl_sync(kFull, rx, first);
    const int ly = __shfl_sync(kFull, ry, first);
    tl.matched(__popc(m), fx, fy, lx, ly);
  }
}

// The steps D of the diagonal run whose lookahead is r: to the first
// field that is not diagonal, on the run's parity, in word row cw, cw-1,
// ..., cw-31 (from the run's first step down in cw, whole words below),
// or all of them.  Alike in every lane.
template <int LAYOUT>
__device__ __forceinline__ int run_steps(const Run<LAYOUT>& r, int y,
                                         int tid) {
  using R = Run<LAYOUT>;
  const int t = LAYOUT ? r.x : 2 * r.x + y;
  // the lane's first field: the run's in word row cw, the top one below
  const int f = tid ? (LAYOUT ? 15 : 14 + (t & 1)) : t & 15;
  const uint32_t nd = (r.w << (30 - 2 * f)) & R::kParity;
  const unsigned stop = __ballot_sync(kFull, nd != 0);
  const int d = r.k + (nd ? (15 - ((31 - __clz(nd)) >> 1)) / R::kStride
                          : 0);
  return stop ? __shfl_sync(kFull, d, __ffs(stop) - 1)
              : r.c0 + R::kSteps * 31;
}

// high bit of each nibble of v that is 0
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t v) {
  return ~(((v & 0x77777777u) + 0x77777777u) | v) & 0x88888888u;
}

// Settle the L steps s .. s+L-1 of the diagonal run whose lookahead is
// r, as settle does the per-step chain's.
template <int LAYOUT>
__device__ __forceinline__ void settle_run(const Run<LAYOUT>& r, int y,
                                           int L, Tally& tl, uint8_t* ed,
                                           int s, int tid) {
  using R = Run<LAYOUT>;
  const int lo = r.x - r.k - (R::kSteps - 1);  // b code of nibble 0
  const int n = min(tid ? R::kSteps : r.c0, L - r.k);  // this lane's steps
  const uint32_t pa = 4 * ((lo + y) & 7), pb = 4 * (lo & 7);
  uint64_t m = 0;  // bit 4i+3: code lo+i matches
#pragma unroll
  for (int g = 0; g < R::kSteps / 8; ++g) {
    const uint32_t va = __funnelshift_r(r.a[g], r.a[g + 1], pa);
    const uint32_t vb = __funnelshift_r(r.b[g], r.b[g + 1], pb);
    m |= (uint64_t)(zero_nibbles(va ^ vb) | zero_nibbles(va ^ 0x44444444u) |
                    zero_nibbles(vb ^ 0x44444444u))
         << (32 * g);
  }
  m = n > 0 ? m & (~0ull << (4 * (R::kSteps - n))) : 0ull;
  const int matches = __reduce_add_sync(kFull, __popcll(m));
  const unsigned has = __ballot_sync(kFull, m != 0);
  if (has) {
    // the run's last match is the lowest code of the last lane with one
    const int last = lo + ((__ffsll(m) - 1) >> 2);
    const int first = lo + ((63 - __clzll(m)) >> 2);
    const int fx = __shfl_sync(kFull, last, 31 - __clz(has));
    const int lx = __shfl_sync(kFull, first, __ffs(has) - 1);
    tl.matched(matches, fx, y, lx, y);
  }
  if (ed)
    for (int j = 0; j < n; ++j)
      ed[s + r.k + j] =
          (m >> (4 * (R::kSteps - 1 - j) + 3)) & 1 ? kMatch : kMismatch;
}

template <int LAYOUT, class Ring>
__global__ void __launch_bounds__(32 * kMaxWarps) walk_kernel(
    const int* __restrict__ dirs, const uint8_t* __restrict__ a_pk,
    const uint8_t* __restrict__ b_pk, const int* __restrict__ begin_a,
    const int* __restrict__ end_a, const int* __restrict__ x_size,
    const int* __restrict__ force_end, const int* __restrict__ last_row,
    const int* __restrict__ diag, int B, int aw, int xw, int band, int NP,
    int lmax, int force_max_gap, int cmask, int* __restrict__ summary,
    uint8_t* __restrict__ edits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;
  const int YS = 2 * band + 1, KL = LAYOUT ? YS : band + 1;
  const int ba = begin_a[b], ea = end_a[b], xs = x_size[b];
  const bool fe = force_end[b] != 0;
  const int* lr = last_row + (size_t)b * YS;
  const int* dg = diag + (size_t)b * YS;

  // 1. find-max: candidate c < YS is last-row lane j = c, c >= YS the
  // diagonal's j = YS-1-(c-YS), i = C - j ascending; c is its order
  const int C = ea - ba + band;  // diagonal j holds row i = C - j
  const int i0 = max(ea - ba - band, 0);
  const bool fe_ok = xs - 1 - force_max_gap >= 0;
  int bv = INT_MIN, bo = INT_MAX;
  for (int c = tid; c < 2 * YS; c += 32) {
    int v;
    bool ok;
    if (c < YS) {
      const int pos = ba + (xs - 1) - band + c;
      ok = !fe && pos >= 0 && pos <= ea;
      v = ok ? lr[c] : 0;
    } else {
      const int j = 2 * YS - 1 - c, i = C - j;
      ok = i >= i0 && i < xs &&
           (!fe || (fe_ok && i >= xs - 1 - force_max_gap));
      v = ok ? dg[j] : 0;
    }
    if (ok && (v > bv || (v == bv && c < bo))) {
      bv = v;
      bo = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, off);
    const int oo = __shfl_xor_sync(kFull, bo, off);
    if (ov > bv || (ov == bv && oo < bo)) {
      bv = ov;
      bo = oo;
    }
  }
  const bool found = bo != INT_MAX;
  int mi = 0, mj = 0, ms = 0;
  if (found) {
    ms = bv;
    if (bo < YS) {
      mi = xs - 1;
      mj = bo;
    } else {
      mj = 2 * YS - 1 - bo;
      mi = C - mj;
    }
  }

  // 2. the walk
  using S = Stage<LAYOUT, Ring>;
  constexpr int GR = Ring::kGroupRows, NG = Ring::kGroups;
  S sg;
  sg.SW = S::slot_words(KL);
  const int rows_words = S::kRows * sg.SW;
  sg.rows = smem + (size_t)w * (rows_words + 2 * (cmask + 1));
  sg.ca = sg.rows + rows_words;
  sg.cb = sg.ca + cmask + 1;
  sg.dp = dirs + (size_t)b * NP * KL;
  sg.ap = reinterpret_cast<const uint32_t*>(a_pk + (size_t)b * (aw / 2));
  sg.bp = reinterpret_cast<const uint32_t*>(b_pk + (size_t)b * (xw / 2));
  sg.KL = KL;
  sg.NP = NP;
  sg.cmask = cmask;
  sg.nwa = aw / 8;
  sg.nwb = xw / 8;
  sg.band = band;
  sg.tid = tid;

  uint8_t* ed = edits ? edits + (size_t)b * lmax : nullptr;
  int x = found ? mi : -1, y = mj, s = 0;
  Tally tl;
  bool active = x >= 0 && y >= 0 && ba + x + y - band >= 0 && lmax > 0;
  int cw = 0;        // word row staged for the current step
  const uint32_t* row = sg.rows;  // its slot
  int rx = 0, ry = 0, rd = 0;     // the cell and direction this lane keeps
  int sb = 0;                     // the first step not yet settled
  int iters = 0;                  // the chain's iterations
  // the ring around word row v: every code word up to the highest its
  // cells can read, and the groups from v's down
  auto prime = [&](int v) {
    cw = v;
    sg.a_lo = (LAYOUT ? 16 * cw + 15 + 2 * band : 8 * cw + 15 + band) / 8 + 1;
    sg.b_lo = (LAYOUT ? 16 * cw + 15 : 8 * cw + 7) / 8 + 1;
    for (int g = cw / GR; g > cw / GR - NG + 1; --g) sg.fetch(g);
    cp_async_wait<NG - 2>();
    __syncwarp();
    row = sg.row_ptr(cw);
  };
  if (active) prime((LAYOUT ? x : 2 * x + y) >> 4);
  while (active) {
    const int t = LAYOUT ? x : 2 * x + y;
    while (t < 16 * cw) {  // one row down: row cw-1
      --cw;
      if (cw % GR == GR - 1) {  // and into group cw/GR
        __syncwarp();  // every lane is done with the slots refilled next
        sg.fetch(cw / GR - NG + 2);
        cp_async_wait<NG - 2>();
        __syncwarp();
      }
      row = sg.row_ptr(cw);
    }
    const uint32_t wd = row[LAYOUT ? y : y >> 1];
    const int sh = (t & 15) * 2;
    if (((wd << (30 - sh)) & Run<LAYOUT>::kParity) == 0) {
      // a diagonal run: the steps before it settled first
      if (s > sb) settle(sg, tl, s - sb, rx, ry, rd, ed, sb);
      Run<LAYOUT> cur, next;
      sg.look(cur, x, y);
      if (tid == 0) cur.w = wd;  // the word tested: at least one step
      bool more;
      do {
        ++iters;
        const int D = run_steps(cur, y, tid);
        const int clip = min(min(lmax - s, x + 1), ba + x + y - band + 1);
        const int L = min(D, clip);
        more = D == cur.c0 + Run<LAYOUT>::kSteps * 31 && D < clip;
        if (more) sg.look(next, x - D, y);
        settle_run(cur, y, L, tl, ed, s, tid);
        s += L;
        x -= L;
        if (more) cur = next;
      } while (more);
      sb = s;
      active = x >= 0 && ba + x + y - band >= 0 && s < lmax;
      const int v = (LAYOUT ? x : 2 * x + y) >> 4;
      if (active && v / GR < cw / GR - NG + 2) {
        // past the groups in flight: the ring anew around the run's end
        cp_async_wait<0>();
        __syncwarp();
        prime(v);
      }
      continue;
    }
    const int d = (wd >> sh) & 3;
    if (tid == s - sb) {
      rx = x;
      ry = y;
      rd = d;
    }
    if (d != kLeft) --x;
    if (d == kUp) ++y;
    if (d == kLeft) --y;
    ++s;
    ++iters;
    active = x >= 0 && y >= 0 && ba + x + y - band >= 0 && s < lmax;
    if (s - sb == 32 || !active) {
      settle(sg, tl, s - sb, rx, ry, rd, ed, sb);
      sb = s;
    }
  }
  cp_async_wait<0>();
  if (tid == 0) {
    const int out[14] = {x,      y,      s,      tl.matches, tl.gapa,
                         tl.gapb, tl.hasm, tl.fmx, tl.fmy,    tl.lmx,
                         tl.lmy, ms,     (int)found, iters};
    for (int r = 0; r < 14; ++r) summary[(size_t)r * B + b] = out[r];
  }
}

// The ring's shape at a band and the block that holds it: words a row
// slot, code words a ring (a power of 2 that spans the codes the rows
// of one ring and the 3 rows above it can read: layout 1's a words are
// 2 a row plus the (2*band+15)/8 a row's cells reach), and as many warps
// a block as the ring's budget holds, at most kMaxWarps (0: none fits).
struct Plan {
  int rows, slot_words, code_words, warps;
  size_t shmem;
};

template <int LAYOUT, class Ring>
Plan plan(int band) {
  using S = Stage<LAYOUT, Ring>;
  Plan p;
  p.rows = S::kRows;
  p.slot_words = S::slot_words(LAYOUT ? 2 * band + 1 : band + 1);
  p.code_words = 1;
  while (p.code_words < 2 * (S::kRows + 4) + (2 * band + 15) / 8 + 4)
    p.code_words *= 2;
  const size_t per_warp = (size_t)(p.rows * p.slot_words + 2 * p.code_words)
                          * 4;
  const size_t fit = Ring::kBudget / per_warp;
  p.warps = (int)(fit < kMaxWarps ? fit : kMaxWarps);
  p.shmem = per_warp * p.warps;
  return p;
}

template <int L, class R>
struct Ring_ {
  static constexpr int kLayout = L;
  using Ring = R;
};

// f(Ring_<layout, the ring the launcher takes at this band>())
template <class F>
int with_ring(int layout, int band, F&& f) {
  if (layout == 0) return f(Ring_<0, NarrowRing>());
  if (band < kWideBand) return f(Ring_<1, NarrowRing>());
  return f(Ring_<1, WideRing>());
}

}  // namespace

extern "C" int bsw_walk(const void* dirs, const void* a_pk, const void* b_pk,
                        const void* begin_a, const void* end_a,
                        const void* x_size, const void* force_end,
                        const void* last_row, const void* diag, int B, int aw,
                        int xw, int band, int NP, int lmax, int force_max_gap,
                        int layout, void* summary, void* edits,
                        void* stream) {
  return with_ring(layout, band, [&](auto r) {
    using R = decltype(r);
    const Plan p = plan<R::kLayout, typename R::Ring>(band);
    if (p.warps == 0) return (int)cudaErrorInvalidValue;
    auto kernel = walk_kernel<R::kLayout, typename R::Ring>;
    if (p.shmem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.shmem);
      if (e != cudaSuccess) return (int)e;
    }
    const int grid = (B + p.warps - 1) / p.warps;
    kernel<<<grid, 32 * p.warps, p.shmem, (cudaStream_t)stream>>>(
        (const int*)dirs, (const uint8_t*)a_pk, (const uint8_t*)b_pk,
        (const int*)begin_a, (const int*)end_a, (const int*)x_size,
        (const int*)force_end, (const int*)last_row, (const int*)diag, B,
        aw, xw, band, NP, lmax, force_max_gap, p.code_words - 1,
        (int*)summary, (uint8_t*)edits);
    return (int)cudaGetLastError();
  });
}

// The launcher's ring at (band, layout): info = {rows, words a row slot,
// code words, warps a block, shared memory bytes a block};
// cudaErrorInvalidValue where no warp's ring fits a block.
extern "C" int bsw_walk_ring(int band, int layout, int* info) {
  return with_ring(layout, band, [&](auto r) {
    using R = decltype(r);
    const Plan p = plan<R::kLayout, typename R::Ring>(band);
    const int out[5] = {p.rows, p.slot_words, p.code_words, p.warps,
                        (int)p.shmem};
    for (int k = 0; k < 5; ++k) info[k] = out[k];
    return p.warps ? 0 : (int)cudaErrorInvalidValue;
  });
}
