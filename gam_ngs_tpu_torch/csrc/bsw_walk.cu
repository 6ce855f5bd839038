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
//   2. the walk from that cell, one serial chain that every lane of the
//      warp follows in step, reading each step's 2-bit direction from the
//      forward kernel's words and the characters from the 4-bit packed
//      windows, until the walk leaves the band or the sequences.
//      layout 0 reads bsw_antidiag's step-major words (B, NP, band+1):
//      cell (x, y) at word (2x+y)/16, lane y/2, bits 2*((2x+y) & 15);
//      layout 1 reads bsw_row's row-major words (B, NP, 2*band+1): cell
//      (x, y) at word x/16, lane y, bits 2*(x & 15).
// It writes the 13-int summary (xf, yf, cnt, matches, gapa, gapb, hasm,
// fmx, fmy, lmx, lmy, score, found), (13, B), and, when `edits` is not
// null, the edit codes in walk order, (B, lmax) bytes.
//
// The serial chain reads only the direction words: each step reads its
// 2-bit direction from shared memory and moves (x, y); lane s & 31 keeps
// step s's cell and direction.  Every 32 steps (and at the end) the warp
// settles those steps in parallel: each lane reads its cell's a and b
// codes, and ballots give the match and gap counts, the first and last
// match and, when asked for, one coalesced store of the 32 edit codes.
//
// Staging: a walk visits the word rows (2x+y)/16 (layout 0) or x/16
// (layout 1) in descending order, one row at most a step.  Each warp
// keeps a ring of kGroups groups of kGroupRows whole word rows in shared
// memory; a group's rows are contiguous in dirs, so one loop of 4-byte
// cp.async copies brings it in.  Entering group g the warp starts the
// copies of group g-kGroups+2, with the a and b code words its rows'
// cells can read, as one commit group, and waits for the group of g; a
// row change inside a group only moves a pointer.  The code rings are
// wide enough that the codes of the rows up to 3 above the walk's (the
// last 32 steps) stay in place.
//
// Bound on this card: the walk is one dependent chain per problem, a
// shared-memory load and ~10 dependent int32 operations a step; the copies
// run one to two groups (32-128 steps in layout 0) ahead of it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0, kUp = 1, kLeft = 2;
// editops codes
constexpr uint8_t kGapA = 0, kGapB = 1, kMatch = 2, kMismatch = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroupRows = 4;  // word rows fetched together
constexpr int kGroups = 4;     // groups staged per warp
constexpr int kRows = kGroupRows * kGroups;  // a power of 2
constexpr int kMaxWarps = 4;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One warp's staging state: the word-row ring and the two code-word
// rings, and how far down the code words have been fetched.
template <int LAYOUT>
struct Stage {
  uint32_t* rows;  // kRows x KL words
  uint32_t* ca;    // cmask+1 words of a codes, word q at q & cmask
  uint32_t* cb;    // the same for b
  const int* dp;   // this problem's direction words
  const uint32_t* ap;
  const uint32_t* bp;
  int KL, NP, cmask, nwa, nwb, band, a_lo, b_lo, tid;

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
    const int v = g * kGroupRows;
    if (v >= 0) {
      uint32_t* dst = rows + (v & (kRows - 1)) * KL;
      const int* src = dp + (size_t)v * KL;
      const int n = (min(v + kGroupRows, NP) - v) * KL;
      for (int q = tid; q < n; q += 32) cp_async4(dst + q, src + q);
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
};

// Settle the n (1..32) steps s0 .. s0+n-1 that lanes 0 .. n-1 recorded:
// cell (rx, ry), direction rd.
template <int LAYOUT>
__device__ __forceinline__ void settle(const Stage<LAYOUT>& sg, Tally& tl,
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
    // walk order is reverse alignment order: the last match seen is the
    // alignment's first, the first seen its last
    const int last = 31 - __clz(m), first = __ffs(m) - 1;
    tl.fmx = __shfl_sync(kFull, rx, last);
    tl.fmy = __shfl_sync(kFull, ry, last);
    const int lx = __shfl_sync(kFull, rx, first);
    const int ly = __shfl_sync(kFull, ry, first);
    if (!tl.hasm) {
      tl.lmx = lx;
      tl.lmy = ly;
    }
    tl.hasm = 1;
    tl.matches += __popc(m);
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(32 * kMaxWarps) walk_kernel(
    const int* __restrict__ dirs, const uint8_t* __restrict__ a_pk,
    const uint8_t* __restrict__ b_pk, const int* __restrict__ begin_a,
    const int* __restrict__ end_a, const int* __restrict__ x_size,
    const int* __restrict__ force_end, const int* __restrict__ last_row,
    const int* __restrict__ diag, int B, int aw, int xw, int band, int NP,
    int lmax, int force_max_gap, int cmask, int* __restrict__ summary,
    uint8_t* __restrict__ edits) {
  extern __shared__ uint32_t smem[];
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
  Stage<LAYOUT> sg;
  const int rows_words = kRows * KL;
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
  if (active) {
    cw = (LAYOUT ? x : 2 * x + y) >> 4;
    // every code word up to the highest the start row can read
    sg.a_lo = (LAYOUT ? 16 * cw + 15 + 2 * band : 8 * cw + 15 + band) / 8 + 1;
    sg.b_lo = (LAYOUT ? 16 * cw + 15 : 8 * cw + 7) / 8 + 1;
    for (int g = cw / kGroupRows; g > cw / kGroupRows - kGroups + 1; --g)
      sg.fetch(g);
    cp_async_wait<kGroups - 2>();
    __syncwarp();
    row = sg.rows + (cw & (kRows - 1)) * KL;
  }
  while (active) {
    const int t = LAYOUT ? x : 2 * x + y;
    if (t < 16 * cw) {  // one row down: row cw-1
      --cw;
      if (cw % kGroupRows == kGroupRows - 1) {  // and into group cw/4
        __syncwarp();  // every lane is done with the slots refilled next
        sg.fetch(cw / kGroupRows - kGroups + 2);
        cp_async_wait<kGroups - 2>();
        __syncwarp();
      }
      row = sg.rows + (cw & (kRows - 1)) * KL;
    }
    const int d = (row[LAYOUT ? y : y >> 1] >> ((t & 15) * 2)) & 3;
    if (tid == (s & 31)) {
      rx = x;
      ry = y;
      rd = d;
    }
    if (d != kLeft) --x;
    if (d == kUp) ++y;
    if (d == kLeft) --y;
    ++s;
    active = x >= 0 && y >= 0 && ba + x + y - band >= 0 && s < lmax;
    if ((s & 31) == 0 || !active) settle(sg, tl, ((s - 1) & 31) + 1, rx, ry,
                                         rd, ed, (s - 1) & ~31);
  }
  cp_async_wait<0>();
  if (tid == 0) {
    const int out[13] = {x,      y,      s,      tl.matches, tl.gapa,
                         tl.gapb, tl.hasm, tl.fmx, tl.fmy,    tl.lmx,
                         tl.lmy, ms,     (int)found};
    for (int r = 0; r < 13; ++r) summary[(size_t)r * B + b] = out[r];
  }
}

}  // namespace

extern "C" int bsw_walk(const void* dirs, const void* a_pk, const void* b_pk,
                        const void* begin_a, const void* end_a,
                        const void* x_size, const void* force_end,
                        const void* last_row, const void* diag, int B, int aw,
                        int xw, int band, int NP, int lmax, int force_max_gap,
                        int layout, void* summary, void* edits,
                        void* stream) {
  const int KL = layout ? 2 * band + 1 : band + 1;
  // code words the rows of one ring and the 3 rows above it span (layout
  // 1's a words: 2 a row, plus the (2*band+15)/8 a row's cells reach)
  int cwords = 1;
  while (cwords < 2 * (kRows + 4) + (2 * band + 15) / 8 + 4) cwords *= 2;
  const size_t per_warp = (size_t)(kRows * KL + 2 * cwords) * 4;
  const size_t budget = 200 * 1024;
  if (per_warp > budget) return (int)cudaErrorInvalidValue;
  const int warps = (int)(budget / per_warp < kMaxWarps ? budget / per_warp
                                                        : kMaxWarps);
  const size_t shmem = per_warp * warps;
  auto kernel = layout ? walk_kernel<1> : walk_kernel<0>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + warps - 1) / warps, 32 * warps, shmem, (cudaStream_t)stream>>>(
      (const int*)dirs, (const uint8_t*)a_pk, (const uint8_t*)b_pk,
      (const int*)begin_a, (const int*)end_a, (const int*)x_size,
      (const int*)force_end, (const int*)last_row, (const int*)diag, B, aw,
      xw, band, NP, lmax, force_max_gap, cwords - 1, (int*)summary,
      (uint8_t*)edits);
  return (int)cudaGetLastError();
}
