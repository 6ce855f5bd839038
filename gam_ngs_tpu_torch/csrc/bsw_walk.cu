// Find-max and traceback walk over the forward kernels' direction words.
//
// Replaces gam_ngs_tpu/ops/bsw_batch.py::_find_max_builder and
// _device_traceback_raw (the lockstep lax.scan walk of LMAX steps; XLA in
// the JAX package, a hand kernel here because in torch ops every walk
// step would be its own launches).  One thread per problem:
//   1. find-max over the last row (j ascending, skipped under force_end)
//      then the pos_a == end_a diagonal (i ascending; force_end keeps the
//      trailing FORCE_MAXGAP_LEN+1 rows, and none at all when
//      x_size <= FORCE_MAXGAP_LEN: the reference's unsigned underflow),
//      first maximum wins (banded_smith_waterman.cc:175-214);
//   2. the walk from that cell, reading each step's 2-bit direction from
//      the forward kernel's words and the characters from the 4-bit
//      packed windows, until the walk leaves the band or the sequences.
//      layout 0 reads bsw_antidiag's step-major words (B, NP, band+1):
//      cell (x, y) at word (2x+y)/16, lane y/2, bits 2*((2x+y) & 15);
//      layout 1 reads bsw_row's row-major words (B, NP, 2*band+1): cell
//      (x, y) at word x/16, lane y, bits 2*(x & 15).
// It writes the 13-int summary (xf, yf, cnt, matches, gapa, gapb, hasm,
// fmx, fmy, lmx, lmy, score, found), (13, B), and, when `edits` is not
// null, the edit codes in walk order, (B, lmax) bytes.
//
// Bound on this card: one dependent direction load (an L2 hit, the words
// were just written) per walk step; a walk is about x_size steps, so a
// chunk costs about x_size load latencies, whatever B is.  Spreading one
// walk over a warp is left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDiag = 0, kUp = 1, kLeft = 2;
// editops codes
constexpr uint8_t kGapA = 0, kGapB = 1, kMatch = 2, kMismatch = 3;

__device__ __forceinline__ int nibble(const uint8_t* pk, int q, int width,
                                      int fill) {
  if (q < 0 || q >= width) return fill;
  return (pk[q >> 1] >> ((q & 1) * 4)) & 15;
}

__global__ void walk_kernel(const int* __restrict__ dirs,
                            const uint8_t* __restrict__ a_pk,
                            const uint8_t* __restrict__ b_pk,
                            const int* __restrict__ begin_a,
                            const int* __restrict__ end_a,
                            const int* __restrict__ x_size,
                            const int* __restrict__ force_end,
                            const int* __restrict__ last_row,
                            const int* __restrict__ diag, int B, int aw,
                            int xw, int band, int NP, int lmax,
                            int force_max_gap, int layout,
                            int* __restrict__ summary,
                            uint8_t* __restrict__ edits) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int YS = 2 * band + 1, K = layout ? YS : band + 1;
  const int ba = begin_a[b], ea = end_a[b], xs = x_size[b];
  const bool fe = force_end[b] != 0;
  const int* lr = last_row + (size_t)b * YS;
  const int* dg = diag + (size_t)b * YS;

  bool found = false;
  int mi = 0, mj = 0, ms = 0;
  if (!fe) {
    for (int j = 0; j < YS; ++j) {
      const int pos = ba + (xs - 1) - band + j;
      if (pos >= 0 && pos <= ea && (!found || lr[j] > ms)) {
        found = true;
        mi = xs - 1;
        mj = j;
        ms = lr[j];
      }
    }
  }
  const int C = ea - ba + band;  // diagonal j holds row i = C - j
  const int i0 = max(ea - ba - band, 0);
  const bool fe_ok = xs - 1 - force_max_gap >= 0;
  for (int j = YS - 1; j >= 0; --j) {
    const int i = C - j;
    if (i < i0 || i >= xs) continue;
    if (fe && !(fe_ok && i >= xs - 1 - force_max_gap)) continue;
    if (!found || dg[j] > ms) {
      found = true;
      mi = i;
      mj = j;
      ms = dg[j];
    }
  }

  const int* dp = dirs + (size_t)b * NP * K;
  const uint8_t* ap = a_pk + (size_t)b * (aw / 2);
  const uint8_t* bp = b_pk + (size_t)b * (xw / 2);
  uint8_t* ed = edits ? edits + (size_t)b * lmax : nullptr;
  int x = found ? mi : -1, y = mj;
  int cnt = 0, matches = 0, gapa = 0, gapb = 0, hasm = 0;
  int fmx = 0, fmy = 0, lmx = 0, lmy = 0;
  bool active = x >= 0 && y >= 0 && ba + x + y - band >= 0;
  for (int s = 0; s < lmax && active; ++s) {
    const int t = layout ? x : 2 * x + y;
    const int d =
        (dp[(size_t)(t >> 4) * K + (layout ? y : y >> 1)] >> ((t & 15) * 2)) &
        3;
    const int ca = nibble(ap, x + y, aw, 15), cb = nibble(bp, x, xw, 0);
    const bool is_match = ca == cb || ca == 4 || cb == 4;
    if (ed)
      ed[s] = d == kDiag ? (is_match ? kMatch : kMismatch)
                         : (d == kUp ? kGapA : kGapB);
    if (d == kDiag && is_match) {
      // walk order is reverse alignment order: the last match seen is
      // the alignment's first, the first seen its last
      fmx = x;
      fmy = y;
      if (!hasm) {
        lmx = x;
        lmy = y;
      }
      hasm = 1;
      ++matches;
    }
    gapa += d == kUp;
    gapb += d == kLeft;
    if (d != kLeft) --x;
    if (d == kUp) ++y;
    if (d == kLeft) --y;
    ++cnt;
    active = x >= 0 && y >= 0 && ba + x + y - band >= 0;
  }
  const int out[13] = {x,    y,   cnt, matches, gapa, gapb,         hasm,
                       fmx,  fmy, lmx, lmy,     ms,   (int)found};
  for (int r = 0; r < 13; ++r) summary[(size_t)r * B + b] = out[r];
}

}  // namespace

extern "C" int bsw_walk(const void* dirs, const void* a_pk, const void* b_pk,
                        const void* begin_a, const void* end_a,
                        const void* x_size, const void* force_end,
                        const void* last_row, const void* diag, int B, int aw,
                        int xw, int band, int NP, int lmax, int force_max_gap,
                        int layout, void* summary, void* edits,
                        void* stream) {
  const int threads = 64;
  walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(
      (const int*)dirs, (const uint8_t*)a_pk, (const uint8_t*)b_pk,
      (const int*)begin_a, (const int*)end_a, (const int*)x_size,
      (const int*)force_end, (const int*)last_row, (const int*)diag, B, aw,
      xw, band, NP, lmax, force_max_gap, layout, (int*)summary,
      (uint8_t*)edits);
  return (int)cudaGetLastError();
}
