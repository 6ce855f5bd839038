// Window gather from the resident sequence arena.
//
// Replaces the XLA `win` gather of gam_ngs_tpu/ops/bsw_batch.py's
// `fused_arena` (:861-885): an arena chunk ships 12 int32 columns a
// problem, and the windows the forward and the walk read are cut from the
// 4-bit packed contig arena on the card.  The output is byte for byte what
// the host packing gives (BswEngine._pack_chunk + _pack4) for the same
// problems:
//   a window (aw codes): code q is the arena code at position
//     p = begin_a - band + q of the a sequence; 15 (the out-of-range
//     sentinel) for p outside [0, a_len) and for q >= x_size + 2*band,
//     where the host window ends;
//   b window (xw codes): code q is at p = begin_b + q of b; 0 for p
//     outside [0, b_len) and for q >= x_size;
// a reverse orientation reads index ofs + len - 1 - p and complements the
// codes below 4 by XOR 1 (N, 4, stays).
//
// Columns: (12, B) int32 rows a_ofs, a_len, a_rev, begin_a, end_a, b_ofs,
// b_len, b_rev, begin_b, x_size, force_start, force_end (the first ten are
// read here).  One launch covers both windows of the chunk: grid z picks
// the window, y the problem, and each thread writes one 4-byte word (eight
// codes) of that problem's window, so no thread divides to find its row.
//
// Bound on this card: bytes.  Each output byte is written once and needs
// at most one arena byte (two codes of one window are neighbours in the
// arena); the arithmetic is ~15 int32 operations a code.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned window_code(
    const uint8_t* __restrict__ arena, long long n_codes, int ofs, int len,
    int rev, long long p, unsigned fill) {
  if (p < 0 || p >= len) return fill;
  long long idx = rev ? (long long)ofs + len - 1 - p : (long long)ofs + p;
  idx = idx < 0 ? 0 : (idx >= n_codes ? n_codes - 1 : idx);
  const unsigned c = (arena[idx >> 1] >> ((idx & 1) * 4)) & 15u;
  return (rev && c < 4) ? (c ^ 1u) : c;
}

__global__ void arena_gather_kernel(const uint8_t* __restrict__ arena,
                                    long long n_codes,
                                    const int32_t* __restrict__ cols, int B,
                                    int band, int a_words, int b_words,
                                    uint32_t* __restrict__ a_pk,
                                    uint32_t* __restrict__ b_pk) {
  const int t = blockIdx.y;
  const bool is_a = blockIdx.z == 0;
  const int words = is_a ? a_words : b_words;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  const int x_size = cols[9 * B + t];
  const int f = is_a ? 0 : 5;  // the window's first column
  const int ofs = cols[f * B + t], len = cols[(f + 1) * B + t];
  const int rev = cols[(f + 2) * B + t];
  const long long start = is_a ? (long long)cols[3 * B + t] - band
                               : (long long)cols[8 * B + t];
  // the host windows: x_size + 2*band a codes, x_size b codes
  const int width = is_a ? x_size + 2 * band : x_size;
  const unsigned fill = is_a ? 15u : 0u;
  uint32_t word = 0;
  const int q0 = 8 * w;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = q0 + j;
    const unsigned c = q < width
        ? window_code(arena, n_codes, ofs, len, rev, start + q, fill) : fill;
    word |= c << (4 * j);
  }
  (is_a ? a_pk + (size_t)t * a_words : b_pk + (size_t)t * b_words)[w] = word;
}

}  // namespace

extern "C" int arena_gather(const void* arena, long long n_codes,
                            const void* cols, int B, int band, int a_bytes,
                            int b_bytes, void* a_pk, void* b_pk,
                            void* stream) {
  if (B == 0) return 0;
  if (B > 65535 || a_bytes % 4 || b_bytes % 4)
    return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const int a_words = a_bytes / 4, b_words = b_bytes / 4;
  const int most = a_words > b_words ? a_words : b_words;
  const dim3 grid((most + kThreads - 1) / kThreads, B, 2);
  arena_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)arena, n_codes, (const int32_t*)cols, B, band, a_words,
      b_words, (uint32_t*)a_pk, (uint32_t*)b_pk);
  return (int)cudaGetLastError();
}
