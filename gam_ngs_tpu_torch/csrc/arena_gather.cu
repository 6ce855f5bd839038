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
// read here).
//
// Bound on this card: bytes.  Each output byte is written once and needs
// at most one arena byte (two codes of one window are neighbours in the
// arena).  So a thread owns one 16-byte chunk (32 codes) of one window
// row and does no work per code: a 1-D grid over B * (aw/32 + xw/32)
// chunks, a's then b's, the row from one 32-bit division.  The live codes
// of a chunk are one interval of nibbles (the window position inside
// [0, len) and below the window's live width); a chunk outside it stores
// the fill without touching the arena.  Otherwise the thread loads the
// two aligned 16-byte arena words that cover its 32 codes (read-only
// path), shifts the 256-bit pair down to the codes' nibble phase (word
// selects, then __funnelshift_r), reverses the 32 nibbles for a reverse
// orientation and complements its codes below 4 as SWAR, masks the
// interval's complement to the fill and stores 16 bytes.  Neighbouring
// threads of a row share at most one arena word, which L1 serves, so no
// shared memory is staged.  Rows are whole chunks: aw is a multiple of
// 32 codes (bsw_antidiag.a_width), xw of 128 (bsw_host._pad_dim); the
// wrapper checks both, and the entry point the 16-byte alignment of every
// pointer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Nibbles [0, n) of a 32-bit word, n clamped to [0, 8].
__device__ __forceinline__ uint32_t low_nibbles(int n) {
  return n <= 0 ? 0u : n >= 8 ? ~0u : (1u << (4 * n)) - 1u;
}

// The 32 arena codes from index i up: nibble j of the result (word j / 8,
// bits 4 * (j % 8)) is code i + j.  Word indices are clamped to the
// arena's n_words; a code read through a clamped word lies outside the
// arena and the caller masks it.
__device__ __forceinline__ uint4 codes_from(const uint4* __restrict__ arena,
                                            long long n_words, long long i) {
  const long long w = i >> 5;  // floor(i / 32), for negative i too
  const long long w0 = w < 0 ? 0 : (w >= n_words ? n_words - 1 : w);
  const long long w1 = w + 1 < 0 ? 0 : (w + 1 >= n_words ? n_words - 1
                                                         : w + 1);
  const uint4 lo = __ldg(arena + w0), hi = __ldg(arena + w1);
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned ph = (unsigned)i & 31u;  // the nibble phase
  // whole 32-bit words first (ph / 8 of them), then the nibbles left
  uint32_t t[7], u[5];
#pragma unroll
  for (int k = 0; k < 7; ++k) t[k] = (ph & 8u) ? v[k + 1] : v[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) u[k] = (ph & 16u) ? t[k + 2] : t[k];
  const unsigned sh = (ph & 7u) * 4u;
  return {__funnelshift_r(u[0], u[1], sh), __funnelshift_r(u[1], u[2], sh),
          __funnelshift_r(u[2], u[3], sh), __funnelshift_r(u[3], u[4], sh)};
}

// The 8 nibbles of a word in reverse order: bytes reversed, then the two
// nibbles of each byte swapped.
__device__ __forceinline__ uint32_t reverse_nibbles(uint32_t x) {
  x = __byte_perm(x, 0, 0x0123);
  return ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
}

// XOR 1 on every nibble below 4 (bits 2 and 3 clear).
__device__ __forceinline__ uint32_t complement(uint32_t x) {
  return x ^ (~((x >> 2) | (x >> 3)) & 0x11111111u);
}

__global__ void arena_gather_kernel(const uint4* __restrict__ arena,
                                    long long n_words,
                                    const int32_t* __restrict__ cols, int B,
                                    int band, unsigned a_chunks,
                                    unsigned b_chunks, unsigned a_total,
                                    unsigned total, uint4* __restrict__ a_pk,
                                    uint4* __restrict__ b_pk) {
  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const bool is_a = g < a_total;
  const unsigned r = is_a ? g : g - a_total;
  const unsigned per_row = is_a ? a_chunks : b_chunks;
  const unsigned t = r / per_row, c = r - t * per_row;
  const int f = is_a ? 0 : 5;  // the window's first column
  const int ofs = __ldg(cols + f * B + t);
  const int len = __ldg(cols + (f + 1) * B + t);
  const int rev = __ldg(cols + (f + 2) * B + t);
  const int x_size = __ldg(cols + 9 * B + t);
  const long long start = is_a ? (long long)__ldg(cols + 3 * B + t) - band
                               : (long long)__ldg(cols + 8 * B + t);
  // the host windows: x_size + 2*band a codes, x_size b codes
  const long long width = is_a ? (long long)x_size + 2 * band : x_size;
  const long long q0 = 32ll * c, p0 = start + q0;
  // live nibbles j in [jl, jh): 0 <= p0 + j < len and q0 + j < width
  const long long lo = -p0 > 0 ? -p0 : 0;
  long long hi = len - p0 < width - q0 ? len - p0 : width - q0;
  hi = hi < 32 ? hi : 32;
  const uint32_t fill = is_a ? ~0u : 0u;  // 15 or 0 in every nibble
  uint4 out = {fill, fill, fill, fill};
  if (hi > lo) {
    const int jl = (int)lo, jh = (int)hi;
    uint4 x;
    if (rev) {  // codes ofs + len - 1 - p0 - j: the 32 below it, reversed
      const uint4 y = codes_from(arena, n_words,
                                 (long long)ofs + len - 32 - p0);
      x = {complement(reverse_nibbles(y.w)), complement(reverse_nibbles(y.z)),
           complement(reverse_nibbles(y.y)), complement(reverse_nibbles(y.x))};
    } else {
      x = codes_from(arena, n_words, (long long)ofs + p0);
    }
    if (jl == 0 && jh == 32) {
      out = x;
    } else {
      uint32_t m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[k] = low_nibbles(jh - 8 * k) & ~low_nibbles(jl - 8 * k);
      out = {(x.x & m[0]) | (fill & ~m[0]), (x.y & m[1]) | (fill & ~m[1]),
             (x.z & m[2]) | (fill & ~m[2]), (x.w & m[3]) | (fill & ~m[3])};
    }
  }
  (is_a ? a_pk : b_pk)[(size_t)t * per_row + c] = out;
}

}  // namespace

// Returns 0, a CUDA error of the launch, or -1 (nothing launched) for
// arguments the kernel does not take: rows or an arena that are not whole
// 16-byte chunks at 16-byte aligned addresses, or 2^31 chunks or more.
extern "C" int arena_gather(const void* arena, long long n_codes,
                            const void* cols, int B, int band, int a_bytes,
                            int b_bytes, void* a_pk, void* b_pk,
                            void* stream) {
  if (B == 0) return 0;
  const long long a_chunks = a_bytes / 16, b_chunks = b_bytes / 16;
  const long long total = (long long)B * (a_chunks + b_chunks);
  if (B < 0 || a_bytes % 16 || b_bytes % 16 || n_codes <= 0 ||
      n_codes % 32 || total >= (1ll << 31) ||
      ((uintptr_t)arena | (uintptr_t)a_pk | (uintptr_t)b_pk) % 16)
    return -1;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  arena_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)arena, n_codes / 32, (const int32_t*)cols, B, band,
      (unsigned)a_chunks, (unsigned)b_chunks, (unsigned)(B * a_chunks),
      (unsigned)total, (uint4*)a_pk, (uint4*)b_pk);
  return (int)cudaGetLastError();
}
