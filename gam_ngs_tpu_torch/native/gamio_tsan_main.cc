// ThreadSanitizer harness for the threaded streaming decoder.
//
// gamio.cc's record pass runs a rolling compressed window feeding
// std::thread parallel member inflates — the one hand-rolled
// concurrency in the native layer (the reference's BamTools is
// single-threaded per reader and shipped no sanitizer harness at
// all).  tests/test_torch_host_copies.py compiles THIS
// whole translation unit (gamio.cc included below) with
// -fsanitize=thread into a standalone binary — TSAN cannot instrument
// a .so loaded by an uninstrumented Python — and fails the test on
// any ThreadSanitizer report.
//
// Usage: gamio_tsan <bam> [n_threads] [window_bytes]

#include "gamio.cc"

#include <cstdio>
#include <cstdlib>

int main(int argc, char* argv[]) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <bam> [threads] [window]\n", argv[0]);
    return 2;
  }
  int threads = argc > 2 ? atoi(argv[2]) : 8;
  int64_t window = argc > 3 ? atoll(argv[3]) : 1 << 14;

  // several passes with different windows stress window-boundary
  // handoffs between the inflate workers and the parser
  for (int pass = 0; pass < 3; ++pass) {
    GamBam* b = gamio_read_bam_range(argv[1], threads, -1, -1, nullptr,
                                     window >> pass);
    if (!b) {
      std::fprintf(stderr, "decode returned null\n");
      return 1;
    }
    if (b->error) {
      std::fprintf(stderr, "decode error: %s\n", b->error);
      gamio_free(b);
      return 1;
    }
    std::printf("pass %d: n=%lld n_ref=%d\n", pass, (long long)b->n,
                b->n_ref);
    gamio_free(b);
  }
  std::printf("TSAN_HARNESS_OK\n");
  return 0;
}
