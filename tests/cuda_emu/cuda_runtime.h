// A CPU stand-in for the CUDA runtime, for tests/test_torch_row_emulated.py
// and tests/test_torch_arena.py: it lets g++ compile a kernel source of
// gam_ngs_tpu_torch/csrc and run it on the host.  A launch runs the grid's
// blocks one after another (a dim3 grid in x, then y, then z order); a
// block's threads are std::threads, and each warp's shuffles, votes,
// reductions and __syncwarp meet at a barrier of its 32 threads, so every
// thread of a warp must reach them together, as `full`-mask shuffles
// require on the card; __syncthreads waits for the whole block.
// __shared__ arrays become statics (one block runs at a time); the test
// rewrites `extern __shared__` buffers and <<<>>> launches.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
using std::max;
using std::min;

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  long long vals[32];
};
inline thread_local Warp* my_warp;
inline thread_local std::barrier<>* my_block;
inline thread_local int* dyn_smem;

// every lane posts v, then reads lane src's (its own when src is outside
// the warp, as a shuffle does)
inline long long exchange(long long v, int src) {
  const int lane = threadIdx.x & 31;
  my_warp->vals[lane] = v;
  my_warp->bar.arrive_and_wait();
  const long long r = (src >= 0 && src < 32) ? my_warp->vals[src] : v;
  my_warp->bar.arrive_and_wait();
  return r;
}

template <class K, class... A>
void launch(K kernel, dim3 grid, int block, size_t shmem, cudaStream_t,
            A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<Warp> warps((block + 31) / 32);
        std::barrier<> block_bar(block);
        std::vector<int> dyn(shmem / sizeof(int) + 1);
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
          threads.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx = {bx, by, bz};
            blockDim.x = block;
            my_warp = &warps[t / 32];
            my_block = &block_bar;
            dyn_smem = dyn.data();
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
}  // namespace emu

template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  return (T)emu::exchange((long long)v, (int)(threadIdx.x & 31) - d);
}
template <class T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int src = (int)(threadIdx.x & 31) + d;
  return (T)emu::exchange((long long)v, src < 32 ? src : -1);
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return (T)emu::exchange((long long)v, src & 31);
}
inline bool __any_sync(unsigned, bool p) {
  const int lane = threadIdx.x & 31;
  emu::my_warp->vals[lane] = p;
  emu::my_warp->bar.arrive_and_wait();
  bool r = false;
  for (int i = 0; i < 32; ++i) r = r || emu::my_warp->vals[i];
  emu::my_warp->bar.arrive_and_wait();
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  const int lane = threadIdx.x & 31;
  emu::my_warp->vals[lane] = v;
  emu::my_warp->bar.arrive_and_wait();
  long long r = emu::my_warp->vals[0];
  for (int i = 1; i < 32; ++i) r = std::max(r, emu::my_warp->vals[i]);
  emu::my_warp->bar.arrive_and_wait();
  return (int)r;
}
inline void __syncwarp() { emu::my_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu::my_block->arrive_and_wait(); }
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return (unsigned)(((((unsigned long long)hi) << 32) | lo) >> (sh & 31));
}
// prmt's default mode: byte n of the result is byte (s >> 4n) & 7 of the
// pair y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
}
