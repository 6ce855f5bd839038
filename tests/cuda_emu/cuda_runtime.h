// A CPU stand-in for the CUDA runtime, for tests/test_torch_row_emulated.py,
// tests/test_torch_walk_emulated.py, tests/test_torch_antidiag_emulated.py
// and tests/test_torch_arena.py: it lets
// g++ compile a kernel source of
// gam_ngs_tpu_torch/csrc and run it on the host.  A launch runs the grid's
// blocks one after another (a dim3 grid in x, then y, then z order); a
// block's threads are std::threads, and each warp's shuffles, votes,
// reductions and __syncwarp meet at a barrier of its 32 threads, so every
// thread of a warp must reach them together, as `full`-mask shuffles
// require on the card; __syncthreads waits for the whole block.
// __shared__ arrays become statics (one block runs at a time); the test
// rewrites `extern __shared__` buffers and <<<>>> launches.
// cudaLaunchKernelEx with a cluster dimension C runs the C blocks of each
// cluster together, one cluster after another: each block has its own
// warps, block barrier and dynamic shared memory, cluster_peer maps an
// address of it to the same place in another rank's, and cluster_arrive /
// cluster_wait are the halves of one barrier over all the cluster's
// threads (the CUDA source defines these four helpers itself, in PTX,
// only under nvcc).  bar_sync(id, n) is the named barrier `bar.sync id,
// n` of a block of a plain launch: the n threads that name id meet
// there.  cp.async
// copies here at once: a commit and a wait have nothing left to do, so a
// missing or too short wait cannot show.  The device has emu::sm_count
// SMs (cudaDeviceGetAttribute), which a test may set.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

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
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
using std::max;
using std::min;

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  long long vals[2][32];  // a collective's posts, two buffers in turn
};
// A block's named barriers, each made for its n threads when first met
struct Named {
  std::mutex m;
  std::unique_ptr<std::barrier<>> bars[16];
};
inline int sm_count = 132;
inline thread_local Warp* my_warp;
inline thread_local int turn;  // the buffer of this thread's next collective
inline thread_local std::barrier<>* my_block;
inline thread_local Named* my_named;
inline thread_local int* dyn_smem;
inline thread_local int rank;          // the block's rank in its cluster
inline thread_local int** rank_smem;   // each rank's dynamic shared memory
inline thread_local std::barrier<>* my_cluster;
inline thread_local std::optional<std::barrier<>::arrival_token> arrived;

// every lane posts v and meets the warp once; returns the posts.  The
// buffers alternate: a lane writes one again only two collectives later,
// after the barrier of the one between, which every lane reaches only
// once it has read this one's posts.
inline const long long* post(long long v) {
  long long* buf = my_warp->vals[turn];
  turn ^= 1;
  buf[threadIdx.x & 31] = v;
  my_warp->bar.arrive_and_wait();
  return buf;
}

// every lane posts v, then reads lane src's (its own when src is outside
// the warp, as a shuffle does)
inline long long exchange(long long v, int src) {
  const long long* buf = post(v);
  return (src >= 0 && src < 32) ? buf[src] : v;
}

template <class K, class... A>
void launch(K kernel, dim3 grid, int block, size_t shmem, cudaStream_t,
            A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<Warp> warps((block + 31) / 32);
        std::barrier<> block_bar(block);
        Named named;
        std::vector<int> dyn(shmem / sizeof(int) + 1);
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
          threads.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx = {bx, by, bz};
            blockDim.x = block;
            my_warp = &warps[t / 32];
            my_block = &block_bar;
            my_named = &named;
            dyn_smem = dyn.data();
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}

// A 1-D grid in clusters of csize blocks, the clusters one after another
template <class K, class... A>
void launch_clusters(K kernel, unsigned grid, int block, size_t shmem,
                     unsigned csize, A... args) {
  for (unsigned b0 = 0; b0 < grid; b0 += csize) {
    std::vector<std::vector<Warp>> warps;
    std::vector<std::unique_ptr<std::barrier<>>> blocks;
    std::vector<std::vector<int>> dyn;
    std::vector<int*> smem;
    for (unsigned r = 0; r < csize; ++r) {
      warps.emplace_back((block + 31) / 32);
      blocks.push_back(std::make_unique<std::barrier<>>(block));
      dyn.emplace_back(shmem / sizeof(int) + 1);
      smem.push_back(dyn.back().data());
    }
    std::barrier<> cluster_bar(csize * block);
    std::vector<std::thread> threads;
    for (unsigned r = 0; r < csize; ++r)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, r, t] {
          threadIdx.x = t;
          blockIdx = {b0 + r, 0, 0};
          blockDim.x = block;
          my_warp = &warps[r][t / 32];
          my_block = blocks[r].get();
          dyn_smem = smem[r];
          rank = (int)r;
          rank_smem = smem.data();
          my_cluster = &cluster_bar;
          kernel(args...);
        });
    for (auto& th : threads) th.join();
  }
}
}  // namespace emu

template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(E...), A&&... args) {
  unsigned csize = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      csize = cfg->attrs[a].val.clusterDim.x;
  if (cfg->gridDim.x % csize) return cudaErrorInvalidValue;
  emu::launch_clusters(kernel, cfg->gridDim.x, (int)cfg->blockDim.x,
                       cfg->dynamicSmemBytes, csize, E(args)...);
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu::sm_count;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K*,
                                           const cudaLaunchConfig_t*) {
  *n = 0;  // no card to ask
  return cudaSuccess;
}
inline int cluster_rank() { return emu::rank; }
inline int* cluster_peer(int* p, int rank) {
  return emu::rank_smem[rank] + (p - emu::dyn_smem);
}
inline void cluster_arrive() { emu::arrived = emu::my_cluster->arrive(); }
inline void cluster_wait() {
  emu::my_cluster->wait(std::move(*emu::arrived));
  emu::arrived.reset();
}

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
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return (T)emu::exchange((long long)v, (int)(threadIdx.x & 31) ^ mask);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  const long long* buf = emu::post(p);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= buf[i] ? 1u << i : 0u;
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clzll(long long x) {
  return x ? __builtin_clzll((unsigned long long)x) : 64;
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline bool __any_sync(unsigned, bool p) {
  const long long* buf = emu::post(p);
  bool r = false;
  for (int i = 0; i < 32; ++i) r = r || buf[i];
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  const long long* buf = emu::post(v);
  long long r = buf[0];
  for (int i = 1; i < 32; ++i) r = std::max(r, buf[i]);
  return (int)r;
}
inline int __reduce_add_sync(unsigned, int v) {
  const long long* buf = emu::post(v);
  long long r = 0;
  for (int i = 0; i < 32; ++i) r += buf[i];
  return (int)r;
}
inline void __syncwarp() { emu::my_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu::my_block->arrive_and_wait(); }
inline void bar_sync(int id, int n) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(emu::my_named->m);
    auto& slot = emu::my_named->bars[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(n);
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
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
// cp.async: the copy at once; commit and wait have nothing to do
inline void cp_async4(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 4);
}
inline void cp_async16(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 16);
}
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}
