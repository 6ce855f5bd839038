// The floor of one row of csrc/bsw_row.cu's cluster instances: a loop of
// rows that does only the exchange between the warps of one problem, as
// row_warps_kernel<R, 8, C> does it, and no cell of the DP.
//
// B problems, each eight warps in each of the C blocks of a cluster
// (C = 1: one block, __syncthreads).  Each row, every warp takes the max
// of a value over its lanes (__reduce_max_sync), lane 0 publishes it to
// its block's exchange, and then (mode)
//   0 pull: the cluster barrier, then lane l of every warp reads warp l's
//         (and l + 32's) total from the exchange of the rank that holds
//         it (remote loads after the barrier);
//   1 push: lanes 1 .. C-1 store it into the exchange of ranks rank+1 ..
//         (remote stores before the barrier), the cluster barrier
//         (arrive.release, wait.acquire), and every read after it local;
//   2 as push, but only the writing lanes fence (fence.acq_rel.cluster)
//         and every thread arrives relaxed;
//   3 as push, with no cluster barrier: each store is followed by an
//         arrive on the receiving block's mbarrier of the row (a ring of
//         16 rows), lane 0 of warp 0 also pushes to the rank before (the
//         kernel's first-lane map, which bounds how far a rank runs
//         ahead), and every warp waits on its own block's mbarrier;
// then lane l folds the totals of the warps before its own, one
// __reduce_max_sync, and the next row's value depends on it.  Two row
// parities (mode 3: 16), as in the kernel.  Timed by tools/kernel_ab.py
// --floor.
//
//   cluster_floor(C, mode, B, rows, out, stream): out holds B*C*256 ints.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

#ifdef __CUDACC__  // the cluster helpers of csrc/bsw_row.cu
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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_local(uint64_t* b) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.release.cta.shared::cta.b64 st, [%0];\n\t}"
      :: "r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* b, int rank) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n\t}"
      :: "r"(smem_u32(b)), "r"(rank) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n\t"
      "@!p bra WAIT;\n\t}"
      :: "r"(smem_u32(b)), "r"(parity) : "memory");
}

template <int C, int MODE>
__global__ void __launch_bounds__(256, 1) floor_kernel(int rows, int* out) {
  constexpr int W = 8, G = C * W, D = MODE == 3 ? 16 : 2;
  constexpr bool PUSH = MODE != 0;
  __shared__ int xch[D * G];
  __shared__ uint64_t bars[16];
  const int rank = C > 1 ? cluster_rank() : 0;
  const int t = threadIdx.x & 31, w = rank * W + (threadIdx.x >> 5);
  int* push = nullptr;
  int to = -1;
  const int *pull0 = nullptr, *pull1 = nullptr;
  if constexpr (C > 1) {
    if (PUSH && t >= 1 && rank + t < C) to = rank + t;
    if (MODE == 3 && threadIdx.x == 0 && rank > 0) to = rank - 1;
    if (to >= 0) push = cluster_peer(xch, to);
    if (!PUSH && t < w) pull0 = cluster_peer(xch, t / W) + t;
    if (!PUSH && t + 32 < w) pull1 = cluster_peer(xch, (t + 32) / W) + t + 32;
    if (MODE == 3 && threadIdx.x == 0) {
      // this block's warps, the earlier ranks' warps, the next rank's
      // warp 0
      for (int d = 0; d < D; ++d)
        mbar_init(&bars[d], W * (rank + 1) + (rank + 1 < C));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  int y = (int)(threadIdx.x + blockIdx.x);
  for (int i = 0; i < rows; ++i) {
    const int tot = __reduce_max_sync(kFull, y);
    const int d = i & (D - 1);
    int* q = xch + d * G;
    if (t == 0) q[w] = tot;
    if (push) push[d * G + w] = tot;
    int z = -1;
    if constexpr (C == 1) {
      __syncthreads();
    } else if constexpr (MODE == 3) {
      if (t == 0) mbar_arrive_local(&bars[d]);
      if (push) mbar_arrive_remote(&bars[d], to);
      mbar_wait(&bars[d], (unsigned)(i / D) & 1u);
    } else if constexpr (MODE == 2) {
      if (t == 0 || push) fence_cluster();
      cluster_arrive_relaxed();
      cluster_wait();
    } else {
      cluster_arrive();
      cluster_wait();
    }
    if (PUSH || C == 1) {
      z = t < w ? q[t] : -1;
      if (G > 32) z = max(z, t + 32 < w ? q[t + 32] : -1);
    } else {
      if (pull0) z = pull0[d * G];
      if (pull1) z = max(z, pull1[d * G]);
    }
    y = (y + __reduce_max_sync(kFull, z) + 1) & 0xffff;
  }
  if constexpr (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = y;
}

template <int C, int MODE>
int launch(int B, int rows, int* out, cudaStream_t stream) {
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const int err =
      (int)cudaLaunchKernelEx(&cfg, floor_kernel<C, MODE>, rows, out);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" int cluster_floor(int C, int mode, int B, int rows, int* out,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define GAM_FLOOR(CC)                                       \
  if (C == CC) {                                            \
    if (mode == 0) return launch<CC, 0>(B, rows, out, st);  \
    if (mode == 1) return launch<CC, 1>(B, rows, out, st);  \
    if (mode == 2) return launch<CC, 2>(B, rows, out, st);  \
    if (mode == 3) return launch<CC, 3>(B, rows, out, st);  \
  }
  if (C == 1) return launch<1, 1>(B, rows, out, st);
  GAM_FLOOR(2)
  GAM_FLOOR(4)
  GAM_FLOOR(8)
#undef GAM_FLOOR
  return (int)cudaErrorInvalidValue;
}
