/* Lloyd loops of the bisecting k-means guide tree.
 *
 * Replaces the XLA programs kalign_tpu/tpu/kmeans.py::_lloyd_batch :46
 * (one recursion depth, every try of every cluster in lockstep) and the
 * Lloyd loop of _fused_splits :322 (the whole recursion in one program);
 * neither is a Pallas kernel.  The TPU runs all tries as matrix products
 * and one while loop whose condition is any try still moving; here each
 * (cluster, try) runs its own loop to convergence or to the iteration cap
 * inside the kernel, so no iteration waits on the host and no finished
 * try idles the others.
 *
 * A cluster is a contiguous segment [start, start + size) of the rows
 * [N, D] (D <= 32 anchor distances).  Try t seeds its left centroid with
 * member t * (size / tries) (tries = min(T, size)), its right one with
 * the reflection of that seed through the cluster mean, in the form of
 * the entry point the launch serves (form 0: mean - (seed - mean), as
 * _lloyd_batch :69; form 1: 2 * mean - seed, as _fused_splits :393).
 * Each iteration assigns every member to the nearer centroid on the
 * sqrt scale of ||x||^2 - 2 x.c + ||c||^2 (clamped at 0), a difference
 * below eps breaking by the member's parity (odd goes right), sums the
 * distance to the nearer centroid (the try's SSE) and moves each
 * centroid to its side's mean; the try stops when no coordinate moved
 * by eps or more, a side is empty, or max_iters iterations ran.  The
 * try's SSE, whether a side was empty and the iterations it ran are
 * written, and the assignment of its last iteration (1 = right) to
 * assign[t, row].  The caller picks the earliest best try.
 *
 * Design (Hopper): one thread-block cluster of B blocks (1, 2, 4, 8 or
 * 16, the launch's choice: gpu/kmeans.py::cluster_blocks) per (cluster,
 * try).  Block r takes the r-th contiguous slice of the members and
 * keeps the try's two centroids in its shared memory; a member takes two
 * neighbouring lanes, each with half of the dimensions (their dot
 * products joined by one shuffle), so a thread holds half the sums and
 * three blocks fit on an SM; each iteration a block sums its slice (a
 * butterfly over the lanes of one parity, then its warps left to right)
 * into its shared memory; after a cluster barrier, block 0 adds the blocks'
 * partials through distributed shared memory in rank order (a fixed
 * order, so a launch is deterministic: the reference promises a fixed
 * tree for a fixed device and program), decides, and writes the next
 * centroids and the stop flag to its shared memory, which every block
 * reads after a second barrier.  At the root of 16,384 sequences that is
 * 40 x 16 = 640 blocks of 1,024 members each, where one block per try
 * left 92 of 132 SMs idle and ran a 256-thread reduction chain over all
 * 16,384 members per iteration.  The rows stay in L2 (2 MB at the root).
 * The float order differs from the plain versions (matrix products and
 * segment sums there) and depends on B, so a member within float noise
 * of the eps boundary may go the other way: the comparison with the
 * plain versions allows that (gpu/kmeans.py).
 *
 * Bound: operations.  Per member and iteration two D-long dot products,
 * the distances, the tie test and D accumulating adds.
 */
#include "kt_cuda.h"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 32;
constexpr int kSums = 2 * kMaxD + 3;   // left sums, right sums, SSE, counts
constexpr int kMaxBlocks = 16;
// a member takes two neighbouring lanes, each kHalf of its dimensions; a
// thread's sums: its half of the left and right sums, then SSE and the
// two counts (kept by the even lane)
constexpr int kHalf = kMaxD / 2;
constexpr int kPart = 2 * kHalf + 3;
constexpr int kPairs = kThreads / 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

/* tot[k] = the block's sum of v[k] for k < K (every thread's v):
 * butterfly within each warp, then the warps' partials left to right. */
template <int NV>
__device__ __forceinline__ void block_sum(const float (&v)[NV], int K,
                                          float (*part)[kSums], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (k < K) {
      float s = warp_sum(v[k]);
      if (lane == 0) part[warp][k] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

/* The block's sums of the threads' kPart partials into tot[kSums]: a
 * butterfly over the lanes of one parity in each warp, then the warps'
 * partials left to right. */
__device__ __forceinline__ void block_sum_pairs(const float (&v)[kPart],
                                                float (*part)[kSums],
                                                float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane & 1;
#pragma unroll
  for (int k = 0; k < kPart; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 1; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane < 2) {
      if (k < kHalf) {
        part[warp][half * kHalf + k] = s;
      } else if (k < 2 * kHalf) {
        part[warp][kMaxD + half * kHalf + (k - kHalf)] = s;
      } else if (half == 0) {
        part[warp][2 * kMaxD + (k - 2 * kHalf)] = s;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

/* Block 0 of the cluster: tot[k] = the blocks' partials ptot[k] added in
 * rank order, k < K.  The nb remote loads are issued together, then
 * added one by one. */
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float* ptot, float* tot, int K,
                                            int nb) {
  if (threadIdx.x < K) {
    float p[kMaxBlocks];
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r)
      p[r] = r < nb ? cluster.map_shared_rank(ptot, r)[threadIdx.x] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxBlocks; ++r)
      if (r < nb) s += p[r];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 3)
lloyd_kernel(const float* __restrict__ rows, int D, long long N,
             const int* __restrict__ start, const int* __restrict__ size,
             int T, int form, int max_iters, float eps,
             float* __restrict__ score, int8_t* __restrict__ degen,
             int8_t* __restrict__ assign, int* __restrict__ iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / nb;   // cluster
  const int t = blockIdx.y;        // try
  const int n = size[c];
  const long long s0 = start[c];
  const int tries = n < T ? n : T;
  const long long out = (long long)c * T + t;
  __shared__ float cl[kMaxD], cr[kMaxD];     // this block's centroids
  __shared__ float part[kWarps][kSums];
  __shared__ float ptot[kSums];              // this block's partial sums
  __shared__ float tot[kSums];               // block 0: the cluster's sums
  __shared__ float next[2 * kMaxD];          // block 0: next centroids
  __shared__ int stop;                       // block 0: the loop ends
  if (t >= tries) {            // an inactive try, or an empty cluster
    if (rank == 0 && threadIdx.x == 0) {
      score[out] = 3.4e38f;
      degen[out] = 0;
      iters[out] = 0;
    }
    return;                    // every block of the cluster returns here
  }
  const float* base = rows + s0 * D;
  int8_t* side = assign + (long long)t * N + s0;
  const int lo = (int)((long long)n * rank / nb);
  const int hi = (int)((long long)n * (rank + 1) / nb);

  // the cluster's mean, then the try's two centroids
  {
    float acc[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) acc[d] = 0.f;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float* x = base + (long long)i * D;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) acc[d] += x[d];
    }
    block_sum(acc, D, part, ptot);
    cluster.sync();
    if (rank == 0) {
      cluster_sum(cluster, ptot, tot, D, nb);
      if (threadIdx.x < D) {
        const int d = threadIdx.x;
        const float mean = tot[d] / fmaxf((float)n, 1.f);
        const float seed = base[(long long)(t * (n / tries)) * D + d];
        next[d] = seed;
        next[kMaxD + d] = form == 0 ? mean - (seed - mean)
                                    : 2.0f * mean - seed;
      }
    }
    cluster.sync();
    if (threadIdx.x < D) {
      const float* nx = cluster.map_shared_rank(next, 0);
      cl[threadIdx.x] = nx[threadIdx.x];
      cr[threadIdx.x] = nx[kMaxD + threadIdx.x];
    }
    __syncthreads();
  }

  for (int it = 0;; ++it) {
    float cl2 = 0.f, cr2 = 0.f;
    for (int d = 0; d < D; ++d) {
      cl2 += cl[d] * cl[d];
      cr2 += cr[d] * cr[d];
    }
    // this lane's half of the left and right sums, SSE, counts: fixed
    // slots, so the array stays in registers.  The loop's trip count is
    // the warp's, so every lane reaches the shuffles.
    const int half = threadIdx.x & 1;
    const int d0 = half * kHalf;
    float v[kPart];
#pragma unroll
    for (int k = 0; k < kPart; ++k) v[k] = 0.f;
    for (int i0 = lo; i0 < hi; i0 += kPairs) {
      const int i = i0 + (threadIdx.x >> 1);
      const bool live = i < hi;
      const float* x = base + (long long)i * D + d0;
      float xv[kHalf];
      float sq = 0.f, xl = 0.f, xr = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        xv[d] = 0.f;
        if (live && d0 + d < D) {
          xv[d] = x[d];
          sq += xv[d] * xv[d];
          xl += xv[d] * cl[d0 + d];
          xr += xv[d] * cr[d0 + d];
        }
      }
      // the two halves' dot products added (IEEE addition commutes: both
      // lanes get the same bits)
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      xl += __shfl_xor_sync(0xffffffffu, xl, 1);
      xr += __shfl_xor_sync(0xffffffffu, xr, 1);
      if (!live) continue;
      const float dl = sqrtf(fmaxf(sq - 2.0f * xl + cl2, 0.f));
      const float dr = sqrtf(fmaxf(sq - 2.0f * xr + cr2, 0.f));
      const float diff = dr - dl;
      const bool right = fabsf(diff) < eps ? (i & 1) != 0 : diff < 0.f;
      if (half == 0) {
        v[2 * kHalf] += fminf(dl, dr);
        v[2 * kHalf + 1] += right ? 0.f : 1.f;
        v[2 * kHalf + 2] += right ? 1.f : 0.f;
        side[i] = right ? 1 : 0;
      }
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        if (d0 + d < D) {
          if (right) v[kHalf + d] += xv[d];
          else v[d] += xv[d];
        }
      }
    }
    block_sum_pairs(v, part, ptot);
    cluster.sync();            // every block's partials are written

    if (rank == 0) {
      cluster_sum(cluster, ptot, tot, kSums, nb);
      // every thread reaches the same decision from the same sums
      const float NL = tot[2 * kMaxD + 1], NR = tot[2 * kMaxD + 2];
      const bool empty_side = NL == 0.f || NR == 0.f;
      const float dl_ = fmaxf(NL, 1.f), dr_ = fmaxf(NR, 1.f);
      bool moved = false;
      for (int d = 0; d < D; ++d) {
        moved |= fabsf(tot[d] / dl_ - cl[d]) >= eps;
        moved |= fabsf(tot[kMaxD + d] / dr_ - cr[d]) >= eps;
      }
      const bool done = !(moved && !empty_side && it + 1 < max_iters);
      if (threadIdx.x == 0) {
        stop = done;
        if (done) {
          score[out] = tot[2 * kMaxD];
          degen[out] = empty_side ? 1 : 0;
          iters[out] = it + 1;
        }
      }
      if (threadIdx.x < D) {
        next[threadIdx.x] = tot[threadIdx.x] / dl_;
        next[kMaxD + threadIdx.x] = tot[kMaxD + threadIdx.x] / dr_;
      }
    }
    cluster.sync();            // block 0's decision and centroids
    if (*cluster.map_shared_rank(&stop, 0)) {
      cluster.sync();          // block 0's memory outlives every read
      return;
    }
    if (threadIdx.x < D) {
      const float* nx = cluster.map_shared_rank(next, 0);
      cl[threadIdx.x] = nx[threadIdx.x];
      cr[threadIdx.x] = nx[kMaxD + threadIdx.x];
    }
    __syncthreads();
  }
}

}  // namespace

KT_EXPORT int kt_kmeans_lloyd(const float* rows, int D, long long N,
                              const int* start, const int* size, int C,
                              int T, int form, int max_iters, float eps,
                              float* score, int8_t* degen, int8_t* assign,
                              int* iters, int blocks, cudaStream_t stream) {
  if (C == 0) return 0;
  if (D < 1 || D > kMaxD || T < 1 || T > 65535 || blocks < 1 ||
      blocks > kMaxBlocks || (blocks & (blocks - 1)))
    return cudaErrorInvalidValue;
  if (blocks > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        lloyd_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * blocks, (unsigned)T, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, lloyd_kernel, rows, D, N, start,
                                     size, T, form, max_iters, eps, score,
                                     degen, assign, iters);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
