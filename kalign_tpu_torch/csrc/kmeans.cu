/* Lloyd loops of the bisecting k-means guide tree.
 *
 * Replaces the XLA programs kalign_tpu/tpu/kmeans.py::_lloyd_batch :46
 * (one recursion depth, every try of every cluster in lockstep) and the
 * Lloyd loop of _fused_splits :322 (the whole recursion in one program);
 * neither is a Pallas kernel.  The TPU runs all tries as matrix products
 * and one while loop whose condition is any try still moving; here each
 * (cluster, try) is one block that runs its own loop to convergence or
 * to the iteration cap inside the kernel, so no iteration waits on the
 * host and no finished try idles the others.
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
 * block writes the try's SSE, whether a side was empty and the
 * iterations it ran, and the assignment of its last iteration (1 =
 * right) to assign[t, row].  The caller picks the earliest best try.
 *
 * Each thread takes every kThreads-th member; its sums go through a warp
 * butterfly and then the warps' partials in a fixed order, so a launch
 * is deterministic (the reference promises a fixed tree for a fixed
 * device and program).  The float order differs from the plain versions
 * (matrix products and segment sums there), so a member within float
 * noise of the eps boundary may go the other way: the comparison with
 * the plain versions allows that (gpu/kmeans.py).
 *
 * Bound: operations.  Per member and iteration two D-long dot products,
 * the distances, the tie test and D accumulating adds; the rows of a
 * cluster stay in L2 (16,384 x 32 floats = 2 MB at the root), so device
 * memory is read about once.  The design keeps the work on one block
 * per try with centroids in shared memory; a cluster of n members keeps
 * min(n, 256) threads busy, and only 40 blocks run at the root.
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 32;
constexpr int kSums = 2 * kMaxD + 3;   // left sums, right sums, SSE, counts

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

__global__ void __launch_bounds__(kThreads)
lloyd_kernel(const float* __restrict__ rows, int D, long long N,
             const int* __restrict__ start, const int* __restrict__ size,
             int T, int form, int max_iters, float eps,
             float* __restrict__ score, int8_t* __restrict__ degen,
             int8_t* __restrict__ assign, int* __restrict__ iters) {
  const int c = blockIdx.x;   // cluster
  const int t = blockIdx.y;   // try
  const int n = size[c];
  const long long s0 = start[c];
  const int tries = n < T ? n : T;
  const long long out = (long long)c * T + t;
  __shared__ float cl[kMaxD], cr[kMaxD];
  __shared__ float part[kWarps][kSums];
  __shared__ float tot[kSums];
  if (t >= tries) {            // an inactive try, or an empty cluster
    if (threadIdx.x == 0) {
      score[out] = 3.4e38f;
      degen[out] = 0;
      iters[out] = 0;
    }
    return;
  }
  const float* base = rows + s0 * D;
  int8_t* side = assign + (long long)t * N + s0;

  // the cluster's mean, then the try's two centroids
  {
    float acc[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) acc[d] = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* x = base + (long long)i * D;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) acc[d] += x[d];
    }
    block_sum(acc, D, part, tot);
    if (threadIdx.x < D) {
      const int d = threadIdx.x;
      const float mean = tot[d] / fmaxf((float)n, 1.f);
      const float seed = base[(long long)(t * (n / tries)) * D + d];
      cl[d] = seed;
      cr[d] = form == 0 ? mean - (seed - mean) : 2.0f * mean - seed;
    }
    __syncthreads();
  }

  for (int it = 0;; ++it) {
    float cl2 = 0.f, cr2 = 0.f;
    for (int d = 0; d < D; ++d) {
      cl2 += cl[d] * cl[d];
      cr2 += cr[d] * cr[d];
    }
    // left sums [0, kMaxD), right sums [kMaxD, 2 kMaxD), SSE, counts:
    // fixed slots, so the array stays in registers
    float v[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* x = base + (long long)i * D;
      float xv[kMaxD];
      float sq = 0.f, xl = 0.f, xr = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        xv[d] = 0.f;
        if (d < D) {
          xv[d] = x[d];
          sq += xv[d] * xv[d];
          xl += xv[d] * cl[d];
          xr += xv[d] * cr[d];
        }
      }
      const float dl = sqrtf(fmaxf(sq - 2.0f * xl + cl2, 0.f));
      const float dr = sqrtf(fmaxf(sq - 2.0f * xr + cr2, 0.f));
      const float diff = dr - dl;
      const bool right = fabsf(diff) < eps ? (i & 1) != 0 : diff < 0.f;
      v[2 * kMaxD] += fminf(dl, dr);
      v[2 * kMaxD + 1] += right ? 0.f : 1.f;
      v[2 * kMaxD + 2] += right ? 1.f : 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          if (right) v[kMaxD + d] += xv[d];
          else v[d] += xv[d];
        }
      }
      side[i] = right ? 1 : 0;
    }
    block_sum(v, kSums, part, tot);

    // every thread reaches the same decision from the same sums
    const float NL = tot[2 * kMaxD + 1], NR = tot[2 * kMaxD + 2];
    const bool empty_side = NL == 0.f || NR == 0.f;
    const float dl_ = fmaxf(NL, 1.f), dr_ = fmaxf(NR, 1.f);
    bool moved = false;
    for (int d = 0; d < D; ++d) {
      moved |= fabsf(tot[d] / dl_ - cl[d]) >= eps;
      moved |= fabsf(tot[kMaxD + d] / dr_ - cr[d]) >= eps;
    }
    if (!(moved && !empty_side && it + 1 < max_iters)) {
      if (threadIdx.x == 0) {
        score[out] = tot[2 * kMaxD];
        degen[out] = empty_side ? 1 : 0;
        iters[out] = it + 1;
      }
      return;
    }
    __syncthreads();           // cl, cr and tot read by every thread
    if (threadIdx.x < D) {
      cl[threadIdx.x] = tot[threadIdx.x] / dl_;
      cr[threadIdx.x] = tot[kMaxD + threadIdx.x] / dr_;
    }
    __syncthreads();
  }
}

}  // namespace

KT_EXPORT int kt_kmeans_lloyd(const float* rows, int D, long long N,
                              const int* start, const int* size, int C,
                              int T, int form, int max_iters, float eps,
                              float* score, int8_t* degen, int8_t* assign,
                              int* iters, cudaStream_t stream) {
  if (C == 0) return 0;
  if (D < 1 || D > kMaxD || T < 1 || T > 65535) return cudaErrorInvalidValue;
  lloyd_kernel<<<dim3(C, T), kThreads, 0, stream>>>(
      rows, D, N, start, size, T, form, max_iters, eps, score, degen, assign,
      iters);
  return cudaGetLastError();
}
