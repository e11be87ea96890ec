/* The exact engine's segmented anti-diagonal wavefront sweep.
 *
 * Replaces the XLA device program of kalign_tpu/tpu/exact.py
 * (_sweep_one :65, vmapped over grids by _sweep_batch :163; not a Pallas
 * kernel).  Plain version: kalign_tpu_torch/gpu/exact_sweep.py::plain.
 *
 * One launch sweeps G grids of VR virtual rows x (C + 1) columns.  A
 * grid stacks Hirschberg windows as bands of rows (an init row, then the
 * window's rows); at anti-diagonal step d, row vr computes column
 * j = d - vr from (vr, j-1), (vr-1, j) and (vr-1, j-1).  Every cell repeats
 * the reference row sweep's float32 operations in their order (the
 * library is built with -fmad=false; the profile x profile chain is
 * written with __fmul_rn / __fadd_rn), so the states are bit-identical to
 * the plain version's and to the native runtime's.
 *
 * Design (simple first): one block per grid; thread t owns the R
 * consecutive rows [t R, t R + R) and keeps their (A, GA, GB) of the last
 * step and their up-neighbour's of the step before (the diagonal of the
 * next step) in registers.  A thread's first row reads the previous
 * thread's last row through shared memory, double-buffered by step
 * parity, so one __syncthreads per step suffices.  Per-row constants,
 * the column addends (float4 per column) and the match and bonus of the
 * cell are read from global memory at column d - vr; neighbouring rows
 * read neighbouring columns, and one 128-byte line of a row's match
 * serves 32 steps.  Rows outside their window write -FLT_MAX without
 * reading anything, as the plain version's selects give them.  Final
 * rows write their window's output slot directly.  Past 4,096 rows (a
 * window of more than 8,186 rows) the registers of 16 rows a thread run
 * out (ptxas: 167 and 236 of them at 16 rows, so no more than 256 threads
 * fit a block): 1,024 threads then keep the rows' state in a global
 * scratch instead (exact_sweep_wide_kernel), for any power-of-two height.
 *
 * Bound: 8 bytes of match and bonus per live cell against ~15 float
 * operations per cell (23 multiplies and adds more in the chain); the
 * kernel is bound by neither but by its serial steps: D = VR + C + 1 steps
 * of R rows each, one barrier per step.
 */
#include "kt_cuda.h"

#include <cfloat>

namespace {

constexpr float NEG = -FLT_MAX;
constexpr int NSUB = 23;
/* threads of a block: the register version's most, the wide version's */
constexpr int kMaxRegThreads = 256;
constexpr int kWideThreads = 1024;

enum : int {
  F_INIT = 1, F_FINAL = 2, F_ACTIVE = 4, F_INIT_TG = 8, F_START_TG = 16,
  F_END_TG = 32
};

struct Args {
  const int4* rowi;     /* [G, VR]: flags, startq, endq, win_slot */
  const float* rowf;    /* [G, VR, 8]: seedA, seedGA, seedGB, gb_ext,
                           gb_open, gb_tg, dgb, 0 */
  const float4* cols;   /* [G, C + 1]: ga_ext, ga_open, ga_tg, dga */
  const float* match;   /* [G, VR, ldm] */
  const float* bonus;   /* [G, VR, ldm] */
  const float* p1cnt;   /* [G, VR, 23] */
  const float* p2sub;   /* [G, C + 1, 23] (chain mode) */
  float* out;           /* [G, W, ncols, 3] */
  int VR, C, ldm, W, ncols, steps;
};

/* The per-grid operands of a launch. */
struct Grid {
  const int4* rowi;
  const float* rowf;
  const float4* cols;
  const float* match;
  const float* bonus;
  const float* p1cnt;
  const float* p2sub;
  float* out;

  __device__ Grid(const Args& a, int g)
      : rowi(a.rowi + (size_t)g * a.VR),
        rowf(a.rowf + (size_t)g * a.VR * 8),
        cols(a.cols + (size_t)g * (a.C + 1)),
        match(a.match + (size_t)g * a.VR * a.ldm),
        bonus(a.bonus + (size_t)g * a.VR * a.ldm),
        p1cnt(a.p1cnt + (size_t)g * a.VR * NSUB),
        p2sub(a.p2sub + (size_t)g * (a.C + 1) * NSUB),
        out(a.out + (size_t)g * a.W * a.ncols * 3) {}
};

/* Row vr at step d: its new (A, GA, GB) at column j = d - vr from its own
 * state of step d - 1 (l: (vr, j-1)), its up-neighbour's of step d - 1
 * (u: (vr-1, j)) and of step d - 2 (dg: (vr-1, j-1)); a final row writes
 * its window's output slot. */
template <bool CHAIN>
__device__ __forceinline__ void cell(const Args& a, const Grid& G, int vr,
                                     int d, float A_l, float GA_l,
                                     float A_u, float GA_u, float GB_u,
                                     float A_d, float GA_d, float GB_d,
                                     float& nA, float& nGA, float& nGB) {
  const int C = a.C;
  const int4 ri = G.rowi[vr];
  const int flags = ri.x;
  const int j = d - vr;
  nA = nGA = nGB = NEG;
  if (!((flags & F_ACTIVE) && j >= ri.y && j <= ri.z)) return;
  const float4 cv = (j >= 0 && j <= C) ? G.cols[j] : make_float4(0, 0, 0, 0);
  const bool at_start = j == ri.y;
  const bool at_end = j == ri.z;
  const float* rf = G.rowf + (size_t)vr * 8;
  const float ga_chain = fmaxf(GA_l + cv.x, A_l + cv.y);
  if (flags & F_INIT) {
    const float ga_chain_tg = fmaxf(GA_l, A_l) + cv.z;
    nA = at_start ? rf[0] : NEG;
    nGA = at_start ? rf[1]
                   : (at_end ? NEG
                             : ((flags & F_INIT_TG) ? ga_chain_tg : ga_chain));
    nGB = at_start ? rf[2] : NEG;
  } else {
    const int jc = j < 0 ? 0 : (j > C ? C : j);
    const size_t at = (size_t)vr * a.ldm + jc;
    float a_int = fmaxf(fmaxf(A_d, GA_d + cv.w), GB_d + rf[6]);
    if (CHAIN) {
      const float* p1 = G.p1cnt + (size_t)vr * NSUB;
      const bool in_c = j >= 0 && j <= C;
      const float* p2 = G.p2sub + (size_t)(in_c ? j : 0) * NSUB;
#pragma unroll
      for (int c = NSUB - 1; c >= 0; c--) {
        a_int = __fadd_rn(a_int, __fmul_rn(p1[c], in_c ? p2[c] : 0.0f));
      }
    } else {
      a_int = a_int + (jc < a.ldm ? G.match[at] : 0.0f);
    }
    a_int = a_int + (jc < a.ldm ? G.bonus[at] : 0.0f);
    nA = at_start ? NEG : a_int;
    nGA = (at_start || at_end) ? NEG : ga_chain;
    const float gb_std = fmaxf(GB_u + rf[3], A_u + rf[4]);
    const float gb_tgv = fmaxf(GB_u, A_u) + rf[5];
    nGB = at_start ? ((flags & F_START_TG) ? gb_tgv : gb_std)
                   : (at_end ? ((flags & F_END_TG) ? gb_tgv : gb_std)
                             : gb_std);
  }
  if ((flags & F_FINAL) && ri.w < a.W && j < a.ncols) {
    float* o = G.out + ((size_t)ri.w * a.ncols + j) * 3;
    o[0] = nA;
    o[1] = nGA;
    o[2] = nGB;
  }
}

/* Up to 4,096 rows: R rows a thread, their state in registers. */
template <int R, bool CHAIN>
__global__ void __launch_bounds__(kMaxRegThreads)
    exact_sweep_kernel(Args a) {
  extern __shared__ float xs[];           /* [2][3][T] */
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const Grid G(a, blockIdx.x);
  const int r0 = t * R;

  float A[R], GA[R], GB[R], dA[R], dGA[R], dGB[R];
#pragma unroll
  for (int k = 0; k < R; k++) {
    A[k] = GA[k] = GB[k] = NEG;
    dA[k] = dGA[k] = dGB[k] = NEG;
  }
  for (int i = t; i < 6 * T; i += T) xs[i] = NEG;
  __syncthreads();

  for (int d = 0; d < a.steps; d++) {
    /* the previous thread's last row at step d - 1 */
    const float* prev = xs + ((d + 1) & 1) * 3 * T;
    const float uA0 = t ? prev[t - 1] : NEG;
    const float uGA0 = t ? prev[T + t - 1] : NEG;
    const float uGB0 = t ? prev[2 * T + t - 1] : NEG;
#pragma unroll
    for (int k = R - 1; k >= 0; k--) {
      /* (vr - 1, j) at step d - 1: the row above, not yet updated */
      const float A_u = k ? A[k - 1] : uA0;
      const float GA_u = k ? GA[k - 1] : uGA0;
      const float GB_u = k ? GB[k - 1] : uGB0;
      float nA, nGA, nGB;
      cell<CHAIN>(a, G, r0 + k, d, A[k], GA[k], A_u, GA_u, GB_u, dA[k],
                  dGA[k], dGB[k], nA, nGA, nGB);
      dA[k] = A_u;
      dGA[k] = GA_u;
      dGB[k] = GB_u;
      A[k] = nA;
      GA[k] = nGA;
      GB[k] = nGB;
    }
    float* cur = xs + (d & 1) * 3 * T;
    cur[t] = A[R - 1];
    cur[T + t] = GA[R - 1];
    cur[2 * T + t] = GB[R - 1];
    __syncthreads();
  }
}

/* Past 4,096 rows: kWideThreads threads of R = VR / kWideThreads rows
 * each, the rows' state (A, GA, GB of the last step, the up-neighbour's
 * of the step before) in a global scratch [G][6][R][T], row k of thread t
 * at k T + t so that a warp's accesses coalesce.  Rows are visited from
 * the last to the first as in the register version: row k reads row
 * k - 1's state before it is overwritten, and carries it on as the next
 * row's own. */
template <bool CHAIN>
__global__ void __launch_bounds__(kWideThreads)
    exact_sweep_wide_kernel(Args a, float* scratch, int R) {
  extern __shared__ float xs[];           /* [2][3][T] */
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int VR = a.VR;
  const Grid G(a, blockIdx.x);
  const int r0 = t * R;
  float* st = scratch + (size_t)blockIdx.x * 6 * VR + t;
#define ST(s, k) st[(size_t)(s) * VR + (size_t)(k) * T]

  for (int k = 0; k < R; k++)
    for (int s = 0; s < 6; s++) ST(s, k) = NEG;
  for (int i = t; i < 6 * T; i += T) xs[i] = NEG;
  __syncthreads();

  for (int d = 0; d < a.steps; d++) {
    const float* prev = xs + ((d + 1) & 1) * 3 * T;
    const float uA0 = t ? prev[t - 1] : NEG;
    const float uGA0 = t ? prev[T + t - 1] : NEG;
    const float uGB0 = t ? prev[2 * T + t - 1] : NEG;
    float A_l = ST(0, R - 1), GA_l = ST(1, R - 1);
    float lastA = NEG, lastGA = NEG, lastGB = NEG;
    for (int k = R - 1; k >= 0; k--) {
      const float A_u = k ? ST(0, k - 1) : uA0;
      const float GA_u = k ? ST(1, k - 1) : uGA0;
      const float GB_u = k ? ST(2, k - 1) : uGB0;
      float nA, nGA, nGB;
      cell<CHAIN>(a, G, r0 + k, d, A_l, GA_l, A_u, GA_u, GB_u, ST(3, k),
                  ST(4, k), ST(5, k), nA, nGA, nGB);
      ST(3, k) = A_u;
      ST(4, k) = GA_u;
      ST(5, k) = GB_u;
      ST(0, k) = nA;
      ST(1, k) = nGA;
      ST(2, k) = nGB;
      if (k == R - 1) {
        lastA = nA;
        lastGA = nGA;
        lastGB = nGB;
      }
      A_l = A_u;
      GA_l = GA_u;
    }
    float* cur = xs + (d & 1) * 3 * T;
    cur[t] = lastA;
    cur[T + t] = lastGA;
    cur[2 * T + t] = lastGB;
    __syncthreads();
  }
#undef ST
}

template <int R>
cudaError_t launch_rows(const Args& a, int G, int threads, bool chain,
                        cudaStream_t s) {
  const size_t smem = 6 * threads * sizeof(float);
  if (chain) {
    exact_sweep_kernel<R, true><<<G, threads, smem, s>>>(a);
  } else {
    exact_sweep_kernel<R, false><<<G, threads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t launch_wide(const Args& a, int G, int rows, float* scratch,
                        bool chain, cudaStream_t s) {
  const size_t smem = 6 * kWideThreads * sizeof(float);
  if (chain) {
    exact_sweep_wide_kernel<true><<<G, kWideThreads, smem, s>>>(a, scratch,
                                                                 rows);
  } else {
    exact_sweep_wide_kernel<false><<<G, kWideThreads, smem, s>>>(a, scratch,
                                                                  rows);
  }
  return cudaGetLastError();
}

}  // namespace

KT_EXPORT int kt_exact_sweep(const void* rowi, const void* rowf,
                             const void* cols, const void* match,
                             const void* bonus, const void* p1cnt,
                             const void* p2sub, void* out, void* scratch,
                             int G, int VR, int C, int ldm, int W, int ncols,
                             int steps, int use_chain, int threads, int rows,
                             void* stream) {
  if (G <= 0 || steps <= 0) return 0;
  if (threads * rows != VR || threads <= 0) return (int)cudaErrorInvalidValue;
  Args a{(const int4*)rowi, (const float*)rowf, (const float4*)cols,
         (const float*)match, (const float*)bonus, (const float*)p1cnt,
         (const float*)p2sub, (float*)out, VR, C, ldm, W, ncols, steps};
  cudaStream_t s = (cudaStream_t)stream;
  const bool chain = use_chain != 0;
  if (threads == kWideThreads) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_wide(a, G, rows, (float*)scratch, chain, s);
  }
  if (threads > kMaxRegThreads) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch_rows<1>(a, G, threads, chain, s);
    case 2: return (int)launch_rows<2>(a, G, threads, chain, s);
    case 4: return (int)launch_rows<4>(a, G, threads, chain, s);
    case 8: return (int)launch_rows<8>(a, G, threads, chain, s);
    case 16: return (int)launch_rows<16>(a, G, threads, chain, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
