/* The exact engine's segmented anti-diagonal wavefront sweep.
 *
 * Replaces the XLA device program of kalign_tpu/tpu/exact.py
 * (_sweep_one :65, vmapped over grids by _sweep_batch :163; not a Pallas
 * kernel).  Plain version: kalign_tpu_torch/gpu/exact_sweep.py::plain.
 *
 * One launch sweeps G grids of VR virtual rows x (C + 1) columns, one
 * block per grid.  A grid stacks Hirschberg windows as bands of rows (an
 * init row, then the window's rows); cell (vr, j) is computed from
 * (vr, j-1), (vr-1, j) and (vr-1, j-1).  Every cell repeats the reference
 * row sweep's float32 operations in their order (the library is built
 * with -fmad=false; the profile x profile chain is written with
 * __fmul_rn / __fadd_rn), so the states are bit-identical to the plain
 * version's and to the native runtime's.
 *
 * Bound: 8 bytes of match and bonus per processed cell against ~15 float
 * operations per cell (46 more in the chain): a few microseconds for the
 * largest launches, far below what a wavefront of dependent steps takes.
 * The kernel is bound by its serial steps, each one a block barrier, so
 * the design cuts the steps and the latency inside each one:
 *
 *  - Band-local schedule.  The reference runs row vr at column
 *    j = d - vr, so a grid of 4,096 rows took ~4,400 steps in which each
 *    row did work only during its window's C + 1 (~7 % of row-steps).
 *    Here row vr runs column j = d - lag[vr], lag = (vr - its band's init
 *    row) - startq, so every band starts at step 0 on its own first
 *    column and a block loops only over its own grid's steps (the host's
 *    span): its tallest band plus its widest column span.  A processed
 *    row reads only its own band and an init row no row above, so each
 *    cell reads the same neighbours with the same values.
 *  - Grids that fill the card.  Once a grid's height no longer sets its
 *    steps, the engine packs the pre-pass's pairs into grids of 256 rows
 *    (about one pair's window), up to 1,024 a launch (gpu/exact.py:
 *    PACK_BUDGET, LAUNCH_CELLS), where it packed 64 grids of 4,096.
 *  - No memory round trip on a step's critical path.  A row's constants
 *    (flags, lag, window steps, slot, its 4 gap addends or 3 seeds, and
 *    in chain form its 23 profile counts) are loaded once into
 *    registers; the column addends (16 B a column, and p2sub's 23 floats
 *    a column in chain form) are staged in shared memory when they fit
 *    in kStageBytes, else read through the read-only cache; the match
 *    and bonus of step d + 1 are loaded during step d, unconditionally
 *    at a clamped column, as is the carried row a strip's first row
 *    reads.
 *
 * Thread t holds R consecutive rows [t R, t R + R) of a strip of T R
 * rows: their (A, GA, GB) of the last step and their up-neighbour's of
 * the step before (the next step's diagonal) in registers.  A thread's
 * first row reads the previous thread's last row through shared memory,
 * double-buffered by step parity: one __syncthreads per step.  Grids
 * taller than a strip are swept strip after strip; a strip's last row
 * leaves its state per column in a global buffer [G][2][3][C + 1] (by
 * strip parity) that the next strip's first row reads as its
 * up-neighbour.  Final rows write their window's output slot directly.
 * The wrapper runs R = 1 and up to 512 threads (gpu/exact_sweep.py::
 * launch_plan): measured on the divergent pre-pass, more rows a thread
 * were 2-4x slower a step, their match rows outgrowing L1 (PERF.md §6).
 */
#include "kt_cuda.h"

#include <cfloat>
#include <climits>

namespace {

constexpr float NEG = -FLT_MAX;
constexpr int NSUB = 23;
constexpr int kThreads = 512;     /* threads a block may take */
/* column addends staged in shared memory up to this many bytes */
constexpr int kStageBytes = 64 * 1024;

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
  const int* lag;       /* [G, VR]: row vr runs column d - lag at step d */
  const int2* span;     /* [G, S]: each strip's first step, step past last */
  float* out;           /* [G, W, ncols, 3] */
  float* edge;          /* [G, 2, 3, C + 1] (S > 1) */
  int VR, C, ldm, W, ncols, S, stage;
};

/* A row's constants, loaded once per strip: in-window steps [lo, hi]
 * (lo = INT_MAX for a row with no window), lag, flags, output slot (-1
 * unless a final row of a live window), and f: an init row's seeds
 * (A, GA, GB) or a processed row's gb_ext, gb_open, gb_tg, dgb. */
struct Row {
  int lo, hi, lag, flags, slot;
  float f0, f1, f2, f3;
};

__device__ __forceinline__ Row load_row(const Args& a, int g, int vr) {
  const size_t at = (size_t)g * a.VR + vr;
  const int4 ri = __ldg(a.rowi + at);
  const int lag = __ldg(a.lag + at);
  const float* rf = a.rowf + at * 8;
  Row r;
  r.flags = ri.x;
  r.lag = lag;
  const bool on = ri.x & F_ACTIVE;
  r.lo = on ? lag + ri.y : INT_MAX;
  r.hi = on ? lag + ri.z : INT_MIN;
  r.slot = ((ri.x & F_FINAL) && ri.w < a.W) ? ri.w : -1;
  const int f = (ri.x & F_INIT) ? 0 : 3;
  r.f0 = __ldg(rf + f);
  r.f1 = __ldg(rf + f + 1);
  r.f2 = __ldg(rf + f + 2);
  r.f3 = (ri.x & F_INIT) ? 0.0f : __ldg(rf + 6);
  return r;
}

/* row vr's match (or 0: chain form, or past the match's width) and bonus
 * at step d, from an address that is valid whatever d is */
template <bool CHAIN>
__device__ __forceinline__ void load_mb(const Args& a, const float* mrow,
                                        const float* brow, const Row& r,
                                        int d, float& m, float& b) {
  m = b = 0.0f;
  if (r.lo == INT_MAX) return;                  /* a row with no window */
  int j = d - r.lag;
  j = j < 0 ? 0 : (j > a.C ? a.C : j);
  const bool in = j < a.ldm;
  const int jc = in ? j : a.ldm - 1;
  if (!CHAIN) {
    const float v = __ldg(mrow + jc);
    m = in ? v : 0.0f;
  }
  const float v = __ldg(brow + jc);
  b = in ? v : 0.0f;
}

template <int R, bool CHAIN>
__global__ void __launch_bounds__(kThreads) exact_sweep_kernel(Args a) {
  extern __shared__ float4 smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int g = blockIdx.x;
  const int C1 = a.C + 1;
  const float4* cols = a.cols + (size_t)g * C1;
  const float* p2 = a.p2sub + (size_t)g * C1 * NSUB;
  float* xs = (float*)smem;                     /* [2][3][T] */
  if (a.stage) {
    float4* scol = smem;
    float* sp2 = (float*)(smem + C1);
    for (int i = t; i < C1; i += T) scol[i] = __ldg(cols + i);
    if (CHAIN)
      for (int i = t; i < C1 * NSUB; i += T) sp2[i] = __ldg(p2 + i);
    cols = scol;
    p2 = sp2;
    xs = sp2 + (CHAIN ? C1 * NSUB : 0);
  }

  for (int s = 0; s < a.S; s++) {
    const int2 sp = a.span[(size_t)g * a.S + s];
    if (sp.y <= sp.x) continue;                 /* the same for the block */
    const int r0 = (s * T + t) * R;
    Row row[R];
    const float* mrow[R];
    const float* brow[R];
    float p1[CHAIN ? R : 1][NSUB];
    float A[R], GA[R], GB[R], dA[R], dGA[R], dGB[R], mn[R], bn[R];
#pragma unroll
    for (int k = 0; k < R; k++) {
      const int vr = r0 + k;
      row[k] = load_row(a, g, vr);
      const size_t at = ((size_t)g * a.VR + vr) * a.ldm;
      mrow[k] = a.match + at;
      brow[k] = a.bonus + at;
      if (CHAIN) {
        const float* pc = a.p1cnt + ((size_t)g * a.VR + vr) * NSUB;
#pragma unroll
        for (int c = 0; c < NSUB; c++) p1[CHAIN ? k : 0][c] = __ldg(pc + c);
      }
      A[k] = GA[k] = GB[k] = NEG;
      dA[k] = dGA[k] = dGB[k] = NEG;
      load_mb<CHAIN>(a, mrow[k], brow[k], row[k], sp.x, mn[k], bn[k]);
    }
    /* the previous strip's last row by column (strip parity), read by
     * this strip's first row; this strip's last row, left for the next */
    const float* ein = (s > 0 && t == 0)
        ? a.edge + ((size_t)g * 2 + ((s + 1) & 1)) * 3 * C1 : nullptr;
    float* eout = (s + 1 < a.S && t == T - 1)
        ? a.edge + ((size_t)g * 2 + (s & 1)) * 3 * C1 : nullptr;
    float eA = NEG, eGA = NEG, eGB = NEG;
    auto load_edge = [&](int d) {
      int j = d - row[0].lag;
      j = j < 0 ? 0 : (j > a.C ? a.C : j);
      eA = ein[j];
      eGA = ein[C1 + j];
      eGB = ein[2 * C1 + j];
    };
    if (ein) load_edge(sp.x);
    for (int i = t; i < 6 * T; i += T) xs[i] = NEG;
    __syncthreads();

    for (int d = sp.x; d < sp.y; d++) {
      /* the previous thread's last row at step d - 1, or the carried
       * row for a strip's first row */
      const float* prev = xs + ((d + 1) & 1) * 3 * T;
      float uA0 = NEG, uGA0 = NEG, uGB0 = NEG;
      if (t) {
        uA0 = prev[t - 1];
        uGA0 = prev[T + t - 1];
        uGB0 = prev[2 * T + t - 1];
      } else if (ein) {
        if (d >= row[0].lo && d <= row[0].hi) {
          uA0 = eA;
          uGA0 = eGA;
          uGB0 = eGB;
        }
        if (d + 1 < sp.y) load_edge(d + 1);
      }
#pragma unroll
      for (int k = R - 1; k >= 0; k--) {
        const Row& r = row[k];
        /* (vr - 1, j) at step d - 1: the row above, not yet updated */
        const float A_u = k ? A[k - 1] : uA0;
        const float GA_u = k ? GA[k - 1] : uGA0;
        const float GB_u = k ? GB[k - 1] : uGB0;
        const float m = mn[k], b = bn[k];
        load_mb<CHAIN>(a, mrow[k], brow[k], r, d + 1, mn[k], bn[k]);
        float nA = NEG, nGA = NEG, nGB = NEG;
        if (d >= r.lo && d <= r.hi) {
          const int j = d - r.lag;
          const float4 cv = cols[j];
          const bool at_start = d == r.lo;
          const bool at_end = d == r.hi;
          const float ga_chain = fmaxf(GA[k] + cv.x, A[k] + cv.y);
          if (r.flags & F_INIT) {
            const float ga_chain_tg = fmaxf(GA[k], A[k]) + cv.z;
            nA = at_start ? r.f0 : NEG;
            nGA = at_start ? r.f1
                           : (at_end ? NEG
                                     : ((r.flags & F_INIT_TG) ? ga_chain_tg
                                                              : ga_chain));
            nGB = at_start ? r.f2 : NEG;
          } else {
            float a_int = fmaxf(fmaxf(dA[k], dGA[k] + cv.w), dGB[k] + r.f3);
            if (CHAIN) {
              const float* q = p2 + (size_t)j * NSUB;
#pragma unroll
              for (int c = NSUB - 1; c >= 0; c--)
                a_int = __fadd_rn(a_int, __fmul_rn(p1[CHAIN ? k : 0][c],
                                                   q[c]));
            } else {
              a_int = a_int + m;
            }
            a_int = a_int + b;
            nA = at_start ? NEG : a_int;
            nGA = (at_start || at_end) ? NEG : ga_chain;
            const float gb_std = fmaxf(GB_u + r.f0, A_u + r.f1);
            const float gb_tgv = fmaxf(GB_u, A_u) + r.f2;
            nGB = at_start ? ((r.flags & F_START_TG) ? gb_tgv : gb_std)
                           : (at_end ? ((r.flags & F_END_TG) ? gb_tgv
                                                             : gb_std)
                                     : gb_std);
          }
          if (r.slot >= 0 && j < a.ncols) {
            float* o = a.out + ((((size_t)g * a.W + r.slot) * a.ncols + j)
                                * 3);
            o[0] = nA;
            o[1] = nGA;
            o[2] = nGB;
          }
          if (k == R - 1 && eout) {
            eout[j] = nA;
            eout[C1 + j] = nGA;
            eout[2 * C1 + j] = nGB;
          }
        }
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
}

template <int R, bool CHAIN>
cudaError_t launch_rows(const Args& a, int G, int threads, size_t smem,
                        cudaStream_t s) {
  auto kernel = exact_sweep_kernel<R, CHAIN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<G, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

KT_EXPORT int kt_exact_sweep(const void* rowi, const void* rowf,
                             const void* cols, const void* match,
                             const void* bonus, const void* p1cnt,
                             const void* p2sub, const void* lag,
                             const void* span, void* out, void* edge, int G,
                             int VR, int C, int ldm, int W, int ncols,
                             int strips, int use_chain, int threads, int rows,
                             void* stream) {
  if (G <= 0) return 0;
  if (threads <= 0 || threads > kThreads || strips <= 0 ||
      threads * rows * strips != VR || (strips > 1 && edge == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool chain = use_chain != 0;
  const size_t staged = (size_t)(C + 1) * (16 + (chain ? 4 * NSUB : 0));
  const int stage = staged <= (size_t)kStageBytes;
  Args a{(const int4*)rowi, (const float*)rowf, (const float4*)cols,
         (const float*)match, (const float*)bonus, (const float*)p1cnt,
         (const float*)p2sub, (const int*)lag, (const int2*)span,
         (float*)out, (float*)edge, VR, C, ldm, W, ncols, strips, stage};
  const size_t smem = (stage ? staged : 0) + 6 * threads * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (chain) {
    switch (rows) {
      case 1: return (int)launch_rows<1, true>(a, G, threads, smem, s);
      case 2: return (int)launch_rows<2, true>(a, G, threads, smem, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (rows) {
    case 1: return (int)launch_rows<1, false>(a, G, threads, smem, s);
    case 2: return (int)launch_rows<2, false>(a, G, threads, smem, s);
    case 4: return (int)launch_rows<4, false>(a, G, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
