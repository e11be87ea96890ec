/* Gotoh forward for large merge batches: one warp per problem.
 *
 * Replaces two TPU kernels with one DP body, templated on where the
 * match score of a cell comes from:
 *   - kalign_tpu/tpu/gotoh_lanewise.py::_kernel (gotoh_forward_lanewise)
 *     reads it from a materialised [B, L1p, L2p] match array
 *     (MatchStream);
 *   - kalign_tpu/tpu/gotoh_lanewise.py::_fused_kernel
 *     (gotoh_forward_fused) computes it in the kernel from the nc-wide
 *     operands, m(i, j) = X[i, 0] * Y[j, 0] + X[i, 1] * Y[j, 1] + ...,
 *     multiplied and added in ascending c, each operation rounded on its
 *     own (FusedOperands).  No match array exists on that route.
 * The DP is the affine-gap recurrence with the in-row gap state computed
 * directly as a loop carry,
 *     GA[i][j] = max(GA[i][j-1] + ge[j], A[i][j-1] + go[j]),
 * so no scan.  The per-cell float op order is gotoh_forward_direct_np's,
 * including the precomputed cols_eps (j * eps) and row_term
 * (i * slope * eps), so that no multiply feeds the bias subtraction, and
 * the lb == 0 fix-up (applied by the wrapper).
 *
 * Design: the TPU kernels put 1,024 problems on the lanes of one vector
 * tile and walk each problem's cells in order.  Here a warp owns a
 * problem and sweeps it in strips of 32 * R rows: lane r holds the R
 * consecutive rows i0 + R*r .. i0 + R*r + R - 1 and, at step t, computes
 * column j = t - r + 1 of all of them, top to bottom (an anti-diagonal
 * wavefront skewed by one column per lane).  The top row's cell above
 * comes from lane r-1's bottom row of the previous step by a warp
 * shuffle; every other row's comes from the row above it in the same
 * lane; the cell to the left and the diagonal stay in registers.  So a
 * lane loads one column's data once per step and uses it for R cells,
 * and a warp shuffles three values per R cells.  The column data
 * (goB, geB, tgeB, cols_eps and, for the fused route, Y[j, :nc]) is
 * staged once per problem in shared memory as float4 records, and the
 * strip's last row goes to the next strip through shared memory.  Every
 * cell runs the same operations in the same order as the sequential
 * oracle, so results are bitwise equal.  All inputs are in the callers'
 * problem-major layout ([B, L1p, L2p] match or [B, L1p, nc] /
 * [B, L2p, nc] operands, [B, 3, L*+1] penalties), so no relayout pass is
 * needed.  Decisions pack eight 4-bit cells per int32, problem-major
 * with the rows innermost, [B, L2p/8, L1p4] (L1p4: L1p rounded up to 4),
 * so that a lane stores its four rows' word of a column group as one
 * 16-byte store every eight steps.
 *
 * Bound: the fused route does 19 + 2 * nc - 1 fp32 operations per cell
 * and moves only half a decision byte, so it is bound by operations; the
 * R rows per lane cut the shared-memory loads and shuffles per cell to
 * about 1/R of one row per lane.  The match-stream route reads 4 bytes
 * of match per cell from device memory (each lane streams its own rows;
 * a 32-byte sector serves 8 steps from L1, so at most two blocks share an
 * SM and the rest of its memory is L1) and is bound by those bytes.
 * Strips stop at a problem's last row; a lane whose rows run past it
 * computes them all (no branch per row) and may store their decisions,
 * which are never read.
 */
#include "kt_cuda.h"

namespace {

constexpr int kMaxWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kColFloats = 4;  // goB[j], geB[j], tgeB[j], cols_eps[j-1]

// floats per staged column record: the penalties and bias, then the
// source's column operands, padded to a float4
__host__ __device__ inline int record_floats(int nc) {
  return kColFloats + ((nc + 3) & ~3);
}

// the decision bits of one cell: all-ones where a >= b (a > b), else 0
__device__ __forceinline__ uint32_t ge_mask(float a, float b) {
  uint32_t r;
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ uint32_t gt_mask(float a, float b) {
  uint32_t r;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  return r;
}

// match source of gotoh_forward_lanewise: the lane's rows of the match
// array, read from device memory; rows past the problem read its last
// row (their cells are never used).  A warp streams 32 * kRows match rows
// and reads each 32-byte sector over 8 steps, so those sectors must stay
// in L1: at most kBlocksPerSM blocks share an SM, and the rest of its
// memory is left to L1
struct MatchStream {
  static constexpr int kRows = 4;
  static constexpr int kBlocksPerSM = 2;
  struct Args {
    const float* match;  // [B, L1p, L2p]
  };
  __host__ __device__ static int nc(const Args&) { return 0; }
  const float* mprob;
  const float* mrow;
  int L2p;
  int j;
  int roff[kRows];
  __device__ MatchStream(const Args& a, int b, int L1p, int L2p_)
      : mprob(a.match + (size_t)b * L1p * L2p_), mrow(nullptr), L2p(L2p_),
        j(0) {}
  __device__ void stage(float*, int, int) {}
  __device__ void rows(int i, int nrows) {
    mrow = mprob + (size_t)(i - 1) * L2p;
#pragma unroll
    for (int q = 0; q < kRows; q++) roff[q] = min(q, nrows - 1) * L2p;
  }
  __device__ void col(int j_, const float*) { j = j_; }
  __device__ float at(int q) const { return mrow[roff[q] + j - 1]; }
};

// match source of gotoh_forward_fused: X[i, :nc] . Y[j, :nc], an
// ascending-c chain of separately rounded multiplies and adds; the rows'
// operands sit in registers for the strip, the column's are read from its
// staged record once per step.  kNC bounds nc, so that the unrolled chain
// indexes registers, not local memory.
template <int kNC, int kR>
struct FusedOperands {
  static constexpr int kRows = kR;
  static constexpr int kBlocksPerSM = 0;  // as many as fit
  struct Args {
    const float* x;  // [B, L1p, nc]
    const float* y;  // [B, L2p, nc]
    int nc;
  };
  __host__ __device__ static int nc(const Args& a) { return a.nc; }
  const float* xprob;
  const float* yprob;
  int ncols;
  float xr[kR][kNC];
  float yc[kNC];
  __device__ FusedOperands(const Args& a, int b, int L1p, int L2p)
      : xprob(a.x + (size_t)b * L1p * a.nc),
        yprob(a.y + (size_t)b * L2p * a.nc), ncols(a.nc) {}
  __device__ bool live(int c) const { return c < ncols; }
  // Y[j-1, c] into column record j-1 (coalesced reads of the operands)
  __device__ void stage(float* rec, int L2p, int lane) {
    const int stride = record_floats(ncols);
    for (int t = lane; t < L2p * ncols; t += 32) {
      const int jj = t / ncols;
      rec[jj * stride + kColFloats + (t - jj * ncols)] = yprob[t];
    }
  }
  __device__ void rows(int i, int nrows) {
#pragma unroll
    for (int q = 0; q < kR; q++)
#pragma unroll
      for (int c = 0; c < kNC; c++)
        xr[q][c] = (q < nrows && live(c))
                       ? xprob[(size_t)(i - 1 + q) * ncols + c]
                       : 0.0f;
  }
  __device__ void col(int, const float* rec) {
#pragma unroll
    for (int c4 = 0; c4 < (kNC + 3) / 4; c4++) {
      if (live(4 * c4)) {
        const float4 v =
            reinterpret_cast<const float4*>(rec + kColFloats)[c4];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; u++)
          if (4 * c4 + u < kNC) yc[4 * c4 + u] = w[u];
      }
    }
  }
  __device__ float at(int q) const {
    float m = xr[q][0] * yc[0];
#pragma unroll
    for (int c = 1; c < kNC; c++)
      if (live(c)) m = m + xr[q][c] * yc[c];
    return m;
  }
};

// shared memory of one warp: the column records and the strip boundary
// row (A, GA, GB)
__host__ __device__ inline size_t warp_smem_floats(int L2p, int nc) {
  return (size_t)L2p * (record_floats(nc) + 3);
}

template <class Src>
__global__ void __launch_bounds__(kMaxWarps * 32)
gotoh_lanewise_kernel(typename Src::Args src_args,
                      const float* __restrict__ colpen,    // [B, 3, L2p+1]
                      const float* __restrict__ cols_eps,  // [B, L2p]
                      const float* __restrict__ rowpen,    // [B, 3, L1p+1]
                      const float* __restrict__ row_term,  // [B, L1p]
                      const float* __restrict__ gb0,       // [B, L1p+1]
                      const float* __restrict__ ga0,       // [B, L2p]
                      const int32_t* __restrict__ la_arr,
                      const int32_t* __restrict__ lb_arr,
                      int B, int L1p, int L2p,
                      int32_t* __restrict__ dec,  // [B, L2p/8, L1p4]
                      float* __restrict__ score_out,
                      int32_t* __restrict__ state_out) {
  constexpr int R = Src::kRows;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const int rows = la < L1p ? la : L1p;
  const int W8 = L2p / 8;
  const int L1p4 = (L1p + 3) & ~3;
  const int stride = record_floats(Src::nc(src_args));
  const float* goB = colpen + (size_t)b * 3 * (L2p + 1);
  const float* geB = goB + (L2p + 1);
  const float* tgeB = geB + (L2p + 1);
  const float* goA = rowpen + (size_t)b * 3 * (L1p + 1);
  const float* geA = goA + (L1p + 1);
  const float* tgeA = geA + (L1p + 1);
  const float* gb0b = gb0 + (size_t)b * (L1p + 1);
  Src src(src_args, b, L1p, L2p);
  float* rec = reinterpret_cast<float*>(smem4) +
               (size_t)warp * warp_smem_floats(L2p, Src::nc(src_args));
  float* bA = rec + (size_t)L2p * stride;  // row above the strip
  float* bGA = bA + L2p;
  float* bGB = bGA + L2p;

  // column records; row 0: A = NEG, GA = the leading terminal-gap run,
  // GB = NEG
  for (int j = lane; j < L2p; j += 32) {
    *reinterpret_cast<float4*>(rec + (size_t)j * stride) = make_float4(
        goB[j + 1], geB[j + 1], tgeB[j + 1], cols_eps[(size_t)b * L2p + j]);
    bA[j] = KT_NEG;
    bGA[j] = ga0[(size_t)b * L2p + j];
    bGB[j] = KT_NEG;
  }
  src.stage(rec, L2p, lane);
  __syncwarp();

  float ea = KT_NEG, ega = KT_NEG, egb = KT_NEG;
  bool have_end = false;
  for (int i0 = 1; i0 <= rows; i0 += 32 * R) {
    const int ib = i0 + R * lane;  // the lane's top row
    const int nr = max(0, min(R, rows - ib + 1));
    const int last_q = la - ib;    // the lane's row that is row la, if any
    float goA_r[R], geA_r[R], tgeA_r[R], rterm[R];
    float A_cur[R], GA_cur[R], GB_cur[R];  // row's values at column j-1
    uint32_t word[R];
#pragma unroll
    for (int q = 0; q < R; q++) {
      const int i = ib + q;
      const bool ok = q < nr;
      goA_r[q] = ok ? goA[i] : 0.f;
      geA_r[q] = ok ? geA[i] : 0.f;
      tgeA_r[q] = ok ? tgeA[i] : 0.f;
      rterm[q] = ok ? row_term[(size_t)b * L1p + i - 1] : 0.f;
      A_cur[q] = KT_NEG;
      GA_cur[q] = KT_NEG;
      GB_cur[q] = ok ? gb0b[i] : KT_NEG;
      word[q] = 0;
    }
    const float goA_top_prev = nr > 0 ? goA[ib - 1] : 0.f;
    src.rows(ib, nr);
    // the lane's rows of decision word 0
    int32_t* dcol = dec + (size_t)b * W8 * L1p4 + (ib - 1);
    // the top row's diagonal (row ib-1, column j-1)
    float dA = (ib == 1) ? 0.0f : KT_NEG;
    float dGA = KT_NEG;
    float dGB = nr > 0 ? gb0b[ib - 1] : KT_NEG;
    float goB_prev = goB[0];  // goB[j-1]
    // this lane's bottom row outputs of the previous step
    float oA = KT_NEG, oGA = KT_NEG, oGB = KT_NEG;
    for (int t = 0; t < L2p + 31; t++) {
      const float sA = __shfl_up_sync(kFull, oA, 1);
      const float sGA = __shfl_up_sync(kFull, oGA, 1);
      const float sGB = __shfl_up_sync(kFull, oGB, 1);
      const int j = t - lane + 1;
      if (nr == 0 || j < 1 || j > L2p) continue;
      // the cell above the top row (row ib-1, column j)
      float uA, uGA, uGB;
      if (lane == 0) {
        uA = bA[j - 1];
        uGA = bGA[j - 1];
        uGB = bGB[j - 1];
      } else {
        uA = sA;
        uGA = sGA;
        uGB = sGB;
      }
      const float* rj = rec + (size_t)(j - 1) * stride;
      const float4 cp = *reinterpret_cast<const float4*>(rj);
      const float goB_j = cp.x, geB_j = cp.y, tgeB_j = cp.z, ceps_j = cp.w;
      src.col(j, rj);
      const bool term = lb == j;
      const int nib = (j - 1) & 7;
      const uint32_t k1 = 1u << (4 * nib);  // this column's decision bits
      // the diagonal of the row below is this row's value at column j-1
      float pA = dA, pGA = dGA, pGB = dGB;
      dA = uA;
      dGA = uGA;
      dGB = uGB;
      // every row of the lane, also rows past the problem's end (their
      // values and decisions are never used; only valid rows are stored)
#pragma unroll
      for (int q = 0; q < R; q++) {
        float m = src.at(q);
        m = m - fabsf(ceps_j - rterm[q]);
        const float goA_prev = q == 0 ? goA_top_prev : goA_r[q - 1];

        const float diagA = pA;
        const float cGA = pGA + goB_prev;
        const float cGB = pGB + goA_prev;
        const float best01 = fmaxf(diagA, cGA);
        const float A_new = fmaxf(best01, cGB) + m;

        const float ge_eff = term ? tgeA_r[q] : geA_r[q];
        const float go_eff = term ? tgeA_r[q] : goA_r[q];
        const float gb_e = uGB + ge_eff;
        const float gb_o = uA + go_eff;
        const float GB_new = fmaxf(gb_e, gb_o);

        const bool last = q == last_q;
        const float ge_row = last ? tgeB_j : geB_j;
        const float go_row = last ? tgeB_j : goB_j;
        const float ga_e = GA_cur[q] + ge_row;
        const float ga_o = A_cur[q] + go_row;
        const float GA_new = fmaxf(ga_e, ga_o);

        // A: 2 if cGB >= best01, else 1 if cGA >= diagA; GA and GB: extend
        const uint32_t a2 = ge_mask(cGB, best01);
        const uint32_t a1 = ge_mask(cGA, diagA);
        word[q] |= (a2 & (k1 << 1)) | (~a2 & a1 & k1) |
                   (gt_mask(ga_e, ga_o) & (k1 * KT_DEC_GA_EXT)) |
                   (gt_mask(gb_e, gb_o) & (k1 * KT_DEC_GB_EXT));
        pA = A_cur[q];
        pGA = GA_cur[q];
        pGB = GB_cur[q];
        uA = A_new;
        uGA = GA_new;
        uGB = GB_new;
        A_cur[q] = A_new;
        GA_cur[q] = GA_new;
        GB_cur[q] = GB_new;
      }
      if (j == lb && last_q >= 0 && last_q < nr) {
#pragma unroll
        for (int q = 0; q < R; q++) {
          if (q == last_q) {
            ea = A_cur[q];
            ega = GA_cur[q];
            egb = GB_cur[q];
          }
        }
        have_end = true;
      }
      if (nib == 7) {
        int32_t* d = dcol + (size_t)((j - 1) >> 3) * L1p4;
        if constexpr (R % 4 == 0) {
          // rows ib-1+4g .. +3 lie within L1p4 when the first is valid
#pragma unroll
          for (int g = 0; g < R / 4; g++)
            if (4 * g < nr)
              *reinterpret_cast<uint4*>(d + 4 * g) =
                  make_uint4(word[4 * g], word[4 * g + 1], word[4 * g + 2],
                             word[4 * g + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < R; q++)
            if (q < nr) d[q] = (int32_t)word[q];
        }
#pragma unroll
        for (int q = 0; q < R; q++) word[q] = 0;
      }
      if (lane == 31) {
        bA[j - 1] = uA;
        bGA[j - 1] = uGA;
        bGB[j - 1] = uGB;
      }
      oA = uA;
      oGA = uGA;
      oGB = uGB;
      goB_prev = goB_j;
    }
    __syncwarp();
  }

  if (la == 0 && lane == 0 && lb >= 1 && lb <= L2p) {
    ega = ga0[(size_t)b * L2p + lb - 1];
    have_end = true;
  }
  const unsigned who = __ballot_sync(kFull, have_end);
  if (who == 0u) {
    if (lane == 0) {
      score_out[b] = KT_NEG;
      state_out[b] = 0;
    }
  } else if (lane == __ffs(who) - 1) {
    score_out[b] = fmaxf(fmaxf(ea, ega), egb);
    state_out[b] = (ega > ea) ? ((egb > ega) ? 2 : 1) : ((egb > ea) ? 2 : 0);
  }
}

template <class Src>
int launch(const typename Src::Args& src, const float* colpen,
           const float* cols_eps, const float* rowpen, const float* row_term,
           const float* gb0, const float* ga0, const int32_t* la,
           const int32_t* lb, int B, int L1p, int L2p, int warps,
           int32_t* dec, float* score, int32_t* st, void* stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)warps * warp_smem_floats(L2p, Src::nc(src)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gotoh_lanewise_kernel<Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (Src::kBlocksPerSM > 0) {
    // a shared-memory carveout (a percentage of the SM's most) that holds
    // kBlocksPerSM blocks, each with the 1 KB the system reserves
    int dev = 0, most = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess) {
      const size_t want = Src::kBlocksPerSM * (smem + 1024);
      const size_t pct = (want * 100 + most - 1) / most;
      e = cudaFuncSetAttribute(gotoh_lanewise_kernel<Src>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               pct < 100 ? (int)pct : 100);
    }
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + warps - 1) / warps;
  gotoh_lanewise_kernel<Src><<<blocks, warps * 32, smem,
                               (cudaStream_t)stream>>>(
      src, colpen, cols_eps, rowpen, row_term, gb0, ga0, la, lb, B, L1p,
      L2p, dec, score, st);
  return (int)cudaGetLastError();
}

}  // namespace

/* Shared memory of a block of `warps` warps at width L2p; nc = 0 for the
 * match-stream route. */
KT_EXPORT size_t kt_gotoh_lanewise_smem_bytes(int L2p, int nc, int warps) {
  return (size_t)warps * warp_smem_floats(L2p, nc) * sizeof(float);
}

KT_EXPORT int kt_gotoh_lanewise_forward(
    const float* match, const float* colpen, const float* cols_eps,
    const float* rowpen, const float* row_term, const float* gb0,
    const float* ga0, const int32_t* la, const int32_t* lb, int B, int L1p,
    int L2p, int warps, int32_t* dec, float* score, int32_t* st,
    void* stream) {
  return launch<MatchStream>({match}, colpen, cols_eps, rowpen, row_term,
                             gb0, ga0, la, lb, B, L1p, L2p, warps, dec,
                             score, st, stream);
}

/* x [B, L1p, nc], y [B, L2p, nc], 1 <= nc <= 32. */
KT_EXPORT int kt_gotoh_fused_forward(
    const float* x, const float* y, int nc, const float* colpen,
    const float* cols_eps, const float* rowpen, const float* row_term,
    const float* gb0, const float* ga0, const int32_t* la, const int32_t* lb,
    int B, int L1p, int L2p, int warps, int32_t* dec, float* score,
    int32_t* st, void* stream) {
  if (nc < 1 || nc > 32) return (int)cudaErrorInvalidValue;
  if (nc <= 8)
    return launch<FusedOperands<8, 4>>(
        {x, y, nc}, colpen, cols_eps, rowpen, row_term, gb0, ga0, la, lb, B,
        L1p, L2p, warps, dec, score, st, stream);
  return launch<FusedOperands<32, 1>>(
      {x, y, nc}, colpen, cols_eps, rowpen, row_term, gb0, ga0, la, lb, B,
      L1p, L2p, warps, dec, score, st, stream);
}
