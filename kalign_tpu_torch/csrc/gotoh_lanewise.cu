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
 * tile and walk each problem's cells in order.  On the card one thread
 * per problem leaves most of it idle, so here a warp owns a problem and
 * sweeps it in strips of 32 rows: lane r holds row i0 + r and, at step t,
 * computes column j = t - r + 1 (an anti-diagonal wavefront skewed by one
 * column per lane).  The cell above comes from lane r-1's previous step
 * by a warp shuffle, the cell to the left and the diagonal stay in the
 * lane's registers, and only the strip's last row goes through global
 * memory to the next strip.  Every cell runs the same operations in the
 * same order as the sequential oracle, so results are bitwise equal.
 * All inputs are in the callers' problem-major layout ([B, L1p, L2p]
 * match or [B, L1p, nc] / [B, L2p, nc] operands, [B, 3, L*+1]
 * penalties), so no relayout pass is needed.  Decisions pack eight 4-bit
 * cells per int32: [L1p, L2p/8, B].
 *
 * Bound: device-memory bytes.  The match-stream route reads 4 bytes of
 * match and writes half a decision byte per cell; each lane reads its
 * own match row, so a warp's loads touch 32 rows and each 32-byte sector
 * is reused by the lane over eight steps from L1.  The fused route keeps
 * its row's nc operands in registers for the whole strip and reads the
 * column's nc operands per step (the 32 lanes read 32 neighbouring
 * columns, L1-resident), so it moves only the decisions per cell and
 * adds 2 * nc - 1 fp32 operations.  Rows past a problem's length are
 * skipped (their decisions are never read).
 */
#include "kt_cuda.h"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// match source of gotoh_forward_lanewise: row i of the match array
struct MatchStream {
  struct Args {
    const float* match;  // [B, L1p, L2p]
  };
  const float* mprob;
  const float* mrow;
  int L2p;
  __device__ MatchStream(const Args& a, int b, int L1p, int L2p_)
      : mprob(a.match + (size_t)b * L1p * L2p_), mrow(nullptr), L2p(L2p_) {}
  __device__ void row(int i, bool) { mrow = mprob + (size_t)(i - 1) * L2p; }
  __device__ float at(int j) const { return mrow[j - 1]; }
};

// match source of gotoh_forward_fused: X[i, :nc] . Y[j, :nc], an
// ascending-c chain of separately rounded multiplies and adds; the row's
// operands sit in registers for the strip (kMaxNC bounds nc at compile
// time so that the unrolled chain indexes registers, not local memory)
template <int kMaxNC>
struct FusedOperands {
  struct Args {
    const float* x;  // [B, L1p, nc]
    const float* y;  // [B, L2p, nc]
    int nc;
  };
  const float* xprob;
  const float* yprob;
  int nc;
  float xr[kMaxNC];
  __device__ FusedOperands(const Args& a, int b, int L1p, int L2p)
      : xprob(a.x + (size_t)b * L1p * a.nc),
        yprob(a.y + (size_t)b * L2p * a.nc), nc(a.nc) {}
  __device__ void row(int i, bool row_ok) {
#pragma unroll
    for (int c = 0; c < kMaxNC; c++)
      xr[c] = (row_ok && c < nc) ? xprob[(size_t)(i - 1) * nc + c] : 0.0f;
  }
  __device__ float at(int j) const {
    const float* y = yprob + (size_t)(j - 1) * nc;
    float m = xr[0] * y[0];
#pragma unroll
    for (int c = 1; c < kMaxNC; c++)
      if (c < nc) m = m + xr[c] * y[c];
    return m;
  }
};

template <class Src>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
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
                      float* __restrict__ bound,           // [B, 3, L2p]
                      int32_t* __restrict__ dec,           // [L1p, L2p/8, B]
                      float* __restrict__ score_out,
                      int32_t* __restrict__ state_out) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int r = threadIdx.x & 31;
  if (b >= B) return;
  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const int rows = la < L1p ? la : L1p;
  const int W8 = L2p / 8;
  const float* goB = colpen + (size_t)b * 3 * (L2p + 1);
  const float* geB = goB + (L2p + 1);
  const float* tgeB = geB + (L2p + 1);
  const float* goA = rowpen + (size_t)b * 3 * (L1p + 1);
  const float* geA = goA + (L1p + 1);
  const float* tgeA = geA + (L1p + 1);
  const float* ceps = cols_eps + (size_t)b * L2p;
  Src src(src_args, b, L1p, L2p);
  float* bA = bound + (size_t)b * 3 * L2p;   // row above the strip
  float* bGA = bA + L2p;
  float* bGB = bGA + L2p;

  // row 0: A = NEG, GA = the leading terminal-gap run, GB = NEG
  for (int j = r; j < L2p; j += 32) {
    bA[j] = KT_NEG;
    bGA[j] = ga0[(size_t)b * L2p + j];
    bGB[j] = KT_NEG;
  }
  __syncwarp();

  float ea = KT_NEG, ega = KT_NEG, egb = KT_NEG;
  bool have_end = false;
  for (int i0 = 1; i0 <= rows; i0 += 32) {
    const int i = i0 + r;
    const bool row_ok = i <= rows;
    const bool last = i == la;
    float goA_i = 0.f, geA_i = 0.f, tgeA_i = 0.f, goA_prev = 0.f;
    float rterm = 0.f, gb_col0 = KT_NEG;
    if (row_ok) {
      goA_i = goA[i];
      geA_i = geA[i];
      tgeA_i = tgeA[i];
      goA_prev = goA[i - 1];
      rterm = row_term[(size_t)b * L1p + i - 1];
      gb_col0 = gb0[(size_t)b * (L1p + 1) + i - 1];
    }
    src.row(i, row_ok);
    int32_t* drow = dec + (size_t)(i - 1) * W8 * B + b;
    // diagonal (row i-1, column j-1) and left (row i, column j-1)
    float A_pm1 = (i == 1) ? 0.0f : KT_NEG;
    float GA_pm1 = KT_NEG;
    float GB_pm1 = gb_col0;
    float A_cur = KT_NEG, GA_cur = KT_NEG;
    // this lane's outputs of the previous step (row i, column j-1)
    float oA = KT_NEG, oGA = KT_NEG, oGB = KT_NEG;
    uint32_t word = 0;
    for (int t = 0; t < L2p + 31; t++) {
      const float sA = __shfl_up_sync(kFull, oA, 1);
      const float sGA = __shfl_up_sync(kFull, oGA, 1);
      const float sGB = __shfl_up_sync(kFull, oGB, 1);
      const int j = t - r + 1;
      if (!row_ok || j < 1 || j > L2p) continue;
      float A_p, GA_p, GB_p;
      if (r == 0) {
        A_p = bA[j - 1];
        GA_p = bGA[j - 1];
        GB_p = bGB[j - 1];
      } else {
        A_p = sA;
        GA_p = sGA;
        GB_p = sGB;
      }
      float m = src.at(j);
      m = m - fabsf(ceps[j - 1] - rterm);
      const float goB_j = goB[j];
      const float geB_j = geB[j];
      const float tgeB_j = tgeB[j];

      const float diagA = A_pm1;
      const float dGA = GA_pm1 + goB[j - 1];
      const float dGB = GB_pm1 + goA_prev;
      const float best01 = fmaxf(diagA, dGA);
      const float A_new = fmaxf(best01, dGB) + m;

      const bool term = lb == j;
      const float ge_eff = term ? tgeA_i : geA_i;
      const float go_eff = term ? tgeA_i : goA_i;
      const float gb_e = GB_p + ge_eff;
      const float gb_o = A_p + go_eff;
      const float GB_new = fmaxf(gb_e, gb_o);

      const float ge_row = last ? tgeB_j : geB_j;
      const float go_row = last ? tgeB_j : goB_j;
      const float ga_e = GA_cur + ge_row;
      const float ga_o = A_cur + go_row;
      const float GA_new = fmaxf(ga_e, ga_o);

      uint32_t d = (dGB >= best01) ? 2u : ((dGA >= diagA) ? 1u : 0u);
      d |= (ga_e > ga_o) ? KT_DEC_GA_EXT : 0u;
      d |= (gb_e > gb_o) ? KT_DEC_GB_EXT : 0u;
      const int nib = (j - 1) & 7;
      word |= d << (4 * nib);
      if (nib == 7) {
        drow[(size_t)((j - 1) >> 3) * B] = (int32_t)word;
        word = 0;
      }
      if (r == 31) {
        bA[j - 1] = A_new;
        bGA[j - 1] = GA_new;
        bGB[j - 1] = GB_new;
      }
      if (last && j == lb) {
        ea = A_new;
        ega = GA_new;
        egb = GB_new;
        have_end = true;
      }
      A_pm1 = A_p;
      GA_pm1 = GA_p;
      GB_pm1 = GB_p;
      A_cur = A_new;
      GA_cur = GA_new;
      oA = A_new;
      oGA = GA_new;
      oGB = GB_new;
    }
    __syncwarp();
  }

  if (la == 0 && r == 0 && lb >= 1 && lb <= L2p) {
    ega = ga0[(size_t)b * L2p + lb - 1];
    have_end = true;
  }
  const unsigned who = __ballot_sync(kFull, have_end);
  if (who == 0u) {
    if (r == 0) {
      score_out[b] = KT_NEG;
      state_out[b] = 0;
    }
  } else if (r == __ffs(who) - 1) {
    score_out[b] = fmaxf(fmaxf(ea, ega), egb);
    state_out[b] = (ega > ea) ? ((egb > ega) ? 2 : 1) : ((egb > ea) ? 2 : 0);
  }
}

template <class Src>
int launch(const typename Src::Args& src, const float* colpen,
           const float* cols_eps, const float* rowpen, const float* row_term,
           const float* gb0, const float* ga0, const int32_t* la,
           const int32_t* lb, int B, int L1p, int L2p, float* bound,
           int32_t* dec, float* score, int32_t* st, void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gotoh_lanewise_kernel<Src><<<blocks, kWarpsPerBlock * 32, 0,
                               (cudaStream_t)stream>>>(
      src, colpen, cols_eps, rowpen, row_term, gb0, ga0, la, lb, B, L1p,
      L2p, bound, dec, score, st);
  return (int)cudaGetLastError();
}

}  // namespace

KT_EXPORT int kt_gotoh_lanewise_forward(
    const float* match, const float* colpen, const float* cols_eps,
    const float* rowpen, const float* row_term, const float* gb0,
    const float* ga0, const int32_t* la, const int32_t* lb, int B, int L1p,
    int L2p, float* bound, int32_t* dec, float* score, int32_t* st,
    void* stream) {
  return launch<MatchStream>({match}, colpen, cols_eps, rowpen, row_term,
                             gb0, ga0, la, lb, B, L1p, L2p, bound, dec,
                             score, st, stream);
}

/* x [B, L1p, nc], y [B, L2p, nc], 1 <= nc <= 32. */
KT_EXPORT int kt_gotoh_fused_forward(
    const float* x, const float* y, int nc, const float* colpen,
    const float* cols_eps, const float* rowpen, const float* row_term,
    const float* gb0, const float* ga0, const int32_t* la, const int32_t* lb,
    int B, int L1p, int L2p, float* bound, int32_t* dec, float* score,
    int32_t* st, void* stream) {
  if (nc < 1 || nc > 32) return (int)cudaErrorInvalidValue;
  if (nc <= 8)
    return launch<FusedOperands<8>>({x, y, nc}, colpen, cols_eps, rowpen,
                                    row_term, gb0, ga0, la, lb, B, L1p, L2p,
                                    bound, dec, score, st, stream);
  return launch<FusedOperands<32>>({x, y, nc}, colpen, cols_eps, rowpen,
                                   row_term, gb0, ga0, la, lb, B, L1p, L2p,
                                   bound, dec, score, st, stream);
}
