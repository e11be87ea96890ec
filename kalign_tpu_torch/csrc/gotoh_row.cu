/* Row Gotoh kernel: batched 3-state affine-gap forward DP, one DP row
 * per step.
 *
 * Replaces kalign_tpu/tpu/gotoh_pallas.py::_kernel (gotoh_forward_pallas).
 * Same recurrences, tie rules and outputs: int8 decisions (A bits 0-1,
 * GA-extend bit 2, GB-extend bit 3), score and end state; DP column 0 is
 * analytic; the in-row gap state GA is solved by the scan transform
 *     u[k] = A[k] + (go[k+1] - C[k+1]),  GA[j] = max_{k<j} u[k] + C[j]
 * with C the prefix sum of the row's gap extensions.
 *
 * Design: one block per problem, 128 threads; thread t owns the
 * contiguous columns [t*CH, (t+1)*CH) of the row (CH = L2p / 128).  The
 * previous and current rows of A, GA, GB, the u vector and its prefix
 * max live in shared memory (33 bytes per column: L2p <= 6912 within
 * the 227 KB a block may use).  A row is three passes:
 *   1. A and GB, elementwise from the previous row, and u;
 *   2. the prefix max of u: sequential within a thread's chunk, then a
 *      warp-shuffle scan of the chunk maxima and a shared-memory scan
 *      of the warp maxima;
 *   3. GA = shifted prefix max + C, and the decision byte.
 * A prefix max is exact in any association, so given the same
 * row-invariant vectors (C_norm, C_term, gnC_norm, gnC_term, goB_s, the
 * leading-gap row ga0 and the per-row scalars, all computed once by the
 * wrapper with the plain version's code) the kernel is bitwise equal to
 * its plain PyTorch version.
 *
 * Bound: device-memory bytes.  Each cell reads its 4-byte match value
 * once and writes one decision byte (~5 B/cell); the row-invariant
 * vectors are re-read per row but stay in L1/L2.  What limits this
 * first version is latency: three block barriers per row and one block
 * per problem, so a bucket of few problems fills few SMs.  Rows past a
 * problem's length are skipped (their decisions are never read).
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gotoh_row_kernel(const float* __restrict__ match,     // [B, L1p, L2p]
                 const float* __restrict__ colpen,    // [5, B, L2p]
                 const float* __restrict__ ga0,       // [B, L2p]
                 const float* __restrict__ rowpen,    // [B, L1p, 5]
                 const float* __restrict__ cols_eps,  // [B, L2p]
                 const float* __restrict__ row_term,  // [B, L1p]
                 const int32_t* __restrict__ la_arr,
                 const int32_t* __restrict__ lb_arr,
                 int B, int L1p, int L2p,
                 int8_t* __restrict__ dec,            // [B, L1p, L2p]
                 float* __restrict__ score_out,
                 int32_t* __restrict__ state_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int CH = L2p / kThreads;
  const int j0 = t * CH;

  float* bufA[2] = {smem, smem + L2p};
  float* bufGA[2] = {smem + 2 * L2p, smem + 3 * L2p};
  float* bufGB[2] = {smem + 4 * L2p, smem + 5 * L2p};
  float* U = smem + 6 * L2p;
  float* CM = smem + 7 * L2p;
  float* wmax = smem + 8 * L2p;                                // [kWarps]
  uint8_t* D = reinterpret_cast<uint8_t*>(smem + 8 * L2p + kWarps);

  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const size_t BW = (size_t)B * L2p;
  const float* C_norm = colpen + 0 * BW + (size_t)b * L2p;
  const float* C_term = colpen + 1 * BW + (size_t)b * L2p;
  const float* gnC_norm = colpen + 2 * BW + (size_t)b * L2p;
  const float* gnC_term = colpen + 3 * BW + (size_t)b * L2p;
  const float* goB_s = colpen + 4 * BW + (size_t)b * L2p;
  const float* ceps = cols_eps + (size_t)b * L2p;

  int cur = 0;
  for (int c = 0; c < CH; c++) {
    const int j = j0 + c;
    bufA[cur][j] = KT_NEG;
    bufGA[cur][j] = ga0[(size_t)b * L2p + j];
    bufGB[cur][j] = KT_NEG;
  }
  __syncthreads();

  const int rows = la < L1p ? la : L1p;
  for (int r = 0; r < rows; r++) {
    const int row = r + 1;
    const bool last = row == la;
    const float* rp = rowpen + ((size_t)b * L1p + r) * 5;
    const float goA_i = rp[0], geA_i = rp[1], tgeA_i = rp[2];
    const float goA_prev = rp[3], gb0_prev = rp[4];
    const float rterm = row_term[(size_t)b * L1p + r];
    const float a0_prev = (row == 1) ? 0.0f : KT_NEG;
    const float* mrow = match + ((size_t)b * L1p + r) * L2p;
    const float* Ap = bufA[cur];
    const float* GAp = bufGA[cur];
    const float* GBp = bufGB[cur];
    float* Ac = bufA[cur ^ 1];
    float* GAc = bufGA[cur ^ 1];
    float* GBc = bufGB[cur ^ 1];

    // pass 1: A, GB, u and the in-chunk prefix max of u
    float run = -INFINITY;
    for (int c = 0; c < CH; c++) {
      const int j = j0 + c;
      const int col = j + 1;
      float m = mrow[j];
      m = m - fabsf(ceps[j] - rterm);
      const float diagA = (j == 0) ? a0_prev : Ap[j - 1];
      const float dGA = ((j == 0) ? KT_NEG : GAp[j - 1]) + goB_s[j];
      const float dGB = ((j == 0) ? gb0_prev : GBp[j - 1]) + goA_prev;
      const float best01 = fmaxf(diagA, dGA);
      const float A_row = fmaxf(best01, dGB) + m;
      const bool term = col == lb;
      const float ge_eff = term ? tgeA_i : geA_i;
      const float go_eff = term ? tgeA_i : goA_i;
      const float gb_e = GBp[j] + ge_eff;
      const float gb_o = Ap[j] + go_eff;
      const float gnC = last ? gnC_term[j] : gnC_norm[j];
      const float u = (col < lb) ? (A_row + gnC) : KT_NEG;
      int d = (dGB >= best01) ? 2 : ((dGA >= diagA) ? 1 : 0);
      d |= (gb_e > gb_o) ? KT_DEC_GB_EXT : 0;
      Ac[j] = A_row;
      GBc[j] = fmaxf(gb_e, gb_o);
      U[j] = u;
      D[j] = (uint8_t)d;
      run = fmaxf(run, u);
      CM[j] = run;
    }

    // pass 2: block-wide exclusive prefix max of the chunk maxima
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = fmaxf(incl, o);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = -INFINITY;
    if (lane == 31) wmax[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; w++) excl = fmaxf(excl, wmax[w]);
    for (int c = 0; c < CH; c++) CM[j0 + c] = fmaxf(excl, CM[j0 + c]);
    __syncthreads();

    // pass 3: GA and the decision byte
    int8_t* drow = dec + ((size_t)b * L1p + r) * L2p;
    for (int c = 0; c < CH; c++) {
      const int j = j0 + c;
      const float C = last ? C_term[j] : C_norm[j];
      const float cm_s = (j == 0) ? KT_NEG : CM[j - 1];
      const float u_s = (j == 0) ? KT_NEG : U[j - 1];
      GAc[j] = cm_s + C;
      drow[j] = (int8_t)(D[j] | ((cm_s > u_s) ? KT_DEC_GA_EXT : 0));
    }
    __syncthreads();
    cur ^= 1;  // row <= la: the new row becomes the state
  }

  if (t == 0) {
    float ea = KT_NEG, ega = KT_NEG, egb = KT_NEG;
    if (lb >= 1 && lb <= L2p) {
      ea = fmaxf(bufA[cur][lb - 1], KT_NEG);
      ega = fmaxf(bufGA[cur][lb - 1], KT_NEG);
      egb = fmaxf(bufGB[cur][lb - 1], KT_NEG);
    }
    score_out[b] = fmaxf(fmaxf(ea, ega), egb);
    state_out[b] = (ega > ea) ? ((egb > ega) ? 2 : 1) : ((egb > ea) ? 2 : 0);
  }
}

}  // namespace

KT_EXPORT size_t kt_gotoh_row_smem_bytes(int L2p) {
  return (size_t)(8 * L2p + kWarps) * sizeof(float) + (size_t)L2p;
}

KT_EXPORT int kt_gotoh_row_forward(const float* match, const float* colpen,
                                   const float* ga0, const float* rowpen,
                                   const float* cols_eps,
                                   const float* row_term, const int32_t* la,
                                   const int32_t* lb, int B, int L1p, int L2p,
                                   int8_t* dec, float* score, int32_t* state,
                                   void* stream) {
  const size_t smem = kt_gotoh_row_smem_bytes(L2p);
  cudaError_t err = cudaFuncSetAttribute(
      gotoh_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gotoh_row_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      match, colpen, ga0, rowpen, cols_eps, row_term, la, lb, B, L1p, L2p,
      dec, score, state);
  return (int)cudaGetLastError();
}
