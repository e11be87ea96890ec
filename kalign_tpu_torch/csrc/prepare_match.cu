/* Match preparation: the centering bias and the consistency bonus added
 * in place to a float32 block of a batch's match scores.
 *
 * Replaces kalign_tpu/tpu/engine.py::_prepare_match (:71), the XLA
 * fusion that, when a consistency bonus is present, subtracts the
 * centering bias |j - i * slope| * eps from the match product and adds
 * the K-anchor bonus accumulated anchor by anchor into zeros.  Its plain
 * PyTorch version is gpu/prepare.py::bonus_match, whose float order this
 * kernel repeats operation by operation (-fmad=false): per cell
 *     m = m - |(col0 + j + 1) - (row0 + i + 1) * slope| * eps
 *     acc = +0; for k < K: acc = acc + (eq_k ? (per_w * cfr_k) * cfc_k : 0)
 *     m = m + acc
 * with eq_k = apr_k[i] == apc_k[j] and apr_k[i] >= 0.  The block is the
 * rows [row0, row0 + R) and columns [col0, col0 + W) of the whole match,
 * so a row block of the wave route (gpu/gotoh_wave.py) or a band of the
 * mesh (parallel/mesh.py::long_operands) gets the bits of the same cells
 * of the whole match.  The bonus vectors are the block's own: apr / cfr
 * [B, K, R], apc / cfc [B, K, W].
 *
 * Design: one block of kThreads threads per kCols * kThreads columns of
 * one row; each thread reads its kCols match values as one float4,
 * updates them in registers and writes them back.  The row's bias term
 * and anchors are the same for every thread of a block (broadcast
 * loads); the columns' anchors are read as int4 / float4 per anchor.
 *
 * Bound: device-memory bytes — each cell's 4 bytes read and written once
 * (8 bytes a cell); the anchor vectors are K * (R + W) * 8 bytes.  Before
 * this kernel the same work took about six full-size float32 temporaries
 * (the bias, its product, each anchor's equality mask and term, the
 * accumulator), so a wide launch with a bonus needed ~29 bytes a cell;
 * in place it needs none past the match itself.
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns a thread: one float4
constexpr int kTile = kThreads * kCols;

__global__ void __launch_bounds__(kThreads)
prepare_match_kernel(float* __restrict__ match,         // [B, R, W]
                     const float* __restrict__ slope,   // [B]
                     const float* __restrict__ eps,     // [B]
                     const float* __restrict__ per_w,   // [1]
                     const int32_t* __restrict__ apr,   // [B, K, R]
                     const float* __restrict__ cfr,     // [B, K, R]
                     const int32_t* __restrict__ apc,   // [B, K, W]
                     const float* __restrict__ cfc,     // [B, K, W]
                     int K, int R, int W, int row0, int col0, int tiles) {
  const int b = blockIdx.y;
  const int i = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * kTile + threadIdx.x * kCols;
  if (j0 >= W) return;  // W % kCols == 0: a thread's columns are all in
  float4* p = reinterpret_cast<float4*>(
      match + ((size_t)b * R + i) * W + j0);
  const float4 v = *p;
  float m[kCols] = {v.x, v.y, v.z, v.w};

  // the centering bias: |j - i * slope| * eps, subtracted
  const float e = eps[b];
  const float t = (float)(row0 + i + 1) * slope[b];
#pragma unroll
  for (int c = 0; c < kCols; c++) {
    const float jj = (float)(col0 + j0 + c + 1);
    m[c] = m[c] - fabsf(jj - t) * e;
  }

  // the bonus: accumulated anchor by anchor from +0, then added once
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; c++) acc[c] = 0.0f;
  const float pw = *per_w;
  for (int k = 0; k < K; k++) {
    const size_t rk = ((size_t)b * K + k) * R + i;
    const int a = apr[rk];
    float add[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a >= 0) {
      const size_t ck = ((size_t)b * K + k) * W + j0;
      const float w = pw * cfr[rk];
      const int4 ac = *reinterpret_cast<const int4*>(apc + ck);
      const float4 cc = *reinterpret_cast<const float4*>(cfc + ck);
      const int acv[kCols] = {ac.x, ac.y, ac.z, ac.w};
      const float ccv[kCols] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
      for (int c = 0; c < kCols; c++)
        add[c] = (acv[c] == a) ? w * ccv[c] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kCols; c++) acc[c] = acc[c] + add[c];
  }
#pragma unroll
  for (int c = 0; c < kCols; c++) m[c] = m[c] + acc[c];
  *p = make_float4(m[0], m[1], m[2], m[3]);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

/* The match block [B, R, W] (W a multiple of 4, 16-byte aligned rows)
 * prepared in place; the anchor vectors as the header note gives them. */
KT_EXPORT int kt_prepare_match(void* match, const void* slope,
                               const void* eps, const void* per_w,
                               const void* apr, const void* cfr,
                               const void* apc, const void* cfc, int B,
                               int K, int R, int W, int row0, int col0,
                               void* stream) {
  if (B <= 0 || R <= 0 || W <= 0) return 0;
  if (K < 0 || W % kCols || B > 65535 || !aligned16(match) ||
      (K > 0 && (!aligned16(apc) || !aligned16(cfc))))
    return (int)cudaErrorInvalidValue;
  const int tiles = (W + kTile - 1) / kTile;
  if ((long long)tiles * R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * R), (unsigned)B, 1);
  prepare_match_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)match, (const float*)slope, (const float*)eps,
      (const float*)per_w, (const int32_t*)apr, (const float*)cfr,
      (const int32_t*)apc, (const float*)cfc, K, R, W, row0, col0, tiles);
  return (int)cudaGetLastError();
}
