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
 * so a row block of the wave route (gpu/gotoh_wave.py) or of a mesh band
 * (parallel/mesh.py::band_source) gets the bits of the same cells of the
 * whole match.  The bonus vectors are the block's own: apr / cfr
 * [B, K, R], apc / cfc [B, K, W].
 *
 * Bound: device-memory bytes — each cell's 4 bytes read and written once
 * (8 bytes a cell) and the anchor vectors once, K * (R + W) * 8 bytes.
 *
 * What bounded the first design (one block per row and 1,024 columns, a
 * float4 a thread): for every anchor every row re-read the columns'
 * anchors apc / cfc, 32 bytes a thread behind a dependent load of the
 * row's anchor — 40 bytes a cell at K = 5 beside the 8 of the match —
 * while each thread had one 16-byte load of the match in flight.  At a
 * plastome row block (1 x 3,440 x 156,032) it moved ~48 bytes a cell in
 * 3.052 ms, 2.4x the 1.284 ms bound: the column vectors (6.2 MB) stayed
 * in L2 and were streamed 3,440 times (PERF.md, PR 15).  Timed on an
 * H100 (no Nsight Compute there), the first design took 2.03 ms at
 * 8 x 9,856 x 9,728 with K = 0, near the bytes bound of 1.83, and 3.72
 * ms with K = 5: the anchors' traffic, not the match's, made the gap.
 *
 * Design: a block of kThreads threads owns a tile of tx * 4 columns (tx
 * threads across, a float4 each) by `rows` rows (ty = kThreads / tx
 * threads down); gpu/prepare.py::launch_plan picks tx by W and `rows` by
 * the shape, from kMaxRows down to no fewer than 16, until the grid has
 * enough blocks to fill the card.  Each thread loads its columns' (apc,
 * cfc) of every anchor once and keeps them in registers (8 a anchor;
 * K <= kGroup has a compile-time instantiation), so the column vectors
 * are read once a tile, not once a row.  The tile's row anchors (apr,
 * per_w * cfr) are staged in shared memory once.  A thread streams its
 * rows kUnroll at a time: kUnroll independent 16-byte loads of the match
 * in flight, with cache-streaming loads and stores (the match is touched
 * once; L2 keeps the anchor vectors).  Past kGroup anchors the kernel
 * takes them in groups of kGroup in k order (the float order holds): a
 * group's column anchors from L1 / L2 for each kUnroll rows, its row
 * anchors from global memory (broadcast loads).
 */
#include "kt_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;     // columns a thread: one float4
constexpr int kUnroll = 4;   // rows a thread has in flight
constexpr int kMaxRows = 64; // rows of a tile (its row anchors in smem)
constexpr int kGroup = 8;    // anchors held in registers at once

struct Args {
  float* match;          // [B, R, W]
  const float* slope;    // [B]
  const float* eps;      // [B]
  const float* per_w;    // [1]
  const int32_t* apr;    // [B, K, R]
  const float* cfr;      // [B, K, R]
  const int32_t* apc;    // [B, K, W]
  const float* cfc;      // [B, K, W]
  int K, R, W, row0, col0;
  int tx, rows, ctiles;  // the launch plan (gpu/prepare.py::launch_plan)
};

/* A group of up to kGroup anchors of one thread's four columns. */
struct Cols {
  int a[kGroup][kCols];
  float c[kGroup][kCols];
};

template <int N>
__device__ __forceinline__ void load_cols(Cols& cs, const Args& p, int b,
                                          int k0, int n, int j0) {
#pragma unroll
  for (int g = 0; g < N; g++) {
    if (g < n) {
      const size_t ck = ((size_t)b * p.K + k0 + g) * p.W + j0;
      const int4 ac = *reinterpret_cast<const int4*>(p.apc + ck);
      const float4 cc = *reinterpret_cast<const float4*>(p.cfc + ck);
      cs.a[g][0] = ac.x; cs.a[g][1] = ac.y; cs.a[g][2] = ac.z;
      cs.a[g][3] = ac.w;
      cs.c[g][0] = cc.x; cs.c[g][1] = cc.y; cs.c[g][2] = cc.z;
      cs.c[g][3] = cc.w;
    }
  }
}

/* acc += each anchor's term in k order: (w_k * cfc_k) where apr_k ==
 * apc_k and apr_k >= 0, else +0. */
__device__ __forceinline__ void add_anchor(float (&acc)[kCols], int ar,
                                           float w, const int (&ac)[kCols],
                                           const float (&cc)[kCols]) {
  const bool live = ar >= 0;
#pragma unroll
  for (int c = 0; c < kCols; c++)
    acc[c] = acc[c] + ((live && ac[c] == ar) ? w * cc[c] : 0.0f);
}

/* KC = K for K <= kGroup (the column anchors loaded once, the row
 * anchors staged in shared memory); KC = -1 past it (groups of kGroup). */
template <int KC>
__global__ void __launch_bounds__(kThreads, 2)
prepare_match_kernel(Args p) {
  constexpr int KS = KC > 0 ? KC : 1;
  __shared__ int s_a[KS][kMaxRows];
  __shared__ float s_w[KS][kMaxRows];
  const int b = blockIdx.y;
  const int ct = blockIdx.x % p.ctiles;
  const int i0 = (blockIdx.x / p.ctiles) * p.rows;
  const int nrows = min(p.rows, p.R - i0);
  const int tx = threadIdx.x % p.tx, ty = threadIdx.x / p.tx;
  const int TY = kThreads / p.tx;
  const int j0 = (ct * p.tx + tx) * kCols;
  const float pw = *p.per_w;

  if constexpr (KC > 0) {
    for (int q = threadIdx.x; q < KC * nrows; q += kThreads) {
      const int k = q / nrows, i = q % nrows;
      const size_t rk = ((size_t)b * KC + k) * p.R + i0 + i;
      s_a[k][i] = p.apr[rk];
      s_w[k][i] = pw * p.cfr[rk];
    }
    __syncthreads();
  }
  if (j0 >= p.W) return;  // W % kCols == 0: a thread's columns are all in

  Cols cs;
  if constexpr (KC > 0) load_cols<KC>(cs, p, b, 0, KC, j0);
  const float e = p.eps[b], sl = p.slope[b];
  float jj[kCols];
#pragma unroll
  for (int c = 0; c < kCols; c++) jj[c] = (float)(p.col0 + j0 + c + 1);
  float* base = p.match + ((size_t)b * p.R + i0) * p.W + j0;

  for (int q0 = ty; q0 < nrows; q0 += TY * kUnroll) {
    float m[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const int q = q0 + u * TY;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < nrows)
        v = __ldcs(reinterpret_cast<const float4*>(base + (size_t)q * p.W));
      m[u][0] = v.x; m[u][1] = v.y; m[u][2] = v.z; m[u][3] = v.w;
    }
    float acc[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      // the centering bias: |j - i * slope| * eps, subtracted
      const float t = (float)(p.row0 + i0 + q0 + u * TY + 1) * sl;
#pragma unroll
      for (int c = 0; c < kCols; c++) {
        m[u][c] = m[u][c] - fabsf(jj[c] - t) * e;
        acc[u][c] = 0.0f;
      }
    }
    // the bonus: accumulated anchor by anchor from +0
    if constexpr (KC > 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        const int q = min(q0 + u * TY, nrows - 1);
#pragma unroll
        for (int k = 0; k < KC; k++)
          add_anchor(acc[u], s_a[k][q], s_w[k][q], cs.a[k], cs.c[k]);
      }
    } else if constexpr (KC < 0) {
      for (int k0 = 0; k0 < p.K; k0 += kGroup) {
        const int n = min(kGroup, p.K - k0);
        load_cols<kGroup>(cs, p, b, k0, n, j0);
#pragma unroll
        for (int u = 0; u < kUnroll; u++) {
          const int q = min(q0 + u * TY, nrows - 1);
#pragma unroll
          for (int g = 0; g < kGroup; g++) {
            if (g < n) {
              const size_t rk = ((size_t)b * p.K + k0 + g) * p.R + i0 + q;
              add_anchor(acc[u], p.apr[rk], pw * p.cfr[rk], cs.a[g],
                         cs.c[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const int q = q0 + u * TY;
      if (q < nrows) {
        __stcs(reinterpret_cast<float4*>(base + (size_t)q * p.W),
               make_float4(m[u][0] + acc[u][0], m[u][1] + acc[u][1],
                           m[u][2] + acc[u][2], m[u][3] + acc[u][3]));
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int KC>
void launch(const Args& a, dim3 grid, cudaStream_t s) {
  prepare_match_kernel<KC><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace

/* The match block [B, R, W] (W a multiple of 4, 16-byte aligned rows)
 * prepared in place; the anchor vectors as the header note gives them;
 * the plan (tx threads across a tile, rows a tile) from
 * gpu/prepare.py::launch_plan. */
KT_EXPORT int kt_prepare_match(void* match, const void* slope,
                               const void* eps, const void* per_w,
                               const void* apr, const void* cfr,
                               const void* apc, const void* cfc, int B,
                               int K, int R, int W, int row0, int col0,
                               int tx, int rows, void* stream) {
  if (B <= 0 || R <= 0 || W <= 0) return 0;
  if (K < 0 || W % kCols || B > 65535 || !aligned16(match) ||
      (K > 0 && (!aligned16(apc) || !aligned16(cfc))) || tx < 32 ||
      tx > kThreads || (tx & (tx - 1)) || rows < 1 || rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const int ctiles = (W / kCols + tx - 1) / tx;
  const long long blocks = (long long)ctiles * ((R + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{(float*)match,         (const float*)slope,
               (const float*)eps,     (const float*)per_w,
               (const int32_t*)apr,   (const float*)cfr,
               (const int32_t*)apc,   (const float*)cfc,
               K, R, W, row0, col0, tx, rows, ctiles};
  const dim3 grid((unsigned)blocks, (unsigned)B, 1);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 0: launch<0>(a, grid, s); break;
    case 1: launch<1>(a, grid, s); break;
    case 2: launch<2>(a, grid, s); break;
    case 3: launch<3>(a, grid, s); break;
    case 4: launch<4>(a, grid, s); break;
    case 5: launch<5>(a, grid, s); break;
    case 6: launch<6>(a, grid, s); break;
    case 7: launch<7>(a, grid, s); break;
    case 8: launch<8>(a, grid, s); break;
    default: launch<-1>(a, grid, s); break;
  }
  return (int)cudaGetLastError();
}
