/* Column-band Gotoh kernel: one block of rows of one DP problem whose
 * columns are split over several shards (cards, or streams of one card).
 *
 * Replaces kalign_tpu/parallel/mesh.py::sharded_long_gotoh (:288), a
 * shard_map program that hands a 4-float halo to the next device once
 * per DP row by lax.ppermute.  Here the handoff is per block of R rows:
 * shard d owns the columns [c0, c0 + Wd) and, at host step s, runs its
 * block s - d on its own stream (gpu/gotoh_mesh.py::forward).  A block
 * reads the left neighbour's strip [R + 1][5] — for the row above the
 * block and each row in it: A, GA and GB at the neighbour's last column,
 * the prefix max of u over every column up to it, and u there — and
 * writes its own strip for the shard on its right.  The band's last-row
 * state A, GA, GB stays on its card between launches in a [2][3][Wd]
 * buffer (one slot per row parity).
 *
 * The arithmetic is the row kernel's (csrc/gotoh_row.cu, gpu/gotoh_row.py
 * ::plain) cell by cell, on the same row-invariant vectors (the prefix
 * sums of gotoh_row.prepare, sliced to the band): the diagonal
 * candidates, A, GB and u = A + (go[j+1] - C[j+1]) left to right, the
 * prefix max of u seeded by the strip's carry, GA = shifted prefix max +
 * C, the decision bits.  A prefix max is exact in any association, so
 * with -fmad=false every band gives the bits the unsplit row kernel
 * gives.  The first band injects the analytic DP column 0 (A = 0 on row
 * 1, GA = NEG, GB the terminal column-0 gap run); the strip of a block's
 * row above carries row 0's state [NEG, GA0, NEG] for block 0, the
 * step-0 packet of mesh.py:456-464.
 *
 * Design (simple first): one block per band, a thread per column of a
 * tile of blockDim.x columns; a row walks the band's tiles left to right
 * with a warp-shuffle scan of u per tile and the warp maxima in shared
 * memory (one barrier a tile, two slot parities), the running carry
 * handed from tile to tile in registers; the previous row's state is
 * read from the global state buffer (L1/L2-resident), so every row ends
 * with a barrier.
 *
 * Bound: device-memory bytes — each cell's 4-byte match value read once
 * and its decision byte written once (the state buffer stays in L2).
 * What the design leaves on the table: a barrier per tile and per row
 * on a dependent chain of rows, and one block per band on a card of 132
 * SMs.  A cluster per band, or a persistent kernel with peer stores and
 * flags in place of one launch per block of rows, is later work.
 */
#include "kt_cuda.h"

namespace {

constexpr int kStrip = 5;          // floats per strip row
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct BandArgs {
  const float* match;     // [L1p][Wd] the band's match rows
  const float* colpen;    // [5][Wd] C_norm, C_term, gnC_norm, gnC_term, goB_s
  const float* rowpen;    // [L1p][5] goA, geA, tgeA, goA_prev, gb0_prev
  const float* cols_eps;  // [Wd]
  const float* row_term;  // [L1p]
  float* state;           // [2][3][Wd] A, GA, GB by row parity
  const float* strip_in;  // [R + 1][kStrip] (unused on the first band)
  float* strip_out;       // [R + 1][kStrip]
  int8_t* dec;            // [L1p][Wd]
  int Wd, r0, nr, la, lb, c0, first;
};

__device__ __forceinline__ float warp_incl_max(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = fmaxf(v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
gotoh_band_block_kernel(BandArgs a) {
  __shared__ float wmax[2][32];   // per tile parity: each warp's max u
  __shared__ float wlast[2][32];  // ... and its last u
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int T = blockDim.x, nw = T >> 5;
  const int Wd = a.Wd;
  const size_t W3 = (size_t)3 * Wd;

  // strip row 0: the state of the row above the block at the last column
  if (t == 0) {
    const float* prev = a.state + (size_t)(a.r0 & 1) * W3;
    a.strip_out[0] = prev[Wd - 1];
    a.strip_out[1] = prev[2 * Wd - 1];
    a.strip_out[2] = prev[3 * Wd - 1];
    a.strip_out[3] = KT_NEG;
    a.strip_out[4] = KT_NEG;
  }

  int it = 0;
  for (int s = 1; s <= a.nr; s++) {
    const int row = a.r0 + s;  // DP row; r indexes match, dec, rowpen
    const int r = row - 1;
    const bool last = row == a.la;
    const float* rp = a.rowpen + (size_t)r * 5;
    const float goA = rp[0], geA = rp[1], tgeA = rp[2], goA_prev = rp[3];
    const float gb0_prev = rp[4];
    const float rterm = a.row_term[r];
    const float* prev = a.state + (size_t)((row - 1) & 1) * W3;
    float* cur = a.state + (size_t)(row & 1) * W3;

    // the left edge: DP column 0 on the first band, else the strip
    float eA, eGA, eGB, carry, lu;
    if (a.first) {
      eA = row == 1 ? 0.0f : KT_NEG;
      eGA = KT_NEG;
      eGB = gb0_prev;
      carry = KT_NEG;
      lu = KT_NEG;
    } else {
      const float* e = a.strip_in + (size_t)(s - 1) * kStrip;
      eA = e[0];
      eGA = e[1];
      eGB = e[2];
      carry = e[kStrip + 3];
      lu = e[kStrip + 4];
    }
    const float* Cv = a.colpen + (size_t)(last ? 1 : 0) * Wd;
    const float* gnCv = a.colpen + (size_t)(last ? 3 : 2) * Wd;
    const float* goB_s = a.colpen + (size_t)4 * Wd;
    const float* mrow = a.match + (size_t)r * Wd;
    int8_t* drow = a.dec + (size_t)r * Wd;

    for (int base = 0; base < Wd; base += T) {
      const int j = base + t;
      const bool in = j < Wd;
      float A_row = KT_NEG, GB_row = KT_NEG, u = -INFINITY;
      int d = 0;
      if (in) {
        const int col = a.c0 + j + 1;
        const float dA = j ? prev[j - 1] : eA;
        const float dGAp = j ? prev[Wd + j - 1] : eGA;
        const float dGBp = j ? prev[2 * Wd + j - 1] : eGB;
        const float mm = mrow[j] - fabsf(a.cols_eps[j] - rterm);
        const float dGA = dGAp + goB_s[j];
        const float dGB = dGBp + goA_prev;
        const float best01 = fmaxf(dA, dGA);
        A_row = fmaxf(best01, dGB) + mm;
        const bool term = col == a.lb;
        const float ge_eff = term ? tgeA : geA;
        const float go_eff = term ? tgeA : goA;
        const float gb_e = prev[2 * Wd + j] + ge_eff;
        const float gb_o = prev[j] + go_eff;
        u = (col < a.lb) ? (A_row + gnCv[j]) : KT_NEG;
        d = (dGB >= best01) ? 2 : ((dGA >= dA) ? 1 : 0);
        d |= (gb_e > gb_o) ? KT_DEC_GB_EXT : 0;
        GB_row = fmaxf(gb_e, gb_o);
      }

      // prefix max of u over the tile: one barrier
      const float incl = warp_incl_max(u, lane);
      float excl = __shfl_up_sync(kFull, incl, 1);
      float us = __shfl_up_sync(kFull, u, 1);
      const int p = it & 1;
      if (lane == 31) {
        wmax[p][warp] = incl;
        wlast[p][warp] = u;
      }
      __syncthreads();
      float wv = lane < nw ? wmax[p][lane] : -INFINITY;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, wv, off);
        if (lane >= off) wv = fmaxf(wv, o);
      }
      const float cin = warp ? __shfl_sync(kFull, wv, warp - 1) : -INFINITY;
      const float tile = __shfl_sync(kFull, wv, nw - 1);
      if (lane == 0) {
        excl = -INFINITY;
        us = warp ? wlast[p][warp - 1] : lu;
      }
      const float cm_s = fmaxf(carry, fmaxf(cin, excl));
      if (in) {
        const float GA_row = cm_s + Cv[j];
        d |= (cm_s > us) ? KT_DEC_GA_EXT : 0;
        cur[j] = A_row;
        cur[Wd + j] = GA_row;
        cur[2 * Wd + j] = GB_row;
        drow[j] = (int8_t)d;
        if (j == Wd - 1) {
          float* so = a.strip_out + (size_t)s * kStrip;
          so[0] = A_row;
          so[1] = GA_row;
          so[2] = GB_row;
          so[3] = fmaxf(cm_s, u);
          so[4] = u;
        }
      }
      carry = fmaxf(carry, tile);
      lu = wlast[p][nw - 1];
      it++;
    }
    // the next row reads this row's state at the column to the left
    __syncthreads();
  }
}

}  // namespace

KT_EXPORT int kt_gotoh_band_block(const void* match, const void* colpen,
                                  const void* rowpen, const void* cols_eps,
                                  const void* row_term, void* state,
                                  const void* strip_in, void* strip_out,
                                  void* dec, int Wd, int r0, int nr, int la,
                                  int lb, int c0, int first, int threads,
                                  void* stream) {
  if (nr <= 0) return 0;
  if (Wd <= 0 || r0 < 0 || threads <= 0 || threads % 32 ||
      threads > kMaxThreads || (!first && strip_in == nullptr))
    return (int)cudaErrorInvalidValue;
  BandArgs a{(const float*)match,  (const float*)colpen,
             (const float*)rowpen, (const float*)cols_eps,
             (const float*)row_term, (float*)state,
             (const float*)strip_in, (float*)strip_out,
             (int8_t*)dec, Wd, r0, nr, la, lb, c0, first};
  gotoh_band_block_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
