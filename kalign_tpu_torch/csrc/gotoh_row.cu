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
 * Design: one block per problem; thread t owns the CH contiguous columns
 * [t*CH, (t+1)*CH) of the row (CH = 4, or 8 past 2,048 columns, chosen
 * with the block size by gpu/gotoh_row.py::launch_config; columns past
 * L2p are computed and never stored).  The DP row is a dependent chain,
 * so what bounds this kernel is the latency of one row; the design keeps
 * everything off that chain except the row's own arithmetic:
 *   - the previous row's A, GA, GB and the row's u stay in registers;
 *   - the match rows arrive ahead of use: each thread copies its own
 *     chunk of row r + kStages - 1 into a shared-memory ring with
 *     cp.async (16-byte copies, coalesced across the warp) while it
 *     computes row r, and waits only on its own copies, so the ring
 *     needs no barrier;
 *   - the row-invariant vectors (cols_eps, goB_s, gnC_norm, C_norm) are
 *     read once into shared memory, each thread's chunk at its own
 *     offset; the last row's C_term / gnC_term come from global memory;
 *   - the per-row scalars (rowpen, row_term) are loaded one row ahead;
 *   - decisions are packed into one CH-byte store per thread, so a warp
 *     writes contiguous bytes;
 *   - one block barrier per row: the prefix max of u is a warp-shuffle
 *     scan of the thread maxima; each warp's last lane then publishes
 *     the warp maximum and what its right neighbour needs at its left
 *     edge (the last u, A and GB, and the prefix max before its last
 *     column, from which the neighbour rebuilds GA there) into a slot
 *     that alternates between two buffers by row parity, so the next
 *     row's writes cannot race this row's reads; after the barrier each
 *     warp scans the warp maxima with log2(warps) shuffles.  (A
 *     barrier-free variant, the warps as a pipeline handing the carry on
 *     through polled shared-memory words, ran slower on the H100: the
 *     polling warps cost more than the barrier they save.)
 * A prefix max is exact in any association, and every other operation
 * is the old per-cell order (-fmad=false), so given the row-invariant
 * vectors of gpu/gotoh_row.py::prepare the kernel is bitwise equal to
 * its plain PyTorch version.
 *
 * Bound: device-memory bytes.  Each cell reads its 4-byte match value
 * once and writes one decision byte (~5 B/cell).  Rows past a problem's
 * length are skipped (their decisions are never read).
 *
 * Rows wider than the largest block's registers hold (896 threads x 8
 * columns) take gotoh_row_tiled_kernel below.
 */
#include "kt_cuda.h"

namespace {

constexpr int kSlot = 5;  // per warp: max u, max u but the last, last u,
                          // A, GB

template <int CH> struct RowCfg;
template <> struct RowCfg<4> {
  static constexpr int kMaxThreads = 512, kStages = 8;
};
template <> struct RowCfg<8> {
  static constexpr int kMaxThreads = 896, kStages = 4;
};

template <int CH>
__device__ __forceinline__ void load_chunk(float (&v)[CH], const float* p) {
#pragma unroll
  for (int q = 0; q < CH / 4; q++) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

template <int CH>
__device__ __forceinline__ void store_chunk(float* p, const float (&v)[CH]) {
#pragma unroll
  for (int c = 0; c < CH; c++) p[c] = v[c];
}

template <int CH>
__device__ __forceinline__ void store_dec(int8_t* p, const int (&d)[CH]) {
  uint32_t w[CH / 4] = {};
#pragma unroll
  for (int c = 0; c < CH; c++)
    w[c / 4] |= (uint32_t)(d[c] & 0xff) << (8 * (c % 4));
  if constexpr (CH == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

/* cp.async of one thread's CH floats (16-byte aligned), 16 bytes at a
 * time. */
template <int CH>
__device__ __forceinline__ void copy_chunk_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
#pragma unroll
  for (int q = 0; q < CH / 4; q++)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d + 16 * q), "l"(src + 4 * q) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_incl_max(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = fmaxf(v, o);
  }
  return v;
}

struct RowScalars {
  float goA, geA, tgeA, goA_prev, gb0_prev, rterm;
};

__device__ __forceinline__ RowScalars row_scalars(const float* rp,
                                                  const float* rt) {
  return RowScalars{rp[0], rp[1], rp[2], rp[3], rp[4], *rt};
}

template <int CH>
__global__ void __launch_bounds__(RowCfg<CH>::kMaxThreads)
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
  constexpr int NS = RowCfg<CH>::kStages;
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int cols = T * CH;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int j0 = t * CH;
  const bool real = j0 < L2p;  // L2p % CH == 0: a chunk is all in or out

  // shared memory: invariants [4][cols] (ceps, goB_s, gnC_norm, C_norm),
  // the match ring [NS][cols], the warp slots [2][nw][kSlot]
  float* inv = smem + j0;
  float* ring = smem + 4 * cols + j0;
  float* slots = smem + (4 + NS) * cols;

  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const size_t BW = (size_t)B * L2p;
  const size_t pb = (size_t)b * L2p + j0;
  const float* mrow0 = match + (size_t)b * L1p * L2p + j0;

  float A[CH], GA[CH], GB[CH], U[CH];
  float Cleft = 0.0f;
  float lA = KT_NEG, lGA = KT_NEG, lGB = KT_NEG;  // column j0 - 1
  {
    float v[CH];
#pragma unroll
    for (int c = 0; c < CH; c++) v[c] = 0.0f;
    const float* src[4] = {cols_eps + pb, colpen + 4 * BW + pb,
                           colpen + 2 * BW + pb, colpen + 0 * BW + pb};
#pragma unroll
    for (int q = 0; q < 4; q++) {
      if (real) load_chunk(v, src[q]);
      store_chunk(inv + q * cols, v);
    }
  }
#pragma unroll
  for (int c = 0; c < CH; c++) {
    A[c] = KT_NEG;
    GB[c] = KT_NEG;
    GA[c] = KT_NEG;
    U[c] = KT_NEG;
  }
  if (real) {
    load_chunk(GA, ga0 + pb);
    if (t > 0) {
      Cleft = colpen[pb - 1];
      lGA = ga0[pb - 1];
    }
  }

  const int rows = la < L1p ? la : L1p;
#pragma unroll
  for (int s = 0; s < NS - 1; s++) {
    if (real && s < rows)
      copy_chunk_async<CH>(ring + s * cols, mrow0 + (size_t)s * L2p);
    cp_async_commit();
  }
  const float* rp0 = rowpen + (size_t)b * L1p * 5;
  const float* rt0 = row_term + (size_t)b * L1p;
  RowScalars nx{};
  if (rows > 0) nx = row_scalars(rp0, rt0);

  for (int r = 0; r < rows; r++) {
    const int row = r + 1;
    const bool last = row == la;
    const RowScalars sc = nx;
    if (r + 1 < rows) nx = row_scalars(rp0 + (size_t)(r + 1) * 5, rt0 + r + 1);
    {
      const int s = r + NS - 1;
      if (real && s < rows)
        copy_chunk_async<CH>(ring + (s % NS) * cols, mrow0 + (size_t)s * L2p);
      cp_async_commit();
    }
    cp_async_wait<NS - 1>();
    float m[CH], gnC[CH];
    load_chunk(m, ring + (r % NS) * cols);
    if (last && real) {
      load_chunk(gnC, colpen + 3 * BW + pb);
    } else {
      load_chunk(gnC, inv + 2 * cols);
    }
    if (!real) {
#pragma unroll
      for (int c = 0; c < CH; c++) m[c] = 0.0f;
    }
    if (t == 0) {
      lA = (row == 1) ? 0.0f : KT_NEG;
      lGA = KT_NEG;
      lGB = sc.gb0_prev;
    }

    // A, GB, u and the decision's A / GB bits, left to right; dA, dGA,
    // dGB hold the previous row's values at the column to the left
    int d[CH];
    float dA = lA, dGAv = lGA, dGBv = lGB;
    float run = -INFINITY, run_but_last = -INFINITY;
#pragma unroll
    for (int c = 0; c < CH; c++) {
      const int col = j0 + c + 1;
      const float mm = m[c] - fabsf(inv[c] - sc.rterm);
      const float diagA = dA;
      const float dGA = dGAv + inv[cols + c];
      const float dGB = dGBv + sc.goA_prev;
      const float best01 = fmaxf(diagA, dGA);
      const float A_row = fmaxf(best01, dGB) + mm;
      const bool term = col == lb;
      const float ge_eff = term ? sc.tgeA : sc.geA;
      const float go_eff = term ? sc.tgeA : sc.goA;
      const float gb_e = GB[c] + ge_eff;
      const float gb_o = A[c] + go_eff;
      const float u = (col < lb) ? (A_row + gnC[c]) : KT_NEG;
      d[c] = (dGB >= best01) ? 2 : ((dGA >= diagA) ? 1 : 0);
      d[c] |= (gb_e > gb_o) ? KT_DEC_GB_EXT : 0;
      dA = A[c];
      dGAv = GA[c];
      dGBv = GB[c];
      A[c] = A_row;
      GB[c] = fmaxf(gb_e, gb_o);
      U[c] = u;
      if (c == CH - 1) run_but_last = run;
      run = fmaxf(run, u);
    }

    // prefix max of u across the block: one barrier
    const float incl = warp_incl_max(run, lane);
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = -INFINITY;
    float lu = __shfl_up_sync(0xffffffffu, U[CH - 1], 1);
    float cin = -INFINITY;   // max u of the warps left of this one
    float wex2 = -INFINITY;  // ... of all but the nearest
    float* slot = slots + (r & 1) * nw * kSlot;
    const float* left = slot + (warp - 1) * kSlot;
    if (lane == 31) {
      float* sw = slot + warp * kSlot;
      sw[0] = incl;
      sw[1] = fmaxf(excl, run_but_last);
      sw[2] = U[CH - 1];
      sw[3] = A[CH - 1];
      sw[4] = GB[CH - 1];
    }
    __syncthreads();
    if (nw > 1) {
      float wv = lane < nw ? slot[lane * kSlot] : -INFINITY;
      for (int off = 1; off < nw; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, wv, off);
        if (lane >= off) wv = fmaxf(wv, o);
      }
      if (warp > 0) cin = __shfl_sync(0xffffffffu, wv, warp - 1);
      if (warp > 1) wex2 = __shfl_sync(0xffffffffu, wv, warp - 2);
    }
    if (lane == 0 && warp > 0) lu = left[2];
    float cm = fmaxf(cin, excl);
    if (t == 0) {
      cm = KT_NEG;
      lu = KT_NEG;
    }

    // GA = shifted prefix max + C, and the decision's GA bit
    float C[CH];
    if (last && real) {
      load_chunk(C, colpen + 1 * BW + pb);
    } else {
      load_chunk(C, inv + 3 * cols);
    }
#pragma unroll
    for (int c = 0; c < CH; c++) {
      const float cm_s = cm;
      const float u_s = c ? U[c - 1] : lu;
      GA[c] = cm_s + C[c];
      d[c] |= (cm_s > u_s) ? KT_DEC_GA_EXT : 0;
      cm = fmaxf(cm, U[c]);
    }
    if (real) store_dec<CH>(dec + ((size_t)b * L1p + r) * L2p + j0, d);

    // the next row's values at column j0 - 1
    lA = __shfl_up_sync(0xffffffffu, A[CH - 1], 1);
    lGA = __shfl_up_sync(0xffffffffu, GA[CH - 1], 1);
    lGB = __shfl_up_sync(0xffffffffu, GB[CH - 1], 1);
    if (lane == 0 && warp > 0) {
      lA = left[3];
      lGB = left[4];
      lGA = fmaxf(wex2, left[1]) + Cleft;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  const bool in_range = lb >= 1 && lb <= L2p;
  if (in_range ? (lb - 1 >= j0 && lb - 1 < j0 + CH) : t == 0) {
    float ea = KT_NEG, ega = KT_NEG, egb = KT_NEG;
#pragma unroll
    for (int c = 0; c < CH; c++) {
      if (in_range && j0 + c == lb - 1) {
        ea = fmaxf(A[c], KT_NEG);
        ega = fmaxf(GA[c], KT_NEG);
        egb = fmaxf(GB[c], KT_NEG);
      }
    }
    score_out[b] = fmaxf(fmaxf(ea, ega), egb);
    state_out[b] = (ega > ea) ? ((egb > ega) ? 2 : 1) : ((egb > ea) ? 2 : 0);
  }
}

/* The tiled instantiation, for rows wider than one block's registers hold
 * (gpu/gotoh_row.py::launch_config takes it past 7,168 columns; it has no
 * width limit of its own).  Replaces the same TPU kernel and, for these
 * widths, the XLA scan kalign_tpu falls back to
 * (kalign_tpu/tpu/gotoh.py::gotoh_forward).
 *
 * One block per problem walks each DP row in column tiles of
 * blockDim.x * kTiledCH columns, left to right.  The previous row's A,
 * GA and GB of the whole row live in a global-memory scratch
 * [B, 2, 3, L2p] that alternates by row parity (a problem's 24 bytes per
 * column stay in L2), so a thread reads the left neighbour's previous-row
 * values at column j0 - 1 from there, whatever tile it lies in.  The scan
 * transform's prefix max of u carries from tile to tile in registers:
 * every thread folds each tile's maximum into `carry`, and the tile's last
 * u is the next tile's left edge.  Match rows and the row-invariant
 * vectors are read straight from global memory per tile.  Per cell the
 * arithmetic is gotoh_row_kernel's, in the same order, so the kernel is
 * bitwise equal to the plain version too.
 *
 * Bound: the same bytes per cell as gotoh_row_kernel; the scratch traffic
 * (24 bytes per column and row) is L2 traffic.  Simple first: one block
 * per problem leaves most SMs idle at few wide problems (a column
 * wavefront of several blocks per problem is the redesign). */
constexpr int kTiledCH = 8;
constexpr int kTiledMaxThreads = 512;
constexpr int kTSlot = 2;  // per warp: max u, last u

__global__ void __launch_bounds__(kTiledMaxThreads)
gotoh_row_tiled_kernel(const float* __restrict__ match,     // [B, L1p, L2p]
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
                       int32_t* __restrict__ state_out,
                       float* scratch) {                    // [B, 2, 3, L2p]
  constexpr int CH = kTiledCH;
  extern __shared__ __align__(16) float tslots[];  // [2][nw][kTSlot]
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int TW = T * CH;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const size_t BW = (size_t)B * L2p;
  const size_t rb = (size_t)b * L2p;
  float* st = scratch + (size_t)b * 6 * L2p;
  const int ntiles = (L2p + TW - 1) / TW;

  // the state before row 1: A = GB = NEG, GA = ga0
  for (int j = t; j < L2p; j += T) {
    st[j] = KT_NEG;
    st[L2p + j] = ga0[rb + j];
    st[2 * L2p + j] = KT_NEG;
  }
  __syncthreads();

  const int rows = la < L1p ? la : L1p;
  int step = 0;  // tiles done: the slots alternate by its parity
  for (int r = 0; r < rows; r++) {
    const int row = r + 1;
    const bool last = row == la;
    const RowScalars sc = row_scalars(rowpen + ((size_t)b * L1p + r) * 5,
                                      row_term + (size_t)b * L1p + r);
    const float* prv = st + (r & 1) * 3 * L2p;
    float* nxt = st + ((r + 1) & 1) * 3 * L2p;
    const float* mrow = match + ((size_t)b * L1p + r) * L2p;
    float carry = -INFINITY;  // max u of the tiles left of this one
    float carry_u = KT_NEG;   // u at the column left of this tile
    for (int k = 0; k < ntiles; k++, step++) {
      const int j0 = k * TW + t * CH;
      const bool real = j0 < L2p;  // L2p % CH == 0
      float A[CH], GA[CH], GB[CH], U[CH], m[CH], ceps[CH], goBs[CH], gnC[CH],
          C[CH];
#pragma unroll
      for (int c = 0; c < CH; c++) {
        A[c] = GA[c] = GB[c] = U[c] = KT_NEG;
        m[c] = ceps[c] = goBs[c] = gnC[c] = C[c] = 0.0f;
      }
      float lA = KT_NEG, lGA = KT_NEG, lGB = KT_NEG;  // column j0 - 1
      if (real) {
        load_chunk(A, prv + j0);
        load_chunk(GA, prv + L2p + j0);
        load_chunk(GB, prv + 2 * L2p + j0);
        load_chunk(m, mrow + j0);
        load_chunk(ceps, cols_eps + rb + j0);
        load_chunk(goBs, colpen + 4 * BW + rb + j0);
        load_chunk(gnC, colpen + (last ? 3 : 2) * BW + rb + j0);
        load_chunk(C, colpen + (last ? 1 : 0) * BW + rb + j0);
        if (j0 == 0) {
          lA = (row == 1) ? 0.0f : KT_NEG;
          lGB = sc.gb0_prev;
        } else {
          lA = prv[j0 - 1];
          lGA = prv[L2p + j0 - 1];
          lGB = prv[2 * L2p + j0 - 1];
        }
      }

      int d[CH];
      float dA = lA, dGAv = lGA, dGBv = lGB;
      float run = -INFINITY;
#pragma unroll
      for (int c = 0; c < CH; c++) {
        const int col = j0 + c + 1;
        const float mm = m[c] - fabsf(ceps[c] - sc.rterm);
        const float diagA = dA;
        const float dGA = dGAv + goBs[c];
        const float dGB = dGBv + sc.goA_prev;
        const float best01 = fmaxf(diagA, dGA);
        const float A_row = fmaxf(best01, dGB) + mm;
        const bool term = col == lb;
        const float ge_eff = term ? sc.tgeA : sc.geA;
        const float go_eff = term ? sc.tgeA : sc.goA;
        const float gb_e = GB[c] + ge_eff;
        const float gb_o = A[c] + go_eff;
        const float u = (col < lb) ? (A_row + gnC[c]) : KT_NEG;
        d[c] = (dGB >= best01) ? 2 : ((dGA >= diagA) ? 1 : 0);
        d[c] |= (gb_e > gb_o) ? KT_DEC_GB_EXT : 0;
        dA = A[c];
        dGAv = GA[c];
        dGBv = GB[c];
        A[c] = A_row;
        GB[c] = fmaxf(gb_e, gb_o);
        U[c] = u;
        run = fmaxf(run, u);
      }

      // prefix max of u across the tile: one barrier
      const float incl = warp_incl_max(run, lane);
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = -INFINITY;
      float lu = __shfl_up_sync(0xffffffffu, U[CH - 1], 1);
      float* slot = tslots + (step & 1) * nw * kTSlot;
      if (lane == 31) {
        slot[warp * kTSlot] = incl;
        slot[warp * kTSlot + 1] = U[CH - 1];
      }
      __syncthreads();
      float wv = lane < nw ? slot[lane * kTSlot] : -INFINITY;
      for (int off = 1; off < nw; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, wv, off);
        if (lane >= off) wv = fmaxf(wv, o);
      }
      const float cin = __shfl_sync(0xffffffffu, wv, warp > 0 ? warp - 1 : 0);
      const float tile_max = __shfl_sync(0xffffffffu, wv, nw - 1);
      const float tile_last_u = slot[(nw - 1) * kTSlot + 1];
      if (lane == 0 && warp > 0) lu = slot[(warp - 1) * kTSlot + 1];
      float cm = fmaxf(fmaxf(warp > 0 ? cin : -INFINITY, excl), carry);
      if (t == 0) {
        cm = k ? carry : KT_NEG;
        lu = carry_u;
      }

      // GA = shifted prefix max + C, the decision's GA bit, the new state
#pragma unroll
      for (int c = 0; c < CH; c++) {
        const float cm_s = cm;
        const float u_s = c ? U[c - 1] : lu;
        GA[c] = cm_s + C[c];
        d[c] |= (cm_s > u_s) ? KT_DEC_GA_EXT : 0;
        cm = fmaxf(cm, U[c]);
      }
      if (real) {
        store_dec<CH>(dec + ((size_t)b * L1p + r) * L2p + j0, d);
        store_chunk(nxt + j0, A);
        store_chunk(nxt + L2p + j0, GA);
        store_chunk(nxt + 2 * L2p + j0, GB);
      }
      carry = fmaxf(carry, tile_max);
      carry_u = tile_last_u;
    }
    // the next row reads this row's state at column j0 - 1, written by
    // another thread (with one tile per row no other barrier lies between)
    __syncthreads();
  }

  if (t == 0) {
    const float* fin = st + (rows & 1) * 3 * L2p;
    float ea = KT_NEG, ega = KT_NEG, egb = KT_NEG;
    if (lb >= 1 && lb <= L2p) {
      ea = fmaxf(fin[lb - 1], KT_NEG);
      ega = fmaxf(fin[L2p + lb - 1], KT_NEG);
      egb = fmaxf(fin[2 * L2p + lb - 1], KT_NEG);
    }
    score_out[b] = fmaxf(fmaxf(ea, ega), egb);
    state_out[b] = (ega > ea) ? ((egb > ega) ? 2 : 1) : ((egb > ea) ? 2 : 0);
  }
}

template <int CH>
size_t smem_bytes(int threads) {
  return ((size_t)(4 + RowCfg<CH>::kStages) * threads * CH +
          (size_t)2 * (threads / 32) * kSlot) * sizeof(float);
}

size_t tiled_smem_bytes(int threads) {
  return (size_t)2 * (threads / 32) * kTSlot * sizeof(float);
}

template <int CH>
int launch(const float* match, const float* colpen, const float* ga0,
           const float* rowpen, const float* cols_eps, const float* row_term,
           const int32_t* la, const int32_t* lb, int B, int L1p, int L2p,
           int8_t* dec, float* score, int32_t* state, int threads,
           cudaStream_t stream) {
  if (threads % 32 || threads > RowCfg<CH>::kMaxThreads ||
      (long long)threads * CH < L2p || L2p % CH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CH>(threads);
  cudaError_t err = cudaFuncSetAttribute(
      gotoh_row_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gotoh_row_kernel<CH><<<B, threads, smem, stream>>>(
      match, colpen, ga0, rowpen, cols_eps, row_term, la, lb, B, L1p, L2p,
      dec, score, state);
  return (int)cudaGetLastError();
}

int launch_tiled(const float* match, const float* colpen, const float* ga0,
                 const float* rowpen, const float* cols_eps,
                 const float* row_term, const int32_t* la, const int32_t* lb,
                 int B, int L1p, int L2p, int8_t* dec, float* score,
                 int32_t* state, float* scratch, int threads,
                 cudaStream_t stream) {
  if (threads <= 0 || threads % 32 || threads > kTiledMaxThreads ||
      L2p % kTiledCH)
    return (int)cudaErrorInvalidValue;
  gotoh_row_tiled_kernel<<<B, threads, tiled_smem_bytes(threads), stream>>>(
      match, colpen, ga0, rowpen, cols_eps, row_term, la, lb, B, L1p, L2p,
      dec, score, state, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

/* Shared memory of a launch with `threads` threads of `ch` columns each
 * (0 for an unsupported ch); gpu/gotoh_row.py::launch_config mirrors it. */
KT_EXPORT size_t kt_gotoh_row_smem_bytes(int threads, int ch) {
  switch (ch) {
    case 4: return smem_bytes<4>(threads);
    case 8: return smem_bytes<8>(threads);
    default: return 0;
  }
}

KT_EXPORT int kt_gotoh_row_forward(const float* match, const float* colpen,
                                   const float* ga0, const float* rowpen,
                                   const float* cols_eps,
                                   const float* row_term, const int32_t* la,
                                   const int32_t* lb, int B, int L1p, int L2p,
                                   int8_t* dec, float* score, int32_t* state,
                                   int threads, int ch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4: return launch<4>(match, colpen, ga0, rowpen, cols_eps, row_term,
                             la, lb, B, L1p, L2p, dec, score, state, threads,
                             s);
    case 8: return launch<8>(match, colpen, ga0, rowpen, cols_eps, row_term,
                             la, lb, B, L1p, L2p, dec, score, state, threads,
                             s);
    default: return (int)cudaErrorInvalidValue;
  }
}

/* Shared memory of a tiled launch; gpu/gotoh_row.py::tiled_config mirrors
 * it. */
KT_EXPORT size_t kt_gotoh_row_tiled_smem_bytes(int threads) {
  return tiled_smem_bytes(threads);
}

/* The tiled row kernel; scratch is [B, 2, 3, L2p] float32 (no contents
 * needed). */
KT_EXPORT int kt_gotoh_row_tiled_forward(
    const float* match, const float* colpen, const float* ga0,
    const float* rowpen, const float* cols_eps, const float* row_term,
    const int32_t* la, const int32_t* lb, int B, int L1p, int L2p,
    int8_t* dec, float* score, int32_t* state, float* scratch, int threads,
    void* stream) {
  return launch_tiled(match, colpen, ga0, rowpen, cols_eps, row_term, la, lb,
                      B, L1p, L2p, dec, score, state, scratch, threads,
                      (cudaStream_t)stream);
}
