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

template <int CH>
size_t smem_bytes(int threads) {
  return ((size_t)(4 + RowCfg<CH>::kStages) * threads * CH +
          (size_t)2 * (threads / 32) * kSlot) * sizeof(float);
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
