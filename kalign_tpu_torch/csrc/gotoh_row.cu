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
 * The DP of a band of columns (band_rows, with the per-row body
 * row_step) is shared with gotoh_row_cluster_kernel below, which takes
 * rows wider than the largest block's registers hold (896 threads x 8
 * columns) up to 16 such bands; wider rows take the wave route
 * (csrc/gotoh_row_wave.cu, the same body in a wavefront of clusters).
 */
#include "gotoh_row_body.cuh"

namespace {

/* The DP of one problem's band of columns [band0, band0 + blockDim.x *
 * CH) over every row: the invariants and the match ring in shared memory
 * (smem: [4 + NS][cols] floats, then the warp slots), the rows through
 * row_step, and the end state from the thread holding column lb - 1 (or
 * DP column 1 where lb is out of range). */
template <int CH, class Edge>
__device__ __forceinline__ void band_rows(
    float* smem, int band0, int b, const float* __restrict__ match,
    const float* __restrict__ colpen, const float* __restrict__ ga0,
    const float* __restrict__ rowpen, const float* __restrict__ cols_eps,
    const float* __restrict__ row_term, const int32_t* __restrict__ la_arr,
    const int32_t* __restrict__ lb_arr, int B, int L1p, int L2p,
    int8_t* __restrict__ dec, float* __restrict__ score_out,
    int32_t* __restrict__ state_out, Edge& edge) {
  RowThread<CH> x;
  float* ring = band_thread(x, smem, band0);
  x.real = x.j0 < L2p;
  x.first = x.j0 == 0;
  float* inv = smem + x.t * CH;

  const int la = la_arr[b];
  const int lb = lb_arr[b];
  x.BW = (size_t)B * L2p;
  const size_t pb = (size_t)b * L2p + x.j0;
  x.colg = colpen + pb;
  const float* mrow0 = match + (size_t)b * L1p * L2p + x.j0;

  band_invariants(x, inv, cols_eps + pb, colpen + pb);
  if (x.real) {
    load_chunk(x.GA, ga0 + pb);
    if (x.j0 > 0) {
      x.Cleft = colpen[pb - 1];
      x.lGA = ga0[pb - 1];
    }
  }

  const int rows = la < L1p ? la : L1p;
  band_span<CH>(x, ring, mrow0, L2p, rowpen + (size_t)b * L1p * 5,
                row_term + (size_t)b * L1p, dec + (size_t)b * L1p * L2p, L2p,
                0, rows, la, lb, edge);

  const bool in_range = lb >= 1 && lb <= L2p;
  if (in_range ? (lb - 1 >= x.j0 && lb - 1 < x.j0 + CH) : x.first) {
    float ea = KT_NEG, ega = KT_NEG, egb = KT_NEG;
#pragma unroll
    for (int c = 0; c < CH; c++) {
      if (in_range && x.j0 + c == lb - 1) {
        ea = fmaxf(x.A[c], KT_NEG);
        ega = fmaxf(x.GA[c], KT_NEG);
        egb = fmaxf(x.GB[c], KT_NEG);
      }
    }
    score_out[b] = fmaxf(fmaxf(ea, ega), egb);
    state_out[b] = (ega > ea) ? ((egb > ega) ? 2 : 1) : ((egb > ea) ? 2 : 0);
  }
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
  extern __shared__ __align__(16) float smem[];
  NoHalo edge;
  band_rows<CH>(smem, 0, blockIdx.x, match, colpen, ga0, rowpen, cols_eps,
                row_term, la_arr, lb_arr, B, L1p, L2p, dec, score_out,
                state_out, edge);
}

/* The cluster instantiation, for rows wider than one block's registers
 * hold (gpu/gotoh_row.py::cluster_config: 7,296 to 16 x 7,168 columns).
 * Replaces the same TPU kernel and, for these widths, the XLA scan
 * kalign_tpu falls back to (kalign_tpu/tpu/gotoh.py::gotoh_forward);
 * the design is the column wavefront of
 * kalign_tpu/parallel/mesh.py::sharded_long_gotoh, with the blocks of a
 * thread-block cluster in place of devices.
 *
 * One cluster of S blocks per problem (grid B * S, cluster S): block k
 * owns the band of columns [k * Wb, (k + 1) * Wb), Wb = blockDim.x * CH,
 * and runs gotoh_row_kernel's design on it (band_rows / row_step).  The
 * gap prefix sums C are global vectors, so the only thing a band needs
 * from the left is a halo per row: after its row r, block k - 1 writes
 * A, GA and GB at its last column, the prefix max of u over every column
 * up to its right edge and its last u (5 floats) into a ring of kSlots
 * message slots in block k's shared memory with st.async, whose bytes
 * complete that slot's full barrier there (mbarrier transaction count).
 * Block k waits on it (acquire at cluster scope) only after its own A /
 * GB / u pass and the block's prefix max, so the wait overlaps that
 * pass: block k runs row r about when block k - 1 runs row r + 1, and
 * the hand-off costs one distributed-shared-memory trip per band on the
 * pipeline's fill, not per row.  A slot is written again only after
 * block k has returned it: once the next row's block barrier shows every
 * thread has read it, block k's thread 0 re-arms the slot's full barrier
 * and st.async-writes a credit word that completes the slot's empty
 * barrier in block k - 1.  No hand-off uses a release fence: a thread
 * that stores decisions would wait there for its outstanding global
 * stores, every row (with mbarrier.arrive.release.cluster in place of
 * st.async the rows took ~1.25 us at any cluster size on the H100,
 * against ~0.9 without).
 * Band 0 keeps the analytic column 0; a band wholly past lb still passes
 * the carry on (its u are all NEG); the end state comes from the block
 * owning column lb - 1.  The hardware schedules a cluster's blocks
 * together and no block waits on another cluster, so the hand-off cannot
 * deadlock; the launch wrapper refuses a plan that
 * cudaOccupancyMaxActiveClusters says cannot be scheduled.
 *
 * Bound: device-memory bytes, as gotoh_row_kernel (~5 B a cell); the
 * halo is 24 bytes of distributed shared memory per band and row (the
 * halo and the credit). */

template <int CH>
__global__ void __launch_bounds__(RowCfg<CH>::kMaxThreads)
gotoh_row_cluster_kernel(const float* __restrict__ match,     // [B, L1p, L2p]
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
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned S = cluster.num_blocks();
  const int b = blockIdx.x / S;
  ClusterHalo edge = cluster_halo(smem, cluster.block_rank(), S,
                                  la_arr[b] < L1p ? la_arr[b] : L1p);
  // every block's barriers exist before any block arrives on them
  cluster.sync();
  band_rows<CH>(smem + kClusterHeader / 4, (int)edge.rank * (int)blockDim.x *
                CH, b, match, colpen, ga0, rowpen,
                cols_eps, row_term, la_arr, lb_arr, B, L1p, L2p, dec,
                score_out, state_out, edge);
  // no block leaves while its neighbour may still arrive on its barriers
  cluster.sync();
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

template <int CH>
int cluster_max_active(int threads, int blocks, int* out) {
  if (!cluster_plan_ok<CH>(threads, blocks)) {
    *out = 0;
    return (int)cudaErrorInvalidValue;
  }
  return cluster_occupancy(gotoh_row_cluster_kernel<CH>, threads, blocks,
                           cluster_smem_bytes<CH>(threads), out);
}

template <int CH>
int launch_cluster(const float* match, const float* colpen, const float* ga0,
                   const float* rowpen, const float* cols_eps,
                   const float* row_term, const int32_t* la,
                   const int32_t* lb, int B, int L1p, int L2p, int8_t* dec,
                   float* score, int32_t* state, int threads, int blocks,
                   cudaStream_t stream) {
  if (!cluster_plan_ok<CH>(threads, blocks) ||
      (long long)threads * CH * blocks < L2p || L2p % CH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes<CH>(threads);
  cudaError_t err =
      cluster_attributes(gotoh_row_cluster_kernel<CH>, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch_config(
      threads, blocks, (unsigned)B * blocks, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gotoh_row_cluster_kernel<CH>, match, colpen,
                           ga0, rowpen, cols_eps, row_term, la, lb, B, L1p,
                           L2p, dec, score, state);
  if (err != cudaSuccess) return (int)err;
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

/* Shared memory of a cluster launch's block (0 for an unsupported ch);
 * gpu/gotoh_row.py::cluster_config mirrors it. */
KT_EXPORT size_t kt_gotoh_row_cluster_smem_bytes(int threads, int ch) {
  switch (ch) {
    case 4: return cluster_smem_bytes<4>(threads);
    case 8: return cluster_smem_bytes<8>(threads);
    default: return 0;
  }
}

/* cudaOccupancyMaxActiveClusters of a cluster plan into *out (0: the
 * card cannot schedule one such cluster). */
KT_EXPORT int kt_gotoh_row_cluster_max_active(int threads, int ch,
                                              int blocks, int* out) {
  switch (ch) {
    case 4: return cluster_max_active<4>(threads, blocks, out);
    case 8: return cluster_max_active<8>(threads, blocks, out);
    default: *out = 0; return (int)cudaErrorInvalidValue;
  }
}

/* The cluster row kernel: B clusters of `blocks` blocks of `threads`
 * threads, ch columns each. */
KT_EXPORT int kt_gotoh_row_cluster_forward(
    const float* match, const float* colpen, const float* ga0,
    const float* rowpen, const float* cols_eps, const float* row_term,
    const int32_t* la, const int32_t* lb, int B, int L1p, int L2p,
    int8_t* dec, float* score, int32_t* state, int threads, int ch,
    int blocks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4: return launch_cluster<4>(match, colpen, ga0, rowpen, cols_eps,
                                     row_term, la, lb, B, L1p, L2p, dec,
                                     score, state, threads, blocks, s);
    case 8: return launch_cluster<8>(match, colpen, ga0, rowpen, cols_eps,
                                     row_term, la, lb, B, L1p, L2p, dec,
                                     score, state, threads, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
