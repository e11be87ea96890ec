/* Column-band Gotoh kernels: one block of rows of one DP problem whose
 * columns are split over several shards (cards, or streams of one card).
 *
 * Replace kalign_tpu/parallel/mesh.py::sharded_long_gotoh (:288), a
 * shard_map program that hands a 4-float halo to the next device once
 * per DP row by lax.ppermute.  Here the handoff is per block of R rows:
 * shard d owns the columns [c0, c0 + Wd) and, at host step s, runs its
 * block s - d on its own stream (gpu/gotoh_mesh.py::schedule).  A block
 * reads the left neighbour's strip [R + 1][5] — for the row above the
 * block and each row in it: A, GA and GB at the neighbour's last column,
 * the prefix max of u over every column up to it, and u there — and
 * writes its own strip for the shard on its right.  A launch reads the
 * match of its own rows only (a block of a ring the host fills block by
 * block: parallel/mesh.py::band_source), so no band's whole match need
 * exist.  The band's last-row state A, GA, GB stays on its card between
 * launches in a [2][3][Wd] buffer: a launch reads slot r0 & 1 and leaves
 * its last row in slot (r0 + nr) & 1.
 *
 * The arithmetic is the row kernel's (csrc/gotoh_row.cu, gpu/gotoh_row.py
 * ::plain) cell by cell, on the same row-invariant vectors (the prefix
 * sums of gotoh_row.prepare, sliced to the band).  A prefix max is exact
 * in any association, so with -fmad=false every band gives the bits the
 * unsplit row kernel gives.  The first band keeps the analytic DP column
 * 0; the strip of a block's row above carries row 0's state [NEG, GA0,
 * NEG] for block 0, the step-0 packet of mesh.py:456-464.
 *
 * Design: the row kernel's body (gotoh_row_body.cuh: the state of a
 * thread's CH columns in registers, the match through a cp.async ring,
 * the invariants in shared memory, one barrier per row) with a third
 * edge, StripHalo: thread 0 takes its diagonal left neighbour and the
 * prefix-max carry from the left band's strip (copied rows ahead into a
 * shared-memory ring), and the thread holding the band's last column
 * writes this band's strip row.  A launch loads the band's state from
 * the state buffer into registers once and stores it back once: it reads
 * slot `slot` and leaves its last row in the other, the host flipping the
 * band's slot at every launch.  Routes, by the band's width alone
 * (gpu/gotoh_mesh.py::band_config):
 *   - gotoh_band_cluster_kernel, up to 16 x 7,168 = 114,688 columns: one
 *     thread-block cluster of S <= 16 blocks per band (S = 1 up to 256
 *     columns), the blocks covering the band exactly, each a band of
 *     its own handing a halo to block k + 1 every row through
 *     distributed shared memory (the cluster row kernel's ClusterHalo),
 *     block 0 reading the left band's strip, block S - 1 writing this
 *     one's.  Narrow blocks make a short row: one block of 2,560 columns
 *     took 1.7 us a row on an H100, ten of 256 0.77 (PERF.md);
 *   - gotoh_band_wave_kernel, past 114,688 columns: the row kernel's wave
 *     (csrc/gotoh_row_wave.cu) over the band: `clusters` clusters of 8
 *     blocks, one block an SM, the blocks inside a cluster handing the
 *     halo on through distributed shared memory, cluster c + 1 reading
 *     cluster c's through a strip in L2 and its release/acquire row
 *     counter (BandHalo).  The band's first block takes the left band's
 *     strip (StripHalo; that launch is done before this one starts, the
 *     host's events order them, so it needs no poll), its last block
 *     writes this band's.  The wave strips are the band's own, their
 *     counters never reset: they count rows from the problem's row 0, so
 *     no later launch of the band reads an earlier one's as published.
 *     Every cluster of every band launch that can run at once on a card
 *     must be resident: the host plans for that
 *     (gpu/gotoh_mesh.py::card_streams), and a wait past 20 s traps.
 *
 * Bound: device-memory bytes — each cell's 4-byte match value read once
 * and its decision byte written once.  What bounds both routes is the
 * latency of a row on the dependent chain (one barrier, the block's
 * prefix max, the halo), as for the row kernel, plus a launch's start
 * (the state, the invariants, the ring's first rows) every R rows and,
 * on the wave route, the wavefront's fill: cluster c runs about
 * (kStages - 1 + every) rows behind cluster c - 1 in each launch.
 */
#include "gotoh_row_body.cuh"

namespace {

struct BandArgs {
  const float* match;     // [nr][Wd] the launch's match rows, r0 first
  const float* colpen;    // [5][Wd] C_norm, C_term, gnC_norm, gnC_term, goB_s
  const float* rowpen;    // [L1p][5] goA, geA, tgeA, goA_prev, gb0_prev
  const float* cols_eps;  // [Wd]
  const float* row_term;  // [L1p]
  float* state;           // [2][3][Wd] A, GA, GB (see above)
  const float* strip_in;  // [R + 1][kStrip] (unused on the first band)
  float* strip_out;       // [R + 1][kStrip]
  int8_t* dec;            // [L1p][Wd]
  int Wd, r0, nr, la, lb, c0, first, slot;
  // the wave route: the clusters' strips [clusters][R][kWaveStrip] and
  // row counters [clusters]
  float* wstrip;
  unsigned* ready;
  int R, every;
};

/* Rows r0 + 1 .. r0 + nr of the band columns [band0, band0 + blockDim.x
 * * CH) (band-local): the start state from the state buffer's slot `slot`
 * (and, at the band's first column, the strip's row 0), strip row 0 from
 * the band's last thread, edge.start(), the rows (band_span), the last
 * row's state into the other slot, which no block of the launch reads. */
template <int CH, class Edge>
__device__ __forceinline__ void band_block(float* smem, int band0,
                                           const BandArgs& a, Edge& edge) {
  RowThread<CH> x;
  float* ring = band_thread(x, smem, band0);
  const int Wd = a.Wd, j0 = x.j0;
  x.real = true;  // the blocks cover the band exactly
  x.first = a.first && j0 == 0;
  x.BW = (size_t)Wd;
  x.colg = a.colpen + j0;
  band_invariants(x, smem + x.t * CH, a.cols_eps + j0, a.colpen + j0);

  const size_t W3 = (size_t)3 * Wd;
  const float* prev = a.state + (size_t)a.slot * W3;
  load_chunk(x.A, prev + j0);
  load_chunk(x.GA, prev + Wd + j0);
  load_chunk(x.GB, prev + 2 * Wd + j0);
  if (j0 > 0) {
    x.Cleft = a.colpen[j0 - 1];
    x.lA = prev[j0 - 1];
    x.lGA = prev[Wd + j0 - 1];
    x.lGB = prev[2 * Wd + j0 - 1];
  } else if (!a.first) {
    x.lA = a.strip_in[0];
    x.lGA = a.strip_in[1];
    x.lGB = a.strip_in[2];
  }
  if (j0 + CH == Wd) {
    // strip row 0: the row above the block at the band's last column
    a.strip_out[0] = x.A[CH - 1];
    a.strip_out[1] = x.GA[CH - 1];
    a.strip_out[2] = x.GB[CH - 1];
    a.strip_out[3] = KT_NEG;
    a.strip_out[4] = KT_NEG;
  }
  edge.start();
  // band_span indexes the match by the DP row's index r >= r0
  const float* mrow0 = a.match + j0 - (ptrdiff_t)a.r0 * Wd;
  band_span<CH>(x, ring, mrow0, Wd, a.rowpen, a.row_term, a.dec, Wd, a.r0,
                a.r0 + a.nr, a.la, a.lb - a.c0, edge);
  float* cur = a.state + (size_t)(a.slot ^ 1) * W3;
  store_chunk(cur + j0, x.A);
  store_chunk(cur + Wd + j0, x.GA);
  store_chunk(cur + 2 * Wd + j0, x.GB);
}

template <int CH>
__global__ void __launch_bounds__(RowCfg<CH>::kMaxThreads)
gotoh_band_cluster_kernel(BandArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  BandHalo<CH> edge = band_halo<CH>(
      smem, rank, cluster.num_blocks(), 0, 1, a.first ? nullptr : a.strip_in,
      a.strip_out, nullptr, nullptr, 0, a.r0, a.nr, 1);
  band_block<CH>(edge.st.ring + StripHalo<CH>::kRingFloats,
                 (int)rank * (int)blockDim.x * CH, a, edge);
  // no block leaves while its neighbour may still arrive on its barriers
  cluster.sync();
}

/* The wave route: `clusters` clusters of S blocks over the band, cluster
 * c the columns [c * S * Wb, (c + 1) * S * Wb), Wb = blockDim.x * CH. */
template <int CH>
__global__ void __launch_bounds__(kWaveMaxThreads)
gotoh_band_wave_kernel(BandArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned S = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  BandHalo<CH> edge = band_halo<CH>(
      smem, rank, S, (int)(blockIdx.x / S), (int)(gridDim.x / S),
      a.first ? nullptr : a.strip_in, a.strip_out, a.wstrip, a.ready, a.R,
      a.r0, a.nr, a.every);
  band_block<CH>(edge.st.ring + StripHalo<CH>::kRingFloats,
                 (int)blockIdx.x * (int)blockDim.x * CH, a, edge);
  // no block leaves while its neighbour may still arrive on its barriers
  cluster.sync();
}


bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

/* A band the blocks cover exactly, 16-byte aligned rows for cp.async
 * and the chunk loads, a strip on every band but the first. */
int check_args(const BandArgs& a, int covered) {
  if (a.Wd <= 0 || a.r0 < 0 || covered != a.Wd || a.Wd % 4 ||
      (!a.first && a.strip_in == nullptr) || !aligned16(a.match) ||
      !aligned16(a.colpen) || !aligned16(a.cols_eps) ||
      !aligned16(a.state) || !aligned16(a.dec))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int CH>
int launch_cluster(const BandArgs& a, int threads, int blocks,
                   cudaStream_t stream) {
  if (!cluster_plan_ok<CH>(threads, blocks)) return (int)cudaErrorInvalidValue;
  int rc = check_args(a, threads * CH * blocks);
  if (rc) return rc;
  const size_t smem = wave_smem_bytes<CH>(threads);
  cudaError_t err =
      cluster_attributes(gotoh_band_cluster_kernel<CH>, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch_config(
      threads, blocks, (unsigned)blocks, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gotoh_band_cluster_kernel<CH>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CH>
int max_active(int threads, int blocks, int* out) {
  if (!cluster_plan_ok<CH>(threads, blocks)) {
    *out = 0;
    return (int)cudaErrorInvalidValue;
  }
  return cluster_occupancy(gotoh_band_cluster_kernel<CH>, threads, blocks,
                           wave_smem_bytes<CH>(threads), out);
}

/* The wave route: `clusters` clusters of `blocks` blocks covering the band
 * exactly, `smem` bytes a block (at least what it needs: the wrapper asks
 * for enough that no two blocks share an SM), its strips and counters,
 * nr within their R rows. */
template <int CH>
int launch_wave(const BandArgs& a, int threads, int blocks, int clusters,
                size_t smem, cudaStream_t stream) {
  if (!wave_plan_ok<CH>(threads, blocks) || clusters < 1 ||
      smem < wave_smem_bytes<CH>(threads) || a.nr > a.R || a.every < 1 ||
      a.wstrip == nullptr || a.ready == nullptr || !aligned16(a.wstrip))
    return (int)cudaErrorInvalidValue;
  int rc = check_args(a, threads * CH * blocks * clusters);
  if (rc) return rc;
  cudaError_t err =
      cluster_attributes(gotoh_band_wave_kernel<CH>, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch_config(
      threads, blocks, (unsigned)(blocks * clusters), smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gotoh_band_wave_kernel<CH>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CH>
int max_active_wave(int threads, int blocks, size_t smem, int* out) {
  if (!wave_plan_ok<CH>(threads, blocks) ||
      smem < wave_smem_bytes<CH>(threads)) {
    *out = 0;
    return (int)cudaErrorInvalidValue;
  }
  return cluster_occupancy(gotoh_band_wave_kernel<CH>, threads, blocks,
                           smem, out);
}

BandArgs band_args(const void* match, const void* colpen, const void* rowpen,
                   const void* cols_eps, const void* row_term, void* state,
                   const void* strip_in, void* strip_out, void* dec, int Wd,
                   int r0, int nr, int la, int lb, int c0, int first,
                   int slot) {
  return BandArgs{(const float*)match,  (const float*)colpen,
                  (const float*)rowpen, (const float*)cols_eps,
                  (const float*)row_term, (float*)state,
                  (const float*)strip_in, (float*)strip_out,
                  (int8_t*)dec, Wd, r0, nr, la, lb, c0, first, slot & 1,
                  nullptr, nullptr, 0, 0};
}

}  // namespace

/* Shared memory of a block of `threads` threads of `ch` columns, either
 * route (0 for an unsupported ch); gpu/gotoh_mesh.py::band_config
 * mirrors it. */
KT_EXPORT size_t kt_gotoh_band_smem_bytes(int threads, int ch) {
  switch (ch) {
    case 4: return wave_smem_bytes<4>(threads);
    case 8: return wave_smem_bytes<8>(threads);
    default: return 0;
  }
}

/* cudaOccupancyMaxActiveClusters of the cluster route's plan into *out
 * (0: the card cannot schedule one such cluster). */
KT_EXPORT int kt_gotoh_band_cluster_max_active(int threads, int ch,
                                               int blocks, int* out) {
  switch (ch) {
    case 4: return max_active<4>(threads, blocks, out);
    case 8: return max_active<8>(threads, blocks, out);
    default: *out = 0; return (int)cudaErrorInvalidValue;
  }
}

/* cudaOccupancyMaxActiveClusters of a wave route's plan (clusters of
 * `blocks` blocks of `threads` threads, `smem` bytes of dynamic shared
 * memory a block) into *out. */
KT_EXPORT int kt_gotoh_band_wave_max_active(int threads, int ch, int blocks,
                                            size_t smem, int* out) {
  switch (ch) {
    case 4: return max_active_wave<4>(threads, blocks, smem, out);
    case 8: return max_active_wave<8>(threads, blocks, smem, out);
    default: *out = 0; return (int)cudaErrorInvalidValue;
  }
}

/* The cluster route: one cluster of `blocks` blocks of `threads` threads
 * of `ch` columns (blocks * threads * ch == Wd). */
KT_EXPORT int kt_gotoh_band_cluster(const void* match, const void* colpen,
                                    const void* rowpen, const void* cols_eps,
                                    const void* row_term, void* state,
                                    const void* strip_in, void* strip_out,
                                    void* dec, int Wd, int r0, int nr,
                                    int la, int lb, int c0, int first,
                                    int slot, int threads, int ch,
                                    int blocks, void* stream) {
  if (nr <= 0) return 0;
  const BandArgs a = band_args(match, colpen, rowpen, cols_eps, row_term,
                               state, strip_in, strip_out, dec, Wd, r0, nr,
                               la, lb, c0, first, slot);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4: return launch_cluster<4>(a, threads, blocks, s);
    case 8: return launch_cluster<8>(a, threads, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

/* The wave route: `clusters` clusters of `blocks` blocks of `threads`
 * threads of `ch` columns (clusters * blocks * threads * ch == Wd), the
 * clusters' strips wstrip [clusters][R][8] and counters ready
 * [clusters], published every `every` rows. */
KT_EXPORT int kt_gotoh_band_wave(const void* match, const void* colpen,
                                 const void* rowpen, const void* cols_eps,
                                 const void* row_term, void* state,
                                 const void* strip_in, void* strip_out,
                                 void* dec, int Wd, int r0, int nr, int la,
                                 int lb, int c0, int first, int slot,
                                 void* wstrip, void* ready, int R, int every,
                                 int threads, int ch, int blocks,
                                 int clusters, size_t smem, void* stream) {
  if (nr <= 0) return 0;
  BandArgs a = band_args(match, colpen, rowpen, cols_eps, row_term, state,
                         strip_in, strip_out, dec, Wd, r0, nr, la, lb, c0,
                         first, slot);
  a.wstrip = (float*)wstrip;
  a.ready = (unsigned*)ready;
  a.R = R;
  a.every = every;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4: return launch_wave<4>(a, threads, blocks, clusters, smem, s);
    case 8: return launch_wave<8>(a, threads, blocks, clusters, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
