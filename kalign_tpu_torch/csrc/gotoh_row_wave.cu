/* The row Gotoh kernel's wave instantiation: one DP problem wider than a
 * thread-block cluster of 16 register bands holds (past 114,688 columns),
 * one block of rows per launch, its columns in a wavefront of clusters.
 *
 * Replaces kalign_tpu/tpu/gotoh_pallas.py::_kernel (gotoh_forward_pallas
 * :272) past its plan's widths, where kalign_tpu runs its XLA scan
 * (kalign_tpu/tpu/gotoh.py:47 gotoh_forward); the design is the column
 * wavefront of kalign_tpu/parallel/mesh.py:288 sharded_long_gotoh with
 * clusters of one card in place of devices.  Same recurrences, tie rules
 * and decisions as gotoh_row_kernel (csrc/gotoh_row.cu), whose note gives
 * the per-row design; gpu/gotoh_wave.py drives it and holds its plain
 * version.
 *
 * A launch runs the rows r0 .. r0 + nr - 1 of one problem b (those below
 * its la, which the kernel reads), whose match rows arrive as one block
 * [nr, L2p] (the fp32 product of those rows,
 * prepared by csrc/prepare_match.cu where a bonus is present): the whole
 * match of a plastome-length problem (156k x 156k x 4 bytes) is larger
 * than the card.  The grid is `bands` clusters of S blocks in index
 * order; block g owns the columns [g * Wb, (g + 1) * Wb), Wb = blockDim.x
 * * CH, so cluster c owns the band [c * S * Wb, (c + 1) * S * Wb).  Inside
 * a cluster the blocks hand the 5-float halo on every row through
 * distributed shared memory (gotoh_row_body.cuh's ClusterHalo, as the
 * cluster row kernel does).  Between clusters the halo goes through
 * global memory (L2): the band's last thread writes its strip row (A, GA,
 * GB at the band's last column, the prefix max of u up to it, its last
 * u) into the band's strip [R][8] and, every `every` rows and at the
 * launch's last row, publishes the rows done with a release store to the
 * band's counter.  Thread 0 of the next band's first block polls that
 * counter with an acquire load (only when the rows it knows of run out)
 * and copies strip rows into a shared-memory ring with cp.async (.cg:
 * L2, never a stale L1 line), kStages - 1 rows ahead in the match ring's
 * commit groups, as the mesh's StripHalo does (gotoh_row_body.cuh's
 * BandHalo holds both edges).  A band waits only on the band to its
 * left, which never waits on it, and the wrapper launches only plans
 * whose every cluster is co-resident
 * (cudaOccupancyMaxActiveClusters), so no wait can block the cluster it
 * waits on.  A strip holds a launch's whole block of rows: the producer
 * never waits for the consumer.
 *
 * The row state of every column (A, GA, GB) carries from launch to
 * launch in a state buffer [2][3][Wp], Wp = bands * S * Wb: a launch
 * reads slot `slot` into registers (and the column left of each thread's
 * first one) and writes its last row into the other slot, so no band
 * overwrites what another band of the same launch still reads.  Slot 0
 * of the first launch holds row 0: A = GB = NEG, GA = the terminal gap
 * run ga0 (NEG past L2p).  Columns past L2p are computed with a zero
 * match and never stored, as in the cluster row kernel.  Per cell the
 * arithmetic and its order are gotoh_row_kernel's, so every launch
 * sequence gives the bits of gotoh_row.plain on the unsplit problem; the
 * score and end state are read from the last launch's state buffer by
 * the wrapper.
 *
 * Bound: device-memory bytes (a 4-byte match value read and a decision
 * byte written per cell; the strips are 32 bytes per band and row, in
 * L2).  What sets the pace is the latency of a row on its dependent
 * chain (one barrier, the block's prefix max, the cluster halo), and the
 * pipeline's fill: band c runs about (kStages - 1 + every) rows behind
 * band c - 1 in each launch.
 */
#include "gotoh_row_body.cuh"

namespace {

struct WaveArgs {
  const float* match;     // [nr, L2p]: the launch's rows r0 .. r0 + nr - 1
  const float* colpen;    // [5, B, L2p]
  const float* rowpen;    // [B, L1p, 5]
  const float* cols_eps;  // [B, L2p]
  const float* row_term;  // [B, L1p]
  float* state;           // [2][3][Wp]
  float* strip;           // [bands][R][kWaveStrip]
  unsigned* ready;        // [bands]: rows of the band's strip published,
                          // counted from the problem's row 0
  int8_t* dec;            // [L1p, L2p] of problem b
  const int32_t* la_arr;  // [B]
  const int32_t* lb_arr;  // [B]
  int b, B, L1p, L2p, Wp, r0, nr, R, slot, every;
  int la, lb;             // problem b's, read by the kernel
};

/* One block's columns [band0, band0 + blockDim.x * CH) over the launch's
 * rows: the start state from the state buffer, the rows (band_span), the
 * last row's state into the other slot. */
template <int CH>
__device__ __forceinline__ void wave_block(float* smem, int band0,
                                           const WaveArgs& a,
                                           BandHalo<CH>& edge) {
  RowThread<CH> x;
  float* ring = band_thread(x, smem, band0);
  const int j0 = x.j0;
  x.real = j0 < a.L2p;
  x.first = j0 == 0;
  x.BW = (size_t)a.B * a.L2p;
  const size_t pb = (size_t)a.b * a.L2p + j0;
  x.colg = a.colpen + pb;
  band_invariants(x, smem + x.t * CH, a.cols_eps + pb, a.colpen + pb);

  const size_t W3 = (size_t)3 * a.Wp;
  const float* prev = a.state + (size_t)a.slot * W3;
  load_chunk(x.A, prev + j0);
  load_chunk(x.GA, prev + a.Wp + j0);
  load_chunk(x.GB, prev + 2 * (size_t)a.Wp + j0);
  if (j0 > 0) {
    if (x.real) x.Cleft = a.colpen[pb - 1];
    x.lA = prev[j0 - 1];
    x.lGA = prev[a.Wp + j0 - 1];
    x.lGB = prev[2 * (size_t)a.Wp + j0 - 1];
  }
  edge.start();
  // the match block's row q is the problem's row r0 + q
  const float* mrow0 = a.match + j0 - (ptrdiff_t)a.r0 * a.L2p;
  band_span<CH>(x, ring, mrow0, a.L2p, a.rowpen + (size_t)a.b * a.L1p * 5,
                a.row_term + (size_t)a.b * a.L1p, a.dec, a.L2p, a.r0,
                a.r0 + a.nr, a.la, a.lb, edge);
  float* cur = a.state + (size_t)(a.slot ^ 1) * W3;
  store_chunk(cur + j0, x.A);
  store_chunk(cur + a.Wp + j0, x.GA);
  store_chunk(cur + 2 * (size_t)a.Wp + j0, x.GB);
}

template <int CH>
__global__ void __launch_bounds__(kWaveMaxThreads)
gotoh_row_wave_kernel(WaveArgs a) {
  extern __shared__ __align__(16) float smem[];
  // the launch's rows stop at the problem's last (la read here, so the
  // host need not know it): a launch wholly past it carries the state
  a.la = a.la_arr[a.b];
  a.lb = a.lb_arr[a.b];
  const int last = a.la < a.L1p ? a.la : a.L1p;
  a.nr = a.nr < last - a.r0 ? a.nr : last - a.r0;
  if (a.nr < 0) a.nr = 0;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned S = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int band = (int)(blockIdx.x / S);
  const int bands = (int)(gridDim.x / S);
  BandHalo<CH> edge =
      band_halo<CH>(smem, rank, S, band, bands, nullptr, nullptr, a.strip,
                    a.ready, a.R, a.r0, a.nr, a.every);
  wave_block<CH>(edge.st.ring + StripHalo<CH>::kRingFloats,
                 (int)blockIdx.x * (int)blockDim.x * CH, a, edge);
  // no block leaves while its neighbour may still arrive on its barriers
  cluster.sync();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int CH>
int max_active(int threads, int blocks, size_t smem, int* out) {
  if (!wave_plan_ok<CH>(threads, blocks) || smem < wave_smem_bytes<CH>(
          threads)) {
    *out = 0;
    return (int)cudaErrorInvalidValue;
  }
  return cluster_occupancy(gotoh_row_wave_kernel<CH>, threads, blocks, smem,
                           out);
}

template <int CH>
int launch(const WaveArgs& a, int threads, int blocks, int bands,
           size_t smem, cudaStream_t stream) {
  if (!wave_plan_ok<CH>(threads, blocks) || bands < 1 ||
      smem < wave_smem_bytes<CH>(threads) ||
      (long long)threads * CH * blocks * bands != a.Wp || a.Wp < a.L2p ||
      a.L2p % CH || a.nr > a.R || a.every < 1 || !aligned16(a.match) ||
      !aligned16(a.colpen) || !aligned16(a.cols_eps) ||
      !aligned16(a.state) || !aligned16(a.strip) || !aligned16(a.dec) ||
      (a.B * (size_t)a.L2p) % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cluster_attributes(gotoh_row_wave_kernel<CH>, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch_config(
      threads, blocks, (unsigned)(blocks * bands), smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gotoh_row_wave_kernel<CH>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

/* Shared memory a wave block needs (0 for an unsupported ch);
 * gpu/gotoh_row.py::wave_config mirrors it. */
KT_EXPORT size_t kt_gotoh_row_wave_smem_bytes(int threads, int ch) {
  switch (ch) {
    case 4: return wave_smem_bytes<4>(threads);
    case 8: return wave_smem_bytes<8>(threads);
    default: return 0;
  }
}

/* cudaOccupancyMaxActiveClusters of a wave plan (clusters of `blocks`
 * blocks of `threads` threads, `smem` bytes of dynamic shared memory a
 * block) into *out. */
KT_EXPORT int kt_gotoh_row_wave_max_active(int threads, int ch, int blocks,
                                           size_t smem, int* out) {
  switch (ch) {
    case 4: return max_active<4>(threads, blocks, smem, out);
    case 8: return max_active<8>(threads, blocks, smem, out);
    default: *out = 0; return (int)cudaErrorInvalidValue;
  }
}

/* One launch of the wave: rows r0 .. r0 + nr - 1 of problem b (those
 * below its la), `bands` clusters of `blocks` blocks of `threads` threads
 * of `ch` columns. */
KT_EXPORT int kt_gotoh_row_wave(
    const void* match, const void* colpen, const void* rowpen,
    const void* cols_eps, const void* row_term, void* state, void* strip,
    void* ready, void* dec, const void* la, const void* lb, int b, int B,
    int L1p, int L2p, int Wp, int r0, int nr, int R, int slot, int every,
    int threads, int ch, int blocks, int bands, size_t smem, void* stream) {
  if (nr <= 0) return 0;
  const WaveArgs a{(const float*)match, (const float*)colpen,
                   (const float*)rowpen, (const float*)cols_eps,
                   (const float*)row_term, (float*)state, (float*)strip,
                   (unsigned*)ready, (int8_t*)dec, (const int32_t*)la,
                   (const int32_t*)lb, b, B, L1p, L2p, Wp, r0, nr, R,
                   slot & 1, every, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4: return launch<4>(a, threads, blocks, bands, smem, s);
    case 8: return launch<8>(a, threads, blocks, bands, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
