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
 * the state buffer into registers once and stores it back once.  Routes,
 * by the band's width alone (gpu/gotoh_mesh.py::band_config):
 *   - gotoh_band_cluster_kernel, up to 16 x 7,168 = 114,688 columns: one
 *     thread-block cluster of S <= 16 blocks per band (S = 1 up to 256
 *     columns), the blocks covering the band exactly, each a band of
 *     its own handing a halo to block k + 1 every row through
 *     distributed shared memory (the cluster row kernel's ClusterHalo),
 *     block 0 reading the left band's strip, block S - 1 writing this
 *     one's.  Narrow blocks make a short row: one block of 2,560 columns
 *     took 1.7 us a row on an H100, ten of 256 0.77 (PERF.md);
 *   - gotoh_band_block_kernel, past 114,688 columns: one block walks
 *     each row in tiles of up to 1,024 columns, a thread per column, the
 *     previous row's state read from the global state buffer, a barrier
 *     per tile and per row (the first design, kept so that no width
 *     raises).
 *
 * Bound: device-memory bytes — each cell's 4-byte match value read once
 * and its decision byte written once.  What bounds the register routes
 * is the latency of a row on the dependent chain (one barrier, the
 * block's prefix max, for a cluster the halo), as for the row kernel,
 * plus a launch's start (the state, the invariants, the ring's first
 * rows) every R rows.
 */
#include "gotoh_row_body.cuh"

namespace {

constexpr int kStrip = 5;          // floats per strip row
constexpr int kStripSlot = 8;      // floats per slot of the strip ring
constexpr int kMaxThreads = 1024;  // gotoh_band_block_kernel
constexpr unsigned kFull = 0xffffffffu;

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
  int Wd, r0, nr, la, lb, c0, first;
};

/* The edge of a band whose left neighbour is another launch's band: its
 * strip, rows r0 .. r0 + nr.  Thread 0 copies strip row q + 1 (what row
 * q of the launch receives) into a ring of kRing slots in shared memory
 * with cp.async as the match row q is copied ahead, in the same commit
 * group; its wait on that group and the row's barrier make the slot
 * visible to every thread, so the receive on the row's dependent chain
 * is a shared-memory read.  A slot is written again kRing rows later,
 * two barriers after every thread has read it. */
template <int CH>
struct StripHalo {
  static constexpr int kRing = RowCfg<CH>::kStages + 1;
  static constexpr int kRingFloats = kRing * kStripSlot;  // 16-byte multiple
  const float* in;  // the left band's strip; nullptr: none (the first band)
  float* out;       // this band's strip (written by the band's last thread)
  float* ring;      // [kRing][kStripSlot] in shared memory
  int r0;

  __device__ __forceinline__ void prefetch(int q) const {
    if (in != nullptr && threadIdx.x == 0) {
      const float* e = in + (size_t)(q + 1) * kStrip;
      float* d = ring + (q % kRing) * kStripSlot;
#pragma unroll
      for (int i = 0; i < kStrip; i++) copy_float_async(d + i, e + i);
    }
  }

  __device__ __forceinline__ Halo receive(int r, int) const {
    if (in == nullptr) return Halo{-INFINITY, KT_NEG, KT_NEG, KT_NEG, KT_NEG};
    const float* h = ring + ((r - r0) % kRing) * kStripSlot;
    return Halo{h[3], h[4], h[0], h[1], h[2]};
  }

  __device__ __forceinline__ void send(int r, float A, float GA, float GB,
                                       float cm, float u) const {
    float* o = out + (size_t)(r - r0 + 1) * kStrip;
    o[0] = A;
    o[1] = GA;
    o[2] = GB;
    o[3] = cm;
    o[4] = u;
  }
};

/* A cluster's band: block 0 takes the left band's strip, block S - 1
 * writes this band's, the blocks between pass the halo on through
 * distributed shared memory (rows counted from the launch's first). */
template <int CH>
struct StripClusterHalo {
  static constexpr bool kBands = true;
  ClusterHalo cl;
  StripHalo<CH> st;

  // every block has loaded its start state and its barriers exist
  __device__ __forceinline__ void start() { cg::this_cluster().sync(); }

  __device__ __forceinline__ void prefetch(int q) const { st.prefetch(q); }

  __device__ __forceinline__ Halo receive(int r, int t) const {
    return cl.rank == 0 ? st.receive(r, t) : cl.receive(r - st.r0, t);
  }

  __device__ __forceinline__ void send(int r, float A, float GA, float GB,
                                       float cm, float u) const {
    if (cl.rank + 1 == cl.S) {
      st.send(r, A, GA, GB, cm, u);
    } else {
      cl.send(r - st.r0, A, GA, GB, cm, u);
    }
  }
};

/* Rows r0 + 1 .. r0 + nr of the band columns [band0, band0 + blockDim.x
 * * CH) (band-local): the start state from the state buffer (and, at the
 * band's first column, the strip's row 0), strip row 0 from the band's
 * last thread, edge.start(), the rows (band_span), the last row's state
 * back into the buffer.  Every load of the buffer comes before
 * edge.start(), every store after it, so no block of a cluster
 * overwrites a slot another still reads. */
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
  const float* prev = a.state + (size_t)(a.r0 & 1) * W3;
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
  float* cur = a.state + (size_t)((a.r0 + a.nr) & 1) * W3;
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
  StripClusterHalo<CH> edge;
  edge.cl = cluster_halo(smem, rank, cluster.num_blocks(), a.nr);
  float* ring = smem + kClusterHeader / 4;
  edge.st = StripHalo<CH>{rank == 0 && !a.first ? a.strip_in : nullptr,
                          a.strip_out, ring, a.r0};
  band_block<CH>(ring + StripHalo<CH>::kRingFloats,
                 (int)rank * (int)blockDim.x * CH, a, edge);
  // no block leaves while its neighbour may still arrive on its barriers
  cluster.sync();
}

/* The first design, for bands past 114,688 columns: one block per band,
 * a thread per column of a tile of blockDim.x columns; a row walks the
 * band's tiles left to right with a warp-shuffle scan of u per tile and
 * the warp maxima in shared memory (one barrier a tile, two slot
 * parities), the running carry handed from tile to tile in registers;
 * the previous row's state is read from the state buffer by row parity
 * (slot row & 1), so every row ends with a barrier. */
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
    const float* mrow = a.match + (size_t)(s - 1) * Wd;
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


/* A block's shared memory: the cluster's halo header, the strip ring,
 * band_thread's arrays. */
template <int CH>
size_t band_smem_bytes(int threads) {
  return kClusterHeader + StripHalo<CH>::kRingFloats * sizeof(float) +
         smem_bytes<CH>(threads);
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
  const size_t smem = band_smem_bytes<CH>(threads);
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
                           band_smem_bytes<CH>(threads), out);
}

BandArgs band_args(const void* match, const void* colpen, const void* rowpen,
                   const void* cols_eps, const void* row_term, void* state,
                   const void* strip_in, void* strip_out, void* dec, int Wd,
                   int r0, int nr, int la, int lb, int c0, int first) {
  return BandArgs{(const float*)match,  (const float*)colpen,
                  (const float*)rowpen, (const float*)cols_eps,
                  (const float*)row_term, (float*)state,
                  (const float*)strip_in, (float*)strip_out,
                  (int8_t*)dec, Wd, r0, nr, la, lb, c0, first};
}

}  // namespace

/* Shared memory of a cluster block of `threads` threads of `ch` columns
 * (0 for an unsupported ch); gpu/gotoh_mesh.py::band_config mirrors it. */
KT_EXPORT size_t kt_gotoh_band_smem_bytes(int threads, int ch) {
  switch (ch) {
    case 4: return band_smem_bytes<4>(threads);
    case 8: return band_smem_bytes<8>(threads);
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

/* The cluster route: one cluster of `blocks` blocks of `threads` threads
 * of `ch` columns (blocks * threads * ch == Wd). */
KT_EXPORT int kt_gotoh_band_cluster(const void* match, const void* colpen,
                                    const void* rowpen, const void* cols_eps,
                                    const void* row_term, void* state,
                                    const void* strip_in, void* strip_out,
                                    void* dec, int Wd, int r0, int nr,
                                    int la, int lb, int c0, int first,
                                    int threads, int ch, int blocks,
                                    void* stream) {
  if (nr <= 0) return 0;
  const BandArgs a = band_args(match, colpen, rowpen, cols_eps, row_term,
                               state, strip_in, strip_out, dec, Wd, r0, nr,
                               la, lb, c0, first);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4: return launch_cluster<4>(a, threads, blocks, s);
    case 8: return launch_cluster<8>(a, threads, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
