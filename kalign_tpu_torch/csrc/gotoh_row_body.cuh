/* The DP body shared by the row Gotoh kernels (csrc/gotoh_row.cu) and the
 * column-band kernels of the mesh (csrc/gotoh_mesh.cu): one thread's CH
 * columns of a band of a DP row (RowThread, row_step), the rows of a band
 * with the match prefetched through a cp.async ring (band_span), and the
 * edges by which a band learns what lies to its left: nothing (NoHalo),
 * the previous block of a thread-block cluster (ClusterHalo), or
 * (BandHalo) besides that the previous cluster of a wavefront of
 * clusters through a strip in L2 with a row counter (gotoh_row_wave.cu,
 * gotoh_mesh.cu's wave route) and a strip in global memory written by
 * another launch's band (StripHalo, gotoh_mesh.cu).  gotoh_row.cu's
 * header note gives the design; a kernel that includes this file adds
 * only how a band starts and ends.
 */
#ifndef KT_GOTOH_ROW_BODY_CUH
#define KT_GOTOH_ROW_BODY_CUH

#include "kt_cuda.h"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

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

/* cp.async of one float (4-byte aligned), through L1. */
__device__ __forceinline__ void copy_float_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
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

/* What the bands left of a block's band hand it for one row: the prefix
 * max of u over every column left of the band (-inf where there is none),
 * the u at the column just left of it, and A, GA, GB there (the band's
 * diagonal left edge in the next row). */
struct Halo {
  float cmax, lu, eA, eGA, eGB;
};

/* An edge: prefetch(q) is called by every thread as the match row of the
 * span's row q is copied ahead (cp.async, committed with it); receive(r,
 * t) after the block's prefix max of row r; send from the band's last
 * thread after its GA pass.
 *
 * The register kernel's row is one band: nothing comes from the left. */
struct NoHalo {
  static constexpr bool kBands = false;
  __device__ __forceinline__ void prefetch(int) const {}
  __device__ __forceinline__ Halo receive(int, int) const {
    return Halo{-INFINITY, KT_NEG, KT_NEG, KT_NEG, KT_NEG};
  }
  __device__ __forceinline__ void send(int, float, float, float, float,
                                       float) const {}
};

/* One thread's place in its band and its DP state. */
template <int CH>
struct RowThread {
  int t, lane, warp, nw;
  int cols;          // the block's columns (the shared-memory row stride)
  int j0;            // the first of the thread's CH columns in the row
  bool real;         // j0 < L2p (L2p % CH == 0: a chunk is all in or out)
  bool first;        // the thread holds DP column 1 (analytic left edge)
  const float* inv;  // invariants [4][cols] at the thread's offset
  float* slots;      // warp slots [2][nw][kSlot]
  const float* colg; // colpen + the thread's offset (last row's C, gnC)
  size_t BW;         // B * L2p: colpen's vector stride
  float Cleft;       // C_norm at column j0 - 1
  float A[CH], GA[CH], GB[CH], U[CH];
  float lA, lGA, lGB;  // the previous row's values at column j0 - 1
};

/* A thread's place in a block that computes a band of blockDim.x * CH
 * columns starting at the band-local column band0, and the block's
 * shared memory: the invariants [4][cols] (ceps, goB_s, gnC_norm,
 * C_norm) at x.inv, the match ring [kStages][cols] (returned, at the
 * thread's offset) and the warp slots [2][nw][kSlot].  The caller sets
 * real, first and the rest of the thread's state. */
template <int CH>
__device__ __forceinline__ float* band_thread(RowThread<CH>& x, float* smem,
                                              int band0) {
  constexpr int NS = RowCfg<CH>::kStages;
  x.t = threadIdx.x;
  x.lane = x.t & 31;
  x.warp = x.t >> 5;
  x.nw = blockDim.x >> 5;
  x.cols = blockDim.x * CH;
  x.j0 = band0 + x.t * CH;
  const int lo = x.t * CH;  // the thread's offset in shared memory
  x.inv = smem + lo;
  x.slots = smem + (4 + NS) * x.cols;
  return smem + 4 * x.cols + lo;
}

/* The thread's chunk of the invariants into shared memory (ceps and
 * colpen at the thread's first column, colpen's vectors x.BW apart;
 * zeros where the chunk is not real) and its DP state set to NEG (the
 * caller loads what it starts from). */
template <int CH>
__device__ __forceinline__ void band_invariants(RowThread<CH>& x, float* inv,
                                                const float* ceps,
                                                const float* colpen) {
  x.Cleft = 0.0f;
  x.lA = KT_NEG;
  x.lGA = KT_NEG;
  x.lGB = KT_NEG;
  const int cols = x.cols;
  {
    float v[CH];
#pragma unroll
    for (int c = 0; c < CH; c++) v[c] = 0.0f;
    const float* src[4] = {ceps, colpen + 4 * x.BW, colpen + 2 * x.BW,
                           colpen + 0 * x.BW};
#pragma unroll
    for (int q = 0; q < 4; q++) {
      if (x.real) load_chunk(v, src[q]);
      store_chunk(inv + q * cols, v);
    }
  }
#pragma unroll
  for (int c = 0; c < CH; c++) {
    x.A[c] = KT_NEG;
    x.GB[c] = KT_NEG;
    x.GA[c] = KT_NEG;
    x.U[c] = KT_NEG;
  }
}

/* One DP row (row r, DP row r + 1) of one thread's CH columns; m holds
 * the match row's chunk.  The per-cell order of operations is the plain
 * version's.  Between the block's prefix max of u and the GA pass the
 * halo of this row is received (the cluster kernel waits for it there,
 * after its own A / GB / u pass); after the GA pass the band's own halo
 * goes to the band on the right. */
template <int CH, class Edge>
__device__ __forceinline__ void row_step(RowThread<CH>& x, float (&m)[CH],
                                         int r, int la, int lb,
                                         const RowScalars& sc,
                                         int8_t* dec_row, Edge& edge) {
  const int row = r + 1;
  const bool last = row == la;
  const int cols = x.cols;
  float gnC[CH];
  if (last && x.real) {
    load_chunk(gnC, x.colg + 3 * x.BW);
  } else {
    load_chunk(gnC, x.inv + 2 * cols);
  }
  if (!x.real) {
#pragma unroll
    for (int c = 0; c < CH; c++) m[c] = 0.0f;
  }
  if (x.first) {
    x.lA = (row == 1) ? 0.0f : KT_NEG;
    x.lGA = KT_NEG;
    x.lGB = sc.gb0_prev;
  }

  // A, GB, u and the decision's A / GB bits, left to right; dA, dGA,
  // dGB hold the previous row's values at the column to the left
  int d[CH];
  float dA = x.lA, dGAv = x.lGA, dGBv = x.lGB;
  float run = -INFINITY, run_but_last = -INFINITY;
#pragma unroll
  for (int c = 0; c < CH; c++) {
    const int col = x.j0 + c + 1;
    const float mm = m[c] - fabsf(x.inv[c] - sc.rterm);
    const float diagA = dA;
    const float dGA = dGAv + x.inv[cols + c];
    const float dGB = dGBv + sc.goA_prev;
    const float best01 = fmaxf(diagA, dGA);
    const float A_row = fmaxf(best01, dGB) + mm;
    const bool term = col == lb;
    const float ge_eff = term ? sc.tgeA : sc.geA;
    const float go_eff = term ? sc.tgeA : sc.goA;
    const float gb_e = x.GB[c] + ge_eff;
    const float gb_o = x.A[c] + go_eff;
    const float u = (col < lb) ? (A_row + gnC[c]) : KT_NEG;
    d[c] = (dGB >= best01) ? 2 : ((dGA >= diagA) ? 1 : 0);
    d[c] |= (gb_e > gb_o) ? KT_DEC_GB_EXT : 0;
    dA = x.A[c];
    dGAv = x.GA[c];
    dGBv = x.GB[c];
    x.A[c] = A_row;
    x.GB[c] = fmaxf(gb_e, gb_o);
    x.U[c] = u;
    if (c == CH - 1) run_but_last = run;
    run = fmaxf(run, u);
  }

  // prefix max of u across the block: one barrier
  const int lane = x.lane, warp = x.warp, nw = x.nw;
  const float incl = warp_incl_max(run, lane);
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -INFINITY;
  float lu = __shfl_up_sync(0xffffffffu, x.U[CH - 1], 1);
  float cin = -INFINITY;   // max u of the warps left of this one
  float wex2 = -INFINITY;  // ... of all but the nearest
  float* slot = x.slots + (r & 1) * nw * kSlot;
  const float* left = slot + (warp - 1) * kSlot;
  if (lane == 31) {
    float* sw = slot + warp * kSlot;
    sw[0] = incl;
    sw[1] = fmaxf(excl, run_but_last);
    sw[2] = x.U[CH - 1];
    sw[3] = x.A[CH - 1];
    sw[4] = x.GB[CH - 1];
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
  const Halo h = edge.receive(r, x.t);
  float cm = fmaxf(cin, excl);
  if constexpr (Edge::kBands) cm = fmaxf(h.cmax, cm);
  if (x.t == 0) {
    cm = x.first ? KT_NEG : h.cmax;
    lu = x.first ? KT_NEG : h.lu;
  }

  // GA = shifted prefix max + C, and the decision's GA bit
  float C[CH];
  if (last && x.real) {
    load_chunk(C, x.colg + 1 * x.BW);
  } else {
    load_chunk(C, x.inv + 3 * cols);
  }
#pragma unroll
  for (int c = 0; c < CH; c++) {
    const float cm_s = cm;
    const float u_s = c ? x.U[c - 1] : lu;
    x.GA[c] = cm_s + C[c];
    d[c] |= (cm_s > u_s) ? KT_DEC_GA_EXT : 0;
    cm = fmaxf(cm, x.U[c]);
  }
  // the band's last thread: cm is now the prefix max of u over every
  // column up to the band's right edge
  if (x.t == (int)blockDim.x - 1)
    edge.send(r, x.A[CH - 1], x.GA[CH - 1], x.GB[CH - 1], cm, x.U[CH - 1]);
  if (x.real) store_dec<CH>(dec_row + x.j0, d);

  // the next row's values at column j0 - 1
  x.lA = __shfl_up_sync(0xffffffffu, x.A[CH - 1], 1);
  x.lGA = __shfl_up_sync(0xffffffffu, x.GA[CH - 1], 1);
  x.lGB = __shfl_up_sync(0xffffffffu, x.GB[CH - 1], 1);
  if (lane == 0 && warp > 0) {
    float w = fmaxf(wex2, left[1]);
    if constexpr (Edge::kBands) w = fmaxf(h.cmax, w);
    x.lA = left[3];
    x.lGB = left[4];
    x.lGA = w + x.Cleft;
  }
  if constexpr (Edge::kBands) {
    if (x.t == 0 && !x.first) {
      x.lA = h.eA;
      x.lGA = h.eGA;
      x.lGB = h.eGB;
    }
  }
}

/* The rows [r_begin, r_end) of a band through row_step: the match rows
 * (row stride mstride floats from mrow0, the thread's first column of row
 * 0) prefetched kStages - 1 rows ahead into the shared-memory ring (ring
 * at the thread's offset, stride x.cols), the row scalars one row ahead
 * (rp0 / rt0 index rows from 0), the decisions of row r at dec0 + r *
 * dstride + x.j0 (dec0 not offset to the thread, unlike mrow0).  lb is
 * relative to the band's column origin. */
template <int CH, class Edge>
__device__ __forceinline__ void band_span(
    RowThread<CH>& x, float* ring, const float* __restrict__ mrow0,
    size_t mstride, const float* __restrict__ rp0,
    const float* __restrict__ rt0, int8_t* __restrict__ dec0,
    size_t dstride, int r_begin, int r_end, int la, int lb, Edge& edge) {
  constexpr int NS = RowCfg<CH>::kStages;
  const int cols = x.cols;
  const int rows = r_end - r_begin;
#pragma unroll
  for (int s = 0; s < NS - 1; s++) {
    if (x.real && s < rows)
      copy_chunk_async<CH>(ring + s * cols,
                           mrow0 + (size_t)(r_begin + s) * mstride);
    if (s < rows) edge.prefetch(s);
    cp_async_commit();
  }
  RowScalars nx{};
  if (rows > 0) nx = row_scalars(rp0 + (size_t)r_begin * 5, rt0 + r_begin);

  for (int k = 0; k < rows; k++) {
    const int r = r_begin + k;
    const RowScalars sc = nx;
    if (k + 1 < rows) nx = row_scalars(rp0 + (size_t)(r + 1) * 5, rt0 + r + 1);
    {
      const int s = k + NS - 1;
      if (x.real && s < rows)
        copy_chunk_async<CH>(ring + (s % NS) * cols,
                             mrow0 + (size_t)(r_begin + s) * mstride);
      if (s < rows) edge.prefetch(s);
      cp_async_commit();
    }
    cp_async_wait<NS - 1>();
    float m[CH];
    load_chunk(m, ring + (k % NS) * cols);
    row_step<CH>(x, m, r, la, lb, sc, dec0 + (size_t)r * dstride, edge);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

/* The thread-block cluster's halo hand-off (gotoh_row.cu's note on
 * gotoh_row_cluster_kernel gives the protocol). */
constexpr int kSlots = 4;      // halo ring slots per block
constexpr int kHaloFloats = 8; // a slot: A, GA, GB, carry, last u, pad
constexpr unsigned kHaloBytes = 5 * 4;  // what a hand-off writes
constexpr unsigned kCreditBytes = 4;
// shared memory ahead of band_rows' arrays: the full and empty barriers
// [2][kSlots] (8 bytes each), the halo ring and the credit words
// [kSlots]; 16-byte aligned
constexpr int kClusterHeader =
    2 * kSlots * 8 + kSlots * kHaloFloats * 4 + kSlots * 4;
static_assert(kClusterHeader % 16 == 0, "band_rows' arrays need 16 bytes");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned remote_addr(const void* p,
                                                unsigned rank) {
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(smem_addr(p)), "r"(rank));
  return ra;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

/* Arm the local barrier's current phase: its one arrival, and `bytes`
 * to come by st.async. */
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

/* Has the phase of parity `parity` of the local barrier completed?
 * Acquire at cluster scope: the bytes another block's st.async counted
 * on it are visible after it. */
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

/* Asynchronous stores into block `rank`'s shared memory at p's offset,
 * counted on that block's barrier at bar's offset: the sender waits for
 * nothing (no release fence, which would wait for the thread's
 * outstanding global stores of decisions). */
__device__ __forceinline__ void store_async4(float* p, unsigned rank,
                                             float a, float b, float c,
                                             float d, uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(remote_addr(p, rank)), "r"(__float_as_uint(a)),
         "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
         "r"(__float_as_uint(d)), "r"(remote_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void store_async1(void* p, unsigned rank,
                                             unsigned v, uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n"
      :: "r"(remote_addr(p, rank)), "r"(v), "r"(remote_addr(bar, rank))
      : "memory");
}

/* The halo hand-off between neighbouring blocks of a cluster.  Every
 * barrier has one arrival a phase, its owner's arming (mbar_expect), and
 * completes when the bytes it expects have landed: full[s] the halo of
 * the rows r = s (mod kSlots), empty[s] the credit for them.  A credit
 * or a halo is sent only where its receiver will wait for it, so none is
 * in flight when a block finishes. */
struct ClusterHalo {
  static constexpr bool kBands = true;
  uint64_t* full;    // [kSlots], completed by block rank - 1's halo
  uint64_t* empty;   // [kSlots], completed by block rank + 1's credit
  float* ring;       // [kSlots][kHaloFloats], written by block rank - 1
  unsigned* credit;  // [kSlots], written by block rank + 1 (not read)
  unsigned rank, S;
  int rows;

  __device__ __forceinline__ void prefetch(int) const {}

  __device__ __forceinline__ Halo receive(int r, int t) const {
    if (rank == 0) return Halo{-INFINITY, KT_NEG, KT_NEG, KT_NEG, KT_NEG};
    // every thread has passed this row's block barrier, so it has read
    // the previous row's slot: arm the slot for its next halo and return
    // it to block rank - 1
    if (t == 0 && r > 0 && r - 1 + kSlots < rows) {
      const int q = (r - 1) % kSlots;
      mbar_expect(full + q, kHaloBytes);
      store_async1(credit + q, rank - 1, 1u, empty + q);
    }
    const int s = r % kSlots;
    mbar_wait(full + s, (unsigned)(r / kSlots) & 1u);
    const float* h = ring + s * kHaloFloats;
    return Halo{h[3], h[4], h[0], h[1], h[2]};
  }

  __device__ __forceinline__ void send(int r, float A, float GA, float GB,
                                       float cmax, float u) const {
    if (rank + 1 == S) return;
    const int s = r % kSlots;
    if (r >= kSlots) {
      // the slot's previous halo (row r - kSlots) has been read
      mbar_wait(empty + s, (unsigned)(r / kSlots - 1) & 1u);
      if (r + kSlots < rows) mbar_expect(empty + s, kCreditBytes);
    }
    float* h = ring + s * kHaloFloats;
    store_async4(h, rank + 1, A, GA, GB, cmax, full + s);
    store_async1(h + 4, rank + 1, __float_as_uint(u), full + s);
  }
};

/* The cluster's halo state in the first kClusterHeader bytes of smem;
 * thread 0 initialises the barriers and arms their first phases.  Every
 * block of the cluster must pass a cluster.sync() before any block
 * arrives on another's barriers. */
__device__ __forceinline__ ClusterHalo cluster_halo(float* smem,
                                                    unsigned rank,
                                                    unsigned S, int rows) {
  ClusterHalo edge;
  edge.full = reinterpret_cast<uint64_t*>(smem);
  edge.empty = edge.full + kSlots;
  edge.ring = smem + 2 * kSlots * 2;
  edge.credit = reinterpret_cast<unsigned*>(edge.ring + kSlots * kHaloFloats);
  edge.rank = rank;
  edge.S = S;
  edge.rows = rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; s++) {
      mbar_init(edge.full + s, 1);
      mbar_init(edge.empty + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first phase of each: the halo of row s, the credit for it
    for (int s = 0; s < kSlots; s++) {
      mbar_expect(edge.full + s, kHaloBytes);
      mbar_expect(edge.empty + s, kCreditBytes);
    }
  }
  return edge;
}

/* The edges of a band that another launch's band, or another cluster of
 * the same launch, borders.
 *
 * Between launches (the mesh's bands, csrc/gotoh_mesh.cu) a strip
 * [R + 1][kStrip] per band and block of rows, complete before the next
 * launch starts (StripHalo).  Between the clusters of one launch (a
 * wavefront: csrc/gotoh_row_wave.cu, gotoh_mesh.cu's wave route) a strip
 * [R][kWaveStrip] in global memory (L2) per cluster, written by its last
 * block and published every `every` rows and at a launch's last by a
 * release store of the rows done (counted from the problem's row 0) to
 * its counter; thread 0 of the next cluster's first block polls that
 * counter with an acquire load when the rows it knows of run out and
 * copies strip rows into a shared-memory ring with cp.async (.cg: L2,
 * never a stale L1 line), in the match ring's commit groups (BandHalo). */
constexpr int kStrip = 5;      // floats per strip row between launches
constexpr int kWaveStrip = 8;  // floats per strip row between clusters
                               // (A, GA, GB, carry, u, pad: two 16-byte
                               // copies) and per slot of the strip ring

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a wait on the left cluster longer than this means a plan whose clusters
// are not all resident: the launch traps (an error the wrapper raises)
// rather than hang the card
constexpr unsigned long long kWaitLimitNs = 20000000000ull;

/* The edge of a band whose neighbours are other launches' bands: the left
 * one's strip, rows r0 .. r0 + nr, and this band's.  Thread 0 copies
 * strip row q + 1 (what row q of the launch receives) into a ring of
 * kRing slots in shared memory with cp.async as the match row q is copied
 * ahead, in the same commit group; its wait on that group and the row's
 * barrier make the slot visible to every thread, so the receive on the
 * row's dependent chain is a shared-memory read.  A slot is written again
 * kRing rows later, two barriers after every thread has read it. */
template <int CH>
struct StripHalo {
  static constexpr int kRing = RowCfg<CH>::kStages + 1;
  static constexpr int kRingFloats = kRing * kWaveStrip;  // 16-byte multiple
  const float* in;  // the left band's strip; nullptr: none (the first band)
  float* out;       // this band's strip (written by the band's last
                    // thread); nullptr: none
  float* ring;      // [kRing][kWaveStrip] in shared memory
  int r0;

  __device__ __forceinline__ void prefetch(int q) const {
    if (in != nullptr && threadIdx.x == 0) {
      const float* e = in + (size_t)(q + 1) * kStrip;
      float* d = ring + (q % kRing) * kWaveStrip;
#pragma unroll
      for (int i = 0; i < kStrip; i++) copy_float_async(d + i, e + i);
    }
  }

  __device__ __forceinline__ Halo receive(int r, int) const {
    if (in == nullptr) return Halo{-INFINITY, KT_NEG, KT_NEG, KT_NEG, KT_NEG};
    const float* h = ring + ((r - r0) % kRing) * kWaveStrip;
    return Halo{h[3], h[4], h[0], h[1], h[2]};
  }

  __device__ __forceinline__ void send(int r, float A, float GA, float GB,
                                       float cm, float u) const {
    if (out == nullptr) return;
    float* o = out + (size_t)(r - r0 + 1) * kStrip;
    o[0] = A;
    o[1] = GA;
    o[2] = GB;
    o[3] = cm;
    o[4] = u;
  }
};

/* The edge of a block of a band of one or more clusters (the mesh's
 * bands; the row kernel's wave, a band of a whole row).  Inside a cluster
 * the blocks pass the halo on through distributed shared memory
 * (ClusterHalo; rows counted from the launch's first); the block holding
 * the band's first column takes the left band's strip, the one holding
 * its last column writes this band's (StripHalo; none on the row
 * kernel's wave); between clusters the first block of a cluster past the
 * first polls the left cluster's row counter and copies its strip rows
 * into the ring (wave_in), the last block of a cluster before the last
 * writes its strip and publishes it (wave_out).  A block reads at most
 * one strip, so one ring serves both. */
template <int CH>
struct BandHalo {
  static constexpr bool kBands = true;
  ClusterHalo cl;
  StripHalo<CH> st;
  const float* wave_in;      // the left cluster's strip (nullptr: none)
  const unsigned* in_ready;  // its counter
  float* wave_out;           // this cluster's (nullptr: none)
  unsigned* out_ready;
  int nr, every;
  unsigned seen;             // rows of wave_in known to be published

  // every block has loaded its start state and its barriers exist
  __device__ __forceinline__ void start() { cg::this_cluster().sync(); }

  __device__ __forceinline__ void prefetch(int q) {
    if (wave_in == nullptr) {
      st.prefetch(q);
      return;
    }
    if (threadIdx.x != 0) return;
    const unsigned need = (unsigned)(st.r0 + q + 1);
    if (seen < need) {
      const unsigned long long t0 = global_ns();
      while ((seen = ld_acquire(in_ready)) < need)
        if (global_ns() - t0 > kWaitLimitNs) __trap();
    }
    copy_chunk_async<8>(st.ring + (q % StripHalo<CH>::kRing) * kWaveStrip,
                        wave_in + (size_t)q * kWaveStrip);
  }

  __device__ __forceinline__ Halo receive(int r, int t) const {
    if (cl.rank > 0) return cl.receive(r - st.r0, t);
    if (wave_in == nullptr) return st.receive(r, t);
    const float* h =
        st.ring + ((r - st.r0) % StripHalo<CH>::kRing) * kWaveStrip;
    return Halo{h[3], h[4], h[0], h[1], h[2]};
  }

  __device__ __forceinline__ void send(int r, float A, float GA, float GB,
                                       float cm, float u) const {
    if (cl.rank + 1 < cl.S) {
      cl.send(r - st.r0, A, GA, GB, cm, u);
    } else if (wave_out == nullptr) {
      st.send(r, A, GA, GB, cm, u);
    } else {
      const int q = r - st.r0;
      float4* o = reinterpret_cast<float4*>(wave_out + (size_t)q * kWaveStrip);
      o[0] = make_float4(A, GA, GB, cm);
      o[1] = make_float4(u, 0.0f, 0.0f, 0.0f);
      if ((q + 1) % every == 0 || q + 1 == nr)
        st_release(out_ready, (unsigned)(r + 1));
    }
  }
};

/* Block `rank` of cluster c of `clusters` (S blocks each) of a band: its
 * edge (the barriers initialised by thread 0), the strip ring after the
 * cluster's halo header in smem; strip_in the left band's strip (nullptr
 * where there is none), strip_out this band's (nullptr: none), the
 * clusters' strips [clusters][R][kWaveStrip] in wstrip and their counters
 * in ready; launch rows r0 .. r0 + nr - 1, published every `every`. */
template <int CH>
__device__ __forceinline__ BandHalo<CH> band_halo(
    float* smem, unsigned rank, unsigned S, int c, int clusters,
    const float* strip_in, float* strip_out, float* wstrip, unsigned* ready,
    int R, int r0, int nr, int every) {
  BandHalo<CH> edge;
  edge.cl = cluster_halo(smem, rank, S, nr);
  const bool left = rank == 0 && c == 0;
  edge.st = StripHalo<CH>{left ? strip_in : nullptr, strip_out,
                          smem + kClusterHeader / 4, r0};
  const bool has_in = rank == 0 && c > 0;
  const bool has_out = rank + 1 == S && c + 1 < clusters;
  const size_t R8 = (size_t)R * kWaveStrip;
  edge.wave_in = has_in ? wstrip + (size_t)(c - 1) * R8 : nullptr;
  edge.in_ready = has_in ? ready + c - 1 : nullptr;
  edge.wave_out = has_out ? wstrip + (size_t)c * R8 : nullptr;
  edge.out_ready = has_out ? ready + c : nullptr;
  edge.nr = nr;
  edge.every = every;
  edge.seen = 0;
  return edge;
}

/* Shared memory of a block of `threads` threads of CH columns: four
 * invariant vectors and the match ring over its columns, the warp slots;
 * a cluster's block has the halo header ahead of them. */
template <int CH>
size_t smem_bytes(int threads) {
  return ((size_t)(4 + RowCfg<CH>::kStages) * threads * CH +
          (size_t)2 * (threads / 32) * kSlot) * sizeof(float);
}

template <int CH>
size_t cluster_smem_bytes(int threads) {
  return kClusterHeader + smem_bytes<CH>(threads);
}

constexpr int kMaxClusterBlocks = 16;

template <int CH>
bool cluster_plan_ok(int threads, int blocks) {
  return threads > 0 && threads % 32 == 0 &&
         threads <= RowCfg<CH>::kMaxThreads && blocks >= 1 &&
         blocks <= kMaxClusterBlocks;
}

/* A wavefront's blocks (csrc/gotoh_row_wave.cu, gotoh_mesh.cu's wave
 * route): at most kWaveMaxThreads threads (at 8 columns a thread the row
 * kernel's 896 would cap a thread at 72 registers, and the body spills
 * there); shared memory: the cluster's halo header, the strip ring (a
 * slot per match row of the ring and one more), then smem_bytes. */
constexpr int kWaveMaxThreads = 512;

template <int CH>
size_t wave_smem_bytes(int threads) {
  return kClusterHeader + StripHalo<CH>::kRingFloats * sizeof(float) +
         smem_bytes<CH>(threads);
}

template <int CH>
bool wave_plan_ok(int threads, int blocks) {
  return cluster_plan_ok<CH>(threads, blocks) && threads <= kWaveMaxThreads;
}

/* A cluster kernel's attributes for blocks of `smem` bytes of dynamic
 * shared memory in clusters of `blocks` (past the portable 8). */
template <class Kernel>
cudaError_t cluster_attributes(Kernel kernel, size_t smem, int blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && blocks > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

/* A launch configuration of grid `grid` and clusters of `blocks`; attr
 * must outlive it. */
inline cudaLaunchConfig_t cluster_launch_config(int threads, int blocks,
                                                unsigned grid, size_t smem,
                                                cudaStream_t stream,
                                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

/* cudaOccupancyMaxActiveClusters of a cluster kernel's plan into *out. */
template <class Kernel>
int cluster_occupancy(Kernel kernel, int threads, int blocks, size_t smem,
                      int* out) {
  *out = 0;
  cudaError_t err = cluster_attributes(kernel, smem, blocks);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_launch_config(
      threads, blocks, (unsigned)blocks, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace

#endif
