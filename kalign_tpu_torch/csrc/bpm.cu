/* Batched Myers bit-parallel edit distance (anchor distances).
 *
 * Replaces kalign_tpu/tpu/bpm_pallas.py::_kernel (bpm_batch_pallas).
 * Same function as the reference's blocked 64-bit kernel
 * (lib/src/bpm.c:356-580, native kt_bpm_block): patterns of up to 1024
 * symbols in 64-bit blocks, text padded with W = 64*b_max - m symbols
 * of code 0, the adaptive active-block window (grow into block y+1 when
 * the band may improve, retract while the bottom block is hopeless),
 * and the minimum score over the bottom row.
 *
 * Bound: integer operations.  Each text symbol costs ~25 32-bit integer
 * operations per live block (a 64-bit block step on lo/hi words, with
 * 3-input logic and add with carry; chip_smoke.BPM_OPS_PER_BLOCK_STEP);
 * the bytes (one text byte per step, a pattern's match masks once) are
 * far below that at the card's rates.  Design, so that the card spends
 * its time on those operations and waits on nothing else:
 *   - one thread per (text, pattern) pair, a block is one uint64_t (the
 *     TPU kernel splits it into u32 lo/hi pairs with an explicit carry);
 *   - the kernel is instantiated per block count NB (1..16) and its
 *     block loop is unrolled, each block predicated on b <= y, so the
 *     pair's state (vp, vn, score of every block) stays in registers
 *     (-Xptxas -v: no stack frame); the window's grow and retract (an
 *     ascending pass, as bpm_pallas.py:182-191) pick blocks by masks,
 *     taken only when the window is not full or its bottom block is
 *     hopeless;
 *   - the match masks come from one table per sequence, peq_table_kernel
 *     below ([N, 13, NB], in L2), read through pat_idx; the masks of the
 *     next step's symbol are loaded one step ahead, so no load sits on
 *     the chain (the table kernel's own design is in its note);
 *   - the text comes in 16-byte loads, one chunk ahead (rows padded to a
 *     multiple of 16 bytes), symbols past n read as 0.
 */
#include "kt_cuda.h"

namespace {

constexpr int kSigma = 13;
constexpr int kMaxBlocks = 16;
constexpr int kWord = 64;
constexpr int kThreads = 256;   // pairs per block (gpu/bpm.py::THREADS)
constexpr int kTableThreads = 256;  // 8 warps: 8 words of a table a block
constexpr unsigned kFull = 0xffffffffu;

/* The horizontal delta out of a block: +1 (p) or -1 (n), never both. */
struct Carry {
  uint32_t p, n;
};

__device__ __forceinline__ Carry block_step(uint64_t eq, uint64_t& vp,
                                            uint64_t& vn, Carry in) {
  const uint64_t pv = vp;
  const uint64_t mv = vn;
  const uint64_t xv = eq | mv;
  const uint64_t q = eq | in.n;
  const uint64_t xh = (((q & pv) + pv) ^ pv) | q;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  const Carry out{(uint32_t)(ph >> 63), (uint32_t)(mh >> 63)};
  ph = (ph << 1) | in.p;
  mh = (mh << 1) | in.n;
  vp = mh | ~(xv | ph);
  vn = ph & xv;
  return out;
}

__device__ __forceinline__ int delta(Carry h) { return (int)h.p - (int)h.n; }

/* all ones where cond holds, else 0 */
__device__ __forceinline__ uint64_t pick64(bool cond) {
  return 0ULL - (uint64_t)cond;
}

__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int keep) {
  return keep >= 4 ? w : keep <= 0 ? 0u : w & ((1u << (8 * keep)) - 1u);
}

/* 16 text symbols from position 16*k; those at or past n read as 0. */
__device__ __forceinline__ uint4 text_chunk(const uint4* text, int k, int n) {
  const int left = n - 16 * k;
  if (left <= 0) return make_uint4(0, 0, 0, 0);
  uint4 v = __ldg(text + k);
  if (left < 16) {
    v.x = keep_bytes(v.x, left);
    v.y = keep_bytes(v.y, left - 4);
    v.z = keep_bytes(v.z, left - 8);
    v.w = keep_bytes(v.w, left - 12);
  }
  return v;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ int byte_of(uint32_t w, int s) {
  return (int)__byte_perm(w, 0, 0x4440 | s);
}

template <int NB>
__device__ __forceinline__ void load_masks(const uint64_t* __restrict__ tab,
                                           int c, uint64_t (&eq)[NB]) {
  const unsigned long long* row =
      reinterpret_cast<const unsigned long long*>(tab) + c * NB;
#pragma unroll
  for (int b = 0; b < NB; b++) eq[b] = __ldg(row + b);
}

/* One pair's DP state, kept in registers (every index compile-time). */
template <int NB>
struct Pair {
  uint64_t vp[NB], vn[NB];
  int score[NB];
  int y, b_max, maxd, best;

  __device__ __forceinline__ void init(int m) {
    b_max = (m == 0) ? 1 : (m + kWord - 1) / kWord;
    maxd = m;
    best = m;
    y = b_max - 1;
#pragma unroll
    for (int b = 0; b < NB; b++) {
      vp[b] = ~0ULL;
      vn[b] = 0;
      score[b] = (b + 1) * kWord;
    }
  }

  /* One text symbol whose masks are eq (bpm.c:470-567). */
  __device__ __forceinline__ void step(const uint64_t (&eq)[NB]) {
    Carry h{0, 0};
    int scy = 0;
#pragma unroll
    for (int b = 0; b < NB; b++) {
      if (b == 0 || b <= y) {
        h = block_step(eq[b], vp[b], vn[b], h);
        score[b] += delta(h);
        scy = score[b];
      }
    }
    if (y < b_max - 1 || scy >= maxd + kWord) scy = window(eq, h, scy);
    best = min(best, scy);
  }

  /* The adaptive window after a step whose bottom block y gave carry h
   * and score scy; returns the new bottom block's score.  Blocks are
   * picked by masks, never by an index that depends on y: a branch on
   * b == y + 1 lets the compiler index the arrays by y + 1, and arrays
   * indexed at run time live in local memory. */
  __device__ __forceinline__ int window(const uint64_t (&eq)[NB], Carry h,
                                        int scy) {
    const int hv = delta(h);
    const int yg = y + 1;
    if (scy - hv <= maxd && yg < b_max) {
      uint64_t e = 0;
#pragma unroll
      for (int b = 1; b < NB; b++) e |= eq[b] & pick64(b == yg);
      if ((e & 1ULL) || h.n) {
        uint64_t gp = ~0ULL, gn = 0;
        const int gs = scy + kWord - hv + delta(block_step(e, gp, gn, h));
#pragma unroll
        for (int b = 1; b < NB; b++) {
          const uint64_t here = pick64(b == yg);
          vp[b] = (vp[b] & ~here) | (gp & here);
          vn[b] = (vn[b] & ~here) | (gn & here);
          score[b] += (gs - score[b]) & (int)here;
        }
        y = yg;
        return gs;
      }
    }
    /* retract: the largest b <= y whose score is below maxd + 64, else 0 */
    int yn = 0;
#pragma unroll
    for (int b = 1; b < NB; b++)
      yn = (b <= y && score[b] < maxd + kWord) ? b : yn;
    y = yn;
    int s = 0;
#pragma unroll
    for (int b = 0; b < NB; b++) s |= score[b] & (int)pick64(b == yn);
    return s;
  }
};

template <int NB>
__global__ void __launch_bounds__(kThreads)
bpm_kernel(const uint8_t* __restrict__ tok, int64_t tok_stride,
           const int32_t* __restrict__ text_idx,
           const int32_t* __restrict__ pat_idx,
           const int32_t* __restrict__ n_arr,
           const int32_t* __restrict__ m_arr,
           const uint64_t* __restrict__ table,   // [N, 13, NB]
           int P, int32_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int n = n_arr[p];
  const int m = min(m_arr[p], NB * kWord);
  Pair<NB> st;
  st.init(m);
  const int total = n + kWord * st.b_max - m;
  const uint4* text =
      reinterpret_cast<const uint4*>(tok + (size_t)text_idx[p] * tok_stride);
  const uint64_t* tab = table + (size_t)pat_idx[p] * kSigma * NB;

  /* step i reads symbol i: byte i%4 of word j = (i/4)%4 of chunk cur;
   * the masks of step i+1 load while step i computes */
  uint4 cur = text_chunk(text, 0, n);
  uint4 nxt = text_chunk(text, 1, n);
  int k_next = 2;
  uint64_t eqa[NB], eqb[NB];
  uint32_t w = cur.x;
  load_masks<NB>(tab, byte_of(w, 0), eqa);
  int i = 0;
  for (int j = 0; i < total;) {
    const uint32_t w1 = (j < 3) ? word_of(cur, j + 1) : nxt.x;
    load_masks<NB>(tab, byte_of(w, 1), eqb);
    st.step(eqa);
    if (++i == total) break;
    load_masks<NB>(tab, byte_of(w, 2), eqa);
    st.step(eqb);
    if (++i == total) break;
    load_masks<NB>(tab, byte_of(w, 3), eqb);
    st.step(eqa);
    if (++i == total) break;
    load_masks<NB>(tab, byte_of(w1, 0), eqa);
    st.step(eqb);
    ++i;
    w = w1;
    if (++j == 4) {
      j = 0;
      cur = nxt;
      nxt = text_chunk(text, k_next++, n);
    }
  }
  out[p] = st.best;
}

/* Match masks of every sequence: table[r, s, b] bit k set where position
 * 64*b + k of row r is symbol s or lies at or past m[r] (bpm.c:428-440);
 * positions past the row's width L read as symbol 0.
 *
 * Replaces kalign_tpu/tpu/bpm.py:51 build_peq, which kalign_tpu runs per
 * pair (XLA, not Pallas) to feed bpm_batch_pallas; here one table per
 * sequence.  Bound: device-memory bytes (each row's tokens up to 64 * nblk
 * read once, 13 * nblk words of 8 bytes written); at the paths' sizes
 * (2,000 to 80,000 words) what it takes is the launch and the warps'
 * latency (a launch of 128 rows x 16 words, 2,048 warps, takes 0.0027
 * ms on an H100, 27 times its bound; PERF.md).
 * Design: one warp per (row, 64-position word).  Lane l loads the bytes
 * at positions l and 32 + l (the word's 64 bytes in two coalesced reads;
 * 0 at or past L; the row length loaded beside them, not before).  Five
 * __ballot_sync per half word give the word's bit planes: bit k of each
 * code (k < 4) and "code >= 16"; lane s < 13 forms symbol s's mask as
 * the AND of the planes or their complements by the bits of s, ORs in
 * the bits at or past m and writes word (r, s, b).  A word costs the
 * warp 2 loads, 10 ballots, a dozen logic operations and one store,
 * where a thread per word (the earlier design) loaded the word's 64 bytes
 * 13 times over and assembled its 64 bits one by one.  Tried on an H100 and
 * slower at the paths' shapes: a ballot per symbol (26 a word), 4 words
 * a warp, a grid of 8 blocks an SM looping over the words (PERF.md). */
__global__ void __launch_bounds__(kTableThreads)
peq_table_kernel(const uint8_t* __restrict__ tok, int L,
                 const int32_t* __restrict__ m_arr, int N, int nblk,
                 uint64_t* __restrict__ table) {
  const int w =
      (int)(((long long)blockIdx.x * kTableThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= N * nblk) return;  // whole warps: w is the warp's
  const int b = w % nblk;
  const int r = w / nblk;
  const int m = __ldg(m_arr + r);
  const uint8_t* row = tok + (size_t)r * L + kWord * b;
  const int p0 = kWord * b + lane;
  const uint32_t c0 = p0 < L ? __ldg(row + lane) : 0u;
  const uint32_t c1 = p0 + 32 < L ? __ldg(row + 32 + lane) : 0u;
  // the planes of the word: bit k of each position's code, and code >= 16
  uint64_t plane[4];
#pragma unroll
  for (int k = 0; k < 4; k++)
    plane[k] = ((uint64_t)__ballot_sync(kFull, (c1 >> k) & 1u) << 32) |
               __ballot_sync(kFull, (c0 >> k) & 1u);
  const uint64_t high = ((uint64_t)__ballot_sync(kFull, c1 >= 16u) << 32) |
                        __ballot_sync(kFull, c0 >= 16u);
  if (lane < kSigma) {
    uint64_t eq = ~high;
#pragma unroll
    for (int k = 0; k < 4; k++) eq &= (lane >> k) & 1 ? plane[k] : ~plane[k];
    const int rest = m - kWord * b;
    const uint64_t beyond =
        rest <= 0 ? ~0ULL : rest >= kWord ? 0ULL : (~0ULL << rest);
    table[((size_t)r * kSigma + lane) * nblk + b] = eq | beyond;
  }
}

using BpmKernel = void (*)(const uint8_t*, int64_t, const int32_t*,
                           const int32_t*, const int32_t*, const int32_t*,
                           const uint64_t*, int, int32_t*);

template <int... NB>
struct Instantiations {
  static BpmKernel get(int nblk) {
    const BpmKernel k[] = {bpm_kernel<NB>...};
    return k[nblk - 1];
  }
};

}  // namespace

KT_EXPORT int kt_bpm_table(const uint8_t* tok, int L, const int32_t* m,
                           int N, int nblk, uint64_t* table, void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks || L % 16 != 0 ||
      (long long)N * nblk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)N * nblk;
  const int per_block = kTableThreads / 32;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  peq_table_kernel<<<(unsigned)blocks, kTableThreads, 0,
                     (cudaStream_t)stream>>>(tok, L, m, N, nblk, table);
  return (int)cudaGetLastError();
}

KT_EXPORT int kt_bpm_batch(const uint8_t* tok, int64_t tok_stride,
                           const int32_t* text_idx, const int32_t* pat_idx,
                           const int32_t* n, const int32_t* m,
                           const uint64_t* table, int P, int nblk,
                           int32_t* out, void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks || tok_stride % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const BpmKernel kernel = Instantiations<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                          12, 13, 14, 15, 16>::get(nblk);
  const int blocks = (P + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tok, tok_stride, text_idx, pat_idx, n, m, table, P, out);
  return (int)cudaGetLastError();
}
