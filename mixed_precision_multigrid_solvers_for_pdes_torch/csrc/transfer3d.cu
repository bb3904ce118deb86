// Kernels F and G: the fused 3D transfer pair of a multigrid cycle level.
//
// F, residual_restrict3d, replaces the Pallas residual_restrict3d of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/
// transfer3d.py (:194, kernel _rr3_kernel :80): fc = R(f - A u), 27-point
// full weighting (1,2,1)^3/64, coarse shell zero. _rr3_kernel masks the
// residual to fine unknowns; every fine node of an interior coarse node's
// window is one (2I-1 >= 1 and 2I+1 <= nf-2 for 1 <= I <= nc-2), so that
// mask is identically true here.
//
// G, prolong_correct3d, replaces the Pallas prolong_correct3d of the same
// file (:342, kernel _pc3_kernel :250): u <- u + P ec on fine interior nodes,
// P trilinear, in place.
//
// Both round every product and sum explicitly in the plain twins' order
// (ops/transfer3d.py): F sums a residual as residual7 does and the 27 terms
// in RESTRICT_TERMS order (centre, then the fine nodes with one, two and
// three odd offsets, weight 8 / 2^odd); G interpolates along z, then y, then
// x. So both equal their twins bit for bit.
//
// Bound: device memory bandwidth. F must read u and f once (8 bytes per fine
// node) and write fc; G must read and write u (8 bytes per fine node) and
// read ec. What bounds them in practice is below.
//
// Design of F, a plane stream in the image of kernel E (smooth3d.cu):
// - A block owns a kRrTileJ x kRrTileK tile of the coarse (J, K) interior
//   and a chunk of at most kRrMaxChunk coarse interior planes [I0, I1), and
//   marches along x. It holds rings of fine x-planes in shared memory over
//   the tile's window: u over fine rows 2*J0-2 .. 2*J0+2*kRrTileJ and
//   columns 2*K0-2 .. 2*K0+2*kRrTileK (the fine residual window plus one
//   node), f over the residual window, and a pair of fine residual planes.
// - Step I: u planes 2I+1, 2I+2 and f planes 2I, 2I+1 have landed (issued
//   kRrAhead steps earlier). The block computes fine residual planes 2I and
//   2I+1 over its window, each residual once; after a barrier each coarse
//   node of plane I sums its 27 residuals from planes 2I-1, 2I, 2I+1 and
//   stores. Residual plane 2I+1 serves coarse planes I and I+1: each coarse
//   node keeps its nine values of it in registers for the next step. Only
//   the window's edge rows and columns are computed by two tiles. A chunk
//   starts with a lead-in step I0 - 1 that computes residual plane 2I0-1.
// - A thread computes the residuals of a strip of rows of one window column
//   (kRrStrips strips to a column), walking down the strip with its u
//   values in registers: a residual reads its y neighbours and, across
//   steps, its x neighbours from registers, and only its z neighbours, its
//   new u planes and f from shared memory (~4.5 shared reads a residual,
//   where 7 u and 1 f each would be 8).
// - Loads: 4-byte cp.async (the rows are unpadded), coalesced along z,
//   zero-filled outside the field; roughly one load per fine node, where the
//   one-thread-per-coarse-node kernel this replaces made 216 scattered
//   stride-2 loads per coarse node (each fine residual ~3.4 times).
// - Shared-memory layout: each window row keeps its even-z and odd-z nodes in
//   two halves, so a warp's 32 residual columns of one row's half, their
//   neighbour sets, and a warp's 32 coarse nodes' terms are consecutive
//   words: no bank conflicts (the last odd column of every strip goes to a
//   ninth warp).
// - What bounds it on the H100 is not DRAM, nor occupancy: timed alone, the
//   loads take ~70% and the compute ~60% of the whole, and they overlap
//   only in part. At 96 registers two blocks (18 warps) share a
//   multiprocessor; three blocks at 72 registers without spills (load
//   offsets packed) ran no faster, and smaller tiles at more blocks spilled.
//   A second barrier per step (the residuals, then the restriction of the
//   same step) was faster than one barrier with the restriction a step
//   behind. Short x-chunks keep the blocks of a wave within a few planes of
//   each other, which the loads gain by (PERF.md §6).
//
// Storage of F: u and f are fp32 or bf16 (one type for both, the level's)
// and fc is written fp32 or bf16 (the coarse level's), each selected by a
// flag of mg_residual_restrict3d. The rings are fp32 whatever the storage.
// A bf16 field's rows cannot come in node by node: cp.async has no 2-byte
// copy, and a bf16 row starts anywhere in a 16-byte word (common.cuh, "bf16
// rows ... as 4-byte words" and "16-byte rows"). So a bf16 window row comes
// in as the kRrChunkRow aligned 16-byte chunks that hold it, by cp.async.cg
// (L1 bypassed) into staging rings (kRrStageBytes per block), kRrStageAhead
// = 2 steps ahead where fp32 planes go one. Each thread waits for its
// copies of step I's planes before step I - 1's second barrier, and after
// the restriction widens its pairs of words of those rows, read at a word
// offset taken from each row's address, into their four nodes (0 outside
// the field) in the fp32 rings, before step I's first barrier. Nothing is
// held in registers across a step. Staged as 4-byte word pairs, each
// thread copying the words it widens, F took 0.94 ms on a bf16 513^3 call;
// as 16-byte chunks, a quarter of the copies, 0.71 (PERF.md §6). The
// residuals and the restriction are fp32, and fc is rounded once, where it
// is stored.
//
// Design of G, a stream of fine row pairs:
// - A thread takes one interior k of fine rows 2J and 2J+1 and kPcSteps
//   coarse x-steps I (fine planes 2I and 2I+1 each); blockIdx.y is J,
//   blockIdx.z the group of steps. It issues all its 4 * kPcSteps u loads
//   first, then forms the z interpolants of coarse rows J and J+1 of each
//   coarse plane once, the y-z interpolants Pyz at rows 2J and 2J+1 from
//   them (z first, then y), and adds Pyz(I) to plane 2I and
//   half_sum(Pyz(I), Pyz(I+1)) to plane 2I+1: the twin's z, y, x order.
//   Coarse plane I+1's interpolants serve the next step too. Row 0 and
//   plane 0 are the shell and are left alone.
// - What bounded the one-thread-per-fine-node kernel this replaces: its ec
//   reads (3.375 scalar loads per fine node, through L1 and L2) and one
//   4-byte u load in flight per thread. Here a fine node costs ~1.1 ec
//   loads, coarse rows are not re-read across fine rows, and a thread has
//   eight u loads in flight (PERF.md §6).
// - Storage: ec and u are each fp32 or bf16 (mg_prolong_correct3d's
//   flags); both are widened on load, the interpolation and the sum are
//   fp32, and a bf16 u is rounded once per node, where it is stored.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

// The geometry below is this file's own; the CPU schedule test
// (tests/unit/test_torch_transfer3d_schedule.py) reads it from here.
// F:
constexpr int kRrTileJ = 8;        // coarse rows (J) of a tile
constexpr int kRrTileK = 32;       // coarse columns (K) of a tile
constexpr int kRrAhead = 1;        // steps whose plane loads are in flight
constexpr int kRrStrips = 4;       // row strips of a residual column
constexpr int kRrThreads = 288;    // a column strip each; the first
                                   // kRrTileJ * kRrTileK a coarse node too
constexpr int kRrBlocksPerSM = 2;
constexpr int kRrMinChunk = 4;     // fewest coarse planes of an x-chunk
constexpr int kRrMaxChunk = 32;    // most coarse planes of an x-chunk
constexpr int kRrRows = 2 * kRrTileJ + 3;  // u window rows
constexpr int kRrCols = 2 * kRrTileK + 3;  // u window columns
constexpr int kRrHalf = kRrTileK + 2;      // one parity half of a window row
constexpr int kRrPlane = kRrRows * 2 * kRrHalf;
// Rings: step I reads u planes 2I .. 2I+2 (plane 2I-1 is in registers), f
// planes 2I, 2I+1 and residual planes 2I, 2I+1 (2I-1 is in registers),
// while the loads of the next kRrAhead steps are in flight (issued after
// the step's first barrier, so no thread still reads an earlier step's
// planes).
constexpr int kRrRingU = 2 * kRrAhead + 3;
constexpr int kRrRingF = 2 * kRrAhead + 2;
constexpr int kRrRingR = 2;
constexpr int kRrBytes =
    (kRrRingU + kRrRingF + kRrRingR) * kRrPlane * (int)sizeof(float);
// G:
constexpr int kPcThreads = 256;    // threads of a block, one k each
constexpr int kPcSteps = 2;        // coarse x-steps a thread takes

// Residual window of a tile: fine rows 1 .. 2*kRrTileJ+1 of the u window,
// columns 1 .. 2*kRrTileK+1 (kRrTileK even ones, kRrTileK+1 odd ones).
constexpr int kRrResRows = 2 * kRrTileJ + 1;
constexpr int kRrStripRows = (kRrResRows + kRrStrips - 1) / kRrStrips;
constexpr int kRrMain = kRrStrips * 2 * kRrTileK;      // warps of 32 columns
constexpr int kRrItems = kRrMain + kRrStrips;          // + the last odd ones
constexpr int kRrLoadsU = (kRrRows * kRrCols + kRrThreads - 1) / kRrThreads;
constexpr int kRrLoadsF =
    (kRrResRows * (kRrCols - 2) + kRrThreads - 1) / kRrThreads;

// bf16 storage: a window row comes in as the aligned 16-byte chunks that
// hold it (common.cuh, "16-byte rows"), kRrChunkRow to a row (u rows
// 0 .. kRrRows - 1, f rows 1 .. kRrResRows), staged kRrStageAhead steps
// ahead: two u and two f planes a step, and the lead-in's west u plane. It
// is widened as pairs of 4-byte words (common.cuh), kRrPairRow to a row: a
// thread takes pair tid of each plane, and the pairs past kRrThreads are
// spread over other threads (kRrExtraU of each u plane, kRrExtraF of each f
// plane).
constexpr int kRrStageAhead = 2;
constexpr int kRrPairRow = (kRrCols + 4) / 4;       // 17 pairs of a row
constexpr int kRrPairsU = kRrRows * kRrPairRow;     // of a u plane
constexpr int kRrPairsF = kRrResRows * kRrPairRow;  // of an f plane
constexpr int kRrExtraU = kRrPairsU - kRrThreads;
constexpr int kRrExtraF = kRrPairsF - kRrThreads;
// a row's pairs start up to 3 words into its first chunk
constexpr int kRrChunkRow = (2 * kRrPairRow + 3 + 3) / 4;  // 10 chunks
constexpr int kRrStageRow = 4 * kRrChunkRow;               // words of a row
constexpr int kRrChunksU = kRrRows * kRrChunkRow;
constexpr int kRrChunksF = kRrResRows * kRrChunkRow;
constexpr int kRrStageU = 2 * kRrStageAhead + 1;  // staged u planes
constexpr int kRrStageF = 2 * kRrStageAhead;      // staged f planes
constexpr int kRrStageBytes =
    (kRrStageU * kRrRows + kRrStageF * kRrResRows) * kRrStageRow *
    (int)sizeof(unsigned);

static_assert(kRrItems <= kRrThreads && kRrTileJ * kRrTileK <= kRrThreads,
              "F takes a column strip and a coarse node a thread");
static_assert(kRrTileK % 32 == 0, "F's warps take 32 columns of one row");
static_assert((kRrBytes + kRrStageBytes) * kRrBlocksPerSM <= 227 * 1024,
              "F's rings (and bf16 staging) must fit kRrBlocksPerSM blocks "
              "on a multiprocessor");
static_assert(kRrExtraU >= 0 && kRrExtraF >= 0 &&
                  2 * (kRrExtraU + kRrExtraF) <= kRrThreads,
              "F's bf16 pairs: one of each plane a thread, and one more");
static_assert(kRrChunksU <= kRrThreads && kRrChunksF <= kRrThreads,
              "F's bf16 chunks: at most one of each plane a thread");

// Dynamic shared memory of an F launch on storage T.
template <class T>
constexpr int rr_bytes() {
  return kRrBytes + (std::is_same_v<T, bf16> ? kRrStageBytes : 0);
}

// Shared-memory word of window node (lj, lk).
__device__ __forceinline__ int rr_word(int lj, int lk) {
  return lj * 2 * kRrHalf + (lk & 1) * kRrHalf + (lk >> 1);
}

// f - (c*u - nb) with nb = w*W + e*E + s*S + n*N + b*B + t*T, left to right:
// residual7's rounding.
__device__ __forceinline__ float residual_of(float fv, float uc, float W,
                                             float E, float S, float N,
                                             float B, float T,
                                             const Stencil7& st) {
  float nb = __fmul_rn(st.w, W);
  nb = __fadd_rn(nb, __fmul_rn(st.e, E));
  nb = __fadd_rn(nb, __fmul_rn(st.s, S));
  nb = __fadd_rn(nb, __fmul_rn(st.n, N));
  nb = __fadd_rn(nb, __fmul_rn(st.b, B));
  nb = __fadd_rn(nb, __fmul_rn(st.t, T));
  return __fsub_rn(fv, __fsub_rn(__fmul_rn(st.c, uc), nb));
}

// Adds the terms of parity pattern P = (px, py, pz) (bits 2, 1, 0) to acc,
// weight 8 / 2^#odd; on the odd axes the offsets run over (+1, -1)^#odd,
// first axis slowest. A term of residual plane 2I-1 comes from rw, of 2I
// from r1, of 2I+1 from r2 (and goes to rn for the next step); rw and rn
// are indexed by (dy + 1) * 3 + dz + 1, and a z offset of +1 / -1 is the odd
// half's word m / m - 1.
template <int P>
__device__ __forceinline__ void restrict_pattern(float& acc, const float* r1,
                                                 const float* r2, int centre,
                                                 const float* rw, float* rn) {
  constexpr int px = (P >> 2) & 1, py = (P >> 1) & 1, pz = P & 1;
  constexpr int nodd = px + py + pz;
  constexpr float wgt = (float)(8 >> nodd);
#pragma unroll
  for (int sgn = 0; sgn < (1 << nodd); ++sgn) {
    int bit = nodd - 1, dx = 0, dy = 0, dz = 0;
    if (px) dx = ((sgn >> bit--) & 1) ? -1 : 1;
    if (py) dy = ((sgn >> bit--) & 1) ? -1 : 1;
    if (pz) dz = ((sgn >> bit) & 1) ? -1 : 1;
    const int idx = (dy + 1) * 3 + dz + 1;
    const int w = centre + dy * 2 * kRrHalf + (dz == 0 ? 0 : kRrHalf) -
                  (dz < 0 ? 1 : 0);
    float v;
    if (dx < 0) {
      v = rw[idx];
    } else if (dx == 0) {
      v = r1[w];
    } else {
      v = r2[w];
      rn[idx] = v;
    }
    acc = __fadd_rn(acc, __fmul_rn(wgt, v));
  }
}

template <class T, class TO>
__global__ void __launch_bounds__(kRrThreads, kRrBlocksPerSM)
    residual_restrict3d_kernel(const T* __restrict__ u,
                               const T* __restrict__ f,
                               TO* __restrict__ fc, int nyf, int nzf,
                               int ncx, int ncy, int ncz, int chunk,
                               Stencil7 st) {
  constexpr bool kBf = std::is_same_v<T, bf16>;
  constexpr int kAheadT = kBf ? kRrStageAhead : kRrAhead;  // steps in flight
  constexpr int R = kRrStripRows, nj = 2 * kRrHalf;
  extern __shared__ float sm[];
  float* us = sm;                              // kRrRingU u planes
  float* fs = us + kRrRingU * kRrPlane;        // kRrRingF f planes
  float* r1 = fs + kRrRingF * kRrPlane;        // residual plane 2I
  float* r2 = r1 + kRrPlane;                   // residual plane 2I + 1
  // bf16: kRrStageU staged u planes, then kRrStageF f planes
  unsigned* ust = reinterpret_cast<unsigned*>(r2 + kRrPlane);
  unsigned* fst = ust + kRrStageU * kRrRows * kRrStageRow;
  const int tid = threadIdx.x;
  const int J0 = 1 + blockIdx.y * kRrTileJ, K0 = 1 + blockIdx.x * kRrTileK;
  const int I0 = 1 + blockIdx.z * chunk, I1 = min(I0 + chunk, ncx - 1);
  const int fj0 = 2 * J0 - 2, fk0 = 2 * K0 - 2;  // the window's fine origin
  const long sx = (long)nyf * nzf, total = (long)(2 * ncx - 1) * sx;

  // This thread's window nodes to load: shared word and in-plane offset in
  // the field (-1 outside it); the same in every plane.
  int lu_s[kRrLoadsU], lu_g[kRrLoadsU], lf_s[kRrLoadsF], lf_g[kRrLoadsF];
#pragma unroll
  for (int r = 0; r < kRrLoadsU; ++r) {
    const int t = tid + r * kRrThreads;
    const int lj = t / kRrCols, lk = t - lj * kRrCols;
    const int j = fj0 + lj, k = fk0 + lk;
    lu_s[r] = t < kRrRows * kRrCols ? rr_word(lj, lk) : -1;
    lu_g[r] = j < nyf && k < nzf ? j * nzf + k : -1;
  }
#pragma unroll
  for (int r = 0; r < kRrLoadsF; ++r) {
    const int t = tid + r * kRrThreads;
    const int lj = 1 + t / (kRrCols - 2), lk = 1 + t % (kRrCols - 2);
    const int j = fj0 + lj, k = fk0 + lk;
    lf_s[r] = t < kRrResRows * (kRrCols - 2) ? rr_word(lj, lk) : -1;
    lf_g[r] = j < nyf && k < nzf ? j * nzf + k : -1;
  }
  // bf16: pair t of a u plane (window row t / kRrPairRow) or of an f plane
  // (row 1 + t / kRrPairRow); this thread's pair tid of each, and its extra
  // pair xp of plane kind xk (0, 1: the first and second u plane of a step,
  // 2, 3: the f planes; -1 none). Bit 31 of a pair's flags: m is odd.
  auto pair = [&](int t, bool f_plane, int pairs) {
    const int r = t / kRrPairRow, m = t % kRrPairRow;
    const int lj = r + f_plane, j = fj0 + lj;
    BfPair p = bf_pair(t < pairs, j < nyf, j * nzf + fk0, fk0, nzf, sx, m,
                       kRrHalf, lj * 2 * kRrHalf + 2 * m,
                       r * kRrStageRow + 2 * m);
    p.fl = (int)((unsigned)p.fl | (unsigned)(m & 1) << 31);
    return p;
  };
  const BfPair pu1 = pair(tid, false, kRrPairsU);
  const BfPair pf1 = pair(tid, true, kRrPairsF);
  int xk = -1, xt = 0;
  if (tid < 2 * kRrExtraU) {
    xk = tid / kRrExtraU;
    xt = kRrThreads + tid % kRrExtraU;
  } else if (tid < 2 * (kRrExtraU + kRrExtraF)) {
    xk = 2 + (tid - 2 * kRrExtraU) / kRrExtraF;
    xt = kRrThreads + (tid - 2 * kRrExtraU) % kRrExtraF;
  }
  const BfPair px = pair(xt, xk >= 2, xk < 0 ? 0 : xk < 2 ? kRrPairsU
                                                          : kRrPairsF);
  // bf16: this thread's chunk of a u plane (t = tid) and of an f plane
  // (t = kRrThreads - 1 - tid): its row's in-plane offset (kNoRow: a row
  // outside the field, or no chunk), and the chunk index (bits 0..3), a
  // flag that it may reach outside the field in its first or last plane
  // (bit 4) and its first staging word (bits 5..)
  auto chunk_of = [&](int t, bool f_plane, int chunks, int& g, int& c) {
    const int r = t / kRrChunkRow, k = t % kRrChunkRow;
    const int j = fj0 + r + f_plane;
    g = t < chunks && j < nyf ? j * nzf + fk0 : kNoRow;
    const bool end = g + 8 * k < 7 || g + 8 * k + 8 > sx;
    c = k | (end ? 16 : 0) | (r * kRrStageRow + 4 * k) << 5;
  };
  int cu_g, cu_c, cf_g, cf_c;
  chunk_of(tid, false, kRrChunksU, cu_g, cu_c);
  chunk_of(kRrThreads - 1 - tid, true, kRrChunksF, cf_g, cf_c);
  // element address of each field's node 0, modulo 8 (the view's offset
  // too): a row's word offset in its first chunk and its parity
  const int pu = (int)((reinterpret_cast<uintptr_t>(u) >> 1) & 7);
  const int pf = (int)((reinterpret_cast<uintptr_t>(f) >> 1) & 7);
  // bf16: plane q of a field (its rings and staging rings of nr and ns
  // planes of `words`, address p0 modulo 8, pair tid's p1, its chunk cg, cc,
  // and the extra pair where xk is the plane's kind): its chunks into the
  // staging slot, or its pairs from it into the ring (widen)
  auto bf16_plane = [&](const T* field, int p0, BfPair p1, int cg, int cc,
                   float* ring, int nr, unsigned* stage, int ns, int words,
                   int q, int kind, bool widen) {
    if constexpr (kBf) {
      unsigned* stq = stage + (q % ns) * words;
      const int p8 = (p0 + (int)(q * sx & 7)) & 7;
      if (!widen) {
        bf_chunk_issue(cg, cc & 15, cc & 16, field, q * sx, total,
                       stq + (cc >> 5));
        return;
      }
      float* d = ring + (q % nr) * kRrPlane;
      auto one = [&](BfPair p) {  // at its row's word offset
        const int off = (((p8 + p.g) & 7) ^ ((unsigned)p.fl >> 29 & 4)) >> 1;
        bf_pair_widen<false>(p, p8 & 1, stq + off, d, kRrHalf);
      };
      one(p1);
      if (xk == kind) one(px);
    }
  };
  // step I's planes: u planes 2I + 1, 2I + 2 (kinds 0, 1), f planes 2I,
  // 2I + 1 (kinds 2, 3), and in the lead-in step u plane 2I
  auto bf16_step = [&](int I, bool widen) {
    auto u_plane = [&](int q, int kind) {
      bf16_plane(u, pu, pu1, cu_g, cu_c, us, kRrRingU, ust, kRrStageU,
            kRrRows * kRrStageRow, q, kind, widen);
    };
    auto f_plane = [&](int q, int kind) {
      bf16_plane(f, pf, pf1, cf_g, cf_c, fs, kRrRingF, fst, kRrStageF,
            kRrResRows * kRrStageRow, q, kind, widen);
    };
    if (I < I0) u_plane(2 * I, 0);
    u_plane(2 * I + 1, 0);
    u_plane(2 * I + 2, 1);
    f_plane(2 * I, 2);
    f_plane(2 * I + 1, 3);
  };
  // fp32: plane q of u or f into its ring
  auto load_u = [&](int q) {
    if constexpr (!kBf) {
      float* d = us + (q % kRrRingU) * kRrPlane;
      const T* g = u + q * sx;
#pragma unroll
      for (int r = 0; r < kRrLoadsU; ++r)
        if (lu_s[r] >= 0)
          cp_async4(d + lu_s[r], g + max(lu_g[r], 0), lu_g[r] >= 0);
    }
  };
  auto load_f = [&](int q) {
    if constexpr (!kBf) {
      float* d = fs + (q % kRrRingF) * kRrPlane;
      const T* g = f + q * sx;
#pragma unroll
      for (int r = 0; r < kRrLoadsF; ++r)
        if (lf_s[r] >= 0)
          cp_async4(d + lf_s[r], g + max(lf_g[r], 0), lf_g[r] >= 0);
    }
  };
  // step I's planes (one commit group; empty past the chunk's last step)
  auto issue = [&](int I) {
    if (I < I1) {
      if constexpr (kBf) {
        bf16_step(I, false);
      } else {
        load_u(2 * I + 1);
        load_u(2 * I + 2);
        load_f(2 * I);
        load_f(2 * I + 1);
      }
    }
    cp_async_commit();
  };
  // bf16: step I's staged planes (and, for the lead-in step, its west u
  // plane) widened into the rings at the end of step I - 1. A chunk is
  // copied by one thread and its pairs widened by others, so each thread
  // waits for its copies of step I (issued kAheadT - 1 commit groups
  // before) ahead of step I - 1's second barrier (land), which makes them
  // visible to all; no thread reads those ring slots before step I's first
  // barrier.
  auto land = [&]() {
    if constexpr (kBf) cp_async_wait<kAheadT - 1>();
  };
  auto settle = [&](int I) {
    if constexpr (kBf) {
      if (I < I1) bf16_step(I, true);
    }
  };

  // This thread's residual strip: n rows from window row `top` of one
  // column (parity half h, word m): shared word of its first row and the
  // offset of a node's z - 1 neighbour (n = 0: none).
  int first, kd, n;
  {
    int s, h, m;
    if (tid < kRrMain) {
      const int w = tid % (2 * kRrTileK);
      s = tid / (2 * kRrTileK);
      h = w / kRrTileK;
      m = w % kRrTileK + 1 - h;
    } else {
      s = min(tid - kRrMain, kRrStrips - 1);
      h = 1;
      m = kRrTileK;
    }
    const int top = 1 + s * kRrResRows / kRrStrips;
    n = tid < kRrItems ? 1 + (s + 1) * kRrResRows / kRrStrips - top : 0;
    first = top * nj + h * kRrHalf + m;
    kd = h ? -kRrHalf : kRrHalf - 1;
  }
  // The strip's u column: rows top-1 .. top+n of plane 2I (cb) and rows
  // top .. top+n-1 of plane 2I-1 (ca), carried from step to step.
  float ca[R], cb[R + 2];

  // This thread's coarse node, its centre word in the residual planes, and
  // its nine values of residual plane 2I-1.
  const int J = J0 + tid / kRrTileK, K = K0 + tid % kRrTileK;
  const bool mine = tid < kRrTileJ * kRrTileK && J <= ncy - 2 && K <= ncz - 2;
  const int centre = rr_word(2 * (J - J0) + 2, 2 * (K - K0) + 2);
  float rw[9];
  int jlo, jhi, klo, khi;
  tile_span(blockIdx.y, kRrTileJ, ncy, &jlo, &jhi);
  tile_span(blockIdx.x, kRrTileK, ncz, &klo, &khi);
  const bool edge = jlo == 0 || jhi == ncy || klo == 0 || khi == ncz;
  // zero this tile's span of plane I: all of it, or its shell nodes
  auto zero_span = [&](int I, bool all) {
    const int cols = khi - klo, nodes = (jhi - jlo) * cols;
    for (int t = tid; t < nodes; t += kRrThreads) {
      const int j = jlo + t / cols, k = klo + t % cols;
      if (all || j == 0 || j == ncy - 1 || k == 0 || k == ncz - 1)
        store_f(fc + ((long)I * ncy + j) * ncz + k, 0.0f);
    }
  };
  if (I0 == 1) zero_span(0, true);

  if constexpr (kBf) {  // the words no pair writes stay 0
    zero_rings(sm, (kRrRingU + kRrRingF) * kRrPlane, kRrThreads);
    __syncthreads();
  }
  // the lead-in's west plane, in the first group (bf16: in bf16_step)
  if constexpr (!kBf) load_u(2 * I0 - 2);
  for (int d = 0; d < kAheadT; ++d) issue(I0 - 1 + d);
  if constexpr (kBf) {
    land();
    __syncthreads();
  }
  settle(I0 - 1);
  for (int I = I0 - 1; I < I1; ++I) {
    // step I's planes have landed (bf16: widened by settle(I))
    if constexpr (!kBf) cp_async_wait<kRrAhead - 1>();
    __syncthreads();
    issue(I + kAheadT);
    const bool lead = I < I0;  // computes residual plane 2I+1 alone
    const float* u1 = us + ((2 * I) % kRrRingU) * kRrPlane + first;
    const float* u2 = us + ((2 * I + 1) % kRrRingU) * kRrPlane + first;
    const float* u3 = us + ((2 * I + 2) % kRrRingU) * kRrPlane + first;
    const float* f1 = fs + ((2 * I) % kRrRingF) * kRrPlane + first;
    const float* f2 = fs + ((2 * I + 1) % kRrRingF) * kRrPlane + first;
    if (n > 0) {
      // rows top-1 .. top+n of planes 2I+1 (cc) and 2I+2 (cd)
      float cc[R + 2], cd[R + 2];
#pragma unroll
      for (int i = 0; i < R + 2; ++i) {
        if (i > n + 1) continue;
        if (lead) cb[i] = u1[(i - 1) * nj];
        cc[i] = u2[(i - 1) * nj];
        cd[i] = u3[(i - 1) * nj];
      }
#pragma unroll
      for (int i = 1; i <= R; ++i) {
        if (i > n) continue;
        const int o = (i - 1) * nj;
        if (!lead)
          r1[first + o] = residual_of(f1[o], cb[i], ca[i - 1], cc[i],
                                      cb[i - 1], cb[i + 1], u1[o + kd],
                                      u1[o + kd + 1], st);
        r2[first + o] = residual_of(f2[o], cc[i], cb[i], cd[i], cc[i - 1],
                                    cc[i + 1], u2[o + kd], u2[o + kd + 1],
                                    st);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) ca[i] = cc[i + 1];
#pragma unroll
      for (int i = 0; i < R + 2; ++i) cb[i] = cd[i];
    }
    land();  // this thread's copies of step I + 1
    __syncthreads();
    if (lead) {
      if (mine) {
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dz = -1; dz <= 1; ++dz)
            rw[(dy + 1) * 3 + dz + 1] =
                r2[centre + dy * nj + (dz == 0 ? 0 : kRrHalf) -
                   (dz < 0 ? 1 : 0)];
      }
      settle(I + 1);
      continue;
    }
    if (mine) {
      float rn[9];
      float acc = __fmul_rn(8.0f, r1[centre]);
      restrict_pattern<1>(acc, r1, r2, centre, rw, rn);
      restrict_pattern<2>(acc, r1, r2, centre, rw, rn);
      restrict_pattern<3>(acc, r1, r2, centre, rw, rn);
      restrict_pattern<4>(acc, r1, r2, centre, rw, rn);
      restrict_pattern<5>(acc, r1, r2, centre, rw, rn);
      restrict_pattern<6>(acc, r1, r2, centre, rw, rn);
      restrict_pattern<7>(acc, r1, r2, centre, rw, rn);
      store_f(fc + ((long)I * ncy + J) * ncz + K,
              __fmul_rn(acc, 1.0f / 64.0f));
#pragma unroll
      for (int i = 0; i < 9; ++i) rw[i] = rn[i];
    }
    if (edge) zero_span(I, false);
    settle(I + 1);
  }
  if (I1 == ncx - 1) zero_span(ncx - 1, true);
  cp_async_wait<0>();
}

// F's blocks the card holds at once (resident blocks per multiprocessor
// times multiprocessors), read once per device and storage; 0 if it cannot
// be read.
template <class T, class TO>
int rr_block_slots(int device) {
  static int slots[kMaxDevices] = {};
  if (slots[device] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, residual_restrict3d_kernel<T, TO>, kRrThreads,
            rr_bytes<T>()) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) == cudaSuccess)
      slots[device] = per_sm * sms;
  }
  return slots[device];
}

template <class TE, class TU>
__global__ void __launch_bounds__(kPcThreads)
    prolong_correct3d_kernel(const TE* __restrict__ ec, TU* __restrict__ u,
                             int ncy, int ncz, int nyf, int nzf, int steps) {
  const int I0 = blockIdx.z * kPcSteps, J = blockIdx.y;
  const int k = 1 + blockIdx.x * kPcThreads + threadIdx.x;
  if (k > nzf - 2) return;
  const long sx = (long)nyf * nzf, csx = (long)ncy * ncz;
  TU* w = u + (long)(2 * I0) * sx + (long)(2 * J) * nzf + k;
  const int ns = min(kPcSteps, steps - I0);
  // u at rows 2J + r of planes 2(I0 + s) + p, all loaded first
  float v[kPcSteps][2][2];
#pragma unroll
  for (int s = 0; s < kPcSteps; ++s)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = s < ns && (I0 + s > 0 || p == 1) && (J > 0 || r == 1);
        v[s][p][r] = in ? load_f(w + (2 * s + p) * sx + r * nzf) : 0.0f;
      }
  const bool kodd = k & 1;
  auto along_z = [&](const TE* q) {
    return kodd ? half_sum(load_f(q), load_f(q + 1)) : load_f(q);
  };
  // Pyz at rows 2J (e) and 2J + 1 (o) of coarse plane I0 + s
  const TE* q = ec + (long)I0 * csx + (long)J * ncz + (k >> 1);
  float e0 = along_z(q), o0 = half_sum(e0, along_z(q + ncz));
#pragma unroll
  for (int s = 0; s < kPcSteps; ++s) {
    if (s >= ns) break;
    q += csx;
    const float e1 = along_z(q), o1 = half_sum(e1, along_z(q + ncz));
    TU* w0 = w + 2 * s * sx;  // plane 2I, row 2J
    TU* w1 = w0 + sx;         // plane 2I + 1
    if (I0 + s > 0) {
      if (J > 0) store_f(w0, __fadd_rn(v[s][0][0], e0));
      store_f(w0 + nzf, __fadd_rn(v[s][0][1], o0));
    }
    if (J > 0) store_f(w1, __fadd_rn(v[s][1][0], half_sum(e0, e1)));
    store_f(w1 + nzf, __fadd_rn(v[s][1][1], half_sum(o0, o1)));
    e0 = e1;
    o0 = o1;
  }
}

template <class T, class TO>
cudaError_t residual_restrict3d_typed(const void* u, const void* f, void* fc,
                                      int nyf, int nzf, int ncx, int ncy,
                                      int ncz, const Stencil7& st, int device,
                                      cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel = residual_restrict3d_kernel<T, TO>;
  const cudaError_t err = allow_smem(kernel, rr_bytes<T>(), device, done);
  if (err != cudaSuccess) return err;
  const int tj = (ncy - 2 + kRrTileJ - 1) / kRrTileJ;
  const int tk = (ncz - 2 + kRrTileK - 1) / kRrTileK;
  const int planes = ncx - 2;
  // as many chunks as fill the card, none over kRrMaxChunk planes (but
  // none under kRrMinChunk where filling the card asks for more)
  const int fill = std::max(
      1, std::min(rr_block_slots<T, TO>(device) / (tj * tk),
                  planes / kRrMinChunk));
  const int chunk = std::min((planes + fill - 1) / fill, kRrMaxChunk);
  const dim3 grid(tk, tj, (planes + chunk - 1) / chunk);
  kernel<<<grid, kRrThreads, rr_bytes<T>(), stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(f),
      static_cast<TO*>(fc), nyf, nzf, ncx, ncy, ncz, chunk, st);
  return cudaGetLastError();
}

template <class TE, class TU>
cudaError_t prolong_correct3d_typed(const void* ec, void* u, int ncy,
                                    int ncz, int nxf, int nyf, int nzf,
                                    cudaStream_t stream) {
  const int steps = (nxf - 1) / 2;  // fine plane pairs (2I, 2I + 1)
  const dim3 grid((nzf - 2 + kPcThreads - 1) / kPcThreads, ncy - 1,
                  (steps + kPcSteps - 1) / kPcSteps);
  prolong_correct3d_kernel<TE, TU><<<grid, kPcThreads, 0, stream>>>(
      static_cast<const TE*>(ec), static_cast<TU*>(u), ncy, ncz, nyf, nzf,
      steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fc (ncx, ncy, ncz) = R_fw(f - A u) from fine fields of row lengths
// (nyf, nzf); u and f are bf16 when `in_bf16`, else fp32, and fc is bf16
// when `out_bf16`, else fp32.
int mg_residual_restrict3d(const void* u, const void* f, void* fc, int nyf,
                           int nzf, int ncx, int ncy, int ncz, float c,
                           float w, float e, float s, float n, float b,
                           float t, int in_bf16, int out_bf16, int device,
                           void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (ncx < 3 || ncy < 3 || ncz < 3) return (int)cudaErrorInvalidValue;
  const Stencil7 st{c, w, e, s, n, b, t};
  const cudaStream_t q = (cudaStream_t)stream;
  if (in_bf16)
    return (int)(out_bf16
                     ? residual_restrict3d_typed<bf16, bf16>(
                           u, f, fc, nyf, nzf, ncx, ncy, ncz, st, device, q)
                     : residual_restrict3d_typed<bf16, float>(
                           u, f, fc, nyf, nzf, ncx, ncy, ncz, st, device,
                           q));
  return (int)(out_bf16
                   ? residual_restrict3d_typed<float, bf16>(
                         u, f, fc, nyf, nzf, ncx, ncy, ncz, st, device, q)
                   : residual_restrict3d_typed<float, float>(
                         u, f, fc, nyf, nzf, ncx, ncy, ncz, st, device, q));
}

// u (nxf, nyf, nzf) += P_trilinear(ec) on interior nodes; ec has row
// lengths (ncy, ncz). ec is bf16 when `ec_bf16`, u when `u_bf16`, else
// fp32.
int mg_prolong_correct3d(const void* ec, void* u, int ncy, int ncz, int nxf,
                         int nyf, int nzf, int ec_bf16, int u_bf16,
                         int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (nxf < 5 || nyf < 5 || nzf < 5) return (int)cudaErrorInvalidValue;
  const cudaStream_t q = (cudaStream_t)stream;
  if (ec_bf16)
    return (int)(u_bf16 ? prolong_correct3d_typed<bf16, bf16>(
                              ec, u, ncy, ncz, nxf, nyf, nzf, q)
                        : prolong_correct3d_typed<bf16, float>(
                              ec, u, ncy, ncz, nxf, nyf, nzf, q));
  return (int)(u_bf16 ? prolong_correct3d_typed<float, bf16>(
                            ec, u, ncy, ncz, nxf, nyf, nzf, q)
                      : prolong_correct3d_typed<float, float>(
                            ec, u, ncy, ncz, nxf, nyf, nzf, q));
}

}  // extern "C"
