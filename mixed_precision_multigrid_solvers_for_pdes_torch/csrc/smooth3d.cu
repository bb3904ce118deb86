// Kernel E: 3D red-black Gauss-Seidel / SOR sweeps with a constant-coefficient
// 7-point stencil on an all-Dirichlet box, out of place: one launch reads u
// and f and writes every node of a separate output (the shell copied).
//
// Replaces the Pallas rbgs_planes of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth3d.py
// (:178, kernel _pipeline_kernel :65). The TPU kernel streams x-planes through
// VMEM and runs both colours of a sweep in one pass with a two-stage plane
// pipeline (red on plane i-1, black on plane i-2), so that red is computed
// from old values and black from red-updated ones. Here that pipeline is
// carried to 2S stages: the S sweeps of a pass (S <= kMaxWaveSweeps) and both
// of their colours are fused into one pass over the data.
//
// Bound: device memory bandwidth. A pass must read u and f and write the
// output once (12 bytes per node), where one launch per colour half-sweep
// moved ~12 bytes per node per launch, ~48 per 2-sweep call. (What bounds
// this design in practice is below.)
//
// Design of the wave kernel (levels that do not fit one block):
// - Each block owns a kTileJ x kTileK tile of the (j, k) interior and a chunk
//   of x-planes [x0, x1). It holds a window of the tile plus a halo of
//   H = 2S nodes in j and k, for a ring of u planes and a ring of f planes in
//   shared memory, and marches along x (i).
// - Step s: plane s has arrived; phase p = 1 .. 2S updates plane s - p with
//   colour (c0 + p - 1) & 1 (c0 = 0 red first, 1 black first). Then plane
//   s - 2S is finished. When phase p runs on plane q, plane q - 1 has had
//   phase p and plane q + 1 phase p - 1, so the other colour around it is in
//   the state exact RB-GS order requires.
// - Node (s - p, j, k) has the phase's colour exactly when s + j + k = c0 + 1
//   (mod 2), whatever p is. So in step s a (j, k) column is updated in all of
//   its phases or in none, and its in-plane neighbours, of the other parity,
//   are not written in that step. One thread runs a column's phases in order,
//   reading everything it needs first and carrying its i-neighbours in
//   registers. No barrier is needed between phases, only one per step, after
//   plane s has landed; the tile a step finishes is stored in the next.
// - A column at distance d from the window's edge takes phases 1 .. min(d, 2S)
//   only (the window's stale edge moves one node per phase), so the tile,
//   2S nodes in, is exact.
// - A chunk's march starts at plane a = max(x0 - 2S, 0) and ends at plane
//   b = min(x1 - 1 + 2S, nx - 1); planes a and b are held fixed. A fixed
//   interior plane spoils one more plane per phase, so 2S planes of lead-in
//   and lead-out keep [x0, x1) exact. Chunks exist only to fill the card on
//   small levels (ops/cuda_kernels/smooth3d.py picks them).
// - Out of place because a block's halo overlaps its neighbours' tiles and
//   blocks run in no order: in place, a block could read planes another block
//   had already updated.
// - Loads: the 3D fields are unpadded (a 513-node row is 2052 bytes), so
//   neither TMA nor 16-byte copies can address their rows. Each plane of u
//   and f comes in with 4-byte cp.async, kAhead planes ahead of the compute,
//   in commit groups; coalesced along z, zero-filled outside the field.
// - Shared-memory layout: each window row keeps its even-k and odd-k nodes in
//   two halves, so the nodes a step updates in a row, and each of their
//   neighbour sets, are consecutive words. A warp takes columns 0..31 of one
//   row's half (the last 2S columns of every row go to separate warps), so
//   no warp's reads straddle two rows and the compute is free of bank
//   conflicts.
// - What bounds it on the H100: shared-memory instructions (a column's step
//   reads 2S + 2 + 5 * 2S words and writes 2S), more than DRAM. The window's
//   halo costs 1.41x the tile's loads and 15% more updates at S = 2.
//
// Storage: u, f and out are each fp32 or bf16 (mg_rbgs3d's storage flags,
// kernel A's encoding). The rings and the one-block buffers are fp32
// whatever the storage, so the rings of mg_rbgs3d_geometry are the same for
// 2-byte planes. An fp32 field's planes come in by cp.async as above. A bf16
// field's rows cannot: cp.async has no 2-byte copy, and a row of an unpadded
// bf16 field starts in either half of a 4-byte word (common.cuh, "bf16 rows
// ... as 4-byte words"). So each bf16 window row comes in as Wave::PR pairs
// of aligned words, one pair a thread, by 4-byte cp.async into a staging
// ring of kAhead planes (Wave::STAGE_BYTES per bf16 field; 220,160 bytes per
// block with both at S = 2), in the same commit groups and as far ahead as
// the fp32 copies; at the end of step q - 1 each thread waits for its own
// pair of plane q and widens it into its four nodes (0 outside the field),
// two in each parity half of the fp32 ring row, before step q's barrier.
// A bf16 level thus moves half an fp32 level's bytes with as many loads in
// flight, and holds nothing in registers across a step. (F stages 16-byte
// chunks instead, which needs a barrier between the copies and the
// widening; E has one barrier a step.) The tile is rounded to bf16 once,
// where it is stored. A call of more sweeps than one launch takes keeps its
// passes before the last in fp32 (the wrapper's scratch field), so a bf16
// call rounds once.
//
// Small levels (both fields within kOneBlockMaxBytes, 17^3 and below) run
// every sweep of a call in one launch of a one-block kernel that holds u and
// f in shared memory, with a barrier per colour phase: the 32-sweep coarsest
// solve is one launch.
//
// Arithmetic: u + omega*((f + nb) / c - u), dividing by c where the Pallas
// kernel multiplies by 1/c rounded to fp32 (an inexact reciprocal biases the
// converged solution, and c = 6/h^2 is no power of two), with every product,
// sum and quotient rounded explicitly in the plain twin's order (neighbour
// sum w, e, s, n, b, t), so the kernel equals its twin (ops/stencil.divide)
// on the card bit for bit.
#include <type_traits>

#include "common.cuh"

namespace {

// The geometry below is this file's own: mg_rbgs3d_geometry reports it,
// ops/cuda_kernels/smooth3d.py checks its launch planning against that
// report before the first launch, and the CPU schedule test reads it from
// this file.
constexpr int kTileJ = 32;
constexpr int kTileK = 64;
constexpr int kMaxWaveSweeps = 2;
constexpr int kAhead = 2;  // planes whose loads are in flight ahead of a step
constexpr int kWaveThreads = 768;
constexpr int kOneBlockMaxBytes = 64 * 1024;
constexpr int kOneBlockThreads = 512;
static_assert(kMaxWaveSweeps == 2,
              "mg_rbgs3d instantiates the wave kernel for 1 and 2 sweeps");

template <int S>
struct Wave {
  static constexpr int H = 2 * S;              // halo in j and k
  static constexpr int RJ = kTileJ + 2 * H;    // window rows
  static constexpr int RK = kTileK + 2 * H;    // window columns (even)
  static constexpr int HP = RK / 2;            // one parity half of a row
  static constexpr int PLANE = RJ * RK;
  // u ring: planes s-2S-2 .. s+kAhead; f ring: planes s-2S-1 .. s+kAhead.
  // With one barrier per step, a load issued at step s+1 may land while
  // slower threads still run step s, so each ring holds one plane more than
  // a step reads.
  static constexpr int NU = 2 * S + 3 + kAhead;
  static constexpr int NF = 2 * S + 2 + kAhead;
  static constexpr int BYTES = (NU + NF) * PLANE * (int)sizeof(float);
  static constexpr int LOADS = (PLANE + kWaveThreads - 1) / kWaveThreads;
  static constexpr int ITEMS = ((RJ - 2) * HP + kWaveThreads - 1) / kWaveThreads;
  // a tile stores at most (kTileJ + 2) x (kTileK + 2) nodes (shell included)
  static constexpr int STORES =
      ((kTileJ + 2) * (kTileK + 2) + kWaveThreads - 1) / kWaveThreads;
  // bf16 storage: pairs of 4-byte words that cover a window row
  // (common.cuh), one pair a thread, staged kAhead planes ahead for each
  // bf16 field
  static constexpr int PR = (RK + 4) / 4;    // pairs of a window row
  static constexpr int PAIRS = RJ * PR;
  static constexpr int STAGE = 2 * PAIRS;    // words of a staged plane
  static constexpr int STAGE_BYTES = kAhead * STAGE * (int)sizeof(unsigned);
  static_assert(PAIRS <= kWaveThreads, "one pair of a plane a thread");
};

// Dynamic shared memory of a wave launch: the fp32 rings, and a staging
// ring for each bf16 field.
template <int S, class TU, class TF>
constexpr int wave_bytes() {
  return Wave<S>::BYTES + ((int)std::is_same_v<TU, bf16> +
                           (int)std::is_same_v<TF, bf16>) *
                              Wave<S>::STAGE_BYTES;
}
static_assert(wave_bytes<2, bf16, bf16>() <= 232448,
              "the rings and both staging rings fit a block's 227 KB");

// RB-GS/SOR value of a node from its value uc, its right-hand side fv and its
// neighbours W, E (i -+ 1), S, N (j -+ 1), B, T (k -+ 1). kUnitOmega skips
// the product by omega = 1, which is exact.
template <bool kUnitOmega = false>
__device__ __forceinline__ float rbgs7(float uc, float fv, float W, float E,
                                       float S, float N, float B, float T,
                                       const Stencil7& st, float omega) {
  float acc = __fmul_rn(st.w, W);
  acc = __fadd_rn(acc, __fmul_rn(st.e, E));
  acc = __fadd_rn(acc, __fmul_rn(st.s, S));
  acc = __fadd_rn(acc, __fmul_rn(st.n, N));
  acc = __fadd_rn(acc, __fmul_rn(st.b, B));
  acc = __fadd_rn(acc, __fmul_rn(st.t, T));
  const float gs = __fdiv_rn(__fadd_rn(fv, acc), st.c);
  const float d = __fsub_rn(gs, uc);
  return __fadd_rn(uc, kUnitOmega ? d : __fmul_rn(omega, d));
}

// A tile node to the output, streaming (evict-first) for fp32; rounded once
// for bf16.
__device__ __forceinline__ void store_stream(float* p, float v) {
  __stcs(p, v);
}
__device__ __forceinline__ void store_stream(bf16* p, float v) {
  store_f(p, v);
}

template <int S, bool kUnitOmega, class TU, class TF, class TO>
__global__ void __launch_bounds__(kWaveThreads, 1)
    rbgs3d_wave_kernel(const TU* __restrict__ u, const TF* __restrict__ f,
                       TO* __restrict__ out, int nx, int ny, int nz,
                       int chunk, Stencil7 st, float omega, int c0) {
  constexpr bool kBfU = std::is_same_v<TU, bf16>;
  constexpr bool kBfF = std::is_same_v<TF, bf16>;
  using W = Wave<S>;
  constexpr int P = 2 * S;  // phases per step
  extern __shared__ float sm[];
  float* us = sm;                        // NU u planes
  float* fs = sm + W::NU * W::PLANE;     // NF f planes
  // kAhead staged planes of words for each bf16 field, u's first
  unsigned* ust = reinterpret_cast<unsigned*>(fs + W::NF * W::PLANE);
  unsigned* fst = ust + (kBfU ? kAhead * W::STAGE : 0);
  const int jw0 = 1 + blockIdx.y * kTileJ - W::H;
  const int kw0 = 1 + blockIdx.x * kTileK - W::H;
  const int x0 = blockIdx.z * chunk, x1 = min(x0 + chunk, nx);
  const int a = max(x0 - P, 0), b = min(x1 - 1 + P, nx - 1);
  const int last = x1 - 1 + P;  // the step that finishes plane x1 - 1
  const long sx = (long)ny * nz, total = (long)nx * sx;
  int jlo, jhi, klo, khi;
  tile_span(blockIdx.y, kTileJ, ny, &jlo, &jhi);
  tile_span(blockIdx.x, kTileK, nz, &klo, &khi);

  // This thread's window nodes to load: ring offset and in-plane offset in
  // the field (-1 outside it); the same in every plane.
  int lo_s[W::LOADS], lo_g[W::LOADS];
#pragma unroll
  for (int r = 0; r < W::LOADS; ++r) {
    const int t = threadIdx.x + r * kWaveThreads;
    const int lj = t / W::RK, lk = t - lj * W::RK;
    const int j = jw0 + lj, k = kw0 + lk;
    lo_s[r] = t < W::PLANE ? lj * W::RK + (lk & 1) * W::HP + (lk >> 1) : -1;
    lo_g[r] = j >= 0 && j < ny && k >= 0 && k < nz ? j * nz + k : -1;
  }
  // A bf16 field's plane comes in as word pairs (common.cuh), this thread's
  // the pair threadIdx.x of a staged plane: pair m of window row lj.
  BfPair pr;
  {
    const int t = threadIdx.x, lj = t / W::PR, m = t - lj * W::PR;
    const int j = jw0 + lj;
    pr = bf_pair(t < W::PAIRS, j >= 0 && j < ny, j * nz + kw0, kw0, nz, sx,
                 m, W::HP, lj * W::RK + 2 * m, 2 * t);
  }
  // element-address parity of each field's node 0 (the view's offset too)
  const int pu = (int)((reinterpret_cast<uintptr_t>(u) >> 1) & 1);
  const int pf = (int)((reinterpret_cast<uintptr_t>(f) >> 1) & 1);
  auto parity = [&](int p0, int q) { return (p0 + (int)(q & sx)) & 1; };

  // plane q of u and f -> the rings, or a bf16 field's into its staging
  // ring (one commit group, empty past plane b)
  auto issue = [&](int q) {
    if (q <= b) {
      float* ud = us + (q % W::NU) * W::PLANE;
      float* fd = fs + (q % W::NF) * W::PLANE;
      const TU* ug = u + (long)q * sx;
      const TF* fg = f + (long)q * sx;
      if constexpr (!kBfU || !kBfF) {
#pragma unroll
        for (int r = 0; r < W::LOADS; ++r) {
          if (lo_s[r] < 0) continue;
          const int g = max(lo_g[r], 0);
          if constexpr (!kBfU) cp_async4(ud + lo_s[r], ug + g, lo_g[r] >= 0);
          if constexpr (!kBfF) cp_async4(fd + lo_s[r], fg + g, lo_g[r] >= 0);
        }
      }
      if constexpr (kBfU)
        bf_pair_issue(pr, u, (long)q * sx, parity(pu, q), total,
                      ust + (q % kAhead) * W::STAGE);
      if constexpr (kBfF)
        bf_pair_issue(pr, f, (long)q * sx, parity(pf, q), total,
                      fst + (q % kAhead) * W::STAGE);
    }
    cp_async_commit();
  };
  // a bf16 field's plane q from its staging ring into its fp32 ring, at the
  // end of step q - 1: its words were issued kAhead - 1 commit groups ago.
  // No thread reads the ring slot before step q's barrier.
  auto settle = [&](int q) {
    if constexpr (kBfU || kBfF) {
      if (q > b) return;
      cp_async_wait<kAhead - 1>();
      if constexpr (kBfU)
        bf_pair_widen(pr, parity(pu, q), ust + (q % kAhead) * W::STAGE,
                      us + (q % W::NU) * W::PLANE, W::HP);
      if constexpr (kBfF)
        bf_pair_widen(pr, parity(pf, q), fst + (q % kAhead) * W::STAGE,
                      fs + (q % W::NF) * W::PLANE, W::HP);
    }
  };

  // This thread's columns: row, parity-half index and, for either parity
  // of the row's active half, the phases the column takes (0: none) by its
  // distance to the window's edge and whether it is an unknown.
  // Columns 0..31 of a row's half go to one warp, so no warp's reads
  // straddle two rows (which would put two rows' words in one bank); the
  // last HP - 32 columns of every row follow, kTail to a row.
  int it_lj[W::ITEMS], it_m[W::ITEMS], it_d0[W::ITEMS], it_d1[W::ITEMS];
#pragma unroll
  for (int r = 0; r < W::ITEMS; ++r) {
    const int t = threadIdx.x + r * kWaveThreads;
    constexpr int kTail = W::HP - 32, kMain = (W::RJ - 2) * 32;
    const int tt = t - kMain;
    const int lj = t < kMain ? 1 + t / 32 : 1 + tt / kTail;
    const int m = t < kMain ? t % 32 : 32 + tt % kTail;
    it_lj[r] = lj;
    it_m[r] = m;
    const int j = jw0 + lj, dj = min(lj, W::RJ - 1 - lj);
    const bool row_ok = t < (W::RJ - 2) * W::HP && j >= 1 && j <= ny - 2;
    int dk[2];
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int lk = 2 * m + hb, k = kw0 + lk;
      const int d = min(dj, min(lk, W::RK - 1 - lk));
      dk[hb] = row_ok && k >= 1 && k <= nz - 2 ? min(d, P) : 0;
    }
    it_d0[r] = dk[0];
    it_d1[r] = dk[1];
  }

  // This thread's nodes of the tile to store: window offset and in-plane
  // offset in the field (-1: none); the same in every plane.
  int st_s[W::STORES], st_g[W::STORES];
  {
    const int cols = khi - klo, n = (jhi - jlo) * cols;
#pragma unroll
    for (int r = 0; r < W::STORES; ++r) {
      const int t = threadIdx.x + r * kWaveThreads;
      const int jj = t / cols, kk = t - jj * cols;
      const int lj = jlo + jj - jw0, lk = klo + kk - kw0;
      st_s[r] = lj * W::RK + (lk & 1) * W::HP + (lk >> 1);
      st_g[r] = t < n ? (jlo + jj) * nz + klo + kk : -1;
    }
  }

  // step s's compute: phases plo .. phi, phase p on plane s - p
  auto step = [&](int s, int plo, int phi) {
    const int par = (c0 + 1 + s + jw0 + kw0) & 1;
    int slot[P + 2];  // ring offsets of planes s - P - 1 .. s
#pragma unroll
    for (int i = 0; i < P + 2; ++i)
      slot[i] = (max(s - P - 1 + i, 0) % W::NU) * W::PLANE;
    int fslot[P];     // f ring offsets of planes s - 1 .. s - P
#pragma unroll
    for (int p = 1; p <= P; ++p)
      fslot[p - 1] = (max(s - p, 0) % W::NF) * W::PLANE;
#pragma unroll
    for (int r = 0; r < W::ITEMS; ++r) {
      const int hb = (par + it_lj[r]) & 1;  // parity of the row's active k
      const int p1 = min(phi, hb ? it_d1[r] : it_d0[r]);
      if (plo > p1) continue;
      const int own = it_lj[r] * W::RK + hb * W::HP + it_m[r];
      const int kd = hb ? own - W::HP : own + W::HP - 1;  // node k - 1
      // every read first: no other thread writes them in this step
      float col[P + 2], fv[P], ys[P], yn[P], zb[P], zt[P];
#pragma unroll
      for (int i = 0; i < P + 2; ++i) col[i] = us[slot[i] + own];
#pragma unroll
      for (int p = 1; p <= P; ++p) {
        const float* pl = us + slot[P + 1 - p];
        fv[p - 1] = fs[fslot[p - 1] + own];
        ys[p - 1] = pl[own - W::RK];
        yn[p - 1] = pl[own + W::RK];
        zb[p - 1] = pl[kd];
        zt[p - 1] = pl[kd + 1];
      }
      // the column's phases in order: plane s - p is col[P + 1 - p]
#pragma unroll
      for (int p = 1; p <= P; ++p) {
        if (p < plo || p > p1) continue;
        col[P + 1 - p] = rbgs7<kUnitOmega>(col[P + 1 - p], fv[p - 1],
                                           col[P - p], col[P + 2 - p],
                                           ys[p - 1], yn[p - 1], zb[p - 1],
                                           zt[p - 1], st, omega);
      }
#pragma unroll
      for (int p = 1; p <= P; ++p)
        if (p >= plo && p <= p1) us[slot[P + 1 - p] + own] = col[P + 1 - p];
    }
  };

  if constexpr (kBfU || kBfF) {  // the words no pair writes stay 0
    zero_rings(sm, (W::NU + W::NF) * W::PLANE, kWaveThreads);
    __syncthreads();
  }
  for (int d = 0; d < kAhead; ++d) issue(a + d);
  settle(a);
  for (int s = a; s <= last + 1; ++s) {
    issue(s + kAhead);
    cp_async_wait<kAhead>();  // plane s has landed
    __syncthreads();

    const int q_done = s - P - 1;  // finished in the previous step
    if (q_done >= x0 && q_done < x1) {
      const float* pl = us + (q_done % W::NU) * W::PLANE;
      TO* og = out + (long)q_done * sx;
#pragma unroll
      for (int r = 0; r < W::STORES; ++r)
        if (st_g[r] >= 0) store_stream(og + st_g[r], pl[st_s[r]]);
    }

    // phases p in [plo, phi] touch planes a < s - p < b
    const int plo = max(1, s - b + 1), phi = min(P, s - a - 1);
    if (s <= last && plo <= phi) step(s, plo, phi);
    settle(s + 1);
  }
  cp_async_wait<0>();
}

template <class TU, class TF, class TO>
__global__ void __launch_bounds__(kOneBlockThreads)
    rbgs3d_block_kernel(const TU* __restrict__ u, const TF* __restrict__ f,
                        TO* __restrict__ out, int nx, int ny, int nz,
                        Stencil7 st, float omega, int c0, int sweeps) {
  extern __shared__ float sm[];
  const int n = nx * ny * nz, sx = ny * nz;
  float* us = sm;
  float* fs = sm + n;
  for (int t = threadIdx.x; t < n; t += kOneBlockThreads) {
    us[t] = load_f(u + t);
    fs[t] = load_f(f + t);
  }
  const int rows = (nx - 2) * (ny - 2), per_row = (nz - 1) / 2;
  for (int ph = 0; ph < 2 * sweeps; ++ph) {
    const int color = (c0 + ph) & 1;  // red where (i + j + k) is even
    __syncthreads();
    for (int t = threadIdx.x; t < rows * per_row; t += kOneBlockThreads) {
      const int r = t / per_row, m = t - r * per_row;
      const int i = 1 + r / (ny - 2), j = 1 + r % (ny - 2);
      const int k = 1 + ((i + j + 1 + color) & 1) + 2 * m;
      if (k > nz - 2) continue;
      const int x = i * sx + j * nz + k;
      us[x] = rbgs7(us[x], fs[x], us[x - sx], us[x + sx], us[x - nz],
                    us[x + nz], us[x - 1], us[x + 1], st, omega);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += kOneBlockThreads)
    store_f(out + t, us[t]);
}

template <int S, class TU, class TF, class TO>
cudaError_t launch_wave(const TU* u, const TF* f, TO* out, int nx, int ny,
                        int nz, int chunk, const Stencil7& st, float omega,
                        int c0, int device, cudaStream_t stream) {
  static bool done[2][kMaxDevices] = {};
  const bool unit = omega == 1.0f;
  const auto kernel = unit ? rbgs3d_wave_kernel<S, true, TU, TF, TO>
                           : rbgs3d_wave_kernel<S, false, TU, TF, TO>;
  constexpr int bytes = wave_bytes<S, TU, TF>();
  const cudaError_t err = allow_smem(kernel, bytes, device, done[unit]);
  if (err != cudaSuccess) return err;
  const dim3 grid((nz - 2 + kTileK - 1) / kTileK,
                  (ny - 2 + kTileJ - 1) / kTileJ, (nx + chunk - 1) / chunk);
  kernel<<<grid, kWaveThreads, bytes, stream>>>(
      u, f, out, nx, ny, nz, chunk, st, omega, c0);
  return cudaGetLastError();
}

// The storage of one launch: the input u, f and the output, as the
// wrapper's passes need them (bit 0: u is bf16, bit 1: f, bit 2: out), as
// kernel A encodes it (smooth.cu). u and f are each fp32 or bf16, as the
// Pallas kernel casts each on its own (smooth3d.py:217): a call on a bf16
// u runs its passes before the last on fp32, so an fp32 f over a bf16 u
// takes codes 5 (one launch), 1 (the first of several) and 4 (the last),
// and a bf16 f over an fp32 u takes code 2 in every launch.
enum Storage : int {
  kFp32 = 0,          // an fp32 level
  kBf16 = 7,          // a bf16 level's call in one launch
  kBf16First = 3,     // the first launch of a longer bf16 call: out fp32
  kBf16Mid = 2,       // u and out fp32, f bf16: between, or an fp32 u's call
  kBf16Last = 6,      // the last: u fp32, out bf16
  kBf16U = 5,         // a bf16 u over an fp32 f, in one launch
  kBf16UFirst = 1,    // the first launch of such a call: out fp32
  kFp32FLast = 4,     // its last: u and f fp32, out bf16
};

// One launch on typed storage: the one-block kernel for fields within
// kOneBlockMaxBytes (any sweep count), else the wave kernel. A longer
// call's launches before its last take kMaxWaveSweeps sweeps each
// (plan_passes in ops/cuda_kernels/smooth3d.py), so the first launches
// (kBf16First, kBf16UFirst) compile the wave kernel for that count only
// (kAnySweeps false).
template <class TU, class TF, class TO, bool kAnySweeps>
cudaError_t rbgs3d_typed(const void* u, const void* f, void* out, int nx,
                         int ny, int nz, const Stencil7& st, float omega,
                         int sweeps, int c0, int chunk, int device,
                         cudaStream_t stream) {
  const TU* tu = static_cast<const TU*>(u);
  const TF* tf = static_cast<const TF*>(f);
  TO* to = static_cast<TO*>(out);
  const long bytes = 2L * nx * ny * nz * (long)sizeof(float);
  if (bytes <= kOneBlockMaxBytes) {
    static bool done[kMaxDevices] = {};
    const cudaError_t err = allow_smem(rbgs3d_block_kernel<TU, TF, TO>,
                                       kOneBlockMaxBytes, device, done);
    if (err != cudaSuccess) return err;
    rbgs3d_block_kernel<TU, TF, TO><<<1, kOneBlockThreads, (int)bytes,
                                      stream>>>(tu, tf, to, nx, ny, nz, st,
                                                omega, c0, sweeps);
    return cudaGetLastError();
  }
  if (chunk < 1) return cudaErrorInvalidValue;
  if (sweeps == kMaxWaveSweeps)
    return launch_wave<2>(tu, tf, to, nx, ny, nz, chunk, st, omega, c0,
                          device, stream);
  if constexpr (kAnySweeps) {
    if (sweeps == 1)
      return launch_wave<1>(tu, tf, to, nx, ny, nz, chunk, st, omega, c0,
                            device, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `sweeps` RB-GS/SOR sweeps (red then black, black then red with
// `reverse`) of u, written to out (every node of out is written; u and f
// are only read, and out must not alias them). Fields whose u and f fit in
// kOneBlockMaxBytes take any sweep count in one block; larger ones take at
// most kMaxWaveSweeps, in x-chunks of `chunk` planes. `storage` says which
// of u, f and out are bf16 (Storage); the others are fp32.
int mg_rbgs3d(const void* u, const void* f, void* out, int nx, int ny,
              int nz, float c, float w, float e, float s, float n, float b,
              float t, float omega, int sweeps, int reverse, int chunk,
              int storage, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (sweeps < 1 || nx < 3 || ny < 3 || nz < 3)
    return (int)cudaErrorInvalidValue;
  const Stencil7 st{c, w, e, s, n, b, t};
  const int c0 = reverse ? 1 : 0;
  const cudaStream_t q = (cudaStream_t)stream;
  switch (storage) {
    case kFp32:
      return (int)rbgs3d_typed<float, float, float, true>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kBf16:
      return (int)rbgs3d_typed<bf16, bf16, bf16, true>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kBf16First:
      return (int)rbgs3d_typed<bf16, bf16, float, false>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kBf16Mid:
      return (int)rbgs3d_typed<float, bf16, float, true>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kBf16Last:
      return (int)rbgs3d_typed<float, bf16, bf16, true>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kBf16U:
      return (int)rbgs3d_typed<bf16, float, bf16, true>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kBf16UFirst:
      return (int)rbgs3d_typed<bf16, float, float, false>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    case kFp32FLast:
      return (int)rbgs3d_typed<float, float, bf16, true>(
          u, f, out, nx, ny, nz, st, omega, sweeps, c0, chunk, device, q);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wave kernel's geometry for `sweeps` (1 .. kMaxWaveSweeps) sweeps per
// launch, into out[7]: tile rows (j), tile columns (k), kMaxWaveSweeps,
// kAhead, kOneBlockMaxBytes, u ring planes, f ring planes.
int mg_rbgs3d_geometry(int sweeps, int* out) {
  if (sweeps < 1 || sweeps > kMaxWaveSweeps) return (int)cudaErrorInvalidValue;
  const int nu = sweeps == 1 ? Wave<1>::NU : Wave<2>::NU;
  const int nf = sweeps == 1 ? Wave<1>::NF : Wave<2>::NF;
  const int g[7] = {kTileJ, kTileK, kMaxWaveSweeps, kAhead, kOneBlockMaxBytes,
                    nu, nf};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
  return 0;
}

}  // extern "C"
