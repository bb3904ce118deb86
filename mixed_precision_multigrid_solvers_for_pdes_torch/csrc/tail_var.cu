// Kernel J: the whole coarse tail of a V(pre, post) cycle in one launch, with
// a variable-coefficient 5-point stencil on every level, walked in the
// shared memory of a thread-block cluster.
//
// Replaces the Pallas tail_vcycle_var of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/tail.py
// (:122, kernel body _tail_kernel_var :84): kernel D's recursion (tail.cu)
// with each level's five coefficient planes. From the entry level (129^2 on
// the main path) down to the coarsest grid: pre-smoothing, residual and
// restriction, the coarsest solve (coarse_sweeps RB-GS sweeps with omega =
// 1), prolongation+correction and post-smoothing (colour order reversed when
// `symmetric`), all in fp32, on all-Dirichlet levels, in place on the entry
// field.
//
// Storage, as the Pallas kernel takes it (:79-81, :152-154): the entry u
// and f are fp32 or bf16 (one dtype), and each level's planes are in that
// level's dtype, fp32 or bf16, whatever the entry's. Every level is held
// and computed in fp32 in shared memory (the plan below is sized in fp32):
// bf16 nodes are widened where they are loaded (2-byte loads: cp.async has
// no 2-byte copy), and the entry u is rounded once where it is written
// back.
//
// What bounds it: latency. A cycle from 129^2 moves ~0.6 MB (0.19 us at
// 3.35 TB/s) through ~120 dependent phases (colour phases, residual,
// restriction, prolongation), 64 of them on the coarsest level's one
// unknown, each phase a chain of dependent shared-memory loads and an IEEE
// division behind a barrier. On the H100 a __syncthreads() of 1024 threads
// costs ~38 ns, a cluster barrier ~0.73 us whatever the cluster's size, a
// __syncwarp() ~1.5 ns (PERF.md), so cluster barriers
// are kept to the levels too large for one SM.
//
// Design:
// - One cluster of kCluster CTAs of kThreads threads. Everything a launch
//   touches lives in shared memory: it loads u and f of the entry level and
//   every level's planes once (4-byte cp.async: rows of odd length are not
//   16-byte aligned; CTA 0's own levels in a second group, awaited just
//   before its walk) and writes the entry u back once at the end.
// - The large levels (the first `ns`, whose rows number at least kCluster *
//   kMinBandRows, and more while the rest would not fit a CTA's shared
//   memory; 129^2 and 65^2 from a 129^2 entry) are split into row bands,
//   one per CTA: rank r holds rows [r B_l, (r + 1) B_l) of level l (the
//   last rank up to the end), with B_l = B_0 / 2^l even, so band starts
//   are even on every split level and restriction and prolongation stay
//   local to a CTA except for one halo row. A CTA reads its neighbours' edge
//   rows straight from their shared memory (cluster.map_shared_rank) and
//   every phase on a split level ends with a cluster barrier (a handshake
//   between neighbour CTAs through remote shared-memory flags, release and
//   acquire at cluster scope, was measured slower: ~2.4 us per phase).
// - Restriction: coarse row I belongs to the CTA that holds fine row 2I; it
//   reads residual row 2I - 1 from the previous CTA. Prolongation: fine row i
//   reads coarse rows i/2 and i/2 + 1; the last odd row of a band reads the
//   next CTA's first coarse row.
// - The levels below the split ones are walked by CTA 0 alone, with
//   __syncthreads() between phases (33^2 and 17^2); from the first level of
//   at most kWarpMaxNodes nodes (9^2 and below) by its first warp alone,
//   with __syncwarp() (a warp took 16 us on 17^2, the block ~6). The
//   coarsest level, when it has at most 32 unknowns, keeps one unknown and
//   its stencil in each lane's registers; a single unknown (3^2) has only
//   fixed neighbours, so its 32 sweeps run back to back in one lane. The
//   split levels' restriction writes the first CTA-0 level's right-hand side
//   into CTA 0's shared memory, and the prolongation back reads CTA 0's
//   correction; the other CTAs wait for CTA 0 at one cluster barrier.
// - Jacobi sweeps write into the level's residual array and copy back, two
//   barriers per sweep.
// The plan (ns, B_0, the first warp level, the shared-memory layout) is
// computed by plan() below; mg_tail_var_geometry reports it, and
// ops/cuda_kernels/tail.py holds its own copy against that report.
//
// Arithmetic: every operation rounded explicitly in the plain twin's order
// (common.cuh: nbsum_values, rbgs_var_update, jacobi_var_update, the
// restriction's centre/edges/corners sums, bilinear prolongation), so J
// equals tail_vcycle_plain bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;           // CTAs of the cluster (portable size)
constexpr int kThreads = 1024;        // threads per CTA
constexpr int kMinBandRows = 8;       // levels of >= kCluster * 8 rows split
constexpr int kWarpMaxNodes = 9 * 9;  // levels walked by one warp
constexpr int kTailMaxLevels = 16;    // as kernel D
constexpr int kArrays = 8;            // u, f, r, c, w, e, s, n per level
constexpr int kMaxSmemBytes = 232448;

struct Plan {
  int ns;         // split levels 0 .. ns-1
  int b0;         // band rows of level 0 (B_l = b0 >> l)
  int warp_from;  // first level walked by one warp (levels when none)
  int off[kTailMaxLevels];     // shared-memory float offset of each level
  int stride[kTailMaxLevels];  // floats per array of each level
  int bytes;      // dynamic shared memory per CTA
};

// B_0 of a tail whose first ns levels are split: the largest multiple of
// 2^ns, at most nx[0] - 1 rows over kCluster rounded up, that leaves the
// last CTA at least two rows of every split level; 0 when none does.
int band0(int ns, const int* nx) {
  const int unit = 1 << ns;
  for (int b = unit * ((nx[0] - 1 + kCluster * unit - 1) / (kCluster * unit));
       b >= unit; b -= unit) {
    bool fits = true;
    for (int l = 0; l < ns; ++l)
      fits = fits && (kCluster - 1) * (b >> l) < nx[l] - 1;
    if (fits) return b;
  }
  return 0;
}

// The layout of a tail with `levels` levels of (nx[l], ny[l]) nodes whose
// first `ns` levels are split (fewer when no band size fits them).
Plan layout(int levels, const int* nx, const int* ny, int ns) {
  Plan q{};
  for (; ns > 0; --ns)
    if ((q.b0 = band0(ns, nx)) > 0) break;
  q.ns = ns;
  q.warp_from = levels;
  for (int l = levels - 1; l >= ns && nx[l] * ny[l] <= kWarpMaxNodes; --l)
    q.warp_from = l;
  int off = 0;
  for (int l = 0; l < levels; ++l) {
    int rows = nx[l];
    if (l < ns) {
      const int b = q.b0 >> l;
      rows = b > nx[l] - (kCluster - 1) * b ? b : nx[l] - (kCluster - 1) * b;
    }
    q.off[l] = off;
    q.stride[l] = rows * ny[l];
    off += kArrays * q.stride[l];
  }
  q.bytes = off * (int)sizeof(float);
  return q;
}

// The launch plan: the levels of at least kCluster * kMinBandRows rows are
// split; while a CTA's shared memory would overflow, the next level is split
// too. Every tail of two or more levels from an entry of at most 129 x 129
// then fits; a one-level tail (the coarsest solve alone) cannot be split and
// fits up to 7264 nodes.
Plan plan(int levels, const int* nx, const int* ny) {
  int ns = 0;
  while (ns < levels - 1 && nx[ns] - 1 >= kCluster * kMinBandRows) ++ns;
  Plan q = layout(levels, nx, ny, ns);
  for (int k = ns + 1; k < levels && q.bytes > kMaxSmemBytes; ++k) {
    const Plan more = layout(levels, nx, ny, k);
    if (more.bytes < q.bytes) q = more;
  }
  return q;
}

struct TailVarParams {
  int levels, ns, b0, warp_from;
  int nx[kTailMaxLevels];
  int ny[kTailMaxLevels];
  int off[kTailMaxLevels];
  int stride[kTailMaxLevels];
  Planes5 planes[kTailMaxLevels];  // bf16 where planes_bf16 says so
  int planes_bf16;                 // bit l set: level l's planes are bf16
  int pre, post, coarse_sweeps;
  int jacobi;     // 1: weighted Jacobi pre/post smoothing, 0: RB-GS/SOR
  int symmetric;  // 1: post-smoothing runs black before red
  float omega;
};

// One level as this CTA holds it: rows [row0, row1) of u, f, the residual /
// Jacobi scratch r and the planes, row row0 first; the u and r rows just
// outside them (a neighbour CTA's edge rows) where they exist.
struct View {
  float *u, *f, *r, *c, *w, *e, *s, *n;
  int nx, ny, row0, row1;
  const float *u_up, *u_dn, *r_up;
  __device__ const float* urow(int i) const {
    return i < row0 ? u_up : (i >= row1 ? u_dn : u + (i - row0) * ny);
  }
  __device__ const float* rrow(int i) const {
    return i < row0 ? r_up : r + (i - row0) * ny;
  }
};

__device__ View make_view(const TailVarParams& p, float* sm, int l, int rank,
                          const cg::cluster_group& cl) {
  const int S = p.stride[l];
  float* base = sm + p.off[l];
  View v{base, base + S, base + 2 * S, base + 3 * S, base + 4 * S,
         base + 5 * S, base + 6 * S, base + 7 * S,
         p.nx[l], p.ny[l], 0, p.nx[l], nullptr, nullptr, nullptr};
  if (l < p.ns) {
    const int b = p.b0 >> l;
    v.row0 = rank * b;
    v.row1 = rank == kCluster - 1 ? v.nx : (rank + 1) * b;
    if (rank > 0) {
      v.u_up = cl.map_shared_rank(v.u + (b - 1) * v.ny, rank - 1);
      v.r_up = cl.map_shared_rank(v.r + (b - 1) * v.ny, rank - 1);
    }
    if (rank < kCluster - 1) v.u_dn = cl.map_shared_rank(v.u, rank + 1);
  }
  return v;
}

// The threads that run a phase and the barrier that ends it.
struct ClusterGroup {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return kThreads; }
  __device__ void sync() const { cg::this_cluster().sync(); }
};

struct BlockGroup {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return kThreads; }
  __device__ void sync() const { __syncthreads(); }
};
struct WarpGroup {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// Neighbour sum of the unknown node x = (i, j) of v, rows i -+ 1 from `a`
// and `b`.
__device__ __forceinline__ float nbsum_at(const View& v, const float* uu,
                                          const float* a, const float* b,
                                          int x, int j) {
  return nbsum_values(v.w[x], v.e[x], v.s[x], v.n[x], a[j], b[j], uu[x - 1],
                      uu[x + 1]);
}

// One colour phase on the unknowns v holds.
template <class G>
__device__ void rbgs_phase(const View& v, int color, float omega, G g) {
  const int i0 = max(v.row0, 1), i1 = min(v.row1, v.nx - 1);
  const int hc = (v.ny - 1) / 2;  // nodes of one colour in a row, at most
  for (int t = g.rank(); t < (i1 - i0) * hc; t += g.size()) {
    const int i = i0 + t / hc, k = t % hc;
    const int j = 1 + ((i + 1 + color) & 1) + 2 * k;
    if (j > v.ny - 2) continue;
    const int x = (i - v.row0) * v.ny + j;
    const float nb = nbsum_at(v, v.u, v.urow(i - 1), v.urow(i + 1), x, j);
    v.u[x] = rbgs_var_update(v.u[x], v.f[x], v.c[x], nb, omega);
  }
  g.sync();
}

// One weighted-Jacobi sweep: new values into r, then r into u.
template <class G>
__device__ void jacobi_sweep(const View& v, float omega, G g) {
  const int i0 = max(v.row0, 1), i1 = min(v.row1, v.nx - 1);
  const int m = v.ny - 2;
  for (int t = g.rank(); t < (i1 - i0) * m; t += g.size()) {
    const int i = i0 + t / m, j = 1 + t % m;
    const int x = (i - v.row0) * v.ny + j;
    const float nb = nbsum_at(v, v.u, v.urow(i - 1), v.urow(i + 1), x, j);
    v.r[x] = jacobi_var_update(v.u[x], v.f[x], v.c[x], nb, omega);
  }
  g.sync();
  for (int t = g.rank(); t < (i1 - i0) * m; t += g.size()) {
    const int x = (i0 + t / m - v.row0) * v.ny + 1 + t % m;
    v.u[x] = v.r[x];
  }
  g.sync();
}

template <class G>
__device__ void smooth(const View& v, int sweeps, bool jacobi, float omega,
                       bool reverse, G g) {
  for (int k = 0; k < sweeps; ++k) {
    if (jacobi) {
      jacobi_sweep(v, omega, g);
    } else {
      rbgs_phase(v, reverse ? 1 : 0, omega, g);
      rbgs_phase(v, reverse ? 0 : 1, omega, g);
    }
  }
}

// r = f - A u on the unknowns v holds.
template <class G>
__device__ void residual(const View& v, G g) {
  const int i0 = max(v.row0, 1), i1 = min(v.row1, v.nx - 1);
  const int m = v.ny - 2;
  for (int t = g.rank(); t < (i1 - i0) * m; t += g.size()) {
    const int i = i0 + t / m, j = 1 + t % m;
    const int x = (i - v.row0) * v.ny + j;
    const float nb = nbsum_at(v, v.u, v.urow(i - 1), v.urow(i + 1), x, j);
    v.r[x] = __fsub_rn(v.f[x], __fsub_rn(__fmul_rn(v.c[x], v.u[x]), nb));
  }
  g.sync();
}

// Full weighting of v's residual onto the coarse interior rows I whose fine
// row 2I v holds: fc holds coarse rows from crow0 on, ncy wide.
template <class G>
__device__ void restrict_to(const View& v, float* fc, int crow0, int ncx,
                            int ncy, G g) {
  const int I0 = max((v.row0 + 1) / 2, 1), I1 = min((v.row1 + 1) / 2, ncx - 1);
  const int m = ncy - 2;
  for (int t = g.rank(); t < (I1 - I0) * m; t += g.size()) {
    const int I = I0 + t / m, J = 1 + t % m, jj = 2 * J;
    const float* r0 = v.rrow(2 * I - 1);
    const float* r1 = v.rrow(2 * I);
    const float* r2 = v.rrow(2 * I + 1);
    const float edges = __fadd_rn(
        __fadd_rn(__fadd_rn(r2[jj], r0[jj]), r1[jj + 1]), r1[jj - 1]);
    const float corners = __fadd_rn(
        __fadd_rn(__fadd_rn(r2[jj + 1], r0[jj + 1]), r2[jj - 1]), r0[jj - 1]);
    const float sum = __fadd_rn(
        __fadd_rn(__fmul_rn(4.0f, r1[jj]), __fmul_rn(2.0f, edges)), corners);
    fc[(I - crow0) * ncy + J] = __fdiv_rn(sum, 16.0f);
  }
  g.sync();
}

// u += P ec on the unknowns v holds; ec holds coarse rows [crow0, crow1),
// ec_dn is coarse row crow1 (a neighbour's) where it exists.
template <class G>
__device__ void prolong_from(const View& v, const float* ec, int crow0,
                             int crow1, const float* ec_dn, int ncy, G g) {
  const int i0 = max(v.row0, 1), i1 = min(v.row1, v.nx - 1);
  const int m = v.ny - 2;
  auto crow = [&](int I) {
    return I >= crow1 ? ec_dn : ec + (I - crow0) * ncy;
  };
  for (int t = g.rank(); t < (i1 - i0) * m; t += g.size()) {
    const int i = i0 + t / m, j = 1 + t % m, J = j >> 1;
    const float* c0 = crow(i >> 1);
    const float* c1 = (i & 1) ? crow((i >> 1) + 1) : c0;
    float e;
    if (!(i & 1) && !(j & 1)) {
      e = c0[J];
    } else if (!(i & 1)) {
      e = __fmul_rn(0.5f, __fadd_rn(c0[J], c0[J + 1]));
    } else if (!(j & 1)) {
      e = __fmul_rn(0.5f, __fadd_rn(c0[J], c1[J]));
    } else {
      e = __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(c0[J], c1[J]),
                                               c0[J + 1]),
                                     c1[J + 1]));
    }
    const int x = (i - v.row0) * v.ny + j;
    v.u[x] = __fadd_rn(v.u[x], e);
  }
  g.sync();
}

// The V-cycle over CTA 0's whole levels [from, levels - 1] run by group g,
// the coarsest solve included; `to` ends the descent early for the block
// part (the warp takes over at level `to`).
template <class G>
__device__ void walk_down(const TailVarParams& p, float* sm, int from, int to,
                          const cg::cluster_group& cl, G g) {
  for (int l = from; l < to; ++l) {
    const View v = make_view(p, sm, l, 0, cl);
    smooth(v, p.pre, p.jacobi, p.omega, false, g);
    residual(v, g);
    restrict_to(v, sm + p.off[l + 1] + p.stride[l + 1], 0, p.nx[l + 1],
                p.ny[l + 1], g);
  }
}

template <class G>
__device__ void walk_up(const TailVarParams& p, float* sm, int from, int to,
                        const cg::cluster_group& cl, G g) {
  for (int l = to - 1; l >= from; --l) {
    const View v = make_view(p, sm, l, 0, cl);
    prolong_from(v, sm + p.off[l + 1], 0, p.nx[l + 1], nullptr, p.ny[l + 1],
                 g);
    smooth(v, p.post, p.jacobi, p.omega, p.symmetric, g);
  }
}

template <class G>
__device__ void coarse_solve(const TailVarParams& p, float* sm,
                             const cg::cluster_group& cl, G g) {
  const View v = make_view(p, sm, p.levels - 1, 0, cl);
  smooth(v, p.coarse_sweeps, false, 1.0f, false, g);
}

// The coarsest solve by one warp on a level of at most 32 unknowns: a lane
// keeps its unknown, right-hand side and stencil in registers across the
// sweeps, so a colour phase is four neighbour loads, the update, one store
// and __syncwarp(). A level of one unknown (3^2) has only fixed
// neighbours: its lane takes the neighbour sum once and runs its red
// updates back to back (the black phases have nothing to update).
__device__ void coarse_solve_lanes(const TailVarParams& p, float* sm,
                                   const cg::cluster_group& cl) {
  const View v = make_view(p, sm, p.levels - 1, 0, cl);
  const int lane = threadIdx.x & 31, m = v.ny - 2;
  const int unknowns = (v.nx - 2) * m;
  const bool mine = lane < unknowns;
  const int i = 1 + lane / m, j = 1 + lane % m;
  const int x = mine ? i * v.ny + j : v.ny + 1;
  const int color = (i + j) & 1;
  const float c = v.c[x], w = v.w[x], e = v.e[x], s = v.s[x], n = v.n[x];
  const float fv = v.f[x];
  float uc = v.u[x];
  if (unknowns == 1) {
    if (lane == 0) {
      const float nb = nbsum_values(w, e, s, n, v.u[x - v.ny], v.u[x + v.ny],
                                    v.u[x - 1], v.u[x + 1]);
      for (int k = 0; k < p.coarse_sweeps; ++k)
        uc = rbgs_var_update(uc, fv, c, nb, 1.0f);
      v.u[x] = uc;
    }
    __syncwarp();
    return;
  }
  for (int k = 0; k < 2 * p.coarse_sweeps; ++k) {
    if (mine && (k & 1) == color) {
      const float nb = nbsum_values(w, e, s, n, v.u[x - v.ny], v.u[x + v.ny],
                                    v.u[x - 1], v.u[x + 1]);
      uc = rbgs_var_update(uc, fv, c, nb, 1.0f);
      v.u[x] = uc;
    }
    __syncwarp();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    tail_var_vcycle_kernel(T* __restrict__ u0, const T* __restrict__ f0,
                           TailVarParams p) {
  extern __shared__ float sm[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int L = p.levels, ns = p.ns;

  // loads: the planes of every level this CTA holds, the entry u and f;
  // u and f of the coarser levels start at zero. CTA 0's whole levels below
  // the split ones are a second commit group, awaited only before its walk
  for (int l = 0; l < L; ++l) {
    if (l >= ns && rank != 0) break;
    if (l == ns && ns > 0) cp_async_commit();
    const View v = make_view(p, sm, l, rank, cl);
    const int n = (v.row1 - v.row0) * v.ny;
    const long g0 = (long)v.row0 * v.ny;
    const Planes5& q = p.planes[l];
    float* dst[5] = {v.c, v.w, v.e, v.s, v.n};
    const float* src[5] = {q.c, q.w, q.e, q.s, q.n};
    const bool narrow = (p.planes_bf16 >> l) & 1;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      for (int a = 0; a < 5; ++a) {
        if (narrow)
          dst[a][t] = load_f(reinterpret_cast<const bf16*>(src[a]) + g0 + t);
        else
          cp_async4(dst[a] + t, src[a] + g0 + t, true);
      }
      if (l == 0) {
        load_shared(v.u + t, u0 + g0 + t);
        load_shared(v.f + t, f0 + g0 + t);
      } else {
        v.u[t] = 0.0f;
        v.f[t] = 0.0f;
      }
    }
  }
  cp_async_commit();
  if (ns > 0 && rank == 0)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  const ClusterGroup cluster{};
  cluster.sync();

  // down the split levels
  for (int l = 0; l < ns; ++l) {
    const View v = make_view(p, sm, l, rank, cl);
    smooth(v, p.pre, p.jacobi, p.omega, false, cluster);
    residual(v, cluster);
    if (l + 1 < ns) {
      const View c = make_view(p, sm, l + 1, rank, cl);
      restrict_to(v, c.f, c.row0, c.nx, c.ny, cluster);
    } else {
      float* fc = cl.map_shared_rank(sm + p.off[l + 1] + p.stride[l + 1], 0);
      restrict_to(v, fc, 0, p.nx[l + 1], p.ny[l + 1], cluster);
    }
  }

  // CTA 0 walks the rest: whole levels by the block, then by one warp
  if (rank == 0) {
    cp_async_wait<0>();
    __syncthreads();
    const BlockGroup block{};
    const int down_end = min(p.warp_from, L - 1);
    walk_down(p, sm, ns, down_end, cl, block);
    if (p.warp_from <= L - 1) {
      if (threadIdx.x < 32) {
        const WarpGroup warp{};
        walk_down(p, sm, p.warp_from, L - 1, cl, warp);
        if ((p.nx[L - 1] - 2) * (p.ny[L - 1] - 2) <= 32)
          coarse_solve_lanes(p, sm, cl);
        else
          coarse_solve(p, sm, cl, warp);
        walk_up(p, sm, p.warp_from, L - 1, cl, warp);
      }
      __syncthreads();
    } else {
      coarse_solve(p, sm, cl, block);
    }
    walk_up(p, sm, ns, down_end, cl, block);
  }
  cluster.sync();

  // up the split levels
  for (int l = ns - 1; l >= 0; --l) {
    const View v = make_view(p, sm, l, rank, cl);
    if (l + 1 < ns) {
      const View c = make_view(p, sm, l + 1, rank, cl);
      prolong_from(v, c.u, c.row0, c.row1, c.u_dn, c.ny, cluster);
    } else {
      const float* ec = cl.map_shared_rank(sm + p.off[l + 1], 0);
      prolong_from(v, ec, 0, p.nx[l + 1], nullptr, p.ny[l + 1], cluster);
    }
    smooth(v, p.post, p.jacobi, p.omega, p.symmetric, cluster);
  }

  // the entry u back, the rows this CTA holds (CTA 0 all of an unsplit one)
  if (ns > 0 || rank == 0) {
    const View v = make_view(p, sm, 0, rank, cl);
    const int n = (v.row1 - v.row0) * v.ny;
    for (int t = threadIdx.x; t < n; t += kThreads)
      store_f(u0 + (long)v.row0 * v.ny + t, v.u[t]);
  }
}

// Launch J on entry storage T with the cluster configuration cfg.
template <class T>
cudaError_t launch(T* u, const T* f, const TailVarParams& p,
                   cudaLaunchConfig_t& cfg, int device) {
  static bool done[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(tail_var_vcycle_kernel<T>, kMaxSmemBytes, device, done);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, tail_var_vcycle_kernel<T>, u, f, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One V(pre, post) cycle over `levels` levels, in place on the entry field
// u, on `stream`. `planes` holds 5 * levels device pointers, (c, w, e, s, n)
// per level, finest first; bit l of `planes_bf16` set: level l's planes are
// bf16, else fp32. u and f are bf16 when `entry_bf16`, else fp32.
int mg_tail_var_vcycle(void* u, const void* f, int levels, const int* nx,
                       const int* ny, const void* const* planes,
                       int planes_bf16, int pre, int post, float omega,
                       int jacobi, int coarse_sweeps, int symmetric,
                       int entry_bf16, int device, void* stream) {
  if (levels < 1 || levels > kTailMaxLevels)
    return (int)cudaErrorInvalidValue;
  const Plan q = plan(levels, nx, ny);
  if (q.bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  TailVarParams p{};
  p.levels = levels;
  p.ns = q.ns;
  p.b0 = q.b0;
  p.warp_from = q.warp_from;
  for (int l = 0; l < levels; ++l) {
    p.nx[l] = nx[l];
    p.ny[l] = ny[l];
    p.off[l] = q.off[l];
    p.stride[l] = q.stride[l];
    const float* const* s =
        reinterpret_cast<const float* const*>(planes) + 5 * l;
    p.planes[l] = Planes5{s[0], s[1], s[2], s[3], s[4]};
  }
  p.planes_bf16 = planes_bf16;
  p.pre = pre;
  p.post = post;
  p.coarse_sweeps = coarse_sweeps;
  p.jacobi = jacobi;
  p.symmetric = symmetric;
  p.omega = omega;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = q.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)(entry_bf16 ? launch(static_cast<bf16*>(u),
                                   static_cast<const bf16*>(f), p, cfg,
                                   device)
                            : launch(static_cast<float*>(u),
                                     static_cast<const float*>(f), p, cfg,
                                     device));
}

// J's plan for a tail of `levels` levels into out[8]: kCluster, kThreads,
// kMinBandRows, kWarpMaxNodes, split levels, band rows of level 0, first
// warp level, shared-memory bytes per CTA.
int mg_tail_var_geometry(int levels, const int* nx, const int* ny, int* out) {
  if (levels < 1 || levels > kTailMaxLevels)
    return (int)cudaErrorInvalidValue;
  const Plan q = plan(levels, nx, ny);
  const int g[8] = {kCluster, kThreads,    kMinBandRows, kWarpMaxNodes,
                    q.ns,     q.b0,        q.warp_from,  q.bytes};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
  return 0;
}

}  // extern "C"
