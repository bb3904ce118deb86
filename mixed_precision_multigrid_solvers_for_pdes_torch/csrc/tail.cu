// Kernel D: the whole coarse tail of a V(pre, post) cycle in one launch,
// walked in the shared memory of one CTA.
//
// Replaces the Pallas tail_vcycle of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/tail.py
// (:170, kernel body _tail_kernel :60): from the entry level (129^2 on the
// main path) down to the coarsest grid, pre-smoothing, fused
// residual+restriction, the coarsest solve (coarse_sweeps RB-GS sweeps with
// omega = 1), prolongation+correction and post-smoothing (colour order
// reversed when `symmetric`), all in fp32, in place on the entry field.
// The entry u and f are fp32 or bf16 (one dtype): bf16 ones are widened
// where they are loaded and u is rounded back once where it is stored, as
// the Pallas kernel casts its entry (:79-81). The levels below live only in
// shared memory, in fp32, whatever their dtype in the hierarchy; their
// stencils come as fp32 (the Pallas kernel's cast, :193).
//
// What bounds it: latency. A cycle from 129^2 moves ~0.2 MB (0.06 us at
// 3.35 TB/s) through ~120 dependent phases, 64 of them on the coarsest
// level's one unknown. On the H100 a __syncthreads() of 1024 threads costs
// ~38 ns, a cluster barrier ~0.72 us and a __syncwarp() ~1.5 ns (PERF.md),
// so D keeps every level on one SM and pays block barriers only.
//
// Design:
// - One CTA of kThreads threads. u and f of every level live in dynamic
//   shared memory (180,960 bytes from a 129^2 entry, of the 232,448 a block
//   may take): the entry level's u and f are loaded once (4-byte cp.async
//   from fp32: rows of odd length are not 16-byte aligned; 2-byte loads
//   from bf16), the coarser levels start
//   at zero, and the entry u is written back once. Nothing else touches
//   device memory, and the wrapper allocates no workspace.
// - A level's rows are padded to an even stride. A colour phase gives each
//   warp two neighbouring rows, sixteen nodes of the colour in each: the
//   nodes of one row lie two words apart and the two rows an odd number of
//   words apart, so the warp's 32 loads of each operand hit 32 banks.
//   Every thread of a phase takes nodes of the colour only.
// - The levels of more than kWarpMaxNodes nodes are walked by the block,
//   with __syncthreads() after each phase; from the first level of at most
//   kWarpMaxNodes nodes (9^2 and below) by its first warp alone, with
//   __syncwarp(), a lane per node of the phase (rows of 16 lanes would
//   leave most lanes idle there). The coarsest level, when it has at most
//   32 unknowns, keeps one unknown in each lane's registers; a single
//   unknown (3^2) has only fixed neighbours, so its sweeps run back to back
//   in one lane.
// - Weighted Jacobi needs the old values of a whole sweep: a thread keeps
//   its (at most kJacobiItems) new values in registers until the block has
//   computed all of them, so no scratch array is needed either.
// The plan (where each level sits, its row stride, the first warp level,
// the shared bytes) is computed by plan() below; mg_tail_geometry reports
// it, and ops/cuda_kernels/tail.py holds its own copy against that report.
//
// Arithmetic: the updates are kernel A's (rbgs_scalar_update,
// jacobi_scalar_update: every operation rounded explicitly, dividing by
// c), restriction and prolongation kernels B's
// and C's device functions (restrict_residual_at, prolong_at), so a cycle
// of D equals the same cycle run through A, B and C launches.
#include "common.cuh"

// The CTA's dynamic shared memory: every level's u and f (plan()).
extern __shared__ float sm[];

namespace {

constexpr int kThreads = 1024;        // threads of the CTA
constexpr int kWarpMaxNodes = 9 * 9;  // levels walked by one warp
constexpr int kJacobiItems = 16;      // unknowns a thread holds in a sweep
constexpr int kTailMaxLevels = 16;
constexpr int kMaxSmemBytes = 232448;

struct Plan {
  int warp_from;  // first level walked by one warp (levels when none)
  int lanes;      // 1: the coarsest level's unknowns in lanes' registers
  int off[kTailMaxLevels];  // float offset of a level's u (its f follows)
  int rs[kTailMaxLevels];   // row stride of a level: ny rounded up to even
  int bytes;                // dynamic shared memory
  int fits;  // 1: the bytes fit a CTA and every level's unknowns its threads
};

Plan plan(int levels, const int* nx, const int* ny) {
  Plan q{};
  q.warp_from = levels;
  for (int l = levels - 1; l >= 0 && nx[l] * ny[l] <= kWarpMaxNodes; --l)
    q.warp_from = l;
  const int L = levels - 1;
  q.lanes = q.warp_from <= L && (nx[L] - 2) * (ny[L] - 2) <= 32;
  int off = 0;
  q.fits = 1;
  for (int l = 0; l < levels; ++l) {
    q.rs[l] = (ny[l] + 1) & ~1;
    q.off[l] = off;
    off += 2 * nx[l] * q.rs[l];
    const int group = l >= q.warp_from ? 32 : kThreads;
    q.fits &= (nx[l] - 2) * (ny[l] - 2) <= kJacobiItems * group;
  }
  q.bytes = off * (int)sizeof(float);
  q.fits &= q.bytes <= kMaxSmemBytes;
  return q;
}

struct TailParams {
  int levels, warp_from, lanes;
  int nx[kTailMaxLevels];
  int ny[kTailMaxLevels];
  int off[kTailMaxLevels];
  int rs[kTailMaxLevels];
  Stencil5 st[kTailMaxLevels];
  int pre, post, coarse_sweeps;
  int jacobi;     // 1: weighted Jacobi pre/post smoothing, 0: RB-GS/SOR
  int symmetric;  // 1: post-smoothing runs black before red
  float omega;
};

// One level in shared memory: node (i, j) of u at sm[u + i * rs + j], f
// alike. Offsets into the __shared__ array keep every access a 32-bit
// shared-memory one.
struct Level {
  int u, f;
  int nx, ny, rs;
  Stencil5 st;
};

__device__ Level level(const TailParams& p, int l) {
  const int u = p.off[l];
  return Level{u, u + p.nx[l] * p.rs[l], p.nx[l], p.ny[l], p.rs[l],
               p.st[l]};
}

// The threads that run a phase and the barrier that ends it. The block
// hands out rows to its warps (kRows); the warp, alone on a small level,
// hands out nodes to its lanes, so that it takes one pass where it can.
template <bool P>
struct BlockGroup {
  static constexpr bool kRows = true;
  static constexpr bool kPow2 = P;  // every level's c a power of two
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return kThreads; }
  __device__ int warp() const { return threadIdx.x >> 5; }
  __device__ int warps() const { return kThreads / 32; }
  __device__ void sync() const { __syncthreads(); }
};
template <bool P>
struct WarpGroup {
  static constexpr bool kRows = false;
  static constexpr bool kPow2 = P;
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ int warp() const { return 0; }
  __device__ int warps() const { return 1; }
  __device__ void sync() const { __syncwarp(); }
};

template <bool kPow2>
__device__ __forceinline__ void rbgs_node(const Level& v, int i, int j,
                                          float omega) {
  const int x = v.u + i * v.rs + j;
  sm[x] = rbgs_scalar_update<kPow2>(sm[x], sm[x - v.u + v.f], sm[x - v.rs],
                                    sm[x + v.rs], sm[x - 1], sm[x + 1], v.st,
                                    omega);
}

// One colour phase. In the block a warp takes the interior rows 2q + 1 and
// 2q + 2, sixteen lanes each, and in each of them the nodes of the colour
// in chunks of sixteen; in the warp lane t takes the t-th node of the
// colour, rows first.
template <class G>
__device__ void rbgs_phase(const Level& v, int color, float omega, G g) {
  if constexpr (G::kRows) {
    const int chunks = ((v.ny - 1) / 2 + 15) / 16;  // per row
    const int lane = threadIdx.x & 31;
    for (int q = g.warp(); q < (v.nx - 1) / 2; q += g.warps()) {
      const int i = 1 + 2 * q + (lane >> 4);
      const int j0 = 1 + ((i + 1 + color) & 1) + 2 * (lane & 15);
      for (int c = 0; c < chunks; ++c) {
        const int j = j0 + 32 * c;
        if (i <= v.nx - 2 && j <= v.ny - 2)
          rbgs_node<G::kPow2>(v, i, j, omega);
      }
    }
  } else {
    const int hc = (v.ny - 1) / 2;  // nodes of one colour in a row, at most
    for (int t = g.rank(); t < (v.nx - 2) * hc; t += g.size()) {
      const int i = 1 + t / hc;
      const int j = 1 + ((i + 1 + color) & 1) + 2 * (t - (i - 1) * hc);
      if (j <= v.ny - 2) rbgs_node<G::kPow2>(v, i, j, omega);
    }
  }
  g.sync();
}

// One weighted-Jacobi sweep: every new value in registers before any store.
template <class G>
__device__ void jacobi_sweep(const Level& v, float omega, G g) {
  const int m = v.ny - 2, total = (v.nx - 2) * m;
  float nv[kJacobiItems];
#pragma unroll
  for (int r = 0; r < kJacobiItems; ++r) {
    const int t = g.rank() + r * g.size();
    if (t < total) {
      const int x = v.u + (1 + t / m) * v.rs + 1 + t % m;
      nv[r] = jacobi_scalar_update<G::kPow2>(
          sm[x], sm[x - v.u + v.f], sm[x - v.rs], sm[x + v.rs], sm[x - 1],
          sm[x + 1], v.st, omega);
    }
  }
  g.sync();
#pragma unroll
  for (int r = 0; r < kJacobiItems; ++r) {
    const int t = g.rank() + r * g.size();
    if (t < total) sm[v.u + (1 + t / m) * v.rs + 1 + t % m] = nv[r];
  }
  g.sync();
}

template <class G>
__device__ void smooth(const Level& v, int sweeps, bool jacobi, float omega,
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

// fn(i, j) for every interior node of an (nx, ny) level: in the block a
// warp per row, in the warp a lane per node.
template <class G, class Fn>
__device__ void for_interior(int nx, int ny, G g, Fn fn) {
  if constexpr (G::kRows) {
    const int lane = threadIdx.x & 31;
    for (int i = 1 + g.warp(); i < nx - 1; i += g.warps())
      for (int j = 1 + lane; j < ny - 1; j += 32) fn(i, j);
  } else {
    const int m = ny - 2;
    for (int t = g.rank(); t < (nx - 2) * m; t += g.size())
      fn(1 + t / m, 1 + t % m);
  }
}

// fc = R(f - A u) on the interior of the coarse level c (its ring stays 0).
template <class G>
__device__ void restrict_to(const Level& v, const Level& c, G g) {
  for_interior(c.nx, c.ny, g, [&](int I, int J) {
    sm[c.f + I * c.rs + J] =
        restrict_residual_at(sm + v.u, sm + v.f, I, J, v.rs, v.st);
  });
  g.sync();
}

// u += P ec on the interior of v, ec the coarse level's u.
template <class G>
__device__ void prolong_from(const Level& v, const Level& c, G g) {
  for_interior(v.nx, v.ny, g, [&](int i, int j) {
    sm[v.u + i * v.rs + j] += prolong_at(sm + c.u, i, j, c.rs);
  });
  g.sync();
}

template <class G>
__device__ void walk_down(const TailParams& p, int from, int to, G g) {
  for (int l = from; l < to; ++l) {
    const Level v = level(p, l);
    smooth(v, p.pre, p.jacobi, p.omega, false, g);
    restrict_to(v, level(p, l + 1), g);
  }
}

template <class G>
__device__ void walk_up(const TailParams& p, int from, int to, G g) {
  for (int l = to - 1; l >= from; --l) {
    const Level v = level(p, l);
    prolong_from(v, level(p, l + 1), g);
    smooth(v, p.post, p.jacobi, p.omega, p.symmetric, g);
  }
}

// The coarsest solve by one warp on a level of at most 32 unknowns: a lane
// keeps its unknown and right-hand side in registers across the sweeps, so
// a colour phase is four neighbour loads, the update, one store and
// __syncwarp(). A level of one unknown has only fixed neighbours: its lane
// runs its red updates back to back (the black phases update nothing).
template <bool kPow2>
__device__ void coarse_solve_lanes(const TailParams& p) {
  const Level v = level(p, p.levels - 1);
  const int lane = threadIdx.x & 31, m = v.ny - 2;
  const int unknowns = (v.nx - 2) * m;
  const bool mine = lane < unknowns;
  const int i = 1 + lane / m, j = 1 + lane % m;
  const int x = v.u + (mine ? i * v.rs + j : v.rs + 1);
  const int color = (i + j) & 1;
  const float fv = sm[x - v.u + v.f];
  float uc = sm[x];
  if (unknowns == 1) {
    if (lane == 0) {
      const float W = sm[x - v.rs], E = sm[x + v.rs], S = sm[x - 1],
                  N = sm[x + 1];
      for (int k = 0; k < p.coarse_sweeps; ++k)
        uc = rbgs_scalar_update<kPow2>(uc, fv, W, E, S, N, v.st, 1.0f);
      sm[x] = uc;
    }
    __syncwarp();
    return;
  }
  for (int k = 0; k < 2 * p.coarse_sweeps; ++k) {
    if (mine && (k & 1) == color) {
      uc = rbgs_scalar_update<kPow2>(uc, fv, sm[x - v.rs], sm[x + v.rs],
                                     sm[x - 1], sm[x + 1], v.st, 1.0f);
      sm[x] = uc;
    }
    __syncwarp();
  }
}

template <class G>
__device__ void coarse_solve(const TailParams& p, G g) {
  smooth(level(p, p.levels - 1), p.coarse_sweeps, false, 1.0f, false, g);
}

template <class T, bool kPow2>
__global__ void __launch_bounds__(kThreads, 1)
    tail_vcycle_kernel(T* __restrict__ u0, const T* __restrict__ f0,
                       TailParams p) {
  const int L = p.levels;

  // the entry u and f into their padded rows; the coarser levels start at 0
  const Level top = level(p, 0);
  for (int t = threadIdx.x; t < top.nx * top.ny; t += kThreads) {
    const int i = t / top.ny, x = i * top.rs + t - i * top.ny;
    load_shared(sm + top.u + x, u0 + t);
    load_shared(sm + top.f + x, f0 + t);
  }
  cp_async_commit();
  if (L > 1) {
    const int end = p.off[L - 1] + 2 * p.nx[L - 1] * p.rs[L - 1];
    for (int t = p.off[1] + threadIdx.x; t < end; t += kThreads) sm[t] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const BlockGroup<kPow2> block{};
  const int down_end = min(p.warp_from, L - 1);
  walk_down(p, 0, down_end, block);
  if (p.warp_from <= L - 1) {
    if (threadIdx.x < 32) {
      const WarpGroup<kPow2> warp{};
      walk_down(p, p.warp_from, L - 1, warp);
      if (p.lanes)
        coarse_solve_lanes<kPow2>(p);
      else
        coarse_solve(p, warp);
      walk_up(p, p.warp_from, L - 1, warp);
    }
    __syncthreads();
  } else {
    coarse_solve(p, block);
  }
  walk_up(p, 0, down_end, block);

  // the entry u back (its ring as loaded)
  for (int t = threadIdx.x; t < top.nx * top.ny; t += kThreads) {
    const int i = t / top.ny;
    store_f(u0 + t, sm[top.u + i * top.rs + t - i * top.ny]);
  }
}

template <class T, bool kPow2>
cudaError_t launch(void* u, const void* f, const TailParams& p, int bytes,
                   int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel = tail_vcycle_kernel<T, kPow2>;
  const cudaError_t err = allow_smem(kernel, kMaxSmemBytes, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, bytes, stream>>>(static_cast<T*>(u),
                                         static_cast<const T*>(f), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One V(pre, post) cycle over `levels` levels, in place on the entry field
// u, on `stream`. coefs holds (c, w, e, s, n) per level, finest first. u and
// f are bf16 when `entry_bf16`, else fp32.
int mg_tail_vcycle(void* u, const void* f, int levels, const int* nx,
                   const int* ny, const float* coefs, int pre, int post,
                   float omega, int jacobi, int coarse_sweeps, int symmetric,
                   int entry_bf16, int device, void* stream) {
  if (levels < 1 || levels > kTailMaxLevels)
    return (int)cudaErrorInvalidValue;
  const Plan q = plan(levels, nx, ny);
  if (!q.fits) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  TailParams p{};
  p.levels = levels;
  p.warp_from = q.warp_from;
  p.lanes = q.lanes;
  for (int l = 0; l < levels; ++l) {
    p.nx[l] = nx[l];
    p.ny[l] = ny[l];
    p.off[l] = q.off[l];
    p.rs[l] = q.rs[l];
    p.st[l] = Stencil5{coefs[5 * l], coefs[5 * l + 1], coefs[5 * l + 2],
                       coefs[5 * l + 3], coefs[5 * l + 4]};
  }
  p.pre = pre;
  p.post = post;
  p.coarse_sweeps = coarse_sweeps;
  p.jacobi = jacobi;
  p.symmetric = symmetric;
  p.omega = omega;
  bool p2 = true;  // every level's c a power of two: no division
  for (int l = 0; l < levels; ++l) p2 = p2 && is_pow2(coefs[5 * l]);
  const cudaStream_t t = (cudaStream_t)stream;
  if (entry_bf16)
    return (int)(p2 ? launch<bf16, true>(u, f, p, q.bytes, device, t)
                    : launch<bf16, false>(u, f, p, q.bytes, device, t));
  return (int)(p2 ? launch<float, true>(u, f, p, q.bytes, device, t)
                  : launch<float, false>(u, f, p, q.bytes, device, t));
}

// D's plan for a tail of `levels` levels into out[8 + 2 * levels]:
// kThreads, kWarpMaxNodes, kJacobiItems, kMaxSmemBytes, the first warp
// level, lanes, shared-memory bytes, fits, then each level's float offset
// and row stride.
int mg_tail_geometry(int levels, const int* nx, const int* ny, int* out) {
  if (levels < 1 || levels > kTailMaxLevels)
    return (int)cudaErrorInvalidValue;
  const Plan q = plan(levels, nx, ny);
  const int g[8] = {kThreads,    kWarpMaxNodes, kJacobiItems, kMaxSmemBytes,
                    q.warp_from, q.lanes,       q.bytes,      q.fits};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
  for (int l = 0; l < levels; ++l) {
    out[8 + 2 * l] = q.off[l];
    out[9 + 2 * l] = q.rs[l];
  }
  return 0;
}

}  // extern "C"
