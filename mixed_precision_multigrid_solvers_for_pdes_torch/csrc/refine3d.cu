// Kernel N: the float64 outer step of the 3D mixed-precision iterative
// refinement (solvers/multigrid3d.py, ir_solve3d), fused into one pass.
//
// N replaces no Pallas kernel: the JAX package's _ir3_jit
// (mixed_precision_multigrid_solvers_for_pdes_tpu/solvers/multigrid3d.py)
// leaves this step to XLA, which fuses it there. The port ran it as ~30 eager
// PyTorch passes over 1.08 GB fp64 fields a step (a zero fill, six
// coefficient products and five adds on shifted views, torch.where, r*r and
// its sum, the low-precision cast, the masked u += e), each leaving a full
// fp64 temporary.
//
// What one launch does on a constant-coefficient 7-point stencil on an
// all-Dirichlet box, in float64:
// - step mode (e given): u_out = u_in + e on the interior and u_in on the
//   shell; r = f - A u_out from the updated values, its halo included;
//   r_lo = r rounded to the level's dtype (fp32, or bf16 through fp32 as
//   PyTorch's cast rounds a double), zero on the shell; the sum of r^2 over
//   the interior. The fp64 r is never stored.
// - start mode (no e): r from u_in, r_lo, and the sums of r^2 and of f^2
//   over the interior (the residual norm and the masked norm of f).
// Every operation is rounded explicitly in the plain twin's order
// (ops/stencil3d.residual: ns = w*uW + e*uE + s*uS + n*uN + b*uB + t*uT,
// then f - (c*u - ns)) by __dmul_rn, __dadd_rn and __dsub_rn, which nvcc
// never contracts into FMAs, so u_out and r_lo equal the twin bit for bit.
//
// Out of place: u_out is a second fp64 buffer, never u_in. In place, a
// block's halo is another block's interior, which that block may already
// have updated. The caller ping-pongs the iterate between two buffers.
//
// Norms, deterministic: each block sums its nodes' squares (each thread in
// plane order, then a fixed shuffle tree) and writes its partial to the
// wrapper's scratch; the last block to finish (a __threadfence and an atomic
// ticket pick it) sums the partials in a fixed order (thread t takes
// partials t, t + kRfThreads, ..., then the same tree), writes
// sqrt(h^3 * sum) and resets the ticket. Reruns give the same bits; only the
// order of summation differs from torch.sum.
//
// Bound: device memory bandwidth. A step must read u_in (8 bytes a node), e
// (4, fp32) and f (8) and write u_out (8) and r_lo (4): 32 bytes a node,
// 4.32 GB at 513^3, 1.29 ms at 3.35 TB/s; the start 20 bytes a node.
//
// Design (2.5D blocking):
// - A block owns a kRfTileY x kRfTileZ tile of the (y, z) interior, z
//   innermost (a warp takes one row of 32 nodes, coalesced 8-byte loads and
//   stores; fp64 rows of 513 nodes are only 8-byte aligned, which is all an
//   8-byte cp.async needs), and marches along a chunk of x-planes [x0, x1).
// - Each plane of the window (the tile and a one-node halo in y and z, no
//   corners) comes in by cp.async into a ring of kRfSlots slots, kRfAhead
//   planes ahead of the compute: u_in at every window node, e at the window's
//   interior nodes, f at the tile's nodes of the chunk's planes. One barrier
//   a plane.
// - When plane p has landed, each thread turns its own window nodes of it
//   into u_out in place (u_in + e on interior nodes), and computes the
//   residual of its tile node on plane p - 1: its in-plane neighbours from
//   the window of plane p - 1 (turned at the previous step), its x
//   neighbours and its own value from registers. So each node of u, e and f
//   is read once, plus the window's halo (mostly from L2) and the chunk's
//   two end planes.
// - The shell: a halo node on the (y, z) shell is written (u_out = u_in,
//   r_lo = 0) by the one tile whose span (common.cuh tile_span) holds it;
//   planes 0 and nx - 1 by an extra x-chunk of blocks (the last gridDim.z).
// - Tiles and x-chunks are sized in mg_refine_step3d from the card's
//   multiprocessor count, so that several blocks fill each of them.
//
// Storage: u_in, f and u_out fp64; e and r_lo fp32 or bf16 (the level's
// dtype, one type). A bf16 e at an interior node comes in as the aligned
// 4-byte word that holds it (its other half is a neighbouring node of the
// same field, never outside the tensor), and is widened from the half its
// address selects.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

// The geometry below is this file's own.
constexpr int kRfTileY = 8;      // tile rows (y)
constexpr int kRfTileZ = 32;     // tile columns (z), one warp
constexpr int kRfThreads = kRfTileY * kRfTileZ;  // a tile node each
constexpr int kRfAhead = 3;      // planes in flight ahead of the landed one
// slots: the window of plane p - 1 (read), plane p (landed, turned), the
// kRfAhead - 1 planes still in flight and the one issued at step p
constexpr int kRfSlots = kRfAhead + 2;
constexpr int kRfWinY = kRfTileY + 2;
constexpr int kRfWinZ = kRfTileZ + 2;
constexpr int kRfWin = kRfWinY * kRfWinZ;
// halo: the rows above and below the tile, the columns left and right of
// it, and the window's four corners (loaded where they are corners of the
// field's (y, z) shell, which only the shell writes read)
constexpr int kRfHalo = 2 * kRfTileZ + 2 * kRfTileY + 4;
constexpr int kRfBlocksPerSM = 4;
constexpr int kRfMinChunk = 8;   // fewest x-planes of a chunk
constexpr int kRfMaxChunk = 32;  // most x-planes of a chunk
constexpr int kRfWarps = kRfThreads / 32;

static_assert(kRfHalo <= kRfThreads, "N: one halo node a thread at most");
static_assert(kRfTileZ == 32, "N: a warp takes one tile row");

struct Stencil7d {
  double c, w, e, s, n, b, t;
};

// One plane of the ring.
struct RfSlot {
  double u[kRfWin];      // u_in over the window, turned into u_out
  double f[kRfThreads];  // f at the tile's nodes
  unsigned e[kRfWin];    // the 4-byte word holding e at each window node
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// The aligned 4-byte word holding element i of e, and e's value from it.
__device__ __forceinline__ const void* e_word(const float* e, long i) {
  return e + i;
}
__device__ __forceinline__ const void* e_word(const bf16* e, long i) {
  return reinterpret_cast<const void*>(
      reinterpret_cast<uintptr_t>(e + i) & ~uintptr_t(3));
}
__device__ __forceinline__ double e_value(const float*, unsigned w, long) {
  return (double)__uint_as_float(w);
}
__device__ __forceinline__ double e_value(const bf16* e, unsigned w,
                                          long i) {
  const bool hi = (reinterpret_cast<uintptr_t>(e + i) >> 1) & 1;
  return (double)__uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

// r rounded as PyTorch's Tensor.to rounds a double: to fp32, and from fp32
// to bf16 (round to nearest even at each step).
__device__ __forceinline__ void store_lo(float* p, double r) {
  *p = __double2float_rn(r);
}
__device__ __forceinline__ void store_lo(bf16* p, double r) {
  *p = __float2bfloat16_rn(__double2float_rn(r));
}

// Sum of v over the block, in a fixed order (a shuffle tree in each warp,
// then warp 0 over the warps' sums); the result in thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kRfWarps ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

template <class T, bool kStep>
__global__ void __launch_bounds__(kRfThreads, kRfBlocksPerSM)
    refine_step3d_kernel(const double* __restrict__ u_in,
                         const T* __restrict__ e,
                         const double* __restrict__ f,
                         double* __restrict__ u_out, T* __restrict__ r_lo,
                         double* __restrict__ norms,
                         double* __restrict__ partials, int nx, int ny,
                         int nz, int chunk, Stencil7d st, double h3) {
  __shared__ RfSlot slots[kRfSlots];
  __shared__ double red[kRfWarps];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long sx = (long)ny * nz;
  const int nb = gridDim.x * gridDim.y * gridDim.z;
  const int bid =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  double acc_r = 0.0, acc_f = 0.0;

  if (blockIdx.z == gridDim.z - 1) {
    // planes 0 and nx - 1: the tile's span of the shell
    int jlo, jhi, klo, khi;
    tile_span(blockIdx.y, kRfTileY, ny, &jlo, &jhi);
    tile_span(blockIdx.x, kRfTileZ, nz, &klo, &khi);
    const int cols = khi - klo, nodes = (jhi - jlo) * cols;
    for (int q = 0; q < 2; ++q) {
      const long base = q ? (long)(nx - 1) * sx : 0;
      for (int t = tid; t < nodes; t += kRfThreads) {
        const long i =
            base + (long)(jlo + t / cols) * nz + klo + t % cols;
        if (kStep) u_out[i] = u_in[i];
        store_lo(r_lo + i, 0.0);
      }
    }
  } else {
    const int x0 = 1 + blockIdx.z * chunk, x1 = min(x0 + chunk, nx - 1);
    const int ylo = 1 + blockIdx.y * kRfTileY;
    const int yhi = min(ylo + kRfTileY, ny - 1);
    const int zlo = 1 + blockIdx.x * kRfTileZ;
    const int zhi = min(zlo + kRfTileZ, nz - 1);
    // this thread's tile node: window word ow, in-plane offset og
    const int ly = tid / kRfTileZ, lz = tid % kRfTileZ;
    const bool own = ylo + ly < yhi && zlo + lz < zhi;
    const int ow = (ly + 1) * kRfWinZ + lz + 1;
    const int og = (ylo + ly) * nz + zlo + lz;
    // this thread's halo node (tid < kRfHalo): window row and column, field
    // row and column, whether it lies in the field's (y, z) shell (then the
    // tile's span holds it, and this thread writes it)
    int hy = 0, hz = 0, wy = 0, wz = 0;
    bool halo = false, shell = false;
    if (tid < kRfTileZ) {  // the row above
      hy = ylo - 1, hz = zlo + tid, wy = 0, wz = 1 + tid;
      halo = hz < zhi, shell = hy == 0;
    } else if (tid < 2 * kRfTileZ) {  // the row below
      const int t = tid - kRfTileZ;
      hy = yhi, hz = zlo + t, wy = yhi - ylo + 1, wz = 1 + t;
      halo = hz < zhi, shell = hy == ny - 1;
    } else if (tid < 2 * kRfTileZ + kRfTileY) {  // the column left
      const int t = tid - 2 * kRfTileZ;
      hy = ylo + t, hz = zlo - 1, wy = 1 + t, wz = 0;
      halo = hy < yhi, shell = hz == 0;
    } else if (tid < 2 * kRfTileZ + 2 * kRfTileY) {  // the column right
      const int t = tid - 2 * kRfTileZ - kRfTileY;
      hy = ylo + t, hz = zhi, wy = 1 + t, wz = zhi - zlo + 1;
      halo = hy < yhi, shell = hz == nz - 1;
    } else if (tid < kRfHalo) {  // a corner, where it is the shell's
      const int t = tid - 2 * kRfTileZ - 2 * kRfTileY;
      hy = (t & 2) ? yhi : ylo - 1, hz = (t & 1) ? zhi : zlo - 1;
      wy = (t & 2) ? yhi - ylo + 1 : 0, wz = (t & 1) ? zhi - zlo + 1 : 0;
      shell = (hy == 0 || hy == ny - 1) && (hz == 0 || hz == nz - 1);
      halo = shell;
    }
    shell = shell && halo;  // a row's or column's nodes past the tile's
                            // span belong to no one here
    const bool inner = halo && !shell;  // an interior node: e applies
    const int hw = wy * kRfWinZ + wz;
    const int hg = hy * nz + hz;

    // plane p's loads, one commit group (empty past the chunk's last plane)
    auto issue = [&](int p) {
      if (p <= x1) {
        RfSlot& s = slots[p % kRfSlots];
        const long base = (long)p * sx;
        const bool px = p >= 1 && p <= nx - 2;
        if (own) {
          cp_async8(&s.u[ow], u_in + base + og);
          if (kStep && px) cp_async4(&s.e[ow], e_word(e, base + og));
          if (p >= x0 && p < x1) cp_async8(&s.f[tid], f + base + og);
        }
        if (halo) {
          cp_async8(&s.u[hw], u_in + base + hg);
          if (kStep && px && inner)
            cp_async4(&s.e[hw], e_word(e, base + hg));
        }
      }
      cp_async_commit();
    };

    for (int d = 0; d < kRfAhead; ++d) issue(x0 - 1 + d);
    double uw = 0.0, uc = 0.0;  // u_out of the tile node at planes p-2, p-1
    for (int p = x0 - 1; p <= x1; ++p) {
      cp_async_wait<kRfAhead - 1>();
      __syncthreads();  // plane p has landed; plane p - 2's slot is free
      issue(p + kRfAhead);
      // turn this thread's nodes of plane p into u_out
      RfSlot& sp = slots[p % kRfSlots];
      const long bp = (long)p * sx;
      const bool px = p >= 1 && p <= nx - 2;
      double up = 0.0;
      if (own) {
        up = sp.u[ow];
        if (kStep && px) {
          up = __dadd_rn(up, e_value(e, sp.e[ow], bp + og));
          sp.u[ow] = up;
        }
      }
      if (kStep && px && inner)
        sp.u[hw] = __dadd_rn(sp.u[hw], e_value(e, sp.e[hw], bp + hg));
      if (p > x0) {
        // plane c = p - 1 of the chunk
        const int c = p - 1;
        const RfSlot& sc = slots[c % kRfSlots];
        const long bc = (long)c * sx;
        if (own) {
          double ns = __dmul_rn(st.w, uw);
          ns = __dadd_rn(ns, __dmul_rn(st.e, up));
          ns = __dadd_rn(ns, __dmul_rn(st.s, sc.u[ow - kRfWinZ]));
          ns = __dadd_rn(ns, __dmul_rn(st.n, sc.u[ow + kRfWinZ]));
          ns = __dadd_rn(ns, __dmul_rn(st.b, sc.u[ow - 1]));
          ns = __dadd_rn(ns, __dmul_rn(st.t, sc.u[ow + 1]));
          const double fv = sc.f[tid];
          const double r =
              __dsub_rn(fv, __dsub_rn(__dmul_rn(st.c, uc), ns));
          if (kStep) u_out[bc + og] = uc;
          store_lo(r_lo + bc + og, r);
          acc_r = __dadd_rn(acc_r, __dmul_rn(r, r));
          if (!kStep) acc_f = __dadd_rn(acc_f, __dmul_rn(fv, fv));
        }
        if (shell) {
          if (kStep) u_out[bc + hg] = sc.u[hw];
          store_lo(r_lo + bc + hg, 0.0);
        }
      }
      uw = uc;
      uc = up;
    }
    cp_async_wait<0>();
  }

  // the block's partial sums, then the last block's total
  acc_r = block_sum(acc_r, red);
  if (!kStep) acc_f = block_sum(acc_f, red);
  if (tid == 0) {
    partials[bid] = acc_r;
    if (!kStep) partials[nb + bid] = acc_f;
    __threadfence();
    unsigned* ticket = reinterpret_cast<unsigned*>(partials + 2 * nb);
    last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  double sr = 0.0, sf = 0.0;
  for (int i = tid; i < nb; i += kRfThreads) {
    sr = __dadd_rn(sr, __ldcg(partials + i));
    if (!kStep) sf = __dadd_rn(sf, __ldcg(partials + nb + i));
  }
  sr = block_sum(sr, red);
  if (!kStep) sf = block_sum(sf, red);
  if (tid == 0) {
    norms[0] = sqrt(__dmul_rn(h3, sr));
    if (!kStep) norms[1] = sqrt(__dmul_rn(h3, sf));
    *reinterpret_cast<unsigned*>(partials + 2 * nb) = 0u;  // for the next
  }
}

// Tiles along z and y, and the x-chunks: as many chunks as fill the card
// with kRfBlocksPerSM blocks a multiprocessor, none under kRfMinChunk planes
// (unless the field has fewer) nor over kRfMaxChunk.
struct RfPlan {
  int tz, ty, chunk, chunks;
  int blocks() const { return tz * ty * (chunks + 1); }
};

cudaError_t rf_plan(int nx, int ny, int nz, int device, RfPlan* plan) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  RfPlan p;
  p.tz = (nz - 2 + kRfTileZ - 1) / kRfTileZ;
  p.ty = (ny - 2 + kRfTileY - 1) / kRfTileY;
  const int planes = nx - 2;
  const int fill = std::max(1, std::min(sms[device] * kRfBlocksPerSM /
                                            (p.tz * p.ty),
                                        planes / kRfMinChunk));
  p.chunk = std::min((planes + fill - 1) / fill, kRfMaxChunk);
  p.chunks = (planes + p.chunk - 1) / p.chunk;
  *plan = p;
  return cudaSuccess;
}

template <class T, bool kStep>
cudaError_t refine_step3d_typed(const void* u_in, const void* e,
                                const void* f, void* u_out, void* r_lo,
                                void* norms, void* scratch, int nx, int ny,
                                int nz, const Stencil7d& st, double h3,
                                const RfPlan& p, cudaStream_t stream) {
  const dim3 grid(p.tz, p.ty, p.chunks + 1);
  refine_step3d_kernel<T, kStep><<<grid, kRfThreads, 0, stream>>>(
      static_cast<const double*>(u_in), static_cast<const T*>(e),
      static_cast<const double*>(f), static_cast<double*>(u_out),
      static_cast<T*>(r_lo), static_cast<double*>(norms),
      static_cast<double*>(scratch), nx, ny, nz, p.chunk, st, h3);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The blocks of a launch on an (nx, ny, nz) field: the scratch of
// mg_refine_step3d holds 2 * blocks doubles and a 4-byte ticket after them.
int mg_refine3d_blocks(int nx, int ny, int nz, int device, int* blocks) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  RfPlan p;
  const cudaError_t err = rf_plan(nx, ny, nz, device, &p);
  if (err != cudaSuccess) return (int)err;
  *blocks = p.blocks();
  return 0;
}

// One refinement step (e non-null: u_out = u_in + e on the interior, r from
// u_out, norms[0] = sqrt(h3 * sum r^2)) or the start (e and u_out null: r
// from u_in, norms[0] as above, norms[1] = sqrt(h3 * sum f^2) over the
// interior). r_lo = r in the level's dtype (bf16 when lo_bf16, else fp32),
// zero on the shell. u_in, f and u_out are fp64 (nx, ny, nz) fields; u_out
// must not alias u_in. scratch: mg_refine3d_blocks' layout, its ticket 0
// (each launch leaves it 0).
int mg_refine_step3d(const void* u_in, const void* e, const void* f,
                     void* u_out, void* r_lo, void* norms, void* scratch,
                     int nx, int ny, int nz, double c, double w, double ce,
                     double s, double n, double b, double t, double h3,
                     int lo_bf16, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 3 || ny < 3 || nz < 3 || (e == nullptr) != (u_out == nullptr))
    return (int)cudaErrorInvalidValue;
  RfPlan p;
  err = rf_plan(nx, ny, nz, device, &p);
  if (err != cudaSuccess) return (int)err;
  const Stencil7d st{c, w, ce, s, n, b, t};
  const cudaStream_t q = (cudaStream_t)stream;
  const bool step = e != nullptr;
  if (lo_bf16)
    return (int)(step ? refine_step3d_typed<bf16, true>(
                            u_in, e, f, u_out, r_lo, norms, scratch, nx, ny,
                            nz, st, h3, p, q)
                      : refine_step3d_typed<bf16, false>(
                            u_in, e, f, u_out, r_lo, norms, scratch, nx, ny,
                            nz, st, h3, p, q));
  return (int)(step ? refine_step3d_typed<float, true>(
                          u_in, e, f, u_out, r_lo, norms, scratch, nx, ny,
                          nz, st, h3, p, q)
                    : refine_step3d_typed<float, false>(
                          u_in, e, f, u_out, r_lo, norms, scratch, nx, ny,
                          nz, st, h3, p, q));
}

}  // extern "C"
