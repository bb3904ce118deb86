// Kernel L: RB-GS / SOR sweeps on a standard (nx, ny) field through parity
// planes held in shared memory, with a constant-coefficient 5-point stencil
// on an all-Dirichlet rectangle.
//
// Replaces the layout="parity" body of the Pallas kernels multisweep and
// multisweep_strips (_parity_sweeps, _split_parity, _merge_parity) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py
// (:119, reached from _smooth_kernel :211 and _strips_kernel :413): split in
// on-chip memory, sweep, merge.
//
// Design: one launch per call, whatever the sweep count. Each block owns a
// tile of kTileX x kTileY nodes of the output and loads a window of u and f
// around it, the tile plus a halo of 2 * sweeps nodes per side clamped to the
// field, into shared memory as the four parity planes (ee, eo, oe, oo) of
// u and of f. Tile and halo are even, so a window starts on an even node and
// plane identity in the window is the node's global parity. The block then
// runs every sweep in shared memory, red then black, with __syncthreads()
// between colour phases; in a phase the threads walk the cells of that
// colour's two planes only, so no thread idles on the other colour, and a
// phase reads only the other colour's planes, so the update in place has no
// race. A node is updated only if it is inside the window and not on its
// border; the window is clamped to the field, so these are exactly the
// unknowns it can update. A stale border value travels one node per colour
// phase, 2 * sweeps - 1 nodes in all, so the tile, 2 * sweeps nodes in, is
// exact: red-then-black has a dependency radius of 2 per sweep, the reason
// the Pallas strips carry a halo of 2 * sweeps rows (smooth.py:536).
// The tile's interior goes to a separate output array: neighbouring blocks
// read this block's nodes as their halo, so writing u in place would race.
// The wrapper copies the output back into u.
//
// Arithmetic: _parity_sweeps' per-node update p + omega*((f + (w*W + e*E +
// s*S + n*N))*inv_c - p) with inv_c = 1/c in fp32, rounded explicitly as in
// kernel K (common.cuh), so L matches its plain twin bit for bit.
//
// Shared memory: 8 planes of (kTileX/2 + 2*sweeps) x (kTileY/2 + 2*sweeps)
// floats, 23 KB at 2 sweeps; a launch takes at most kMaxSweeps sweeps (160
// KB, above the 48 KB default, set with cudaFuncSetAttribute) and refuses
// more; the wrapper splits longer runs into several launches.
//
// Bound: device memory bandwidth. A call must read u and f and write u once
// (12 bytes per node); L reads the windows (1.41x the tile at 2 sweeps) and
// writes the tile, and the wrapper's copy adds 8 bytes per node. Kernel A
// moves ~16 bytes per node per sweep over 2 * sweeps launches.
#include "common.cuh"

namespace {

constexpr int kTileX = 32;    // output rows (i) per block; even
constexpr int kTileY = 64;    // output columns (j, contiguous) per block; even
constexpr int kThreads = 256;
// MAX_PARITY_SWEEPS in ops/cuda_kernels/smooth.py
constexpr int kMaxSweeps = 24;

// Rows and columns of one shared-memory plane at `sweeps` sweeps.
__host__ __device__ __forceinline__ int plane_rows(int sweeps) {
  return kTileX / 2 + 2 * sweeps;
}
__host__ __device__ __forceinline__ int plane_cols(int sweeps) {
  return kTileY / 2 + 2 * sweeps;
}

__global__ void rbgs_parity_kernel(const float* __restrict__ u,
                                   const float* __restrict__ f,
                                   float* __restrict__ out, int nx, int ny,
                                   Stencil5 st, float inv_c, float omega,
                                   int sweeps) {
  extern __shared__ float sm[];
  const int pr = plane_rows(sweeps), pc = plane_cols(sweeps);
  const int ps = pr * pc;
  float* up = sm;           // u planes k = 2a + b: ee, eo, oe, oo
  float* fp = sm + 4 * ps;  // f planes, same order
  const int halo = 2 * sweeps;
  const int ti0 = blockIdx.y * kTileX, tj0 = blockIdx.x * kTileY;
  const int wi0 = max(ti0 - halo, 0), wj0 = max(tj0 - halo, 0);
  const int wx = min(ti0 + kTileX + halo, nx) - wi0;
  const int wy = min(tj0 + kTileY + halo, ny) - wj0;

  // window -> planes; global reads coalesced along j
  for (int t = threadIdx.x; t < wx * wy; t += kThreads) {
    const int li = t / wy, lj = t - li * wy;
    const long g = (long)(wi0 + li) * ny + (wj0 + lj);
    const int s = (2 * (li & 1) + (lj & 1)) * ps + (li >> 1) * pc + (lj >> 1);
    up[s] = u[g];
    fp[s] = f[g];
  }

  const int hwx = (wx + 1) / 2, hwy = (wy + 1) / 2;  // plane cells in use
  const int cells = hwx * hwy;
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int color = 0; color < 2; ++color) {
      __syncthreads();
      for (int t = threadIdx.x; t < 2 * cells; t += kThreads) {
        // red: ee (0,0) and oo (1,1); black: eo (0,1) and oe (1,0)
        const int which = t >= cells;
        const int r = t - which * cells;
        const int pi = r / hwy, pj = r - pi * hwy;
        const int a = which, b = color == 0 ? which : 1 - which;
        const int li = 2 * pi + a, lj = 2 * pj + b;
        if (li <= 0 || li >= wx - 1 || lj <= 0 || lj >= wy - 1) continue;
        const float* xnb = up + (2 * (a ^ 1) + b) * ps;  // nodes (i -+ 1, j)
        const float* ynb = up + (2 * a + (b ^ 1)) * ps;  // nodes (i, j -+ 1)
        const int self = (2 * a + b) * ps + pi * pc + pj;
        up[self] = rbgs_scalar_update(
            up[self], fp[self], xnb[((li - 1) >> 1) * pc + pj],
            xnb[((li + 1) >> 1) * pc + pj], ynb[pi * pc + ((lj - 1) >> 1)],
            ynb[pi * pc + ((lj + 1) >> 1)], st, inv_c, omega);
      }
    }
  }
  __syncthreads();

  // the tile's interior -> out
  const int oi = ti0 - wi0, oj = tj0 - wj0;
  const int tx = min(kTileX, nx - ti0), ty = min(kTileY, ny - tj0);
  for (int t = threadIdx.x; t < tx * ty; t += kThreads) {
    const int i = t / ty, j = t - i * ty;
    const int li = oi + i, lj = oj + j;
    out[(long)(ti0 + i) * ny + (tj0 + j)] =
        up[(2 * (li & 1) + (lj & 1)) * ps + (li >> 1) * pc + (lj >> 1)];
  }
}

}  // namespace

extern "C" {

// `sweeps` RB-GS/SOR sweeps (red then black) of u, written to out (every
// node of out is written; u and f are only read).
int mg_rbgs_parity(const float* u, const float* f, float* out, int nx, int ny,
                   float c, float w, float e, float s, float n, float omega,
                   int sweeps, int device, void* stream) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bytes =
      8 * plane_rows(sweeps) * plane_cols(sweeps) * (int)sizeof(float);
  err = cudaFuncSetAttribute(rbgs_parity_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const dim3 grid((ny + kTileY - 1) / kTileY, (nx + kTileX - 1) / kTileX);
  rbgs_parity_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      u, f, out, nx, ny, st, 1.0f / c, omega, sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
