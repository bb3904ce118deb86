// Kernel I: fused residual + full-weighting restriction with a
// variable-coefficient 5-point stencil and per-side boundary kinds.
//
// Replaces the variable-coefficient and Neumann/Robin branches of the Pallas
// residual_restrict of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer.py
// (:262; kernel _rr_kernel :140 with n_in = 7, window body _rr_window :85,
// mask _unknown_at :67): fc = R_fw(f - A u), where A's five coefficient
// planes are read from device memory and a 4-bit side mask says which sides
// are Dirichlet. On a Neumann/Robin side the fine ring nodes are unknowns
// (their ghost elimination is in the planes), the window rows and columns
// that leave the domain fold back onto the interior (row -1 reads row 1, row
// nx reads row nx-2; _rr_window :106-118), and the coarse ring is written.
// Coarse nodes off the coarse unknowns are written as 0.
//
// Design: as kernel B. One thread per coarse node; an unknown coarse node
// computes the nine fine residuals of its window in registers, so the fine
// residual is never stored. Every operation is rounded explicitly in the
// plain twin's order (common.cuh): the twin restricts by centre, edges and
// corners where the Pallas kernel sums separably, so I follows the twin.
//
// Bound: device memory bandwidth. The windows of neighbouring coarse nodes
// overlap by one fine row and column, so each fine node's u, f and planes
// are read about once from device memory (28 bytes per fine node, against
// kernel B's 8) and the rest from L1/L2; 4 bytes per coarse node are
// written.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void residual_restrict_var_kernel(const float* __restrict__ u,
                                             const float* __restrict__ f,
                                             Planes5 p,
                                             float* __restrict__ fc, int nxf,
                                             int nyf, int ncx, int ncy,
                                             int sides) {
  const int J = blockIdx.x * kBlockX + threadIdx.x;
  const int I = blockIdx.y * kBlockY + threadIdx.y;
  if (I >= ncx || J >= ncy) return;
  float out = 0.0f;
  if (unknown_rect(ncx, ncy, sides).contains(I, J))
    out = restrict_residual_var_at(u, f, p, I, J, nxf, nyf,
                                   unknown_rect(nxf, nyf, sides));
  fc[(long)I * ncy + J] = out;
}

}  // namespace

extern "C" {

// fc (ncx, ncy) = R_fw(f - A u) from fine (nxf, nyf) fields and planes; bit
// k of `sides` set means side k of (west, east, south, north) is Dirichlet.
int mg_residual_restrict_var(const float* u, const float* f, const float* c,
                             const float* w, const float* e, const float* s,
                             const float* n, float* fc, int nxf, int nyf,
                             int ncx, int ncy, int sides, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ncy + kBlockX - 1) / kBlockX, (ncx + kBlockY - 1) / kBlockY);
  residual_restrict_var_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, f, Planes5{c, w, e, s, n}, fc, nxf, nyf, ncx, ncy, sides);
  return (int)cudaGetLastError();
}

}  // extern "C"
