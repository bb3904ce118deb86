// Kernel H: multi-sweep smoothing (RB-GS / SOR / weighted Jacobi) with a
// variable-coefficient 5-point stencil, its five coefficient planes c, w, e,
// s, n read from device memory, on an all-Dirichlet rectangle.
//
// Replaces the variable-coefficient branches of the Pallas kernels
// multisweep (whole level in VMEM, _smooth_kernel_var :231) and
// multisweep_strips (row strips streaming seven windows, _strips_kernel with
// n_in = 7 :353) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py
// (:290 and :507). As for kernel A, the whole-grid/strip split existed only
// because of the TPU's VMEM budget, and one kernel covers both.
//
// Design: as kernel A. One launch per colour half-sweep, one thread per
// interior node; a thread whose node has the other colour exits at once. A
// colour update reads only nodes of the other colour and its own, so the
// in-place update has no race. Jacobi reads src and writes every node of dst
// (the ring copied), ping-ponging with a scratch array. Only interior nodes
// are updated: the kernel serves all-Dirichlet levels, and Neumann/Robin
// levels smooth on the plain path, as in the JAX package.
//
// Arithmetic: the Pallas kernels multiply by 1/c with c forced to 1 off the
// unknowns; here the update divides by c, in the twin's order with every
// operation rounded explicitly (common.cuh), so H matches the plain twin bit
// for bit. A thread never divides on a fixed node.
//
// Bound: device memory bandwidth. A sweep reads f and the five planes once
// (24 bytes per node), reads u in both colour launches (the neighbours cover
// the other colour) and writes it once: ~36 bytes per node, where kernel A
// moves ~16 by the same count. Keeping the planes in fewer bytes (c is
// w + e + s + n + lam) or several sweeps in shared memory is the next step
// and not done here.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;  // along j, the contiguous axis
constexpr int kBlockY = 8;   // along i

__global__ void rbgs_var_color_kernel(float* u, const float* __restrict__ f,
                                      Planes5 p, int nx, int ny, float omega,
                                      int color) {
  const int j = blockIdx.x * kBlockX + threadIdx.x + 1;
  const int i = blockIdx.y * kBlockY + threadIdx.y + 1;
  if (i >= nx - 1 || j >= ny - 1 || ((i + j) & 1) != color) return;
  u[(long)i * ny + j] = rbgs_var_value(u, f, p, i, j, nx, ny, omega);
}

__global__ void jacobi_var_kernel(const float* __restrict__ src,
                                  float* __restrict__ dst,
                                  const float* __restrict__ f, Planes5 p,
                                  int nx, int ny, float omega) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const long idx = (long)i * ny + j;
  dst[idx] = (i > 0 && i < nx - 1 && j > 0 && j < ny - 1)
                 ? jacobi_var_value(src, f, p, i, j, nx, ny, omega)
                 : src[idx];
}

}  // namespace

extern "C" {

// One RB-GS/SOR half-sweep of colour `color` (0 = red) in place on u.
int mg_rbgs_var_color(float* u, const float* f, const float* c,
                      const float* w, const float* e, const float* s,
                      const float* n, int nx, int ny, float omega, int color,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ny - 2 + kBlockX - 1) / kBlockX,
                  (nx - 2 + kBlockY - 1) / kBlockY);
  rbgs_var_color_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, f, Planes5{c, w, e, s, n}, nx, ny, omega, color);
  return (int)cudaGetLastError();
}

// One weighted-Jacobi sweep src -> dst (every node of dst is written).
int mg_jacobi_var(const float* src, float* dst, const float* f,
                  const float* c, const float* w, const float* e,
                  const float* s, const float* n, int nx, int ny,
                  float omega, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ny + kBlockX - 1) / kBlockX, (nx + kBlockY - 1) / kBlockY);
  jacobi_var_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, dst, f, Planes5{c, w, e, s, n}, nx, ny, omega);
  return (int)cudaGetLastError();
}

}  // extern "C"
