// Kernel A: multi-sweep smoothing (RB-GS / SOR / weighted Jacobi) with a
// constant-coefficient 5-point stencil on an all-Dirichlet rectangle.
//
// Replaces the Pallas kernels multisweep (whole level in VMEM) and
// multisweep_strips (double-buffered row strips with a redundant halo) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py
// (:290 and :507). On Hopper one kernel covers both: the whole-grid/strip
// split existed only because of the TPU's VMEM budget.
//
// Design: one launch per colour half-sweep (2*sweeps launches per call for
// RB-GS), one thread per interior node; a thread whose node has the other
// colour exits at once. A colour update reads only nodes of the other colour
// plus its own, so the in-place update has no race. The colour is that of
// the global index, red where (i + j) is even. Jacobi reads src and writes
// every node of dst (the ring copied), ping-ponging with a scratch array.
//
// Bound: device memory bandwidth. Each half-sweep reads f and u and writes u
// for its colour: about 12 bytes per node of the colour, plus the
// neighbour reads, which mostly hit L1/L2 since neighbouring threads share
// them. A full RB-GS sweep moves ~24 bytes per node, where the TPU kernel
// moved ~12/sweeps by keeping the level resident. Temporal blocking of
// several sweeps in shared memory is the next step and not done here.
//
// The update multiplies by 1/c (computed once in fp32 on the host), as the
// Pallas kernel does; the plain twin divides by c. The two differ by one
// rounding per update. The RB-GS update rounds every operation explicitly in
// the Pallas body's operand order (rbgs_scalar_update), as kernels K and L
// do, so the direct and the parity layouts agree bit for bit.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;  // along j, the contiguous axis
constexpr int kBlockY = 8;   // along i

__global__ void rbgs_color_kernel(float* u, const float* __restrict__ f,
                                  int nx, int ny, Stencil5 st, float inv_c,
                                  float omega, int color) {
  const int j = blockIdx.x * kBlockX + threadIdx.x + 1;
  const int i = blockIdx.y * kBlockY + threadIdx.y + 1;
  if (i >= nx - 1 || j >= ny - 1 || ((i + j) & 1) != color) return;
  const long idx = (long)i * ny + j;
  u[idx] = rbgs_scalar_update(u[idx], f[idx], u[idx - ny], u[idx + ny],
                              u[idx - 1], u[idx + 1], st, inv_c, omega);
}

__global__ void jacobi_kernel(const float* __restrict__ src,
                              float* __restrict__ dst,
                              const float* __restrict__ f, int nx, int ny,
                              Stencil5 st, float inv_c, float omega) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const long idx = (long)i * ny + j;
  float v = src[idx];
  if (i > 0 && i < nx - 1 && j > 0 && j < ny - 1) {
    const float r = f[idx] - (st.c * v - neighbor_sum(src, idx, ny, st));
    v = v + omega * r * inv_c;
  }
  dst[idx] = v;
}

}  // namespace

extern "C" {

// Text of a CUDA error code returned by any entry point of the library.
const char* mg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One RB-GS/SOR half-sweep of colour `color` (0 = red) in place on u.
int mg_rbgs_color(float* u, const float* f, int nx, int ny, float c, float w,
                  float e, float s, float n, float omega, int color,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ny - 2 + kBlockX - 1) / kBlockX,
                  (nx - 2 + kBlockY - 1) / kBlockY);
  rbgs_color_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, f, nx, ny, st, 1.0f / c, omega, color);
  return (int)cudaGetLastError();
}

// One weighted-Jacobi sweep src -> dst (every node of dst is written).
int mg_jacobi(const float* src, float* dst, const float* f, int nx, int ny,
              float c, float w, float e, float s, float n, float omega,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ny + kBlockX - 1) / kBlockX, (nx + kBlockY - 1) / kBlockY);
  jacobi_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, dst, f, nx, ny, st, 1.0f / c, omega);
  return (int)cudaGetLastError();
}

}  // extern "C"
