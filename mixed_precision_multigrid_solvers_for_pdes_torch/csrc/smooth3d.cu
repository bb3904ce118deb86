// Kernel E: one colour half-sweep of 3D red-black Gauss-Seidel / SOR with a
// constant-coefficient 7-point stencil on an all-Dirichlet box, in place.
//
// Replaces the Pallas rbgs_planes of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth3d.py
// (:178, kernel _pipeline_kernel :65). The TPU kernel streams x-planes through
// VMEM and runs both colours in one pass with a two-stage plane pipeline, so
// that red is computed from old values and black from red-updated ones. Here
// the same order comes from two launches per sweep, one per colour (the
// 'reverse' order is black first). In place is safe: a colour update reads
// only nodes of the other colour and its own node, so the threads of one
// launch never race.
//
// Design: one thread per interior node of the launch's colour. Threads run
// along z, the contiguous axis: thread t of row (i, j) takes k = k0 + 2t,
// with k0 in {1, 2} set by the colour, red where (i + j + k) is even. A block
// of (32, 8) threads covers 32 such nodes of 8 rows j; grid z runs over i.
//
// Arithmetic: u + omega*((f + nb) * (1/c) - u), multiplying by 1/c (computed
// once in fp32) as the Pallas kernel does, with every product and sum
// rounded explicitly in the plain twin's order (common.cuh).
//
// Bound: device memory bandwidth. A colour launch touches every line of u
// (the neighbours cover the other colour) and of f, and writes half of u:
// about 12 bytes per node, so ~24 bytes per node per sweep, where the TPU
// pipeline moved 12. The stride-2 loads and stores along z use half of each
// sector directly and the rest through L1/L2. Rolling x-planes through
// shared memory with both colours in one pass is the next step and not done
// here.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;  // colour nodes along k, the contiguous axis
constexpr int kBlockY = 8;   // rows along j

__global__ void rbgs3d_color_kernel(float* u, const float* __restrict__ f,
                                    int ny, int nz, Stencil7 st, float inv_c,
                                    float omega, int color) {
  const int j = blockIdx.y * kBlockY + threadIdx.y + 1;
  const int i = blockIdx.z + 1;
  const int k = 1 + ((i + j + 1 + color) & 1) +
                2 * (blockIdx.x * kBlockX + threadIdx.x);
  if (j >= ny - 1 || k >= nz - 1) return;
  const long sx = (long)ny * nz;
  const long idx = (long)i * sx + (long)j * nz + k;
  const float uc = u[idx];
  const float gs =
      __fmul_rn(__fadd_rn(f[idx], neighbor_sum7(u, idx, sx, nz, st)), inv_c);
  u[idx] = __fadd_rn(uc, __fmul_rn(omega, __fsub_rn(gs, uc)));
}

}  // namespace

extern "C" {

// One RB-GS/SOR half-sweep of colour `color` (0 = red) in place on the
// (nx, ny, nz) field u.
int mg_rbgs3d_color(float* u, const float* f, int nx, int ny, int nz,
                    float c, float w, float e, float s, float n, float b,
                    float t, float omega, int color, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil7 st{c, w, e, s, n, b, t};
  const int per_row = (nz - 1) / 2;  // colour nodes in a row, at most
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((per_row + kBlockX - 1) / kBlockX,
                  (ny - 2 + kBlockY - 1) / kBlockY, nx - 2);
  rbgs3d_color_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, f, ny, nz, st, 1.0f / c, omega, color);
  return (int)cudaGetLastError();
}

}  // extern "C"
