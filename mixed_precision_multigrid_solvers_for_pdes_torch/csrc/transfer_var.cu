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
// Storage: u, f and the planes (the fine level's dtype) and fc (the coarse
// level's) are each fp32 or bf16, as the Pallas kernel takes them: loads are
// widened to fp32, the residual and its restriction run in fp32, and fc is
// rounded once where it is stored.
//
// Design: as kernel B. One thread per coarse node; an unknown coarse node
// computes the nine fine residuals of its window in registers, so the fine
// residual is never stored. Every operation is rounded explicitly in the
// plain twin's order (common.cuh): the twin restricts by centre, edges and
// corners where the Pallas kernel sums separably, so I follows the twin.
//
// Bound: device memory bandwidth. The windows of neighbouring coarse nodes
// overlap by one fine row and column, so each fine node's u, f and planes
// are read about once from device memory (28 bytes per fine node in fp32,
// 14 in bf16, against kernel B's 8 and 4) and the rest from L1/L2; 4 (or 2)
// bytes per coarse node are written.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <class TI, class TO>
__global__ void residual_restrict_var_kernel(const TI* __restrict__ u,
                                             const TI* __restrict__ f,
                                             PlanesOf<TI> p,
                                             TO* __restrict__ fc, int nxf,
                                             int nyf, int ncx, int ncy,
                                             int sides) {
  const int J = blockIdx.x * kBlockX + threadIdx.x;
  const int I = blockIdx.y * kBlockY + threadIdx.y;
  if (I >= ncx || J >= ncy) return;
  float out = 0.0f;
  if (unknown_rect(ncx, ncy, sides).contains(I, J))
    out = restrict_residual_var_at(u, f, p, I, J, nxf, nyf,
                                   unknown_rect(nxf, nyf, sides));
  store_f(fc + (long)I * ncy + J, out);
}

template <class TI, class TO>
cudaError_t residual_restrict_var_typed(const void* u, const void* f,
                                        const void* const* planes, void* fc,
                                        int nxf, int nyf, int ncx, int ncy,
                                        int sides, cudaStream_t t) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ncy + kBlockX - 1) / kBlockX, (ncx + kBlockY - 1) / kBlockY);
  residual_restrict_var_kernel<<<grid, block, 0, t>>>(
      static_cast<const TI*>(u), static_cast<const TI*>(f),
      PlanesOf<TI>{static_cast<const TI*>(planes[0]),
                   static_cast<const TI*>(planes[1]),
                   static_cast<const TI*>(planes[2]),
                   static_cast<const TI*>(planes[3]),
                   static_cast<const TI*>(planes[4])},
      static_cast<TO*>(fc), nxf, nyf, ncx, ncy, sides);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fc (ncx, ncy) = R_fw(f - A u) from fine (nxf, nyf) fields and planes; bit
// k of `sides` set means side k of (west, east, south, north) is Dirichlet.
// u, f and the planes are bf16 when `in_bf16`, fc when `out_bf16`, else
// fp32.
int mg_residual_restrict_var(const void* u, const void* f, const void* c,
                             const void* w, const void* e, const void* s,
                             const void* n, void* fc, int nxf, int nyf,
                             int ncx, int ncy, int sides, int in_bf16,
                             int out_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* planes[5] = {c, w, e, s, n};
  const cudaStream_t t = (cudaStream_t)stream;
  if (in_bf16)
    return (int)(out_bf16 ? residual_restrict_var_typed<bf16, bf16>(
                                u, f, planes, fc, nxf, nyf, ncx, ncy, sides, t)
                          : residual_restrict_var_typed<bf16, float>(
                                u, f, planes, fc, nxf, nyf, ncx, ncy, sides,
                                t));
  return (int)(out_bf16 ? residual_restrict_var_typed<float, bf16>(
                              u, f, planes, fc, nxf, nyf, ncx, ncy, sides, t)
                        : residual_restrict_var_typed<float, float>(
                              u, f, planes, fc, nxf, nyf, ncx, ncy, sides, t));
}

}  // extern "C"
