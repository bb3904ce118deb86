// Kernels B and C: the fused transfer pair of a multigrid cycle level.
//
// B, residual_restrict, replaces the Pallas residual_restrict of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/transfer.py
// (:262, constant-coefficient all-Dirichlet branch): fc = R_fw(f - A u) with
// full weighting [1 2 1]^2/16. One thread per coarse node. An interior coarse
// node computes the nine fine residuals of its window in registers, so the
// fine residual is never stored; ring nodes are written as zero.
//
// C, prolong_correct, replaces the Pallas prolong_correct of the same file
// (:488, window body _pc_window :361): u <- u + P_bilinear(ec) on fine
// unknowns, in place. One thread per fine unknown; fixed nodes stay as they
// are. A 4-bit side mask (bit k set: side k of west, east, south, north is
// Dirichlet) says which rings are unknowns, as the Pallas kernel's `sides`
// flags do: a Neumann/Robin ring is corrected too, and every interpolation
// read stays in the domain. With all four sides Dirichlet (0xF) the
// unknowns are the interior.
//
// Storage: B's u and f (one dtype) and fc, and C's ec and u, are each fp32
// or bf16, as the Pallas kernels take them (:193-249, :431-476): loads are
// widened to fp32, the residual, the restriction, the interpolation and the
// sum run in fp32, and the result is rounded once into its storage.
//
// Bound: device memory bandwidth. B reads u and f once (8 bytes per fine
// node in fp32, 4 in bf16; the 3x3 windows of neighbouring threads overlap
// in L1/L2) and writes 4 (or 2) bytes per coarse node. C reads and writes u
// (8 bytes per fine node in fp32, 4 in bf16) and reads ec from cache. The
// TPU needed strips, halos and transpose tricks for
// the stride-2 lane access; here each thread computes its own addresses and
// the stride-2 reads coalesce well enough to leave the kernels
// bandwidth-bound. Neither stores any intermediate field.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <class TI, class TO>
__global__ void residual_restrict_kernel(const TI* __restrict__ u,
                                         const TI* __restrict__ f,
                                         TO* __restrict__ fc, int nyf,
                                         int ncx, int ncy, Stencil5 st) {
  const int J = blockIdx.x * kBlockX + threadIdx.x;
  const int I = blockIdx.y * kBlockY + threadIdx.y;
  if (I >= ncx || J >= ncy) return;
  float out = 0.0f;
  if (I > 0 && I < ncx - 1 && J > 0 && J < ncy - 1)
    out = restrict_residual_at(u, f, I, J, nyf, st);
  store_f(fc + (long)I * ncy + J, out);
}

template <class TE, class TU>
__global__ void prolong_correct_kernel(const TE* __restrict__ ec,
                                       TU* __restrict__ u, int ncy, int nyf,
                                       Rect unk) {
  const int j = blockIdx.x * kBlockX + threadIdx.x + unk.j0;
  const int i = blockIdx.y * kBlockY + threadIdx.y + unk.i0;
  if (i >= unk.i1 || j >= unk.j1) return;
  TU* x = u + (long)i * nyf + j;
  store_f(x, load_f(x) + prolong_at(ec, i, j, ncy));
}

template <class TI, class TO>
cudaError_t residual_restrict_typed(const void* u, const void* f, void* fc,
                                    int nyf, int ncx, int ncy,
                                    const Stencil5& st, cudaStream_t t) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ncy + kBlockX - 1) / kBlockX, (ncx + kBlockY - 1) / kBlockY);
  residual_restrict_kernel<<<grid, block, 0, t>>>(
      static_cast<const TI*>(u), static_cast<const TI*>(f),
      static_cast<TO*>(fc), nyf, ncx, ncy, st);
  return cudaGetLastError();
}

template <class TE, class TU>
cudaError_t prolong_correct_typed(const void* ec, void* u, int ncy, int nyf,
                                  const Rect& unk, cudaStream_t t) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((unk.j1 - unk.j0 + kBlockX - 1) / kBlockX,
                  (unk.i1 - unk.i0 + kBlockY - 1) / kBlockY);
  prolong_correct_kernel<<<grid, block, 0, t>>>(
      static_cast<const TE*>(ec), static_cast<TU*>(u), ncy, nyf, unk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fc (ncx, ncy) = R_fw(f - A u) from fine fields of row length nyf; u and
// f are bf16 when `in_bf16`, fc when `out_bf16`, else fp32.
int mg_residual_restrict(const void* u, const void* f, void* fc, int nyf,
                         int ncx, int ncy, float c, float w, float e, float s,
                         float n, int in_bf16, int out_bf16, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const cudaStream_t t = (cudaStream_t)stream;
  if (in_bf16)
    return (int)(out_bf16 ? residual_restrict_typed<bf16, bf16>(
                                u, f, fc, nyf, ncx, ncy, st, t)
                          : residual_restrict_typed<bf16, float>(
                                u, f, fc, nyf, ncx, ncy, st, t));
  return (int)(out_bf16 ? residual_restrict_typed<float, bf16>(
                              u, f, fc, nyf, ncx, ncy, st, t)
                        : residual_restrict_typed<float, float>(
                              u, f, fc, nyf, ncx, ncy, st, t));
}

// u (nxf, nyf) += P_bilinear(ec) on the unknowns that `sides` leaves (bit k
// set: side k is Dirichlet); ec has row length ncy. ec is bf16 when
// `ec_bf16`, u when `u_bf16`, else fp32.
int mg_prolong_correct(const void* ec, void* u, int ncy, int nxf, int nyf,
                       int sides, int ec_bf16, int u_bf16, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Rect unk = unknown_rect(nxf, nyf, sides);
  const cudaStream_t t = (cudaStream_t)stream;
  if (ec_bf16)
    return (int)(u_bf16 ? prolong_correct_typed<bf16, bf16>(ec, u, ncy, nyf,
                                                            unk, t)
                        : prolong_correct_typed<bf16, float>(ec, u, ncy, nyf,
                                                             unk, t));
  return (int)(u_bf16 ? prolong_correct_typed<float, bf16>(ec, u, ncy, nyf,
                                                           unk, t)
                      : prolong_correct_typed<float, float>(ec, u, ncy, nyf,
                                                            unk, t));
}

}  // extern "C"
