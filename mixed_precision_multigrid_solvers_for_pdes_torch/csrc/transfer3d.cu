// Kernels F and G: the fused 3D transfer pair of a multigrid cycle level.
//
// F, residual_restrict3d, replaces the Pallas residual_restrict3d of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/
// transfer3d.py (:194, kernel _rr3_kernel :80): fc = R(f - A u), 27-point
// full weighting (1,2,1)^3/64, coarse shell zero. One thread per coarse
// node. An interior coarse node computes the 27 fine residuals of its window
// in registers, so the fine residual never reaches memory. _rr3_kernel masks
// the residual to fine unknowns; here every node of an interior coarse
// node's window is one (2I-1 >= 1 and 2I+1 <= nf-2 for 1 <= I <= nc-2), so
// that mask is identically true and costs nothing. The sum runs in the plain
// twin's order (ops/transfer3d.RESTRICT_TERMS): centre, then the fine
// nodes with one, two and three odd offsets.
//
// G, prolong_correct3d, replaces the Pallas prolong_correct3d of the same
// file (:342, kernel _pc3_kernel :250): u <- u + P ec on fine interior nodes,
// P trilinear, in place. One thread per fine interior node; it reads at most
// eight coarse values and interpolates along z, then y, then x, as the plain
// twin does, so the two round identically.
//
// Bound: device memory bandwidth. F reads u and f once from memory (8 bytes
// per fine node; the 3x3x3 windows of neighbouring threads overlap in L1/L2,
// ~216 cached loads per coarse node) and writes 4 bytes per coarse node. G
// reads and writes u (8 bytes per fine node) and reads ec from cache. The
// TPU streamed x-planes and needed transpose tricks for the stride-2 lane
// access; here each thread computes its own 64-bit addresses.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;  // along k, the contiguous axis
constexpr int kBlockY = 8;   // along j

__global__ void residual_restrict3d_kernel(const float* __restrict__ u,
                                           const float* __restrict__ f,
                                           float* __restrict__ fc, int nyf,
                                           int nzf, int ncx, int ncy, int ncz,
                                           Stencil7 st) {
  const int K = blockIdx.x * kBlockX + threadIdx.x;
  const int J = blockIdx.y * kBlockY + threadIdx.y;
  const int I = blockIdx.z;
  if (J >= ncy || K >= ncz) return;
  float out = 0.0f;
  if (I > 0 && I < ncx - 1 && J > 0 && J < ncy - 1 && K > 0 && K < ncz - 1) {
    const long sx = (long)nyf * nzf;
    const long centre = (long)(2 * I) * sx + (long)(2 * J) * nzf + 2 * K;
    float acc = 0.0f;
    // parity pattern p = (px, py, pz) in binary order, weight 8 / 2^#odd;
    // on the odd axes the offsets run over (+1, -1)^#odd, first axis slowest
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int px = (p >> 2) & 1, py = (p >> 1) & 1, pz = p & 1;
      const int nodd = px + py + pz;
      const float wgt = (float)(8 >> nodd);
#pragma unroll
      for (int sgn = 0; sgn < (1 << nodd); ++sgn) {
        int bit = nodd - 1, dx = 0, dy = 0, dz = 0;
        if (px) dx = ((sgn >> bit--) & 1) ? -1 : 1;
        if (py) dy = ((sgn >> bit--) & 1) ? -1 : 1;
        if (pz) dz = ((sgn >> bit) & 1) ? -1 : 1;
        const long idx = centre + dx * sx + (long)dy * nzf + dz;
        acc = __fadd_rn(acc, __fmul_rn(wgt, residual7(u, f, idx, sx, nzf, st)));
      }
    }
    out = __fmul_rn(acc, 1.0f / 64.0f);
  }
  fc[((long)I * ncy + J) * ncz + K] = out;
}

__global__ void prolong_correct3d_kernel(const float* __restrict__ ec,
                                         float* __restrict__ u, int ncy,
                                         int ncz, int nyf, int nzf) {
  const int k = blockIdx.x * kBlockX + threadIdx.x + 1;
  const int j = blockIdx.y * kBlockY + threadIdx.y + 1;
  const int i = blockIdx.z + 1;
  if (j >= nyf - 1 || k >= nzf - 1) return;
  const long csx = (long)ncy * ncz;
  const float* c = ec + (long)(i >> 1) * csx + (long)(j >> 1) * ncz + (k >> 1);
  auto along_z = [&](const float* p) {
    return (k & 1) ? half_sum(p[0], p[1]) : p[0];
  };
  auto along_y = [&](const float* p) {
    return (j & 1) ? half_sum(along_z(p), along_z(p + ncz)) : along_z(p);
  };
  const float e = (i & 1) ? half_sum(along_y(c), along_y(c + csx)) : along_y(c);
  const long idx = ((long)i * nyf + j) * nzf + k;
  u[idx] = __fadd_rn(u[idx], e);
}

}  // namespace

extern "C" {

// fc (ncx, ncy, ncz) = R_fw(f - A u) from fine fields of row lengths
// (nyf, nzf).
int mg_residual_restrict3d(const float* u, const float* f, float* fc, int nyf,
                           int nzf, int ncx, int ncy, int ncz, float c,
                           float w, float e, float s, float n, float b,
                           float t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil7 st{c, w, e, s, n, b, t};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ncz + kBlockX - 1) / kBlockX, (ncy + kBlockY - 1) / kBlockY,
                  ncx);
  residual_restrict3d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, f, fc, nyf, nzf, ncx, ncy, ncz, st);
  return (int)cudaGetLastError();
}

// u (nxf, nyf, nzf) += P_trilinear(ec) on interior nodes; ec has row
// lengths (ncy, ncz).
int mg_prolong_correct3d(const float* ec, float* u, int ncy, int ncz, int nxf,
                         int nyf, int nzf, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nzf - 2 + kBlockX - 1) / kBlockX,
                  (nyf - 2 + kBlockY - 1) / kBlockY, nxf - 2);
  prolong_correct3d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      ec, u, ncy, ncz, nyf, nzf);
  return (int)cudaGetLastError();
}

}  // extern "C"
