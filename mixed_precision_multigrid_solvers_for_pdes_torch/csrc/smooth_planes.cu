// Kernel K: RB-GS / SOR sweeps on a field stored as four parity planes,
// with a constant-coefficient 5-point stencil on an all-Dirichlet rectangle.
//
// Replaces the Pallas kernel multisweep_planes (_whole_kernel, _strips_kernel
// and _plane_sweeps) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth_planes.py
// (:225). The whole-plane and strip variants are one kernel here: the strip
// pipeline existed only because of the TPU's VMEM budget. So neither its
// over-budget strip floor (:286) nor its short first window (:101) has a
// counterpart.
//
// Layout: up and fp are contiguous (4, hx, hy) fp32 arrays, planes in the
// order ee, eo, oe, oo; plane (a, b) entry (i, j) is node (2i + a, 2j + b) of
// the (nx, ny) grid. Red nodes ((i + j) even) are the ee and oo planes, black
// nodes the eo and oe planes.
//
// Design: one launch per colour half-sweep (2 * sweeps launches per call).
// A thread owns plane position (i, j) and updates the node of each of its
// colour's two planes there, if that node is an unknown. A red update reads
// only black planes and a black update only red ones, so the update in place
// has no race, and no thread idles on the other colour. Unknown nodes never
// read outside the planes, so nothing wraps.
//
// Arithmetic: p + omega*((f + (w*W + e*E + s*S + n*N))*inv_c - p), with
// inv_c = 1/c in fp32, in _plane_sweeps' operand order (smooth_planes.py
// :63-80), every operation rounded explicitly (__fmul_rn, __fadd_rn,
// __fsub_rn, never contracted into an FMA). K matches its plain twin bit for
// bit.
//
// Bound: device memory bandwidth. A call must read u and f and write u once:
// 12 bytes per node. Each launch reads the f and u planes of its colour and
// the other colour's u planes and writes its own u planes (16 bytes per node
// per sweep, mostly from L2 at 1025^2, where u and f take 8 MB). Keeping
// several sweeps in shared memory, as kernel L does, is the next step.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;  // along j, the contiguous axis of a plane
constexpr int kBlockY = 8;   // along i

struct PlaneGrid {
  int hx, hy, nx, ny;
  __device__ __forceinline__ bool unknown(int i, int j, int a, int b) const {
    const int gi = 2 * i + a, gj = 2 * j + b;
    return gi > 0 && gi < nx - 1 && gj > 0 && gj < ny - 1;
  }
};

__global__ void planes_rbgs_color_kernel(float* up,
                                         const float* __restrict__ fp,
                                         PlaneGrid g, Stencil5 st,
                                         float inv_c, float omega,
                                         int color) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= g.hx || j >= g.hy) return;
  const long ps = (long)g.hx * g.hy;
  float* ee = up;
  float* eo = up + ps;
  float* oe = up + 2 * ps;
  float* oo = up + 3 * ps;
  const long k = (long)i * g.hy + j;
  const int hy = g.hy;
  if (color == 0) {  // red: ee and oo read the black planes
    if (g.unknown(i, j, 0, 0))
      ee[k] = rbgs_scalar_update(ee[k], fp[k], oe[k - hy], oe[k], eo[k - 1],
                                 eo[k], st, inv_c, omega);
    if (g.unknown(i, j, 1, 1))
      oo[k] = rbgs_scalar_update(oo[k], fp[3 * ps + k], eo[k], eo[k + hy],
                                 oe[k], oe[k + 1], st, inv_c, omega);
  } else {  // black: oe and eo read the fresh red planes
    if (g.unknown(i, j, 1, 0))
      oe[k] = rbgs_scalar_update(oe[k], fp[2 * ps + k], ee[k], ee[k + hy],
                                 oo[k - 1], oo[k], st, inv_c, omega);
    if (g.unknown(i, j, 0, 1))
      eo[k] = rbgs_scalar_update(eo[k], fp[ps + k], oo[k - hy], oo[k], ee[k],
                                 ee[k + 1], st, inv_c, omega);
  }
}

}  // namespace

extern "C" {

// One RB-GS/SOR half-sweep of colour `color` (0 = red) in place on the
// (4, hx, hy) planes up of an (nx, ny) grid.
int mg_planes_rbgs_color(float* up, const float* fp, int hx, int hy, int nx,
                         int ny, float c, float w, float e, float s, float n,
                         float omega, int color, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((hy + kBlockX - 1) / kBlockX, (hx + kBlockY - 1) / kBlockY);
  planes_rbgs_color_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      up, fp, PlaneGrid{hx, hy, nx, ny}, st, 1.0f / c, omega, color);
  return (int)cudaGetLastError();
}

}  // extern "C"
