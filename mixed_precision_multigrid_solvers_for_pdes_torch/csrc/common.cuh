// Shared pieces of the hand-written Hopper multigrid kernels.
//
// 2D fields are fp32, row-major (nx, ny) arrays with the boundary ring
// included: node (i, j) lives at i * ny + j. Only interior nodes
// 1..nx-2 x 1..ny-2 are ever updated, so no access wraps around. The 3D
// layout is given with the 3D helpers below.
#pragma once

#include <cuda_runtime.h>

struct Stencil5 {
  float c, w, e, s, n;
};

// w*u[i-1,j] + e*u[i+1,j] + s*u[i,j-1] + n*u[i,j+1], summed left to right as
// the plain PyTorch twin sums it.
__device__ __forceinline__ float neighbor_sum(const float* u, long idx, int ny,
                                              const Stencil5& st) {
  return st.w * u[idx - ny] + st.e * u[idx + ny] + st.s * u[idx - 1] +
         st.n * u[idx + 1];
}

// f - A u at an interior node.
__device__ __forceinline__ float residual_at(const float* u, const float* f,
                                             long idx, int ny,
                                             const Stencil5& st) {
  return f[idx] - (st.c * u[idx] - neighbor_sum(u, idx, ny, st));
}

// Full-weighting restriction of the residual onto coarse interior node
// (I, J): [1 2 1; 2 4 2; 1 2 1]/16 over the nine fine residuals around
// (2I, 2J), each computed in registers. Same summation order as the plain
// twin (centre, edges, corners).
__device__ __forceinline__ float restrict_residual_at(const float* u,
                                                      const float* f, int I,
                                                      int J, int nyf,
                                                      const Stencil5& st) {
  const long c = (long)(2 * I) * nyf + 2 * J;
  const float r00 = residual_at(u, f, c, nyf, st);
  const float rp0 = residual_at(u, f, c + nyf, nyf, st);
  const float rm0 = residual_at(u, f, c - nyf, nyf, st);
  const float r0p = residual_at(u, f, c + 1, nyf, st);
  const float r0m = residual_at(u, f, c - 1, nyf, st);
  const float rpp = residual_at(u, f, c + nyf + 1, nyf, st);
  const float rmp = residual_at(u, f, c - nyf + 1, nyf, st);
  const float rpm = residual_at(u, f, c + nyf - 1, nyf, st);
  const float rmm = residual_at(u, f, c - nyf - 1, nyf, st);
  return (4.0f * r00 + 2.0f * (rp0 + rm0 + r0p + r0m) +
          (rpp + rmp + rpm + rmm)) /
         16.0f;
}

// Bilinear interpolant of the coarse field ec (ncx, ncy) at fine node (i, j):
// coincident nodes copy, edge nodes average two, centre nodes average four.
__device__ __forceinline__ float prolong_at(const float* ec, int i, int j,
                                            int ncy) {
  const float* c = ec + (long)(i >> 1) * ncy + (j >> 1);
  const bool oi = i & 1, oj = j & 1;
  if (!oi && !oj) return c[0];
  if (!oi) return 0.5f * (c[0] + c[1]);
  if (!oj) return 0.5f * (c[0] + c[ncy]);
  return 0.25f * (c[0] + c[ncy] + c[1] + c[ncy + 1]);
}

// ---------------------------------------------------------------------------
// 3D: fields are row-major (nx, ny, nz) arrays, shell included: node
// (i, j, k) lives at (i * ny + j) * nz + k, z contiguous. Offsets are 64-bit
// (a 513^3 field holds 1.35e8 nodes). The 3D helpers round every product and
// sum explicitly (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
// contracts into FMAs, in the order the plain PyTorch twins use.

struct Stencil7 {
  float c, w, e, s, n, b, t;
};

// w*u[i-1] + e*u[i+1] + s*u[j-1] + n*u[j+1] + b*u[k-1] + t*u[k+1], left to
// right; sx = ny * nz is the stride of i.
__device__ __forceinline__ float neighbor_sum7(const float* u, long idx,
                                               long sx, int nz,
                                               const Stencil7& st) {
  float acc = __fmul_rn(st.w, u[idx - sx]);
  acc = __fadd_rn(acc, __fmul_rn(st.e, u[idx + sx]));
  acc = __fadd_rn(acc, __fmul_rn(st.s, u[idx - nz]));
  acc = __fadd_rn(acc, __fmul_rn(st.n, u[idx + nz]));
  acc = __fadd_rn(acc, __fmul_rn(st.b, u[idx - 1]));
  return __fadd_rn(acc, __fmul_rn(st.t, u[idx + 1]));
}

// f - (c*u - neighbour sum) at an interior node.
__device__ __forceinline__ float residual7(const float* u, const float* f,
                                           long idx, long sx, int nz,
                                           const Stencil7& st) {
  return __fsub_rn(f[idx], __fsub_rn(__fmul_rn(st.c, u[idx]),
                                     neighbor_sum7(u, idx, sx, nz, st)));
}

// 0.5 * (a + b): one linear-interpolation step of the trilinear prolongation.
__device__ __forceinline__ float half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}
