// Shared pieces of the hand-written Hopper multigrid kernels.
//
// Fields are fp32, row-major (nx, ny) arrays with the boundary ring included:
// node (i, j) lives at i * ny + j. Only interior nodes 1..nx-2 x 1..ny-2 are
// ever updated, so no access wraps around.
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
