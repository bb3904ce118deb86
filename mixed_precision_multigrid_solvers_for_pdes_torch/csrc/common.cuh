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

// Red-black Gauss-Seidel / SOR value of a node from its own value p, its
// right-hand side f and its neighbours W, E, S, N (the nodes at i-1, i+1,
// j-1, j+1): p + omega*((f + (w*W + e*E + s*S + n*N))*inv_c - p), every
// operation rounded explicitly in the Pallas sweep bodies' operand order
// (kernels A, K and L).
__device__ __forceinline__ float rbgs_scalar_update(float p, float f, float W,
                                                    float E, float S, float N,
                                                    const Stencil5& st,
                                                    float inv_c, float omega) {
  float acc = __fmul_rn(st.w, W);
  acc = __fadd_rn(acc, __fmul_rn(st.e, E));
  acc = __fadd_rn(acc, __fmul_rn(st.s, S));
  acc = __fadd_rn(acc, __fmul_rn(st.n, N));
  const float gs = __fmul_rn(__fadd_rn(f, acc), inv_c);
  return __fadd_rn(p, __fmul_rn(omega, __fsub_rn(gs, p)));
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

// ---------------------------------------------------------------------------
// 2D coefficient planes (kernels H, I and J): the five (nx, ny) planes of a
// variable-coefficient or Neumann/Robin stencil, laid out as the fields.
// Every product, sum and quotient is rounded explicitly (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn) in the plain twins' order, so nvcc
// contracts nothing into FMAs and the updates divide by c as the twins do.
// Division happens on unknown nodes only: c may be 0 on a fixed corner.

struct Planes5 {
  const float *c, *w, *e, *s, *n;
};

// The unknowns of a level are the rectangle [i0, i1) x [j0, j1): a Dirichlet
// side's ring is fixed, a Neumann/Robin side's ring is unknown.
struct Rect {
  int i0, i1, j0, j1;
  __device__ __forceinline__ bool contains(int i, int j) const {
    return i >= i0 && i < i1 && j >= j0 && j < j1;
  }
};

// Bit k of `sides` set: side k of (west, east, south, north) is Dirichlet.
__host__ __device__ __forceinline__ Rect unknown_rect(int nx, int ny,
                                                      int sides) {
  return Rect{sides & 1, nx - ((sides >> 1) & 1), (sides >> 2) & 1,
              ny - ((sides >> 3) & 1)};
}

// w*u[i-1,j] + e*u[i+1,j] + s*u[i,j-1] + n*u[i,j+1], left to right, reading
// zero outside the (nx, ny) array as the twins' zero halo does.
__device__ __forceinline__ float neighbor_sum_var(const float* u,
                                                  const Planes5& p, int i,
                                                  int j, int nx, int ny) {
  const long idx = (long)i * ny + j;
  float acc = __fmul_rn(p.w[idx], i > 0 ? u[idx - ny] : 0.0f);
  acc = __fadd_rn(acc, __fmul_rn(p.e[idx], i < nx - 1 ? u[idx + ny] : 0.0f));
  acc = __fadd_rn(acc, __fmul_rn(p.s[idx], j > 0 ? u[idx - 1] : 0.0f));
  return __fadd_rn(acc, __fmul_rn(p.n[idx], j < ny - 1 ? u[idx + 1] : 0.0f));
}

// f - (c*u - neighbour sum) at node (i, j).
__device__ __forceinline__ float residual_var(const float* u, const float* f,
                                              const Planes5& p, int i, int j,
                                              int nx, int ny) {
  const long idx = (long)i * ny + j;
  return __fsub_rn(f[idx], __fsub_rn(__fmul_rn(p.c[idx], u[idx]),
                                     neighbor_sum_var(u, p, i, j, nx, ny)));
}

// Red-black Gauss-Seidel / SOR value at unknown node (i, j):
// u + omega*((f + neighbour sum)/c - u).
__device__ __forceinline__ float rbgs_var_value(const float* u,
                                                const float* f,
                                                const Planes5& p, int i,
                                                int j, int nx, int ny,
                                                float omega) {
  const long idx = (long)i * ny + j;
  const float uc = u[idx];
  const float gs = __fdiv_rn(
      __fadd_rn(f[idx], neighbor_sum_var(u, p, i, j, nx, ny)), p.c[idx]);
  return __fadd_rn(uc, __fmul_rn(omega, __fsub_rn(gs, uc)));
}

// Weighted-Jacobi value at unknown node (i, j): u + (omega*r)/c.
__device__ __forceinline__ float jacobi_var_value(const float* u,
                                                  const float* f,
                                                  const Planes5& p, int i,
                                                  int j, int nx, int ny,
                                                  float omega) {
  const long idx = (long)i * ny + j;
  return __fadd_rn(u[idx],
                   __fdiv_rn(__fmul_rn(omega, residual_var(u, f, p, i, j, nx,
                                                           ny)),
                             p.c[idx]));
}

// Fine index k of a restriction window, folded back into the domain where it
// leaves it (row -1 reads row 1, row n reads row n-2): the 'reflect' fold of
// Neumann/Robin rings.
__device__ __forceinline__ int fold(int k, int n) {
  return k < 0 ? -k : (k >= n ? 2 * (n - 1) - k : k);
}

// Full-weighting restriction of the residual onto coarse node (I, J) of a
// fine (nx, ny) level whose unknowns are `fine`: the nine fine residuals of
// the window around (2I, 2J) (zero off the unknowns, folded at the ring) in
// registers, summed as the twin sums them: 4*centre + 2*(edges) + corners,
// over 16.
__device__ __forceinline__ float restrict_residual_var_at(
    const float* u, const float* f, const Planes5& p, int I, int J, int nx,
    int ny, const Rect& fine) {
  int ri[3], rj[3];
  float r[3][3];
  for (int d = 0; d < 3; ++d) {
    ri[d] = fold(2 * I + d - 1, nx);
    rj[d] = fold(2 * J + d - 1, ny);
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      r[a][b] = fine.contains(ri[a], rj[b])
                    ? residual_var(u, f, p, ri[a], rj[b], nx, ny)
                    : 0.0f;
  const float edges = __fadd_rn(
      __fadd_rn(__fadd_rn(r[2][1], r[0][1]), r[1][2]), r[1][0]);
  const float corners = __fadd_rn(
      __fadd_rn(__fadd_rn(r[2][2], r[0][2]), r[2][0]), r[0][0]);
  const float sum = __fadd_rn(
      __fadd_rn(__fmul_rn(4.0f, r[1][1]), __fmul_rn(2.0f, edges)), corners);
  return __fdiv_rn(sum, 16.0f);
}
