// Kernel J: the whole coarse tail of a V(pre, post) cycle in one launch, with
// a variable-coefficient 5-point stencil on every level.
//
// Replaces the Pallas tail_vcycle_var of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/tail.py
// (:122, kernel body _tail_kernel_var :84): kernel D's recursion (tail.cu)
// with each level's five coefficient planes. From the entry level (129^2 on
// the main path) down to the coarsest grid: pre-smoothing, fused
// residual+restriction, the coarsest solve (coarse_sweeps RB-GS sweeps with
// omega = 1), prolongation+correction and post-smoothing (colour order
// reversed when `symmetric`), all in fp32, on all-Dirichlet levels.
//
// Design: as D, a single CTA of 1024 threads walks the recursion, with
// __syncthreads() between every colour phase and every transfer phase; the
// smoothing and the restriction are H's and I's device functions
// (common.cuh) on the all-Dirichlet mask, the prolongation is C's. Coarse u,
// f and the Jacobi scratch live in the workspace the wrapper allocates, as
// for D. The Pallas kernel kept every level's planes in VMEM; here they are
// read from device memory, about 0.44 MB over the tail levels from a 129^2
// entry, which stays in the 50 MB L2 for the whole launch. Updates divide by
// c on interior nodes only, as H does.
//
// Bound: latency, as for D: a cycle visits each tiny level about a dozen
// times, so one launch for the recursion replaces some hundred.
//
// No pointer to a field is __restrict__: coarse fields are written and then
// read inside the same launch, ordered by __syncthreads() for the single
// block.
#include "common.cuh"

namespace {

constexpr int kTailThreads = 1024;
constexpr int kTailMaxLevels = 16;  // as kernel D

struct TailVarParams {
  int levels;
  int nx[kTailMaxLevels];
  int ny[kTailMaxLevels];
  Planes5 planes[kTailMaxLevels];
  long off_u[kTailMaxLevels];  // workspace offsets of levels >= 1
  long off_f[kTailMaxLevels];
  int pre, post, coarse_sweeps;
  int jacobi;     // 1: weighted Jacobi pre/post smoothing, 0: RB-GS/SOR
  int symmetric;  // 1: post-smoothing runs black before red
  float omega;
};

__device__ void rbgs_half_var(float* u, const float* f, const Planes5& p,
                              int nx, int ny, float omega, int color) {
  const int nj = ny - 2;
  const int total = (nx - 2) * nj;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int i = 1 + t / nj, j = 1 + t % nj;
    if (((i + j) & 1) != color) continue;
    u[(long)i * ny + j] = rbgs_var_value(u, f, p, i, j, nx, ny, omega);
  }
  __syncthreads();
}

__device__ void jacobi_full_var(float* u, const float* f, float* tmp,
                                const Planes5& p, int nx, int ny,
                                float omega) {
  const int nj = ny - 2;
  const int total = (nx - 2) * nj;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int i = 1 + t / nj, j = 1 + t % nj;
    tmp[(long)i * ny + j] = jacobi_var_value(u, f, p, i, j, nx, ny, omega);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const long idx = (long)(1 + t / nj) * ny + 1 + t % nj;
    u[idx] = tmp[idx];
  }
  __syncthreads();
}

__device__ void smooth_n_var(float* u, const float* f, float* tmp,
                             const Planes5& p, int nx, int ny, int sweeps,
                             int jacobi, float omega, int reverse) {
  for (int k = 0; k < sweeps; ++k) {
    if (jacobi) {
      jacobi_full_var(u, f, tmp, p, nx, ny, omega);
    } else {
      rbgs_half_var(u, f, p, nx, ny, omega, reverse ? 1 : 0);
      rbgs_half_var(u, f, p, nx, ny, omega, reverse ? 0 : 1);
    }
  }
}

__global__ void __launch_bounds__(kTailThreads)
    tail_var_vcycle_kernel(float* u0, const float* f0, float* work,
                           TailVarParams p) {
  const int L = p.levels;
  float* tmp = work;  // Jacobi scratch, entry-level sized, at offset 0
  auto level_u = [&](int l) { return l == 0 ? u0 : work + p.off_u[l]; };
  auto level_f = [&](int l) -> const float* {
    return l == 0 ? f0 : work + p.off_f[l];
  };

  for (int l = 0; l < L - 1; ++l) {
    float* u = level_u(l);
    const float* f = level_f(l);
    const int nx = p.nx[l], ny = p.ny[l];
    smooth_n_var(u, f, tmp, p.planes[l], nx, ny, p.pre, p.jacobi, p.omega, 0);
    const int ncx = p.nx[l + 1], ncy = p.ny[l + 1];
    const Rect fine = unknown_rect(nx, ny, 0xF);
    float* fc = work + p.off_f[l + 1];
    float* uc = work + p.off_u[l + 1];
    for (int t = threadIdx.x; t < ncx * ncy; t += blockDim.x) {
      const int I = t / ncy, J = t % ncy;
      const bool interior = I > 0 && I < ncx - 1 && J > 0 && J < ncy - 1;
      fc[t] = interior ? restrict_residual_var_at(u, f, p.planes[l], I, J, nx,
                                                  ny, fine)
                       : 0.0f;
      uc[t] = 0.0f;
    }
    __syncthreads();
  }

  smooth_n_var(level_u(L - 1), level_f(L - 1), tmp, p.planes[L - 1],
               p.nx[L - 1], p.ny[L - 1], p.coarse_sweeps, 0, 1.0f, 0);

  for (int l = L - 2; l >= 0; --l) {
    float* u = level_u(l);
    const float* ec = level_u(l + 1);
    const int nxf = p.nx[l], nyf = p.ny[l];
    const int nj = nyf - 2;
    for (int t = threadIdx.x; t < (nxf - 2) * nj; t += blockDim.x) {
      const int i = 1 + t / nj, j = 1 + t % nj;
      u[(long)i * nyf + j] += prolong_at(ec, i, j, p.ny[l + 1]);
    }
    __syncthreads();
    smooth_n_var(u, level_f(l), tmp, p.planes[l], nxf, nyf, p.post, p.jacobi,
                 p.omega, p.symmetric);
  }
}

}  // namespace

extern "C" {

// One V(pre, post) cycle over `levels` levels, in place on the entry field
// u. `planes` holds 5 * levels device pointers, (c, w, e, s, n) per level,
// finest first; `work` holds mg_tail_workspace_floats(levels, nx, ny)
// floats (tail.cu).
int mg_tail_var_vcycle(float* u, const float* f, float* work, int levels,
                       const int* nx, const int* ny,
                       const float* const* planes, int pre, int post,
                       float omega, int jacobi, int coarse_sweeps,
                       int symmetric, int device, void* stream) {
  if (levels < 1 || levels > kTailMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TailVarParams p{};
  p.levels = levels;
  long off = (long)nx[0] * ny[0];
  for (int l = 0; l < levels; ++l) {
    p.nx[l] = nx[l];
    p.ny[l] = ny[l];
    const float* const* q = planes + 5 * l;
    p.planes[l] = Planes5{q[0], q[1], q[2], q[3], q[4]};
    if (l > 0) {
      p.off_u[l] = off;
      off += (long)nx[l] * ny[l];
      p.off_f[l] = off;
      off += (long)nx[l] * ny[l];
    }
  }
  p.pre = pre;
  p.post = post;
  p.coarse_sweeps = coarse_sweeps;
  p.jacobi = jacobi;
  p.symmetric = symmetric;
  p.omega = omega;
  tail_var_vcycle_kernel<<<1, kTailThreads, 0, (cudaStream_t)stream>>>(
      u, f, work, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
