// Kernel D: the whole coarse tail of a V(pre, post) cycle in one launch.
//
// Replaces the Pallas tail_vcycle of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/tail.py
// (:170, kernel body _tail_kernel :60): from the entry level (129^2 on the
// main path) down to the coarsest grid, pre-smoothing, fused
// residual+restriction, the coarsest solve (coarse_sweeps RB-GS sweeps with
// omega = 1), prolongation+correction and post-smoothing (colour order
// reversed when `symmetric`), all in fp32.
//
// Bound: latency, not bandwidth. The tail levels are tiny (the 129^2 entry
// is 66 KB) and a cycle visits each of them about a dozen times, so one
// launch per step would cost far more than the work. The design is a single
// CTA of 1024 threads that walks the recursion itself, with __syncthreads()
// between every colour phase and every transfer phase; each phase strides
// over the level's nodes. Coarse u, f and the Jacobi scratch live in one
// global-memory workspace the wrapper allocates (for a 129^2 entry, 46 KB of
// coarse fields and a 66 KB scratch), which stays in L1/L2 for the whole
// launch. Moving the workspace
// and the entry level into dynamic shared memory (about 180 KB for all tail
// levels) is the next step and not done here.
//
// No pointer here is __restrict__: coarse fields are written and then read
// inside the same launch, and __syncthreads() orders those accesses for the
// single block only through coherent (non-.nc) loads.
#include "common.cuh"

namespace {

constexpr int kTailThreads = 1024;
constexpr int kTailMaxLevels = 16;

struct TailParams {
  int levels;
  int nx[kTailMaxLevels];
  int ny[kTailMaxLevels];
  Stencil5 st[kTailMaxLevels];
  long off_u[kTailMaxLevels];  // workspace offsets of levels >= 1
  long off_f[kTailMaxLevels];
  int pre, post, coarse_sweeps;
  int jacobi;     // 1: weighted Jacobi pre/post smoothing, 0: RB-GS/SOR
  int symmetric;  // 1: post-smoothing runs black before red
  float omega;
};

__device__ void rbgs_half(float* u, const float* f, int nx, int ny,
                          const Stencil5& st, float omega, int color) {
  const float inv_c = 1.0f / st.c;
  const int nj = ny - 2;
  const int total = (nx - 2) * nj;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int i = 1 + t / nj, j = 1 + t % nj;
    if (((i + j) & 1) != color) continue;
    const long idx = (long)i * ny + j;
    const float uc = u[idx];
    const float gs = (f[idx] + neighbor_sum(u, idx, ny, st)) * inv_c;
    u[idx] = uc + omega * (gs - uc);
  }
  __syncthreads();
}

__device__ void jacobi_full(float* u, const float* f, float* tmp, int nx,
                            int ny, const Stencil5& st, float omega) {
  const float inv_c = 1.0f / st.c;
  const int nj = ny - 2;
  const int total = (nx - 2) * nj;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const long idx = (long)(1 + t / nj) * ny + 1 + t % nj;
    const float r = residual_at(u, f, idx, ny, st);
    tmp[idx] = u[idx] + omega * r * inv_c;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const long idx = (long)(1 + t / nj) * ny + 1 + t % nj;
    u[idx] = tmp[idx];
  }
  __syncthreads();
}

__device__ void smooth_n(float* u, const float* f, float* tmp, int nx, int ny,
                         const Stencil5& st, int sweeps, int jacobi,
                         float omega, int reverse) {
  for (int k = 0; k < sweeps; ++k) {
    if (jacobi) {
      jacobi_full(u, f, tmp, nx, ny, st, omega);
    } else {
      rbgs_half(u, f, nx, ny, st, omega, reverse ? 1 : 0);
      rbgs_half(u, f, nx, ny, st, omega, reverse ? 0 : 1);
    }
  }
}

__global__ void __launch_bounds__(kTailThreads)
    tail_vcycle_kernel(float* u0, const float* f0, float* work, TailParams p) {
  const int L = p.levels;
  float* tmp = work;  // Jacobi scratch, entry-level sized, at offset 0
  auto level_u = [&](int l) { return l == 0 ? u0 : work + p.off_u[l]; };
  auto level_f = [&](int l) -> const float* {
    return l == 0 ? f0 : work + p.off_f[l];
  };

  for (int l = 0; l < L - 1; ++l) {
    float* u = level_u(l);
    const float* f = level_f(l);
    smooth_n(u, f, tmp, p.nx[l], p.ny[l], p.st[l], p.pre, p.jacobi, p.omega,
             0);
    const int ncx = p.nx[l + 1], ncy = p.ny[l + 1];
    float* fc = work + p.off_f[l + 1];
    float* uc = work + p.off_u[l + 1];
    for (int t = threadIdx.x; t < ncx * ncy; t += blockDim.x) {
      const int I = t / ncy, J = t % ncy;
      const bool interior = I > 0 && I < ncx - 1 && J > 0 && J < ncy - 1;
      fc[t] = interior ? restrict_residual_at(u, f, I, J, p.ny[l], p.st[l])
                       : 0.0f;
      uc[t] = 0.0f;
    }
    __syncthreads();
  }

  smooth_n(level_u(L - 1), level_f(L - 1), tmp, p.nx[L - 1], p.ny[L - 1],
           p.st[L - 1], p.coarse_sweeps, 0, 1.0f, 0);

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
    smooth_n(u, level_f(l), tmp, nxf, nyf, p.st[l], p.post, p.jacobi,
             p.omega, p.symmetric);
  }
}

}  // namespace

extern "C" {

// Floats of workspace tail_vcycle needs: the Jacobi scratch (entry size) and
// u, f of every level below the entry.
long mg_tail_workspace_floats(int levels, const int* nx, const int* ny) {
  long n = (long)nx[0] * ny[0];
  for (int l = 1; l < levels; ++l) n += 2L * nx[l] * ny[l];
  return n;
}

// One V(pre, post) cycle over `levels` levels, in place on the entry field u.
// coefs holds (c, w, e, s, n) per level, finest first.
int mg_tail_vcycle(float* u, const float* f, float* work, int levels,
                   const int* nx, const int* ny, const float* coefs, int pre,
                   int post, float omega, int jacobi, int coarse_sweeps,
                   int symmetric, int device, void* stream) {
  if (levels < 1 || levels > kTailMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TailParams p{};
  p.levels = levels;
  long off = (long)nx[0] * ny[0];
  for (int l = 0; l < levels; ++l) {
    p.nx[l] = nx[l];
    p.ny[l] = ny[l];
    p.st[l] = Stencil5{coefs[5 * l], coefs[5 * l + 1], coefs[5 * l + 2],
                       coefs[5 * l + 3], coefs[5 * l + 4]};
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
  tail_vcycle_kernel<<<1, kTailThreads, 0, (cudaStream_t)stream>>>(u, f, work,
                                                                  p);
  return (int)cudaGetLastError();
}

}  // extern "C"
