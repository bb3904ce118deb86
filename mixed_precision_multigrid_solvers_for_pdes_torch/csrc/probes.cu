// Kernel M: the smoothing microbenchmark's probe and copy kernels.
//
// Replaces the Pallas probes of scripts/kernel_microbench.py: probe_call
// (:108, the body _probe_kernel :67) and copy_call (:123). The third Pallas
// probe there, parity_call (:191), is kernel K run on pre-split planes, and
// needs no kernel of its own.
//
// The probe runs RB-GS-shaped colour updates with c = 4 on the whole grid,
// u <- (f + nbsum(u)) / 4 on the unknowns of one colour, where nbsum is the
// neighbour pattern of a mode:
//   0 roll   u[i-1] + u[i+1] + u[j-1] + u[j+1] (the 5-point sum)
//   1 sub    u[i-1] + u[i+1] + u[i-2] + u[i+2] (rows: the strided axis)
//   2 lane   u[j-1] + u[j+1] + u[j-2] + u[j+2] (columns: the contiguous axis)
//   3 none   4 u                               (no neighbour reads)
//   4 concat as roll
// Offsets wrap around the (nx, ny) array, as jnp.roll does; sub and lane
// keep the Pallas probe's "wrong numerics, perf only" arithmetic. On the TPU
// sub against lane asked what sublane against lane shifts cost; here it
// measures strided against coalesced neighbour reads. roll and concat were
// two ways of moving data in Mosaic; a hand-written kernel reads neighbours
// by index either way, so concat is the same kernel as roll.
//
// Design: one launch per colour update, reading src and writing every node of
// dst (the other colour and the fixed nodes copied), so sub and lane, which
// read their own colour, have no race; the wrapper ping-pongs two arrays.
// Every operation is rounded explicitly in the Pallas body's order, so the
// probe matches its plain twin bit for bit.
//
// The copy kernel writes o = 2 u with 16-byte loads and stores: its time
// gives the card's copy bandwidth, the yardstick for the other kernels.
//
// Bound: device memory bandwidth. A probe call of k sweeps must read u and f
// and write u (12 bytes per node); it moves ~12 bytes per node per launch.
// The copy must move 8 bytes per element and moves exactly that.
#include "common.cuh"

namespace {

constexpr int kBlockX = 32;  // along j, the contiguous axis
constexpr int kBlockY = 8;   // along i

__device__ __forceinline__ float probe_nbsum(const float* u, int i, int j,
                                             int nx, int ny, int mode) {
  auto at = [&](int ii, int jj) {
    ii = ii < 0 ? ii + nx : (ii >= nx ? ii - nx : ii);
    jj = jj < 0 ? jj + ny : (jj >= ny ? jj - ny : jj);
    return u[(long)ii * ny + jj];
  };
  switch (mode) {
    case 1:
      return __fadd_rn(__fadd_rn(__fadd_rn(at(i - 1, j), at(i + 1, j)),
                                 at(i - 2, j)),
                       at(i + 2, j));
    case 2:
      return __fadd_rn(__fadd_rn(__fadd_rn(at(i, j - 1), at(i, j + 1)),
                                 at(i, j - 2)),
                       at(i, j + 2));
    case 3:
      return __fmul_rn(4.0f, at(i, j));
    default:  // 0 roll, 4 concat
      return __fadd_rn(__fadd_rn(__fadd_rn(at(i - 1, j), at(i + 1, j)),
                                 at(i, j - 1)),
                       at(i, j + 1));
  }
}

__global__ void probe_color_kernel(const float* __restrict__ src,
                                   float* __restrict__ dst,
                                   const float* __restrict__ f, int nx,
                                   int ny, int mode, int color) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const long idx = (long)i * ny + j;
  float v = src[idx];
  if (i > 0 && i < nx - 1 && j > 0 && j < ny - 1 && ((i + j) & 1) == color)
    v = __fmul_rn(__fadd_rn(f[idx], probe_nbsum(src, i, j, nx, ny, mode)),
                  0.25f);
  dst[idx] = v;
}

__global__ void copy2x_kernel(const float* __restrict__ u,
                              float* __restrict__ o, long n) {
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * blockDim.x;
  const float4* u4 = reinterpret_cast<const float4*>(u);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (long k = (long)blockIdx.x * blockDim.x + threadIdx.x; k < n4;
       k += stride) {
    const float4 v = u4[k];
    o4[k] = make_float4(__fmul_rn(2.0f, v.x), __fmul_rn(2.0f, v.y),
                        __fmul_rn(2.0f, v.z), __fmul_rn(2.0f, v.w));
  }
  for (long k = 4 * n4 + (long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride)
    o[k] = __fmul_rn(2.0f, u[k]);
}

}  // namespace

extern "C" {

// One probe colour update src -> dst (every node of dst is written).
int mg_probe_color(const float* src, float* dst, const float* f, int nx,
                   int ny, int mode, int color, int device, void* stream) {
  if (mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ny + kBlockX - 1) / kBlockX, (nx + kBlockY - 1) / kBlockY);
  probe_color_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, dst, f, nx, ny, mode, color);
  return (int)cudaGetLastError();
}

// o = 2 u over n floats; u and o 16-byte aligned.
int mg_copy2x(const float* u, float* o, long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long want = (n / 4 + 255) / 256;
  const int blocks = (int)(want < 8L * sms ? (want > 0 ? want : 1) : 8L * sms);
  copy2x_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(u, o, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
