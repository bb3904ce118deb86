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
// Design, kernel A's (csrc/smooth.cu), sharing its launch geometry
// (smooth_tiles.cuh): one launch per call of up to kMaxSweeps sweeps, as
// the Pallas probe runs every sweep of a call in one pallas_call over a
// grid held in VMEM. (The first design launched once per colour update and
// moved a whole field each time: 48 bytes a node for a 2-sweep call
// against 12.)
// - A block owns a tile of the interior (with the ring next to it at the
//   field's edge), loads a window of u and f into shared memory with 4-byte
//   cp.async, runs every phase of the launch there and writes its tile to
//   a new output; u is left as it was.
// - The halo follows the mode's reads: a colour phase reads at distance r
//   along an axis (roll and concat 1 along both, sub 2 along rows, lane 2
//   along columns, none 0), and a node is updated only if it is an unknown
//   of the field and at least r nodes inside the window. So a stale window
//   border travels one node a phase at r = 1, and the window takes P nodes
//   a side for a launch of P = 2 * sweeps phases. At r = 2 the node two
//   away has the phase's own colour and was last written two phases
//   before, so the border travels P + 1 nodes over the launch, not 2P
//   (halo_of; tests/unit/test_torch_probe_schedule.py finds a halo one
//   shorter wrong).
// - JAX's update is functional: each colour update reads the whole old
//   field. roll, concat and none read only the other colour and each
//   node's own old value, so a thread computes its items and stores them
//   (kernel A's one barrier a phase). sub and lane read their own colour
//   at distance 2, so every thread computes all its new values, the block
//   waits at a barrier, and only then are they stored.
// - Offsets wrap as jnp.roll does. An unknown of sub at row 1 or nx - 2
//   reads row -1 or nx, which wrap to the far ring row (lane alike along
//   columns). The ring is fixed through the call, so a window at such an
//   edge takes the far ring's line as a ghost line beyond its own ring.
// - Each window row keeps its even and odd columns in two halves, as A's.
// So `none` is A's loads, stores and barriers with no neighbour reads, and
// `roll` against `none` is the cost of the neighbour reads. Every
// operation is rounded explicitly in the Pallas body's order, so the probe
// matches its plain twin bit for bit.
//
// The copy kernel writes o = 2 u with 16-byte loads and stores: its time
// gives the card's copy bandwidth, the yardstick for the other kernels. A
// grid-stride loop over at most 8 blocks of 256 threads per SM reached 82% of
// the published rate at 8192^2. What the card needs is a grid that covers the
// array once in small blocks. On the H100, one float4 per thread matches
// torch.mul on a copy beyond L2, and four per thread match it on a copy that
// L2 holds, where one per thread is ~20% slower (PERF.md); mg_copy2x picks by
// the copy's bytes against the device's L2 size, read once per device.
//
// Bound: device memory bandwidth. A probe call of k sweeps must read u and f
// and write u (12 bytes per node, 3.76 us at 1025^2 at 3.35 TB/s); it
// reads the windows ((TX + 2 h)(TY + 2 h) / (TX TY) times the tile along
// the halo's axes) and writes the tile once per launch. The copy must move
// 8 bytes per element and moves exactly that.
#include "common.cuh"
#include "smooth_tiles.cuh"

namespace {

constexpr int kCopyThreads = 128;  // small blocks spread evenly over the SMs

enum Mode : int { kRoll = 0, kSub = 1, kLane = 2, kNone = 3, kConcat = 4 };

// Read distance of a mode's neighbour sum along rows (i) and columns (j).
// A node is updated only if it is at least that far inside its window.
__host__ __device__ constexpr int reach_i(int mode) {
  return mode == kSub ? 2 : (mode == kLane || mode == kNone ? 0 : 1);
}
__host__ __device__ constexpr int reach_j(int mode) {
  return mode == kLane ? 2 : (mode == kSub || mode == kNone ? 0 : 1);
}

// Halo along an axis of reach r for a launch of `sweeps` sweeps.
__host__ __device__ constexpr int halo_of(int r, int sweeps) {
  return r == 2 ? 2 * sweeps + 1 : 2 * sweeps * r;
}

// A window's extent along one axis of n nodes: the tile's nodes a .. b - 1
// and h more on either side. Where that reaches the ring (or, with no halo,
// touches it), the window takes the ring too, and with `ghost` the far
// ring's line beyond it (node -1 or n, which the reads wrap to n - 1 or 0).
__device__ __forceinline__ int window_lo(int a, int h, bool ghost) {
  const int lo = a - h;
  return lo > (h ? 0 : 1) ? lo : (ghost ? -1 : 0);
}
__device__ __forceinline__ int window_hi(int b, int h, int n, bool ghost) {
  const int hi = b + h;
  return hi < (h ? n : n - 1) ? hi : (ghost ? n + 1 : n);
}

// Widest window along an axis for a tile of t nodes at halo h: the ring,
// or a ring and a ghost line, add at most max(h, 1) a side.
__host__ __device__ constexpr int window_span(int t, int h) {
  return t + 2 * (h > 1 ? h : 1);
}

// Shared memory of a launch: u's and f's windows.
__host__ __device__ constexpr int probe_smem_bytes(int tx, int ty, int hi,
                                                   int hj) {
  return 2 * window_span(tx, hi) * window_span(ty, hj) * (int)sizeof(float);
}

template <int kTileX, int kTileY, int kSweeps, int kMode>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ u, const float* __restrict__ f,
                 float* __restrict__ out, int nx, int ny) {
  extern __shared__ float sm[];
  constexpr int ri = reach_i(kMode), rj = reach_j(kMode);
  constexpr int hi = halo_of(ri, kSweeps), hj = halo_of(rj, kSweeps);
  constexpr bool kGhostI = ri == 2, kGhostJ = rj == 2;
  constexpr int RS = window_span(kTileY, hj);  // row stride: two halves
  constexpr int HP = RS / 2;
  constexpr int WX = window_span(kTileX, hi);
  float* us = sm;
  float* fs = sm + WX * RS;

  const int ai = 1 + blockIdx.y * kTileX, bi = min(ai + kTileX, nx - 1);
  const int aj = 1 + blockIdx.x * kTileY, bj = min(aj + kTileY, ny - 1);
  const int wi0 = window_lo(ai, hi, kGhostI);
  const int wx = window_hi(bi, hi, nx, kGhostI) - wi0;
  const int wj0 = window_lo(aj, hj, kGhostJ);
  const int wy = window_hi(bj, hj, ny, kGhostJ) - wj0;
  auto at = [&](int li, int lj) { return li * RS + (lj & 1) * HP + (lj >> 1); };

  for (int t = threadIdx.x; t < wx * wy; t += kThreads) {
    const int li = t / wy, lj = t - li * wy;
    int gi = wi0 + li, gj = wj0 + lj;
    if constexpr (kGhostI) gi += gi < 0 ? nx : (gi >= nx ? -nx : 0);
    if constexpr (kGhostJ) gj += gj < 0 ? ny : (gj >= ny ? -ny : 0);
    const long g = (long)gi * ny + gj;
    load_shared(us + at(li, lj), u + g);
    load_shared(fs + at(li, lj), f + g);
  }
  cp_async_commit();
  cp_async_wait<0>();

  // item (row li, m), li = ri .. wx - 1 - ri: the node of the phase's
  // colour among window columns 2m, 2m + 1 of row li. Along an axis the
  // mode reads, a node r inside the window is an unknown (the window's
  // border is the ring, or a ghost line and the ring, where it reaches the
  // field's edge); along one it does not read, the field's bounds decide.
  constexpr int kItems = ((WX - 2 * ri) * HP + kThreads - 1) / kThreads;
  for (int ph = 0; ph < 2 * kSweeps; ++ph) {
    const int color = ph & 1;  // red ((i + j) even) first
    __syncthreads();
    float nv[kItems];
    int at_self[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int t = threadIdx.x + r * kThreads;
      const int q = t / HP, li = ri + q, m = t - q * HP;
      const int b = (color + wi0 + wj0 + li) & 1;
      const int lj = 2 * m + b, gi = wi0 + li, gj = wj0 + lj;
      at_self[r] = -1;
      if (t >= (wx - 2 * ri) * HP || lj < rj || lj >= wy - rj ||
          (ri == 0 && (gi < 1 || gi > nx - 2)) ||
          (rj == 0 && (gj < 1 || gj > ny - 2)))
        continue;
      const int self = li * RS + b * HP + m;
      const int sj = b ? self - HP : self + HP - 1;  // (li, lj - 1)
      const int nj = b ? self - HP + 1 : self + HP;  // (li, lj + 1)
      float nb;
      if constexpr (kMode == kSub)
        nb = __fadd_rn(__fadd_rn(__fadd_rn(us[self - RS], us[self + RS]),
                                 us[self - 2 * RS]),
                       us[self + 2 * RS]);
      else if constexpr (kMode == kLane)
        nb = __fadd_rn(__fadd_rn(__fadd_rn(us[sj], us[nj]), us[self - 1]),
                       us[self + 1]);
      else if constexpr (kMode == kNone)
        nb = __fmul_rn(4.0f, us[self]);
      else  // roll, concat
        nb = __fadd_rn(__fadd_rn(__fadd_rn(us[self - RS], us[self + RS]),
                                 us[sj]),
                       us[nj]);
      nv[r] = __fmul_rn(__fadd_rn(fs[self], nb), 0.25f);
      at_self[r] = self;
    }
    // sub and lane read their own colour: every new value of the phase is
    // computed before any is stored
    if constexpr (kGhostI || kGhostJ) __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (at_self[r] >= 0) us[at_self[r]] = nv[r];
  }
  __syncthreads();

  // the tile (with the ring next to it at the field's edge) -> out
  int lo_i, hi_i, lo_j, hi_j;
  tile_span(blockIdx.y, kTileX, nx, &lo_i, &hi_i);
  tile_span(blockIdx.x, kTileY, ny, &lo_j, &hi_j);
  const int ty = hi_j - lo_j;
  for (int t = threadIdx.x; t < (hi_i - lo_i) * ty; t += kThreads) {
    const int i = t / ty, j = t - i * ty;
    out[(long)(lo_i + i) * ny + lo_j + j] =
        us[at(lo_i + i - wi0, lo_j + j - wj0)];
  }
}

template <int kTileX, int kTileY, int kSweeps, int kMode>
cudaError_t launch_probe(const float* u, const float* f, float* out, int nx,
                         int ny, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel = probe_kernel<kTileX, kTileY, kSweeps, kMode>;
  constexpr int bytes =
      probe_smem_bytes(kTileX, kTileY, halo_of(reach_i(kMode), kSweeps),
                       halo_of(reach_j(kMode), kSweeps));
  const cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((ny - 2 + kTileY - 1) / kTileY,
                  (nx - 2 + kTileX - 1) / kTileX);
  kernel<<<grid, kThreads, bytes, stream>>>(u, f, out, nx, ny);
  return cudaGetLastError();
}

// o = 2 u: each thread loads kUnroll float4s (one per block-wide stride,
// so every load of a warp is coalesced) before it stores any, so kUnroll
// 16-byte loads are in flight per thread; the grid covers the array once.
// Block 0 also doubles the n % 4 tail.
template <int kUnroll>
__global__ void __launch_bounds__(kCopyThreads)
    copy2x_kernel(const float* __restrict__ u, float* __restrict__ o, long n) {
  const long n4 = n / 4;
  const float4* u4 = reinterpret_cast<const float4*>(u);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long k0 = (long)blockIdx.x * kCopyThreads * kUnroll + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const long k = k0 + (long)r * kCopyThreads;
    if (k < n4) v[r] = u4[k];
  }
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const long k = k0 + (long)r * kCopyThreads;
    if (k < n4)
      o4[k] = make_float4(__fmul_rn(2.0f, v[r].x), __fmul_rn(2.0f, v[r].y),
                          __fmul_rn(2.0f, v[r].z), __fmul_rn(2.0f, v[r].w));
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long k = 4 * n4 + threadIdx.x;
    o[k] = __fmul_rn(2.0f, u[k]);
  }
}

template <int kUnroll>
cudaError_t launch_copy2x(const float* u, float* o, long n,
                          cudaStream_t stream) {
  const long per_block = (long)kCopyThreads * kUnroll;
  const long blocks = (n / 4 + per_block - 1) / per_block;
  copy2x_kernel<kUnroll>
      <<<(unsigned)(blocks > 0 ? blocks : 1), kCopyThreads, 0, stream>>>(u, o,
                                                                         n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `sweeps` (1 .. kMaxSweeps) probe sweeps of `mode` (red then black) of u,
// written to out (every node of out is written; u and f are only read, and
// out must not alias them).
int mg_probe(const float* u, const float* f, float* out, int nx, int ny,
             int mode, int sweeps, int device, void* stream) {
  if (mode < kRoll || mode > kConcat || sweeps < 1 || sweeps > kMaxSweeps ||
      nx < 3 || ny < 3)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)with_tile_and_sweeps(nx, ny, sweeps, [&](auto ti, auto sw) {
    constexpr Tile t = kTiles[decltype(ti)::value];
    constexpr int s = decltype(sw)::value;
    switch (mode) {
      case kSub:
        return launch_probe<t.x, t.y, s, kSub>(u, f, out, nx, ny, device, st);
      case kLane:
        return launch_probe<t.x, t.y, s, kLane>(u, f, out, nx, ny, device,
                                                st);
      case kNone:
        return launch_probe<t.x, t.y, s, kNone>(u, f, out, nx, ny, device,
                                                st);
      default:  // roll and concat: one kernel
        return launch_probe<t.x, t.y, s, kRoll>(u, f, out, nx, ny, device,
                                                st);
    }
  });
}

// o = 2 u over n floats; u and o 16-byte aligned. A copy whose bytes fit
// the device's L2 takes four float4s per thread, a larger one one.
int mg_copy2x(const float* u, float* o, long n, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  static int l2_bytes[kMaxDevices] = {};
  if (l2_bytes[device] == 0) {
    err = cudaDeviceGetAttribute(&l2_bytes[device], cudaDevAttrL2CacheSize,
                                 device);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(8L * n <= l2_bytes[device] ? launch_copy2x<4>(u, o, n, st)
                                          : launch_copy2x<1>(u, o, n, st));
}

}  // extern "C"
