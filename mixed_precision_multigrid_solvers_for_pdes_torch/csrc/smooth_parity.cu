// Kernels L and K: RB-GS / SOR sweeps through parity planes held in shared
// memory, with a constant-coefficient 5-point stencil on an all-Dirichlet
// rectangle. L takes a standard (nx, ny) field in fp32 or bf16 storage, K a
// field stored as four fp32 parity planes. Both run every sweep of a call in
// one launch, out of place.
//
// L replaces the layout="parity" body of the Pallas kernels multisweep and
// multisweep_strips (_parity_sweeps, _split_parity, _merge_parity) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth.py
// (:119, reached from _smooth_kernel :211 and _strips_kernel :413): split in
// on-chip memory, sweep, merge. K replaces the Pallas kernel
// multisweep_planes (_whole_kernel, _strips_kernel, _plane_sweeps) of
// mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels/smooth_planes.py
// (:225). Its strip pipeline, over-budget strip floor (:286) and short first
// window (:101) existed for the TPU's VMEM budget only, and have no
// counterpart here.
//
// K's layout: up is a contiguous (4, hx, hy) fp32 array, planes in the order
// ee, eo, oe, oo, with hx = (nx + 1) / 2 and hy = (ny + 1) / 2; plane (a, b)
// entry (i, j) is node (2i + a, 2j + b). An entry beyond the field (the last
// row of the odd-row planes of an odd nx, the last column of the odd-column
// planes of an odd ny) is padding, copied to the output unchanged.
//
// Design: kernel A's engine (csrc/smooth.cu, smooth_tiles.cuh) with a
// parity-plane layout in shared memory.
// - The level's tile (tile_of), kThreads threads, the sweep count compiled
//   in: 1 .. kMaxSweeps sweeps per launch. The wrappers split longer calls
//   as they split A's. The colour phases are unrolled, and the registers
//   capped so that two blocks share an SM: the 1025^2 level's 256 blocks
//   then run in one wave (at 82 registers, one block per SM, L took 10%
//   longer than A there).
// - Each block loads a window of u and f: its tile plus a halo of 2 nodes
//   per sweep, clamped to the field. fp32 nodes come in as 4-byte
//   cp.async, all in flight at once. L's u, f and output are each fp32 or
//   bf16 (the storage flags of mg_rbgs_parity, as kernel A's), in every
//   pairing of u and f; the output keeps u's dtype. A bf16
//   array's window rows come in as aligned 4-byte words (common.cuh
//   load_windows: two nodes a load, every load of a thread in flight
//   before it widens any), widened into the same fp32 planes. The
//   tile is rounded once where it is stored; a bf16 call of several
//   launches keeps its passes before the last in fp32 (the wrapper's
//   scratch fields), as A's does. The nodes land as the window's four
//   parity planes: window node (li, lj) sits in plane (li & 1, lj & 1) at
//   (li >> 1, lj >> 1). Both read window rows in order: a warp takes a run
//   of a field row (L), or runs of two of the global planes' rows (K).
// - A colour's nodes are two of the window's four planes. A colour phase
//   walks whole rows of those two planes, so no thread takes a node of the
//   other colour and a warp's lanes take consecutive words (no bank
//   conflict); it skips the cells on the window's border, the first or last
//   column of a plane and, in a window clamped at the field's far edge, its
//   last rows and columns.
// - A thread computes all its cells of a phase before it stores any (a
//   phase reads only the other colour's planes and each cell's own old
//   value), so their loads overlap.
// - A stale border value travels one node per colour phase, so after the
//   launch the tile, 2 * sweeps nodes in, is exact. Where the window is
//   clamped its border is the field's fixed ring, which is exact too.
// - The tile (with the ring next to it at the field's edge, and for K the
//   padding) goes to a separate output: neighbouring blocks load this
//   block's nodes as their halo, so writing u in place would race. The
//   wrappers return that output; u is left as it was.
//
// Arithmetic: rbgs_scalar_update (common.cuh), dividing by c, every
// operation rounded explicitly, red then black. So K and L
// equal their plain twin (the parity body ops/planes.plane_sweeps) and
// kernel A bit for bit.
//
// Bound: device memory bandwidth. A call must read u and f and write u
// once: 12 bytes per node in fp32 (6 in bf16), 3.76 us at 1025^2 at
// 3.35 TB/s. The windows read
// (TX + 4 s)(TY + 4 s) / (TX TY) times the tile: 1.27x at 64 x 64 and 2
// sweeps.
#include "common.cuh"
#include "smooth_tiles.cuh"

namespace {

// Rows of one shared-memory plane for a tile of `rows` rows (columns alike):
// the window holds rows + 4 * sweeps nodes, half of them in each plane.
__host__ __device__ constexpr int plane_rows(int rows, int sweeps) {
  return rows / 2 + 2 * sweeps;
}

// u's four planes and f's.
__host__ __device__ constexpr int smem_bytes(int tx, int ty, int sweeps) {
  return 8 * plane_rows(tx, sweeps) * plane_rows(ty, sweeps) *
         (int)sizeof(float);
}

// Offset of node (gi, gj) of an (nx, ny) field: row-major (L), or in the
// (4, hx, hy) planes (K). K's offsets are 32-bit (mg_planes_rbgs refuses
// planes of 2^31 entries or more): its 64-bit index arithmetic cost ~7% of
// a call at 1025^2 (PERF.md).
template <bool kPlanes>
__device__ __forceinline__ long node_at(int gi, int gj, int ny, int hx,
                                        int hy) {
  if (kPlanes)
    return ((2 * (gi & 1) + (gj & 1)) * hx + (gi >> 1)) * hy + (gj >> 1);
  return (long)gi * ny + gj;
}

// The body of K and L, on the block's dynamic shared memory sm; every
// geometry value is a compile-time constant of the instantiation.
template <int kTileX, int kTileY, int kSweeps, bool kPlanes, bool kPow2,
          class TU, class TF, class TO>
__device__ __forceinline__ void parity_sweeps(float* sm,
                                              const TU* __restrict__ u,
                                              const TF* __restrict__ f,
                                              TO* __restrict__ out, int nx,
                                              int ny, const Stencil5& st,
                                              float omega) {
  constexpr int halo = 2 * kSweeps;
  constexpr int PR = plane_rows(kTileX, kSweeps);
  constexpr int PC = plane_rows(kTileY, kSweeps);
  constexpr int PS = PR * PC;
  float* us = sm;  // planes 2a + b: ee, eo, oe, oo (the window's parity)
  float* fs = sm + 4 * PS;
  const int hx = (nx + 1) >> 1, hy = (ny + 1) >> 1;

  const int ai = 1 + blockIdx.y * kTileX, bi = min(ai + kTileX, nx - 1);
  const int aj = 1 + blockIdx.x * kTileY, bj = min(aj + kTileY, ny - 1);
  const int wi0 = max(ai - halo, 0), wx = min(bi + halo, nx) - wi0;
  const int wj0 = max(aj - halo, 0), wy = min(bj + halo, ny) - wj0;
  auto at = [&](int li, int lj) {
    return (2 * (li & 1) + (lj & 1)) * PS + (li >> 1) * PC + (lj >> 1);
  };

  // row by row: a warp reads a run of a field row (L), or of two global
  // planes' rows (K); loading K plane by plane was slower (PERF.md)
  constexpr bool kBu = std::is_same_v<TU, bf16>;
  constexpr bool kBf = std::is_same_v<TF, bf16>;
  constexpr int WY = 2 * PC;  // columns of a full window
  if constexpr (!kBu || !kBf) {
    for (int t = threadIdx.x; t < wx * WY; t += kThreads) {
      const int li = t / WY, lj = t - li * WY;
      if (lj >= wy) continue;
      const long g = node_at<kPlanes>(wi0 + li, wj0 + lj, ny, hx, hy);
      if constexpr (!kBu) load_shared(us + at(li, lj), u + g);
      if constexpr (!kBf) load_shared(fs + at(li, lj), f + g);
    }
  }
  if constexpr (kBu || kBf) {
    // L's bf16 arrays as words into the planes (common.cuh load_windows),
    // u's then f's (4 PS apart): window row li's columns 2m and 2m + 1 in
    // planes (li & 1, 0) and (li & 1, 1) at (li >> 1, m)
    constexpr int K = kBu + kBf, WR = PC + 1;  // the widest row's words
    constexpr int kPer = (2 * PR * WR + kThreads - 1) / kThreads;
    const bf16* src[K];
    src[K - 1] = reinterpret_cast<const bf16*>(f);
    if constexpr (kBu) src[0] = reinterpret_cast<const bf16*>(u);
    load_windows<K, kPer, WR, kThreads>(
        src, kBu ? us : fs, 4 * PS, wi0, wj0, wx, wy, nx, ny, PS,
        [&](int li) { return 2 * (li & 1) * PS + (li >> 1) * PC; });
  }
  cp_async_commit();
  cp_async_wait<0>();

  // Plane (a, b) holds window nodes (2 pi + a, 2 pj + b); those off the
  // window's border are rows pi = 1 - a .. (wx - 2 - a) / 2 and columns
  // pj = 1 - b .. (wy - 2 - b) / 2. A phase walks whole rows 1 - a ..
  // PR - 1 - a of its two planes, so a warp's lanes take consecutive words
  // (no bank conflict), and skips the cells off those bounds: the first or
  // last column, and in a window clamped at the field's far edge its last
  // rows and columns.
  constexpr int CELLS = (PR - 1) * PC;
  constexpr int kItems = (2 * CELLS + kThreads - 1) / kThreads;
  const int r_last0 = (wx - 2) >> 1, r_last1 = (wx - 3) >> 1;
  const int c_last0 = (wy - 2) >> 1, c_last1 = (wy - 3) >> 1;
  const int par = (wi0 + wj0) & 1;  // colour of window node (0, 0)
#pragma unroll
  for (int ph = 0; ph < 2 * kSweeps; ++ph) {
    // colour ph & 1 (red first) is planes (0, b0) and (1, b0 ^ 1): items
    // 0 .. CELLS - 1 walk the first, CELLS .. 2 CELLS - 1 the second
    const int b0 = (ph + par) & 1;
    __syncthreads();
    float nv[kItems];
    int self[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int t = threadIdx.x + k * kThreads;
      const int a = t >= CELLS, b = b0 ^ a;
      const int rc = t - a * CELLS, r = rc / PC;
      const int pi = r + 1 - a, pj = rc - r * PC;
      self[k] = -1;
      // past 2 CELLS, pi >= PR - 1 > r_last1
      if (pi > (a ? r_last1 : r_last0) || pj < 1 - b ||
          pj > (b ? c_last1 : c_last0))
        continue;
      const int s = (2 * a + b) * PS + pi * PC + pj;
      // (li + 1, lj) in plane (a ^ 1, b), (li - 1, lj) one plane row above;
      // (li, lj + 1) in plane (a, b ^ 1), (li, lj - 1) one cell before
      const float* xn = us + (2 * (a ^ 1) + b) * PS + (pi + a) * PC + pj;
      const float* yn = us + (2 * a + (b ^ 1)) * PS + pi * PC + pj + b;
      nv[k] = rbgs_scalar_update<kPow2>(us[s], fs[s], xn[-PC], xn[0],
                                        yn[-1], yn[0], st, omega);
      self[k] = s;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (self[k] >= 0) us[self[k]] = nv[k];
  }
  __syncthreads();

  // the tile (with the ring next to it at the field's edge) -> out
  int lo_i, hi_i, lo_j, hi_j;
  tile_span(blockIdx.y, kTileX, nx, &lo_i, &hi_i);
  tile_span(blockIdx.x, kTileY, ny, &lo_j, &hi_j);
  constexpr int SY = kTileY + 2;  // columns of the span, at most
  const int ty = hi_j - lo_j;
  for (int t = threadIdx.x; t < (hi_i - lo_i) * SY; t += kThreads) {
    const int i = t / SY, j = t - i * SY;
    if (j >= ty) continue;
    const int gi = lo_i + i, gj = lo_j + j;
    store_f(out + node_at<kPlanes>(gi, gj, ny, hx, hy),
            us[at(gi - wi0, gj - wj0)]);
  }
  if constexpr (kPlanes) {
    // K: the padding beyond an odd field's edge next to the span (row nx,
    // column ny, their corner), copied from up
    const int pad_i = (nx & 1) && hi_i == nx, pad_j = (ny & 1) && hi_j == ny;
    const int row = pad_i ? ty + pad_j : 0;
    for (int t = threadIdx.x; t < row + pad_j * (hi_i - lo_i); t += kThreads) {
      const int gi = t < row ? nx : lo_i + t - row;
      const int gj = t < row ? lo_j + t : ny;
      const long g = node_at<true>(gi, gj, ny, hx, hy);
      out[g] = u[g];
    }
  }
}

template <int kTileX, int kTileY, int kSweeps, bool kPow2, class TU,
          class TF, class TO>
__global__ void __launch_bounds__(kThreads, 2)
    parity_kernel(const TU* __restrict__ u, const TF* __restrict__ f,
                  TO* __restrict__ out, int nx, int ny, Stencil5 st,
                  float omega) {
  extern __shared__ float sm[];
  parity_sweeps<kTileX, kTileY, kSweeps, false, kPow2>(sm, u, f, out, nx, ny,
                                                       st, omega);
}

template <int kTileX, int kTileY, int kSweeps, bool kPow2>
__global__ void __launch_bounds__(kThreads, 2)
    planes_kernel(const float* __restrict__ up, const float* __restrict__ fp,
                  float* __restrict__ out, int nx, int ny, Stencil5 st,
                  float omega) {
  extern __shared__ float sm[];
  parity_sweeps<kTileX, kTileY, kSweeps, true, kPow2>(sm, up, fp, out, nx, ny,
                                                      st, omega);
}

// K's kernel (fp32 planes) or L's (TU, TF, TO storage).
template <int kTileX, int kTileY, int kSweeps, bool kPlanes, bool kPow2,
          class TU, class TF, class TO>
constexpr auto kernel_of() {
  if constexpr (kPlanes)
    return planes_kernel<kTileX, kTileY, kSweeps, kPow2>;
  else
    return parity_kernel<kTileX, kTileY, kSweeps, kPow2, TU, TF, TO>;
}

template <int kTileX, int kTileY, int kSweeps, bool kPlanes, bool kPow2,
          class TU, class TF, class TO>
cudaError_t launch(const TU* u, const TF* f, TO* out, int nx, int ny,
                   const Stencil5& st, float omega, int device,
                   cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const auto kernel =
      kernel_of<kTileX, kTileY, kSweeps, kPlanes, kPow2, TU, TF, TO>();
  constexpr int bytes = smem_bytes(kTileX, kTileY, kSweeps);
  const cudaError_t err = allow_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((ny - 2 + kTileY - 1) / kTileY,
                  (nx - 2 + kTileX - 1) / kTileX);
  kernel<<<grid, kThreads, bytes, stream>>>(u, f, out, nx, ny, st, omega);
  return cudaGetLastError();
}

// kAnySweeps false: compiled for kMaxSweeps sweeps only (the first launch
// of a longer call on a bf16 u, as kernel A's).
template <bool kPlanes, class TU, class TF, class TO, bool kAnySweeps>
int run(const void* u, const void* f, void* out, int nx, int ny, float c,
        float w, float e, float s, float n, float omega, int sweeps,
        int device, void* stream) {
  if (sweeps < 1 || sweeps > kMaxSweeps || nx < 3 || ny < 3)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Stencil5 st{c, w, e, s, n};
  const TU* tu = static_cast<const TU*>(u);
  const TF* tf = static_cast<const TF*>(f);
  TO* to = static_cast<TO*>(out);
  return (int)with_tile_and_sweeps(nx, ny, sweeps, [&](auto ti, auto sw) {
    constexpr Tile tile = kTiles[decltype(ti)::value];
    constexpr int sweeps_ = decltype(sw)::value;
    if constexpr (!kAnySweeps && sweeps_ != kMaxSweeps) {
      return cudaErrorInvalidValue;
    } else {
      const auto go = [&](auto p2) {
        return launch<tile.x, tile.y, sweeps_, kPlanes, decltype(p2)::value>(
            tu, tf, to, nx, ny, st, omega, device, (cudaStream_t)stream);
      };
      return is_pow2(c) ? go(std::true_type{}) : go(std::false_type{});
    }
  });
}

// The storage of one of L's launches, as kernel A's (csrc/smooth.cu): bit 0
// the input u is bf16, bit 1 f, bit 2 out; u and f each fp32 or bf16.
enum Storage : int {
  kFp32 = 0,        // an fp32 level
  kBf16 = 7,        // a bf16 level's call in one launch
  kBf16First = 3,   // the first launch of a longer bf16 call: out fp32
  kBf16Mid = 2,     // u and out fp32, f bf16: between, or an fp32 u's call
  kBf16Last = 6,    // the last: u fp32, out bf16
  kBf16U = 5,       // a bf16 u over an fp32 f, in one launch
  kBf16UFirst = 1,  // the first launch of such a call: out fp32
  kFp32FLast = 4,   // its last: u and f fp32, out bf16
};

}  // namespace

extern "C" {

// Kernel L: `sweeps` (1 .. kMaxSweeps) RB-GS/SOR sweeps (red then black)
// of the (nx, ny) field u, written to out (every node of out is written; u
// and f are only read, and out must not alias them). `storage` says which
// of u, f and out are bf16 (Storage); the others are fp32.
int mg_rbgs_parity(const void* u, const void* f, void* out, int nx, int ny,
                   float c, float w, float e, float s, float n, float omega,
                   int sweeps, int storage, int device, void* stream) {
  switch (storage) {
    case kFp32:
      return run<false, float, float, float, true>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kBf16:
      return run<false, bf16, bf16, bf16, true>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kBf16First:
      return run<false, bf16, bf16, float, false>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kBf16Mid:
      return run<false, float, bf16, float, true>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kBf16Last:
      return run<false, float, bf16, bf16, true>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kBf16U:
      return run<false, bf16, float, bf16, true>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kBf16UFirst:
      return run<false, bf16, float, float, false>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    case kFp32FLast:
      return run<false, float, float, bf16, true>(
          u, f, out, nx, ny, c, w, e, s, n, omega, sweeps, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel K: the same on the (4, hx, hy) planes up and fp of an (nx, ny)
// field, written to the planes out (every entry written, padding copied);
// the planes hold fewer than 2^31 entries.
int mg_planes_rbgs(const float* up, const float* fp, float* out, int nx,
                   int ny, float c, float w, float e, float s, float n,
                   float omega, int sweeps, int device, void* stream) {
  if (4L * ((nx + 1) / 2) * ((ny + 1) / 2) > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  return run<true, float, float, float, true>(up, fp, out, nx, ny, c, w, e, s,
                                              n, omega, sweeps, device,
                                              stream);
}

}  // extern "C"
